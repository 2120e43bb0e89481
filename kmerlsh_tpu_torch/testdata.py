"""Synthetic fixtures.

``generate`` is kmerlsh_tpu.testdata's (which imports no JAX): two-group
FASTQs with planted differential markers. ``python -m
kmerlsh_tpu_torch.testdata <dir>`` writes the FASTQs plus the two-column
sample lists (``groupA.txt`` / ``groupB.txt``).

``wrs_rows`` and ``read_part`` make the inputs of the mode-E kernels from a
seed, with their edge cases planted, for the kernel tests and chip_smoke.py.
``window_keys``, ``marker_keys``, ``write_hex`` and ``write_source_fastqs``
build mode-E inputs from source sequences, so that chip_smoke.py needs no
codec of its own.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from kmerlsh_tpu.kmer import codec
from kmerlsh_tpu.testdata import generate

__all__ = ["generate", "wrs_rows", "read_part", "window_keys", "marker_keys",
           "write_hex", "write_source_fastqs"]


def wrs_rows(n: int, n1: int, n2: int, seed: int = 0):
    """Cluster rows for the t-test: values f32 [n, n1+n2] around 4 with
    spread 0.3, sizes int32 [n] in [0, 100). A tenth of the rows are
    shifted up in group A, a tenth in group B, by 0–1.5; one row in a
    hundred is constant (s = 0, equal means) and one in a hundred has
    constant groups of different values (s = 0, unequal means)."""
    r = np.random.default_rng(seed)
    v = (4.0 + 0.3 * r.normal(size=(n, n1 + n2))).astype(np.float32)
    shift = r.uniform(0, 1.5, size=n).astype(np.float32)
    kind = r.integers(0, 100, size=n)
    v[kind < 10, :n1] += shift[kind < 10, None]
    v[(kind >= 10) & (kind < 20), n1:] += shift[(kind >= 10) & (kind < 20),
                                               None]
    v[kind == 20] = 4.0
    v[kind == 21, :n1] = 4.5
    v[kind == 21, n1:] = 4.0
    sizes = r.integers(0, 100, size=n).astype(np.int32)
    return v, sizes


def read_part(n_reads: int, n_keys: int, k: int = 31, read_len: int = 150,
              vote: float = 0.5, seed: int = 0):
    """One part of reads and a sorted uint64 differential set of exactly
    ``n_keys`` keys: every window of a pool of source sequences of
    ``read_len`` bases, topped up with random 64-bit keys. A third of the
    reads are copies of sources with 1% substitutions (some with N bases),
    the rest random; a few have N, a few are 1–9 bases shorter than k+10,
    one is the first k+10 bases of a source, one is empty, and one has a
    hit ratio of exactly ``vote`` (returned as its index)."""
    r = np.random.default_rng(seed)
    n_w = read_len - k + 1
    n_src = max(1, min(n_keys // n_w, n_reads))
    src = r.integers(0, 4, size=(n_src, read_len)).astype(np.uint8)
    keys = np.unique(window_keys(src, k))
    while len(keys) < n_keys:
        extra = r.integers(0, 2**64, size=n_keys - len(keys), dtype=np.uint64)
        keys = np.union1d(keys, extra)
    keys = keys[:n_keys]

    base = np.frombuffer(b"ACGT", np.uint8)
    codes = r.integers(0, 4, size=(n_reads, read_len)).astype(np.uint8)
    copy = r.random(n_reads) < 1 / 3
    pick = r.integers(0, n_src, size=n_reads)
    codes[copy] = src[pick[copy]]
    sub = (r.random((n_reads, read_len)) < 0.01) & copy[:, None]
    codes[sub] = r.integers(0, 4, size=int(sub.sum()))
    seqs = base[codes]
    with_n = r.random(n_reads) < 0.05
    seqs[with_n, r.integers(0, read_len, size=int(with_n.sum()))] = ord("N")
    reads = [bytes(s) for s in seqs]

    n_short = min(9, n_reads // 8)
    for i in range(n_short):       # lengths k+1 … k+9: never eligible
        reads[i] = bytes(base[src[i % n_src, : k + 1 + i]])
    reads[n_short] = bytes(base[src[0, : k + 10]])     # eligible, all hits
    reads[n_short + 1] = b""
    # exactly vote · n_w hits: the source's first windows, then a base that
    # differs from the source's, so that no later window is the source's
    tie = n_short + 2
    hits = int(round(vote * n_w))
    if abs(hits - vote * n_w) > 1e-9 or hits + k > read_len:
        raise ValueError(f"vote {vote} × {n_w} windows is not a whole count")
    t = r.integers(0, 4, size=read_len).astype(np.uint8)
    t[: hits + k - 1] = src[0, : hits + k - 1]
    t[hits + k - 1] = (src[0, hits + k - 1] + 1) % 4
    reads[tie] = bytes(base[t])
    got = int(np.isin(window_keys(t[None], k), keys).sum())
    if got != hits:
        raise ValueError(f"tie read has {got} hits, not {hits}")
    return reads, keys, tie


def window_keys(src: np.ndarray, k: int) -> np.ndarray:
    """Canonical keys of every window of every row of ``src`` [n, L]."""
    n, L = src.shape
    packed = codec.sliding_kmers(src.reshape(-1), k)
    idx = (np.arange(n)[:, None] * L + np.arange(L - k + 1)).reshape(-1)
    return codec.canonical_key(packed[idx], k)


def marker_keys(markers: list[str], k: int) -> np.ndarray:
    """Sorted unique canonical keys of every k-mer of the marker strings."""
    return np.unique(np.concatenate([
        codec.canonical_key(codec.sliding_kmers(
            codec.seq_to_codes(m.encode())[0], k), k) for m in markers]))


def write_hex(path: str, keys: np.ndarray) -> None:
    """``kmer_set.hex`` of canonical uint64 keys, row r = keys[r]."""
    codec.packed_of_key(keys).astype("<u8").tofile(path)


def write_source_fastqs(work: str, src: np.ndarray, n_files: int,
                        n_reads: int, seed: int) -> list[str]:
    """``n_files`` FASTQs ``sample{i:02d}.fastq`` of ``n_reads`` reads of
    L bases, src being codes uint8 [n, L]: half of the reads are copies of
    random sources with 0.5% substitutions, half random sequence."""
    r = np.random.default_rng(seed)
    L = src.shape[1]
    width = 1 + 9 + 1 + L + 3 + L + 1          # @r%08d\n seq \n+\n qual \n
    digits = (np.arange(n_reads)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    paths = []
    for i in range(n_files):
        codes = r.integers(0, 4, size=(n_reads, L), dtype=np.uint8)
        copy = r.random(n_reads) < 0.5
        codes[copy] = src[r.integers(0, len(src), size=int(copy.sum()))]
        sub = (r.random((n_reads, L)) < 0.005) & copy[:, None]
        codes[sub] = r.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
        rec = np.empty((n_reads, width), np.uint8)
        rec[:, 0], rec[:, 1] = ord("@"), ord("r")
        rec[:, 2:10] = ord("0") + digits
        rec[:, 10] = ord("\n")
        rec[:, 11:11 + L] = codec.CODE_TO_BASE[codes]
        rec[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 14 + L:14 + 2 * L] = ord("I")
        rec[:, -1] = ord("\n")
        path = os.path.join(work, f"sample{i:02d}.fastq")
        rec.tofile(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else "."
    m = generate(target)
    print(f"wrote {m['lists']['A']} and {m['lists']['B']}")
