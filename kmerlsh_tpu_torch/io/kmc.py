# Copy of kmerlsh_tpu/io/kmc.py; only its imports of this package changed.
"""KMC3 database codec, runner, and native-counting fallback.

The reference reads KMC databases through the vendored ``kmc_api``
(kmer/kmc_api/kmc_file.cpp) with a per-k-mer string round trip
(kmer/kmc_reader.cc:52-54). Here the ``.kmc_pre``/``.kmc_suf`` pair is
parsed directly into NumPy arrays of packed uint64 k-mers + uint32 counts —
no strings, no per-record loop.

Format facts (mirroring kmc_file.cpp:136-298):

``.kmc_pre``  = "KMCP" + DATA + "KMCP"; the last 8 bytes of DATA are
``kmc_version (u32)`` then ``header_offset (u32)``.
  * version 0 (KMC1): DATA = LUT(u64 × 4^L) ++ header(5×u64) ++ ver ++ off.
    LUT[p] = index of the first suffix record whose k-mer starts with
    prefix p (CSR starts). header: (k | mode<<32), (counter_size |
    L<<32), (min | max<<32), total_kmers, flags.
  * version 0x200 (KMC2/KMC3): header block of 7×u32 + u64 total + u8 flag
    located ``header_offset+8`` bytes before file end; LUT area =
    concatenated per-signature-bin LUTs; a signature map (u32 ×
    (4^sig_len + 1)) follows the LUT area. For listing, the prefix value of
    a record is its LUT slot index masked with 4^L − 1.

``.kmc_suf``  = "KMCS" + total_kmers × (suffix bytes ++ counter bytes) +
"KMCS". Suffix bytes hold 4 bases each, MSB-first; the counter is
little-endian. The k-mer = prefix bases (MSB-first in the LUT slot value)
followed by suffix bases.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Iterable, Sequence

import numpy as np

from kmerlsh_tpu_torch.kmer import codec

PRE_MARKER = b"KMCP"
SUF_MARKER = b"KMCS"


class KmcFormatError(ValueError):
    pass


def _strip_markers(raw: bytes, marker: bytes, path: str) -> bytes:
    if len(raw) < 8 or raw[:4] != marker or raw[-4:] != marker:
        raise KmcFormatError(f"{path}: bad KMC marker")
    return raw[4:-4]


def read_db(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Read a KMC database → (packed uint64 k-mers, uint32 counts, k).

    K-mers are returned in the database's listing order (lexicographic).
    Supports KMC1 (version 0) and KMC2/KMC3 (version 0x200) databases,
    like the reference API (kmc_file.cpp:191-192).
    """
    with open(path + ".kmc_pre", "rb") as f:
        pre = _strip_markers(f.read(), PRE_MARKER, path + ".kmc_pre")
    # version probe = u32 at file offset -12, i.e. pre[-8:-4]; in a KMC1 file
    # this aliases the high half of the last header word (always 0), in
    # KMC2/KMC3 it is an explicit 0x200 (kmc_file.cpp:187-192)
    version = int(np.frombuffer(pre[-8:-4], dtype="<u4")[0])
    header_offset = int(np.frombuffer(pre[-4:], dtype="<u4")[0])

    if version == 0:
        hdr_pos = len(pre) - 4 - header_offset
        d = np.frombuffer(pre[hdr_pos : hdr_pos + 40], dtype="<u8")
        k = int(d[0] & 0xFFFFFFFF)
        mode = int(d[0] >> np.uint64(32))
        counter_size = int(d[1] & 0xFFFFFFFF)
        lut_prefix_len = int(d[1] >> np.uint64(32))
        total_kmers = int(d[3])
        lut = np.frombuffer(pre[:hdr_pos], dtype="<u8")
    elif version == 0x200:
        # header sits header_offset+8 bytes before the END OF FILE; pre has
        # both markers stripped, so in `pre` coords: len(pre)+8-(header_offset+8)-4
        hdr_pos = len(pre) - header_offset - 4
        h32 = np.frombuffer(pre[hdr_pos : hdr_pos + 28], dtype="<u4")
        k, mode, counter_size, lut_prefix_len, sig_len = (
            int(h32[0]), int(h32[1]), int(h32[2]), int(h32[3]), int(h32[4]))
        total_kmers = int(np.frombuffer(pre[hdr_pos + 28 : hdr_pos + 36], dtype="<u8")[0])
        sig_map_entries = (1 << (2 * sig_len)) + 1
        lut_area = (len(pre) - 4) - (sig_map_entries * 4 + header_offset + 8)
        lut = np.frombuffer(pre[: lut_area + 8], dtype="<u8").copy()
        # the final LUT entry is the CSR end sentinel; the reference
        # overwrites it with total+1 before listing (kmc_file.cpp:234) —
        # do the same so garbage there can never claim the last records
        lut[-1] = total_kmers + 1
    else:
        raise KmcFormatError(f"{path}: unsupported KMC version 0x{version:x}")

    if mode != 0:
        raise KmcFormatError(f"{path}: Quake mode (mode=1) not supported")
    if k > codec.MAX_K:
        raise KmcFormatError(f"{path}: k={k} exceeds supported max {codec.MAX_K}")

    sufix_size = (k - lut_prefix_len) // 4
    rec_size = sufix_size + counter_size

    with open(path + ".kmc_suf", "rb") as f:
        suf = _strip_markers(f.read(), SUF_MARKER, path + ".kmc_suf")
    recs = np.frombuffer(suf[: total_kmers * rec_size], dtype=np.uint8)
    recs = recs.reshape(total_kmers, rec_size)

    # prefix of record r = last LUT slot whose start <= r (empty slots share
    # starts; searchsorted 'right' lands on the non-empty one, matching the
    # skip-empty loop at kmc_file.cpp:453-454)
    rec_idx = np.arange(total_kmers, dtype=np.uint64)
    slot = np.searchsorted(lut, rec_idx, side="right") - 1
    prefix_mask = (1 << (2 * lut_prefix_len)) - 1
    prefix = slot.astype(np.uint64) & np.uint64(prefix_mask)

    # lexicographic value: prefix bases are the most significant
    lex = prefix << np.uint64(8 * sufix_size)
    for b in range(sufix_size):
        lex |= recs[:, b].astype(np.uint64) << np.uint64(8 * (sufix_size - 1 - b))

    counts = np.zeros(total_kmers, dtype=np.uint64)
    for b in range(counter_size):
        counts |= recs[:, sufix_size + b].astype(np.uint64) << np.uint64(8 * b)

    packed = codec.packed_of_lex(lex, k)
    return packed, counts.astype(np.uint32), k


def _pick_lut_prefix_len(k: int) -> int:
    # (k - L) must be divisible by 4 (kmc_file.cpp:273-274)
    return k % 4 if k % 4 else 4


def write_db_kmc1(
    path: str, packed: np.ndarray, counts: np.ndarray, k: int,
    min_count: int = 1, max_count: int = 0xFFFFFFFF,
) -> None:
    """Write a KMC1-format (version 0) database readable by both this module
    and the reference ``kmc_api``. Used by the native-counter fallback and by
    round-trip tests. K-mers may be in any order; they are sorted
    lexicographically as the format requires."""
    packed = np.asarray(packed, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.uint32)
    L = _pick_lut_prefix_len(k)
    sufix_size = (k - L) // 4
    counter_size = 4
    n = len(packed)

    lex = codec.lex_value(packed, k)
    order = np.argsort(lex, kind="stable")
    lex, counts = lex[order], counts[order]

    prefix = (lex >> np.uint64(8 * sufix_size)).astype(np.int64)
    n_lut = 1 << (2 * L)
    lut = np.zeros(n_lut, dtype="<u8")
    np.cumsum(np.bincount(prefix, minlength=n_lut)[:-1], out=lut[1:])

    recs = np.zeros((n, sufix_size + counter_size), dtype=np.uint8)
    for b in range(sufix_size):
        recs[:, b] = (lex >> np.uint64(8 * (sufix_size - 1 - b))).astype(np.uint8)
    for b in range(counter_size):
        recs[:, sufix_size + b] = (counts >> np.uint32(8 * b)).astype(np.uint8)

    header = np.zeros(5, dtype="<u8")
    header[0] = np.uint64(k)  # mode=0 in high bits
    header[1] = np.uint64(counter_size) | (np.uint64(L) << np.uint64(32))
    header[2] = np.uint64(min_count) | (np.uint64(max_count) << np.uint64(32))
    header[3] = np.uint64(n)
    header[4] = np.uint64(0)  # flags: both_strands stored as 0 → canonical db

    with open(path + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        f.write(lut.tobytes())
        f.write(header.tobytes())
        # KMC1 has NO version field: the reference's version probe at file
        # offset -12 (kmc_file.cpp:189-191) reads the high half of the flags
        # word, which is 0 ⇒ version 0. Only header_offset (=40) follows.
        f.write(np.array([40], dtype="<u4").tobytes())
        f.write(PRE_MARKER)
    with open(path + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        f.write(recs.tobytes())
        f.write(SUF_MARKER)


def write_db_kmc2(
    path: str, packed: np.ndarray, counts: np.ndarray, k: int,
    lut_prefix_len: int | None = None, counter_size: int = 4,
    signature_len: int = 5, n_bins: int = 1,
    min_count: int = 1, max_count: int = 0xFFFFFFFF,
) -> None:
    """Write a KMC2/KMC3-format (version 0x200) database.

    Format per ``kmc_file.cpp:195-246``: the ``.kmc_pre`` LUT area is ONE
    flat CSR array over (signature-bin, prefix) slots — ``n_bins · 4^L``
    starts plus one trailing end sentinel — followed by the signature map
    (``4^sig_len + 1`` u32, unused for listing), the 37-byte header
    (k, mode, counter_size, L, sig_len, min, max u32s; total u64;
    both_strands u8), the version word 0x200, and header_offset = 41.
    Records are sorted by (bin, prefix, suffix); k-mers land in bins by a
    deterministic hash here (real KMC uses minimizer signatures — the bin
    rule is irrelevant to readers, which only walk the CSR). Test fixture
    for the 0x200 read path; also documents the format."""
    packed = np.asarray(packed, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.uint32)
    L = lut_prefix_len if lut_prefix_len is not None else _pick_lut_prefix_len(k)
    if (k - L) % 4:
        raise ValueError(f"(k - L) = {k - L} must be divisible by 4")
    sufix_size = (k - L) // 4
    n = len(packed)

    lex = codec.lex_value(packed, k)
    bins = ((lex * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(n_bins)).astype(
        np.int64)
    order = np.lexsort((lex, bins))
    lex, counts, bins = lex[order], counts[order], bins[order]

    prefix = (lex >> np.uint64(8 * sufix_size)).astype(np.int64)
    n_lut = 1 << (2 * L)
    slot = bins * n_lut + prefix
    lut = np.zeros(n_bins * n_lut + 1, dtype="<u8")
    np.cumsum(np.bincount(slot, minlength=n_bins * n_lut), out=lut[1:])
    # readers overwrite the end sentinel with total+1; prove they must by
    # writing garbage there (real files hold `total`)
    lut[-1] = 0xDEADBEEF

    recs = np.zeros((n, sufix_size + counter_size), dtype=np.uint8)
    for b in range(sufix_size):
        recs[:, b] = (lex >> np.uint64(8 * (sufix_size - 1 - b))).astype(np.uint8)
    for b in range(counter_size):
        recs[:, sufix_size + b] = (counts >> np.uint32(8 * b)).astype(np.uint8)

    sig_map = np.zeros((1 << (2 * signature_len)) + 1, dtype="<u4")
    header32 = np.array(
        [k, 0, counter_size, L, signature_len, min_count, max_count],
        dtype="<u4")

    with open(path + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        f.write(lut.tobytes())
        f.write(sig_map.tobytes())
        f.write(header32.tobytes())
        f.write(np.array([n], dtype="<u8").tobytes())
        f.write(b"\x00")                                  # both_strands
        f.write(np.array([0x200, 41], dtype="<u4").tobytes())
        f.write(PRE_MARKER)
    with open(path + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        f.write(recs.tobytes())
        f.write(SUF_MARKER)


def kmc_available() -> bool:
    return shutil.which("kmc") is not None


def run_kmc(
    fastq: str, db_name: str, k: int, count_min: int, threads: int,
    max_memory_gb: int, work_dir: str = ".", verbose: bool = False,
) -> None:
    """Count one sample's k-mers into a KMC database.

    Uses the external ``kmc`` binary with the reference's exact CLI contract
    (io/ioHT.cc:100-103: ``kmc -k{K} -r -cs65535 -ci{C} -t{T} -m{M} sample
    db .``); falls back to the built-in native counter when ``kmc`` is not
    on PATH, writing an equivalent KMC1-format database.
    """
    if kmc_available():
        cmd = [
            "kmc", f"-k{k}", "-r", "-cs65535", f"-ci{count_min}",
            f"-t{threads}", f"-m{max_memory_gb}", fastq, db_name, work_dir,
        ]
        if verbose:
            print("running:", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)
    else:
        if verbose:
            print(f"kmc not found; native-counting {fastq} -> {db_name}")
        packed, counts = count_fastq([fastq], k, count_min=count_min,
                                     cs=65535, threads=threads)
        write_db_kmc1(db_name, packed, counts, k)


def count_fastq(
    paths: Sequence[str], k: int, count_min: int = 2, cs: int = 65535,
    chunk_reads: int = 1 << 16, threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Built-in canonical k-mer counter (KMC semantics): k-mers containing
    non-ACGT bases are skipped; counts are over both strands of the canonical
    (lexicographic-min) representative; counts < count_min dropped; counts
    capped at ``cs``. Returns (packed kmers sorted lexicographically, counts).

    Uses the C++ key-range-sharded counter (native/_native.cc, ``threads``
    worker threads; 0 = hardware concurrency) when built; vectorized NumPy
    sort-unique fallback otherwise.
    """
    try:
        import _kmerlsh_native as native
    except ImportError:
        native = None
    if native is not None:
        counter = native.KmerCounter(k, threads)
        for path in paths:
            rd = native.FastqReader(path)
            while True:
                n, _, _, seqs, soff, _, _ = rd.next_part(chunk_reads)
                if n == 0:
                    break
                counter.add(seqs, soff)
                if n < chunk_reads:
                    break
        pk, cb = counter.finalize(count_min, cs)
        return (np.frombuffer(pk, dtype="<u8").copy(),
                np.frombuffer(cb, dtype="<u4").copy())

    from kmerlsh_tpu_torch.io import fastq as fq

    acc_keys: list[np.ndarray] = []
    acc_counts: list[np.ndarray] = []
    for part in fq.read_parts(paths, part_size=chunk_reads):
        blobs, valids = [], []
        sep = np.zeros(1, dtype=np.uint8)
        sep_invalid = np.zeros(1, dtype=bool)
        for r in part:
            c, v = codec.seq_to_codes(r.seq)
            blobs += [c, sep]
            valids += [v, sep_invalid]
        codes = np.concatenate(blobs) if blobs else np.empty(0, np.uint8)
        valid = np.concatenate(valids) if valids else np.empty(0, bool)
        if len(codes) < k:
            continue
        kmers = codec.sliding_kmers(codes, k)
        mask = codec.valid_kmer_mask(valid, k)
        kmers = kmers[mask]
        if not len(kmers):
            continue
        canon = codec.canonical_lex(kmers, k)
        keys, cnts = np.unique(codec.lex_value(canon, k), return_counts=True)
        acc_keys.append(keys)
        acc_counts.append(cnts.astype(np.uint64))
        # periodic consolidation to bound memory
        if len(acc_keys) > 64:
            acc_keys, acc_counts = _consolidate(acc_keys, acc_counts)

    if not acc_keys:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    acc_keys, acc_counts = _consolidate(acc_keys, acc_counts)
    lex, counts = acc_keys[0], acc_counts[0]
    keep = counts >= count_min
    lex, counts = lex[keep], np.minimum(counts[keep], cs)
    return codec.packed_of_lex(lex, k), counts.astype(np.uint32)


def _consolidate(keys: list[np.ndarray], counts: list[np.ndarray]):
    allk = np.concatenate(keys)
    allc = np.concatenate(counts)
    uk, inv = np.unique(allk, return_inverse=True)
    uc = np.zeros(len(uk), dtype=np.uint64)
    np.add.at(uc, inv, allc)
    return [uk], [uc]
