# Copy of kmerlsh_tpu/io/counts.py; only its imports of this package changed.
"""Count-matrix artifacts: kmer_set.hex / kmer_count.bin / kmer_count.log.

Byte-compatible with the reference stage-B outputs (io/ioHT.cc:83-199), with
one documented divergence: the global k-mer row order here is **sorted by
canonical memcmp key** (deterministic) instead of cuckoo-hash iteration order
(which is unstable run-to-run in the reference, io/ioHT.cc:144-148).

Formats:
  * ``kmer_set.hex``  — 8 bytes per k-mer, the reference ``Kmer`` byte packing
    (= packed uint64 little-endian), in global row order.
  * ``kmer_count.bin`` — sample-major uint16: sample i's counts for all
    kmap_size rows at byte offset ``i * kmap_size * 2`` (io/ioHT.cc:65-66).
  * ``kmer_count.log`` — one line: ``kmap_size\\t cov_1\\t cov_2 …`` where
    cov_j = Σ log(count) over sample j's own KMC records (kmc_reader.cc:146),
    printed with %f formatting and no trailing newline (io/ioHT.cc:171,185).
"""

from __future__ import annotations

import os

import numpy as np

from kmerlsh_tpu_torch.io import kmc as kmcio
from kmerlsh_tpu_torch.kmer import codec

HEX_NAME = "kmer_set.hex"
BIN_NAME = "kmer_count.bin"
LOG_NAME = "kmer_count.log"


def build_count_matrix(
    kmc_names: list[str], k: int, out_dir: str = ".", verbose: bool = False,
) -> tuple[int, list[float]]:
    """Stage B: union all samples' canonical k-mers, write the three
    artifacts. Returns (kmap_size, v_kmers) where v_kmers[j] =
    coverage_j / kmap_size (io/ioHT.cc:184).

    Two streaming passes so memory stays O(union + one sample) instead of
    O(Σ samples) — the same shape as the reference's KmcRead-then-KmcCount
    double read (kmer/kmc_reader.cc:26,88): pass 1 folds each database's
    keys into the running union; pass 2 re-reads each database to emit its
    uint16 count row against the final union."""
    union = np.empty(0, np.uint64)
    for name in kmc_names:
        packed, counts, db_k = kmcio.read_db(name)
        if db_k != k:
            raise ValueError(f"{name}: database k={db_k} != requested k={k}")
        keys = codec.canonical_key(packed, k)
        del packed, counts
        union = np.union1d(union, keys)
        if verbose:
            print(f"{name}: {len(keys)} kmers, union {len(union)}")
        del keys
    kmap_size = len(union)
    if verbose:
        print(f"union size: {kmap_size}")

    codec.packed_of_key(union).astype("<u8").tofile(os.path.join(out_dir, HEX_NAME))

    coverages: list[float] = []
    with open(os.path.join(out_dir, BIN_NAME), "wb") as f:
        for name in kmc_names:
            packed, counts, _ = kmcio.read_db(name)
            keys = codec.canonical_key(packed, k)
            del packed
            row = np.zeros(kmap_size, dtype="<u2")
            row[np.searchsorted(union, keys)] = np.minimum(
                counts, 65535).astype(np.uint16)
            f.write(row.tobytes())
            # float64 accumulation (divergence: the reference accumulates
            # float32, kmc_reader.cc:110,146)
            coverages.append(float(np.log(counts.astype(np.float64)).sum()))
            if verbose:
                print(f"{name}: coverage {coverages[-1]:.3f}")
            del keys, counts, row

    with open(os.path.join(out_dir, LOG_NAME), "w") as f:
        f.write(str(kmap_size))
        for cov in coverages:
            f.write("\t%f" % cov)

    return kmap_size, [c / kmap_size for c in coverages]


def read_log(path: str) -> tuple[int, list[float]]:
    """Parse kmer_count.log → (kmap_size, raw coverages)."""
    with open(path) as f:
        parts = f.readline().split()
    try:
        kmap = int(parts[0])
        covs = [float(x) for x in parts[1:]]
    except (IndexError, ValueError) as e:
        raise ValueError(
            f"{path}: malformed kmer_count.log (expected "
            f"'<kmap_size>\\t<cov_1>\\t…', got {' '.join(parts[:4])!r}…)"
        ) from e
    if not covs:
        raise ValueError(f"{path}: no per-sample coverages recorded")
    return kmap, covs


def read_hex(path: str) -> np.ndarray:
    """kmer_set.hex → canonical keys in row order."""
    packed = np.fromfile(path, dtype="<u8")
    return codec.key_of(packed)


def read_count_batch(
    path: str, num_sample: int, num_kmer: int, batch_offset: int, batch_size: int,
) -> np.ndarray:
    """One [num_sample, batch_size] uint16 slice of the sample-major matrix
    (= ``ReadHT``, io/ioHT.cc:59-81)."""
    expect = num_sample * num_kmer * 2
    actual = os.path.getsize(path)
    if actual != expect:
        raise ValueError(
            f"{path}: size {actual} B does not match {num_sample} samples × "
            f"{num_kmer} k-mers × 2 B = {expect} B — truncated kmer_count.bin"
            f" or wrong kmer_count.log?")
    mm = np.memmap(path, dtype="<u2", mode="r", shape=(num_sample, num_kmer))
    return np.asarray(mm[:, batch_offset : batch_offset + batch_size])
