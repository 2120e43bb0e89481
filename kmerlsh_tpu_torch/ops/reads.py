"""Differential-read scoring of mode E (port of kmerlsh_tpu/ops/reads.py).

Reference semantics (``IOFQ::CheckRead``, io/ioFastQ.cc:5-76):
  * reads with an empty sequence are skipped;
  * reads shorter than k+10 are never extracted;
  * every window of the read gives a k-mer, non-ACGT bases encoding as 'A';
  * each k-mer is canonicalized by the memcmp rule and looked up in the
    differential set; a read is selected iff
    ``hits / (len − k + 1) > kmer_vote`` (strict).

Three scorers with that contract:

  * :func:`score_part`: host NumPy (a copy of the reference's);
  * :func:`score_part_native`: the C++ ``ReadScorer`` of ``_kmerlsh_native``
    (a copy of the reference's wrapper);
  * :func:`score_part_device` / :func:`score_part_device_async`: the part
    packed as the reference packs it for its device, uploaded, and scored
    by ``kernels.score_reads`` (the CUDA kernel on a card, its plain
    PyTorch version on the CPU). The differential keys are uploaded, and
    their prefix directory built, once per group, not once per part.

Keys are uint64 on the host. On the device they are int64 tensors holding
the same bits, sorted in unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

from kmerlsh_tpu_torch.kmer import codec

READS_CAP = 1 << 16          # reads per part (utils/fastq.h:36 contract)


# copied from kmerlsh_tpu/ops/reads.py _pack_flat_codes
def _pack_flat_codes(seqs: list[bytes], k: int) -> np.ndarray:
    """Concatenate reads with k−1 zero-code pad bases between them and
    2-bit-encode the whole blob in ONE table lookup. Pads encode as code 0;
    windows that overlap a pad are masked out by the callers."""
    blob = (b"\x00" * (k - 1)).join(seqs)
    return codec.BASE_TO_CODE[np.frombuffer(blob, dtype=np.uint8)]


# copied from kmerlsh_tpu/ops/reads.py score_part
def score_part(
    seqs: list[bytes], diff_keys: np.ndarray, k: int, kmer_vote: float
) -> np.ndarray:
    """Return a bool mask of selected reads.

    ``diff_keys`` must be a sorted uint64 array of canonical memcmp keys.
    """
    n = len(seqs)
    selected = np.zeros(n, dtype=bool)
    if n == 0 or len(diff_keys) == 0:
        return selected

    lens = np.fromiter((len(s) for s in seqs), count=n, dtype=np.int64)
    eligible = lens >= k + 10  # strict '<' skip in the reference (:25)

    flat = _pack_flat_codes(seqs, k)
    kmers = codec.sliding_kmers(flat, k)
    keys = codec.canonical_key(kmers, k)
    idx = np.searchsorted(diff_keys, keys)
    idx_c = np.minimum(idx, len(diff_keys) - 1)
    hit = (diff_keys[idx_c] == keys).astype(np.int64)

    # windows starting inside the k-1 pad after read i overlap read i+1's
    # prefix; mask them out, then reduce per read via cumsum differences
    starts = np.concatenate([[0], np.cumsum(lens + (k - 1))])[:-1]
    n_win = np.maximum(lens - k + 1, 0)
    win_start = starts
    mark = np.zeros(len(kmers) + 1, dtype=np.int64)
    valid_reads = n_win > 0
    np.add.at(mark, win_start[valid_reads], 1)
    np.add.at(mark, (win_start + n_win)[valid_reads], -1)
    in_read = np.cumsum(mark[:-1]) > 0
    hit &= in_read

    chit = np.concatenate([[0], np.cumsum(hit)])
    counts = chit[np.minimum(win_start + n_win, len(kmers))] - chit[
        np.minimum(win_start, len(kmers))
    ]

    denom = (lens - k + 1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(denom > 0, counts / denom, 0.0)
    selected = eligible & (lens > 0) & (ratio > kmer_vote)
    # reference also skips empty-sequence reads explicitly (:21-24)
    selected &= np.fromiter((len(s) > 0 for s in seqs), count=n, dtype=bool)
    return selected


# --- device scorer ---------------------------------------------------------------

def pack_part(seqs: list[bytes], k: int):
    """One part as the device scorer takes it (kmerlsh_tpu/ops/reads.py
    score_part_device_async): uint8 codes of the reads joined by k−1 zero
    pads, with k zero codes after the last read; per read int32 lens, the
    start of its first window and its window count."""
    n = len(seqs)
    if n > READS_CAP:
        raise ValueError(f"part has {n} reads > {READS_CAP}")
    lens = np.fromiter((len(s) for s in seqs), count=n, dtype=np.int64)
    flat = _pack_flat_codes(seqs, k)
    codes = np.zeros(len(flat) + k, np.uint8)
    codes[:len(flat)] = flat
    if len(codes) >= 2**31:
        raise ValueError(f"part of {len(codes)} bases: int32 offsets overflow")
    starts = np.concatenate([[0], np.cumsum(lens + (k - 1))])[:-1]
    n_win = np.maximum(lens - k + 1, 0)
    return (codes, starts.astype(np.int32), n_win.astype(np.int32),
            lens.astype(np.int32))


# device-resident differential keys and their prefix directory: mode E
# scores many parts against the same key array, so both are made once per
# group. Keyed on object identity (the pipeline passes one array per group);
# the value holds the host array, so the id cannot be recycled while the
# entry lives.
_DIFF_CACHE: dict = {}


def _diff_on_device(diff_keys: np.ndarray, device):
    """(keys int64 [D], their ``kernels.key_directory``) on ``device``."""
    from kmerlsh_tpu_torch import kernels

    dev = torch.device(device)
    key = (id(diff_keys), len(diff_keys), str(dev))
    hit = _DIFF_CACHE.get(key)
    if hit is not None:
        return hit[1]
    bits = np.ascontiguousarray(diff_keys, np.uint64).view(np.int64)
    keys = torch.from_numpy(bits).to(dev)
    _DIFF_CACHE.clear()                      # hold at most one set
    _DIFF_CACHE[key] = (diff_keys, (keys, kernels.key_directory(keys)))
    return _DIFF_CACHE[key][1]


def score_part_device_async(
    seqs: list[bytes], diff_keys: np.ndarray, k: int, kmer_vote: float,
    device="cuda",
):
    """Pack and upload a part and launch the scorer on ``device``; return a
    zero-argument resolver that gives the bool mask on the host, so that a
    caller can pack the next part while this one runs."""
    from kmerlsh_tpu_torch import kernels

    n = len(seqs)
    if n == 0 or len(diff_keys) == 0:
        empty = np.zeros(n, dtype=bool)
        return lambda: empty
    dev = torch.device(device)
    keys, directory = _diff_on_device(diff_keys, dev)
    arrays = [torch.from_numpy(a).to(dev) for a in pack_part(seqs, k)]
    mask = kernels.score_reads(*arrays, keys, k, kmer_vote, directory)
    return lambda: mask.cpu().numpy()


def score_part_device(
    seqs: list[bytes], diff_keys: np.ndarray, k: int, kmer_vote: float,
    device="cuda",
) -> np.ndarray:
    """Device twin of :func:`score_part` (identical selection contract)."""
    return score_part_device_async(seqs, diff_keys, k, kmer_vote, device)()


# --- native (C++) scorer ------------------------------------------------------

# copied from kmerlsh_tpu/ops/reads.py score_part_native and its cache
_NATIVE_SCORER_CACHE: dict = {}   # (id, len, k) → (diff_keys ref, scorer)


def score_part_native(
    seqs: list[bytes], diff_keys: np.ndarray, k: int, kmer_vote: float
) -> np.ndarray:
    """Native multithreaded twin of :func:`score_part` (identical selection
    contract; native/_native.cc ReadScorer). The differential set builds
    into an open-addressing table once per group."""
    import _kmerlsh_native as native

    n = len(seqs)
    if n == 0 or len(diff_keys) == 0:
        return np.zeros(n, dtype=bool)
    ck = (id(diff_keys), len(diff_keys), k)
    hit = _NATIVE_SCORER_CACHE.get(ck)
    if hit is None:
        scorer = native.ReadScorer(
            np.ascontiguousarray(diff_keys, np.uint64), k)
        _NATIVE_SCORER_CACHE.clear()          # hold at most one set
        _NATIVE_SCORER_CACHE[ck] = (diff_keys, scorer)
    else:
        scorer = hit[1]
    blob = b"".join(seqs)
    lens = np.fromiter((len(s) for s in seqs), count=n, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    mask = scorer.score(blob, np.ascontiguousarray(offs), float(kmer_vote))
    return np.frombuffer(mask, np.uint8).astype(bool)
