# Copy of kmerlsh_tpu/kmer/hashing.py; it imports nothing of either package.
"""Non-cryptographic hashes (vectorized NumPy).

Covers the reference ``hash/`` layer (hash/hash.cc): the live use is
``MurmurHash3_x64_64`` over the 8 packed k-mer bytes as the cuckoo-table
hash (kmer/Kmer.cc:138-147). This framework's sorted-array design doesn't
need a hash table on the hot path (the native counter uses splitmix64), but
the hash is provided — vectorized over arrays of packed k-mers — for API
completeness and for any downstream tooling that partitions by the
reference's hash values.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _fmix(k: np.ndarray) -> np.ndarray:
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xFF51AFD7ED558CCD)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xC4CEB9FE1A85EC53)
    k ^= k >> np.uint64(33)
    return k


def murmur3_x64_128_u64(data: np.ndarray, length: int, seed: int = 0):
    """MurmurHash3_x64_128 of the first ``length`` (≤ 8) little-endian bytes
    of each uint64 in ``data``. Returns (h1, h2) uint64 arrays.

    The reference vendors the *beta* x64_128 variant (constant-initialized
    h1/h2, ``bmix64`` with 23/41 rotations, ``h2 ^= len`` finalization —
    hash/hash.cc:104-199), NOT Appleby's final version; this matches the
    vendored one bit-for-bit for inputs up to one 8-byte block — the k-mer
    case (k ≤ 31 ⇒ k_bytes ≤ 8).
    """
    if not 0 < length <= 8:
        raise ValueError("length must be in 1..8")
    with np.errstate(over="ignore"):
        data = np.asarray(data, dtype=np.uint64)
        mask = (
            np.uint64(0xFFFFFFFFFFFFFFFF)
            if length == 8
            else np.uint64((1 << (8 * length)) - 1)
        )
        k1 = data & mask
        s = np.uint64(seed)
        h1 = np.full_like(k1, np.uint64(0x9368E53C2F6AF274) ^ s)
        h2 = np.full_like(k1, np.uint64(0x586DCD208F7CD3FD) ^ s)
        # tail → bmix64 with k2 = 0 (hash.cc:67-87,135-155)
        k1 = k1 * _C1
        k1 = _rotl(k1, 23)
        k1 = k1 * _C2
        h1 = h1 ^ k1
        h1 = h1 + h2
        h2 = _rotl(h2, 41)
        h2 = h2 + h1  # k2 contribution is 0
        h1 = h1 * np.uint64(3) + np.uint64(0x52DCE729)
        h2 = h2 * np.uint64(3) + np.uint64(0x38495AB5)
        # finalization (hash.cc:159-171)
        h2 = h2 ^ np.uint64(length)
        h1 += h2
        h2 += h1
        h1 = _fmix(h1)
        h2 = _fmix(h2)
        h1 += h2
        h2 += h1
    return h1, h2


def murmur3_x64_64_u64(data: np.ndarray, length: int, seed: int = 0) -> np.ndarray:
    """``MurmurHash3_x64_64`` (first half of the 128-bit hash, hash/hash.cc:
    183-190) — the reference ``Kmer::hash`` / ``KmerHash`` value."""
    h1, _ = murmur3_x64_128_u64(data, length, seed)
    return h1


def kmer_hash(packed, k: int) -> np.ndarray:
    """= ``Kmer::hash()``: murmur3_x64_64 over k_bytes = ⌈k/4⌉ packed bytes
    with seed 0 (kmer/Kmer.cc:138-147).

    Note: the reference hashes ``k_bytes`` bytes, not the full 8."""
    return murmur3_x64_64_u64(np.asarray(packed, np.uint64), (k + 3) // 4, 0)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The native counter's table hash (native/_native.cc)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))
