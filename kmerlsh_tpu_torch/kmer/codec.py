# Copy of kmerlsh_tpu/kmer/codec.py; only the docstring's first line and
# the reference's path changed.
"""2-bit k-mer codec on uint64 words (vectorized, host NumPy).

Replaces the reference's byte-array ``Kmer`` value type
(the reference's ``kmer/Kmer.cc``) with a packed ``uint64`` representation
that vectorizes over millions of k-mers at once.

Representation
--------------
A k-mer ``c_0 c_1 … c_{k-1}`` (A=0, C=1, G=2, T=3; any other character maps
to 0, matching ``Kmer::set_kmer`` at ``kmer/Kmer.cc:115-136`` which leaves
unrecognized bases as ``00``) is packed as

    packed = sum_i  c_i << (2*i)            (base 0 in the lowest bits)

This is bit-for-bit the reference's byte layout (base ``i`` at bit offset
``2*(i%4)`` of byte ``i/4``) when the uint64 is stored little-endian, so
``kmer_set.hex`` written from ``packed`` little-endian is byte-compatible
with ``Kmer::writeBytes`` (``kmer/Kmer.cc:307-311``).

Ordering / canonicality
-----------------------
The reference compares k-mers with ``memcmp`` over the 8 packed bytes
(``kmer/Kmer.cc:76-78``) and canonicalizes as ``rep = min(km, twin())``
(``kmer/kmc_reader.cc:14-15``). memcmp order over little-endian bytes equals
numeric order of the byte-swapped word, so we define

    key = bswap64(packed)

and use ``key`` as the global integer identity of a k-mer everywhere (sorting,
set union, searchsorted membership). ``canonical_key = min(key(x), key(rc(x)))``
reproduces the reference's canonical representative exactly.
"""

from __future__ import annotations

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)

BASE_TO_CODE = np.zeros(256, dtype=np.uint8)
BASE_TO_CODE[ord("C")] = 1
BASE_TO_CODE[ord("G")] = 2
BASE_TO_CODE[ord("T")] = 3
CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

MAX_K = 31  # reference usage: "at most MAX_K-1" with MAX_K=32 (app/kmerLSH.cc:114)


def _as_u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


def reverse_bases64(v) -> np.ndarray:
    """Reverse the 32 2-bit groups of each uint64."""
    v = _as_u64(v)
    v = ((v >> np.uint64(2)) & _M2) | ((v & _M2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & _M4) | ((v & _M4) << np.uint64(4))
    return v.byteswap()


def revcomp(packed, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (= ``Kmer::twin``, kmer/Kmer.cc:150-187)."""
    packed = _as_u64(packed)
    return reverse_bases64(~packed & _FULL) >> np.uint64(64 - 2 * k)


def key_of(packed) -> np.ndarray:
    """memcmp-order integer key of packed k-mers (bswap64)."""
    return _as_u64(packed).byteswap()


def packed_of_key(key) -> np.ndarray:
    return _as_u64(key).byteswap()


def canonical_key(packed, k: int) -> np.ndarray:
    """Canonical representative key: min(key(x), key(revcomp(x))) — the
    reference's ``rep = (km < tw) ? km : tw`` (kmer/kmc_reader.cc:14-15)."""
    fwd = key_of(packed)
    rc = key_of(revcomp(packed, k))
    return np.minimum(fwd, rc)


def encode_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Pack a (..., k) uint8 code array into packed uint64 k-mers."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = (np.uint64(2) * np.arange(k, dtype=np.uint64))
    return (codes << shifts).sum(axis=-1, dtype=np.uint64)


def encode_string(s: str) -> np.uint64:
    """Pack one k-mer string (k = len(s) ≤ 31)."""
    b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return np.uint64(encode_codes(BASE_TO_CODE[b], len(s)))


def decode(packed, k: int) -> list[str] | str:
    """Unpack packed k-mers back to strings (scalar in → str out)."""
    v = np.atleast_1d(_as_u64(packed))
    shifts = (np.uint64(2) * np.arange(k, dtype=np.uint64))
    codes = ((v[..., None] >> shifts) & np.uint64(3)).astype(np.uint8)
    out = [bytes(CODE_TO_BASE[c]).decode("ascii") for c in codes]
    return out[0] if np.isscalar(packed) or np.ndim(packed) == 0 else out


def forward_base(packed, code, k: int) -> np.ndarray:
    """Rolling next k-mer: drop base 0, append ``code`` at position k-1
    (= ``Kmer::forwardBase``, kmer/Kmer.cc:210-236)."""
    packed = _as_u64(packed)
    return (packed >> np.uint64(2)) | (
        np.asarray(code, dtype=np.uint64) << np.uint64(2 * (k - 1))
    )


def sliding_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All len(codes)-k+1 packed k-mers of a code sequence, vectorized.

    Equivalent to the reference's forwardBase loop over a read
    (io/ioFastQ.cc:31-36) including its non-ACGT→A substitution.

    Doubling composition: ``p_w[i]`` packs bases ``i..i+w-1``;
    ``p_2w[i] = p_w[i] | p_w[i+w] << 2w`` builds power-of-two widths in
    log2(k) passes, and k composes from its binary decomposition — O(log k)
    sweeps instead of materializing an [n, k] window view (which costs
    ~50× more at part scale: 31 s vs 0.6 s for 2^16 × 150 bp reads)."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    # each level w needs 2w bits: stage through the narrowest dtype so the
    # sweeps stay memory-bandwidth-cheap (8.4 M windows/part in mode E)
    dt = {2: np.uint8, 4: np.uint8, 8: np.uint16, 16: np.uint32, 32: np.uint64}
    p: dict[int, np.ndarray] = {1: np.ascontiguousarray(codes, np.uint8)}
    w = 1
    while 2 * w <= k:
        a = p[w]
        b = a[w: L - w + 1].astype(dt[2 * w])
        b <<= 2 * w
        b |= a[: L - 2 * w + 1]
        p[2 * w] = b
        if not (k & w):          # level not in k's binary decomposition
            del p[w]
        w *= 2
    rem, pos, acc = k, 0, None
    for w in sorted(p, reverse=True):
        while w <= rem:
            term = p[w][pos: pos + n].astype(np.uint64)
            if pos:
                term <<= 2 * pos
            if acc is None:
                acc = term
            else:
                acc |= term
            rem -= w
            pos += w
    return acc


def valid_kmer_mask(codes_valid: np.ndarray, k: int) -> np.ndarray:
    """Mask of windows containing only ACGT bases (KMC skips k-mers with N)."""
    n = len(codes_valid) - k + 1
    if n <= 0:
        return np.empty(0, dtype=bool)
    win = np.lib.stride_tricks.sliding_window_view(codes_valid, k)
    return win.all(axis=-1)


def seq_to_codes(seq: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Byte string → (codes uint8 with non-ACGT as 0, validity mask)."""
    b = np.frombuffer(seq, dtype=np.uint8)
    codes = BASE_TO_CODE[b]
    valid = (b == ord("A")) | (b == ord("C")) | (b == ord("G")) | (b == ord("T"))
    return codes, valid


# --- lexicographic (KMC-order) helpers -------------------------------------

def lex_value(packed, k: int) -> np.ndarray:
    """Integer whose numeric order equals lexicographic (sequence) order:
    base 0 in the MOST significant position. Used by the KMC database codec
    (KMC sorts and canonicalizes lexicographically, unlike the reference's
    memcmp rule)."""
    packed = _as_u64(packed)
    return reverse_bases64(packed) >> np.uint64(64 - 2 * k)


def packed_of_lex(lex, k: int) -> np.ndarray:
    lex = _as_u64(lex)
    return reverse_bases64(lex << np.uint64(64 - 2 * k))


def canonical_lex(packed, k: int) -> np.ndarray:
    """KMC-style canonical: min(x, revcomp(x)) in lexicographic order,
    returned as packed."""
    rc = revcomp(packed, k)
    lf, lr = lex_value(packed, k), lex_value(rc, k)
    return np.where(lf <= lr, _as_u64(packed), rc)
