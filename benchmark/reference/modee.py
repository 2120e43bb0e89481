"""Mode E in plain PyTorch and NumPy: the reference of
``pipeline.kmer_cluster -M E``.

From the raw files the job read (the ``.clust`` ids of the clustering
file, ``kmer_set.hex``, the FASTQs) and the counts the harness made, it
works out again:

* each cluster's two-sample pooled Student's t-test (``AB::WRS``: only
  clusters of more than ``size_thresh`` members; left tail ≤ p gives group
  2, else right tail ≤ p group 1), in float64 with a continued fraction of
  its own for the regularized incomplete beta function;
* given the verdicts under judgement, the differential keys of each group
  and the reads each sample's extraction must write: a read of at least
  k + 10 bases whose share of windows with a differential canonical k-mer
  exceeds ``kmer_vote``, non-ACGT bases read as A (``IOFQ::CheckRead``).

The numbers it gives:

``verdict_gap``  over the clusters whose verdict differs from the float64
    one, the widest distance, as |ln(tail / p)|, between p and the nearer
    of the cluster's two tails: a verdict that rounding alone can flip has
    a tail within rounding of p. 0 where none differs.
``read_faults``  records of the extracted FASTQs that differ from the
    records the verdicts call for, missing or extra; its limit is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.modec import counts_as_int

_SIGN = -(1 << 63)
BASE_TO_CODE = np.zeros(256, np.uint8)
for _code, _base in enumerate(b"CGT", 1):
    BASE_TO_CODE[_base] = _code


# --- the clustering file --------------------------------------------------

def read_clust(path: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``size\\tid\\t…\\n`` lines → (ids int64, offsets int64) on
    ``device``; raises where a size disagrees with its ids."""
    buf = torch.from_numpy(np.fromfile(path, np.uint8)).to(device)
    if len(buf) == 0:
        z = torch.zeros(1, dtype=torch.int64, device=device)
        return z[:0], z
    sep = (buf == 9) | (buf == 10)
    ends = torch.nonzero(sep).flatten()
    tok = torch.cumsum(sep.to(torch.int64), 0) - sep.to(torch.int64)
    pos = torch.arange(len(buf), device=device)
    power = (ends[tok.clamp(max=len(ends) - 1)] - pos - 1).clamp(min=0)
    digit = (buf.to(torch.int64) - 48).clamp(0, 9)
    ten = torch.tensor(10, dtype=torch.int64, device=device)
    part = torch.where(sep, 0, digit * ten.pow(power))
    vals = torch.zeros(len(ends), dtype=torch.int64, device=device)
    vals.index_add_(0, tok[~sep], part[~sep])
    newline = buf[ends] == 10
    first = torch.cat([newline.new_ones(1), newline[:-1]])
    sizes = vals[first]
    ids = vals[~first]
    per_line = torch.diff(torch.nonzero(first).flatten(),
                          append=torch.tensor([len(vals)], device=device)) - 1
    if not torch.equal(per_line, sizes):
        raise ValueError(f"{path}: a size does not match its ids")
    return ids, torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])


def read_hex_keys(path: str, device) -> torch.Tensor:
    """``kmer_set.hex`` (packed k-mers, little-endian) → each row's memcmp
    key, as int64 bits XOR 2^63 (signed order = the keys' order)."""
    keys = np.fromfile(path, ">u8").astype(np.uint64).view(np.int64)
    return torch.from_numpy(keys).to(device) ^ _SIGN


def centroids(counts: torch.Tensor, v: np.ndarray, ids: torch.Tensor,
              sizes: torch.Tensor) -> torch.Tensor:
    """f64 [clusters, S]: each cluster's mean over its members (``ids`` in
    clusters of ``sizes``) of log(count + 1) − v, from the counts uint16
    [S, M] and v [S] that the harness made."""
    cid = torch.repeat_interleave(
        torch.arange(len(sizes), device=ids.device), sizes)
    cents = torch.zeros((len(sizes), counts.shape[0]), dtype=torch.float64,
                        device=ids.device)
    for s in range(counts.shape[0]):
        row = torch.log1p(counts_as_int(counts[s])[ids].to(torch.float64))
        cents[:, s].index_add_(0, cid, row - float(v[s]))
    return cents / sizes[:, None].to(torch.float64)


# --- the t-test -----------------------------------------------------------

_FPMIN = 1e-300
_EPS = 1e-16


def _fraction(a, b, x, iters: int = 400):
    """The continued fraction of I_x(a, b) (modified Lentz), float64."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = 1.0 / torch.where(d.abs() < _FPMIN, _FPMIN, d)
    h = d.clone()
    for m in range(1, iters):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = 1.0 / torch.where(d.abs() < _FPMIN, _FPMIN, d)
            c = 1.0 + aa / c
            c = torch.where(c.abs() < _FPMIN, _FPMIN, c)
            delta = d * c
            h = h * delta
        if bool(((delta - 1.0).abs() < _EPS).all()):
            break
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), float64, 0 ≤ x ≤ 1."""
    xc = x.clamp(1e-300, 1.0 - 1e-16)
    lbt = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
           + a * torch.log(xc) + b * torch.log1p(-xc))
    bt = torch.exp(lbt)
    low = x < (a + 1.0) / (a + b + 2.0)
    front = bt * _fraction(a, b, xc) / a
    back = 1.0 - bt * _fraction(b, a, 1.0 - xc) / b
    out = torch.where(low, front, back)
    return torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, out))


def tails(values: torch.Tensor, n1: int, n2: int, dtype=torch.float64):
    """(left, right) tails of each row's pooled two-sample t statistic
    (values [N, ≥ n1 + n2], group A's columns first), float64. The means,
    sums of squares and the statistic are computed in ``dtype``; s = 0
    gives left = [x̄ ≥ ȳ], right = [x̄ ≤ ȳ]."""
    v = values.to(dtype)
    x, y = v[:, :n1], v[:, n1:n1 + n2]
    xm, ym = x.mean(1), y.mean(1)
    ss = ((x - xm[:, None]) ** 2).sum(1) + ((y - ym[:, None]) ** 2).sum(1)
    df = n1 + n2 - 2
    s = torch.sqrt(ss * (1.0 / n1 + 1.0 / n2) / max(df, 1))
    ok = (s > 0) & (df > 0)
    t = ((xm - ym) / torch.where(ok, s, 1.0)).to(torch.float64)
    dff = torch.full_like(t, float(df))
    ib = betainc(dff / 2.0, torch.full_like(t, 0.5), dff / (dff + t * t))
    left = torch.where(t >= 0, 1.0 - 0.5 * ib, 0.5 * ib)
    right = torch.where(t >= 0, 0.5 * ib, 1.0 - 0.5 * ib)
    ge, le = (xm >= ym).to(torch.float64), (xm <= ym).to(torch.float64)
    return torch.where(ok, left, ge), torch.where(ok, right, le)


def verdicts(left, right, sizes, pval: float, size_thresh: int):
    v = torch.where(left <= pval, 2, torch.where(right <= pval, 1, 0))
    return torch.where(sizes > size_thresh, v, 0).to(torch.int8)


def verdict_gap(got: torch.Tensor, left, right, sizes, pval: float,
                size_thresh: int) -> float:
    want = verdicts(left, right, sizes, pval, size_thresh)
    off = got.to(want.device) != want
    if not bool(off.any()):
        return 0.0
    near = torch.minimum((torch.log(left[off].clamp(min=1e-300)) - math.log(
        pval)).abs(), (torch.log(right[off].clamp(min=1e-300))
                       - math.log(pval)).abs())
    return float(near.max())


# --- the reads --------------------------------------------------------------

def parse_fastq(data: bytes):
    """Records of a FASTQ: (names, seqs, quals), lists of bytes; a name is
    the header's first word, as the reference's reader takes it."""
    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr == 10)
    if len(arr) and (len(nl) == 0 or nl[-1] != len(arr) - 1):
        nl = np.r_[nl, len(arr)]
    if len(nl) % 4:
        raise ValueError(f"{len(nl)} lines: not whole records")
    ls = np.r_[0, nl[:-1] + 1]
    names = [(data[ls[i] + 1:nl[i]].split() or [b""])[0]
             for i in range(0, len(nl), 4)]
    seqs = [data[ls[i]:nl[i]] for i in range(1, len(nl), 4)]
    quals = [data[ls[i]:nl[i]] for i in range(3, len(nl), 4)]
    return names, seqs, quals


def _key_shift(i: int) -> int:
    return 56 - 8 * (i // 4) + 2 * (i % 4)


def selected_reads(seqs: list[bytes], diff: torch.Tensor, k: int,
                   vote: float) -> np.ndarray:
    """bool [n]: the reads the extraction keeps against the sorted
    differential keys ``diff`` (int64, keys XOR 2^63)."""
    n = len(seqs)
    lens = np.array([len(s) for s in seqs], np.int64)
    if n == 0 or len(diff) == 0 or lens.max() < k:
        return np.zeros(n, bool)
    width = int(lens.max())
    codes = np.zeros((n, width), np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = BASE_TO_CODE[np.frombuffer(s, np.uint8)]
    c = torch.from_numpy(codes).to(diff.device).to(torch.int64)
    n_w = width - k + 1
    fwd = torch.zeros((n, n_w), dtype=torch.int64, device=diff.device)
    rev = torch.zeros_like(fwd)
    for i in range(k):
        fwd |= c[:, i:i + n_w] << _key_shift(i)
        rev |= (3 - c[:, k - 1 - i:k - 1 - i + n_w]) << _key_shift(i)
    key = torch.minimum(fwd ^ _SIGN, rev ^ _SIGN)
    at = torch.searchsorted(diff, key).clamp(max=len(diff) - 1)
    hit = diff[at] == key
    lens_t = torch.from_numpy(lens).to(diff.device)
    wins = (lens_t - k + 1).clamp(min=0)
    inside = torch.arange(n_w, device=diff.device)[None, :] < wins[:, None]
    hits = (hit & inside).sum(1).to(torch.float64)
    ratio = torch.where(wins > 0, hits / wins.clamp(min=1).to(torch.float64),
                        0.0)
    keep = (lens_t >= k + 10) & (lens_t > 0) & (ratio > vote)
    return keep.cpu().numpy()


def expected_fastq(data: bytes, diff: torch.Tensor, k: int,
                   vote: float) -> list[tuple]:
    names, seqs, quals = parse_fastq(data)
    keep = selected_reads(seqs, diff, k, vote)
    return [(names[i], seqs[i], quals[i]) for i in np.flatnonzero(keep)]


def record_faults(got: bytes, want: list[tuple]) -> int:
    """Records of ``got`` that differ from ``want`` position by position,
    and the records one has beyond the other."""
    try:
        g = list(zip(*parse_fastq(got)))
    except ValueError:
        return max(len(want), 1)
    return sum(a != b for a, b in zip(g, want)) + abs(len(g) - len(want))
