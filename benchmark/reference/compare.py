"""The numbers that decide whether a mode-C job's result is correct.

``layout``  exact: the program's clusters are a partition of the rows that
            pass the keep filter, each cluster's size is its member count,
            members ascend within a cluster, and clusters come in the order
            of their smallest member. The count of rows and clusters that
            break a rule; its limit is 0.
``centroid_gap``  the largest absolute difference between a centroid and
            the mean of its members' transformed profiles, computed here in
            float64 from the counts and v.
``row_gap``  the share of kept rows that the program places otherwise than
            the reference does: 1 − (rows in the best-matching pairs of
            clusters) / kept rows, taken from both sides, the larger.
``count_gap``  |clusters of the program − the reference's| / the
            reference's clusters.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.modec import counts_as_int


def as_device(result: dict, device) -> dict:
    """A result (numpy or tensors) with tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device) for k, v in result.items()}


def kept_rows(counts: torch.Tensor) -> torch.Tensor:
    c = counts_as_int(counts)
    return c.sum(0, dtype=torch.int32).to(torch.float32) > float(
        np.float32(0.1 * c.shape[0]))


def layout_faults(res: dict, kept: torch.Tensor) -> int:
    flat, offs, sizes = res["flat"].long(), res["offsets"].long(), res["sizes"]
    m = kept.shape[0]
    k = len(offs) - 1
    faults = int(((flat < 0) | (flat >= m)).sum())
    flat = flat.clamp(0, m - 1)
    seen = torch.bincount(flat, minlength=m)
    faults += int((seen != kept.long()).sum())
    lens = offs[1:] - offs[:-1]
    faults += int((lens <= 0).sum()) + abs(k - len(sizes)) + abs(
        k - res["cents"].shape[0])
    n = min(k, len(sizes))
    faults += int((sizes[:n].long() != lens[:n]).sum())
    if len(flat) > 1:
        cid = torch.repeat_interleave(torch.arange(k, device=flat.device),
                                      lens.clamp(min=0))
        same = cid[1:] == cid[:-1]
        faults += int((same & (flat[1:] <= flat[:-1])).sum())
        firsts = flat[offs[:-1].clamp(max=len(flat) - 1)]
        faults += int((firsts[1:] <= firsts[:-1]).sum())
    return faults


def centroid_gap(res: dict, counts: torch.Tensor, v: np.ndarray) -> float:
    flat, offs = res["flat"].long(), res["offsets"].long()
    k = len(offs) - 1
    if k == 0 or len(flat) != int(offs[-1]):
        return float("inf")
    lens = offs[1:] - offs[:-1]
    cid = torch.repeat_interleave(torch.arange(k, device=flat.device), lens)
    cents = res["cents"].to(torch.float64)
    gap = 0.0
    for s in range(counts.shape[0]):
        row = torch.log1p(counts_as_int(counts[s]).to(torch.float64)) \
            - float(np.float32(v[s]))
        sums = torch.zeros(k, dtype=torch.float64, device=flat.device)
        sums.index_add_(0, cid, row[flat])
        mean = sums / lens.to(torch.float64)
        gap = max(gap, float((cents[:, s] - mean).abs().max()))
    return gap


def _row_cluster(res: dict, m: int) -> torch.Tensor:
    """Cluster index of each row, −1 for a row in no cluster."""
    flat, offs = res["flat"].long(), res["offsets"].long()
    lens = offs[1:] - offs[:-1]
    cid = torch.repeat_interleave(torch.arange(len(lens), device=flat.device),
                                  lens.clamp(min=0))
    out = torch.full((m,), -1, dtype=torch.int64, device=flat.device)
    ok = (flat >= 0) & (flat < m)
    out[flat[ok]] = cid[:len(flat)][ok]
    return out


def row_gap(res: dict, ref: dict, kept: torch.Tensor) -> float:
    m = kept.shape[0]
    p, r = _row_cluster(res, m), _row_cluster(ref, m)
    both = (p >= 0) & (r >= 0)
    kr = len(ref["offsets"])
    pairs, n = torch.unique(p[both] * kr + r[both], return_counts=True)
    pp, rr = pairs // kr, pairs % kr
    best_p = torch.zeros(int(p.max()) + 1 if len(p) else 1,
                         dtype=torch.int64, device=p.device)
    best_p.scatter_reduce_(0, pp, n, "amax")
    best_r = torch.zeros(kr, dtype=torch.int64, device=p.device)
    best_r.scatter_reduce_(0, rr, n, "amax")
    n_kept = max(int(kept.sum()), 1)
    return 1.0 - min(int(best_p.sum()), int(best_r.sum())) / n_kept


def numbers(res: dict, ref: dict, counts: torch.Tensor,
            v: np.ndarray) -> dict[str, float]:
    """The four numbers of ``res`` (the program's result, or the control's)
    against ``ref`` (the float32 reference's)."""
    kept = kept_rows(counts)
    kp, kr = len(res["offsets"]) - 1, len(ref["offsets"]) - 1
    return dict(layout=layout_faults(res, kept),
                centroid_gap=centroid_gap(res, counts, v),
                row_gap=row_gap(res, ref, kept),
                count_gap=abs(kp - kr) / max(kr, 1))
