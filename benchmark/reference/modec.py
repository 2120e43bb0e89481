"""One mode-C session in plain PyTorch: the reference of
``engine.cluster_counts`` with the chain merge.

A frozen copy of the port's plain path: ``ops/transform.py``
``abundance_transform_t``, ``ops/lsh.py`` ``project``, ``signatures_t`` and
``combined_sort_key``, ``kernels/__init__.py`` ``chain_collapse_plain``
(with ``_seg_scan`` and ``_rev_fill``) and ``finalize_plain``,
``cluster/engine.py`` ``_drive_session``, ``compact_sort`` and ``_pull``;
a stable ``torch.sort`` in place of each ``sort_keys``. Two departures that
change no number: the projection runs only on the planes the key uses,
and a shift writes into one new tensor instead of concatenating.

``dtype`` is the precision of every value the session computes (the
profiles, projections, cosines, sums and means): float32 as the program
states, or a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import rng

BIG_KEY = 2**31 - 1
MAX_CHAIN_LOG = 15   # chains are cut at positions that are multiples of 2^15


def counts_as_int(counts: torch.Tensor) -> torch.Tensor:
    """uint16 [S, M] → int32 of the same values."""
    return counts.view(torch.int16).to(torch.int32) & 0xFFFF


def transform(counts: torch.Tensor, v: torch.Tensor, dtype):
    """(values [S, M] in ``dtype``, sizes int32 [M]): log(count + 1) − v,
    and 1 where the column's count sum exceeds 0.1 · S."""
    c = counts_as_int(counts)
    values = (torch.log1p(c.to(torch.float32)) - v[:, None]).to(dtype)
    total = c.sum(0, dtype=torch.int32)
    keep = total.to(torch.float32) > float(np.float32(0.1 * c.shape[0]))
    return values, keep.to(torch.int32)


def free_bits(h: int) -> int:
    return min(max(30 - h, 0), 29)


def combined_key(values, sizes, planes, h: int) -> torch.Tensor:
    """The iteration's int32 sort key: the h sign bits of the first planes
    (plane 0 on top, a projection of 0 gives 1) above the projection on
    plane H_MAX quantized into 2^(30 − h) levels over the alive columns'
    range; BIG_KEY for dead columns. Projections summed over samples in
    order, a rounded multiply and a rounded add a term."""
    used = list(range(h)) + [rng.H_MAX]
    p_planes = planes[:, used].to(values.dtype)
    proj = torch.zeros((len(used), values.shape[1]), dtype=values.dtype,
                       device=values.device)
    for s in range(values.shape[0]):
        proj = proj + p_planes[s][:, None] * values[s][None, :]
    keys = torch.zeros(values.shape[1], dtype=torch.int32,
                       device=values.device)
    for j in range(h):
        keys = keys | ((proj[j] >= 0).to(torch.int32) << (h - 1 - j))
    second = proj[-1]
    alive = sizes > 0
    keys = torch.where(alive, keys, BIG_KEY)
    free = free_bits(h)
    levels = 1 << free
    inf = torch.tensor(float("inf"), dtype=second.dtype, device=second.device)
    pmin = torch.where(alive, second, inf).min()
    pmax = torch.where(alive, second, -inf).max()
    span = torch.clamp(pmax - pmin, min=1e-20)
    scaled = (second - pmin) / span * float(levels)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=0.0, neginf=0.0)
    q = torch.clamp(scaled.to(torch.int32), 0, levels - 1)
    return torch.where(keys == BIG_KEY, BIG_KEY, (keys << free) | q)


def _shift(x: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """out[..., i] = x[..., i − d], ``fill`` where i < d."""
    out = torch.empty_like(x)
    out[..., :d] = fill
    out[..., d:] = x[..., :x.shape[-1] - d]
    return out


def _levels(m: int) -> int:
    return min(MAX_CHAIN_LOG, max(m - 1, 1).bit_length())


def _seg_scan(head, w, wv, slots, m: int):
    """Hillis–Steele segmented scan: inclusive within-chain sums of w and
    wv, and the head's slot filled forward."""
    f, W, fill, d = head, w, slots, 1
    for _ in range(_levels(m)):
        keep = ~f
        W = W + torch.where(keep, _shift(W, d), 0)
        wv = wv + torch.where(keep[None, :], _shift(wv, d), 0.0)
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return W, wv, fill


def _rev_fill(last, slots, m: int):
    """Every position gets the slot of its chain's last member."""
    f, fill, d = last.flip(0), slots.flip(0), 1
    for _ in range(_levels(m)):
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return fill.flip(0)


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev


def chain_collapse(svals, ssizes, sslots, skey, threshold: float, h: int,
                   parent):
    """Collapse every chain of the sorted state: neighbours in one bucket
    whose cosine reaches ``threshold`` link; each chain's last position
    takes the chain's size-weighted mean and its head's slot, the others
    die and their slots point at the head's in ``parent``."""
    dt = svals.dtype
    m = svals.shape[1]
    starts = segment_starts(skey >> free_bits(h))
    alive = (ssizes > 0) & (skey != BIG_KEY)
    prev = _shift(svals, 1)
    dot = torch.zeros(m, dtype=dt, device=svals.device)
    na = torch.zeros_like(dot)
    nb = torch.zeros_like(dot)
    for i in range(svals.shape[0]):
        dot = dot + svals[i] * prev[i]
        na = na + svals[i] * svals[i]
        nb = nb + prev[i] * prev[i]
    del prev
    nn = torch.sqrt(na * nb)
    sim = dot / torch.where(nn > 0, nn, 1.0)
    pos = torch.arange(m, device=svals.device)
    uncut = (pos & ((1 << MAX_CHAIN_LOG) - 1)) != 0
    link = (alive & _shift(alive, 1, False) & ~starts & uncut
            & (sim >= threshold))
    head = alive & ~link
    is_last = alive & ~torch.cat([link[1:], link.new_zeros(1)])
    W, WV, head_slots = _seg_scan(head, ssizes,
                                  svals * ssizes.to(dt)[None, :], sslots, m)
    denom = torch.clamp(W, min=1).to(dt)
    new_vals = torch.where(is_last[None, :], WV / denom[None, :], svals)
    del WV
    new_size = torch.where(is_last, W, torch.where(alive, 0, ssizes))
    last_slots = _rev_fill(is_last, sslots, m)
    new_slots = torch.where(is_last, head_slots,
                            torch.where(head, last_slots, sslots))
    dying = alive & ~is_last
    parent[new_slots[dying].long()] = head_slots[dying]
    return new_vals, new_size, new_slots


def finalize(values, sizes, slots, parent):
    """Group the rows by the root of the merge forest: (flat int64 [cap0]:
    members, clusters by smallest member, members ascending; lens, sizes
    [fc] and centroids [S, fc] in that cluster order)."""
    cap0 = parent.shape[0]
    dev = parent.device
    roots = parent.long()
    while True:
        nxt = roots[roots]
        if torch.equal(nxt, roots):
            break
        roots = nxt
    alive_of_slot = torch.zeros(cap0 + 1, dtype=torch.bool, device=dev)
    alive_of_slot[slots[sizes > 0].long()] = True
    key = torch.where(alive_of_slot[roots], roots, cap0)
    rows = torch.arange(cap0, device=dev)
    first = torch.full((cap0 + 1,), cap0, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, key, rows, "amin")
    count = torch.bincount(key, minlength=cap0 + 1)
    member_key = torch.where(key == cap0, cap0, first[key])
    flat = torch.sort(member_key, stable=True)[1]
    cluster_key = torch.where(sizes > 0, first[slots.long()], cap0)
    order = torch.sort(cluster_key, stable=True)[1]
    alive = sizes[order] > 0
    lens = torch.where(alive, count[slots[order].long()], 0)
    csizes = torch.where(alive, sizes[order], 0)
    cents = torch.where(alive[None, :], values[:, order], 0.0)
    return flat, lens, csizes, cents


def session(counts: torch.Tensor, v: np.ndarray, thresholds, seed: int,
            dtype=torch.float32) -> dict:
    """The session's result on the counts' device: ``cents`` [K, S]
    (float32), ``sizes`` [K], ``flat`` and ``offsets`` (cluster k's
    members are flat[offsets[k]:offsets[k + 1]])."""
    dev = counts.device
    S, cap0 = counts.shape
    vt = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    values, sizes = transform(counts, vt, dtype)
    slots = torch.arange(cap0, dtype=torch.int32, device=dev)
    parent = torch.arange(cap0, dtype=torch.int32, device=dev)
    na = int((sizes > 0).sum())
    for it, threshold in enumerate(np.asarray(thresholds, np.float32)):
        if na == 0:
            break
        h = rng.active_h(na)
        planes = rng.draw_hyperplanes(seed, it, S).to(dev)
        key = combined_key(values, sizes, planes, h)
        skey, order = torch.sort(key, stable=True)
        values, sizes, slots = chain_collapse(
            values[:, order], sizes[order], slots[order], skey,
            float(threshold), h, parent)
        na_next = int((sizes > 0).sum())
        values, sizes, slots = values[:, :na], sizes[:na], slots[:na]
        na = na_next
    order = torch.sort((sizes == 0).to(torch.int32), stable=True)[1]
    values, sizes, slots = values[:, order], sizes[order], slots[order]
    flat, lens, csizes, cents = finalize(values[:, :na].contiguous(),
                                         sizes[:na], slots[:na], parent)
    offsets = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    return dict(cents=cents.T.to(torch.float32), sizes=csizes.to(torch.int64),
                flat=flat[:int(offsets[-1])], offsets=offsets)
