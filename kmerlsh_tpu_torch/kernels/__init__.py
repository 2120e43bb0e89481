"""The engine's hand-written CUDA kernels, each beside its plain PyTorch
version.

A wrapper takes the plain version for tensors on the CPU. For tensors on a
CUDA device it launches its kernel (built from ``kmerlsh_tpu_torch/csrc`` at
first use, see :mod:`.build`) or raises; it never falls back. ``launches``
counts the kernel launches of each wrapper, so that a run can show that its
main path went through the kernels.

| wrapper              | source                 | replaces (kmerlsh_tpu/)                   |
| -------------------- | ---------------------- | ----------------------------------------- |
| abundance_transform  | csrc/lsh_keys.cu       | ops/transform.py abundance_transform_t    |
| lsh_keys             | csrc/lsh_keys.cu       | ops/lsh.py signatures_t + engine.py       |
|                      |                        | _combined_sort_key                        |
| permute_state        | csrc/permute_state.cu  | engine.py _sort_state / compact_sort      |
|                      |                        | payloads                                  |
| chain_collapse       | csrc/chain_collapse.cu | engine.py chain_collapse + parent fold    |
| finalize             | csrc/finalize.cu       | engine.py _finalize_grouped               |
| wrs_verdicts         | csrc/ttest.cu          | ops/ttest.py t_cdf, studentttest2,        |
|                      |                        | wrs_verdicts                              |
| score_reads          | csrc/reads.cu          | ops/reads.py _device_score_kernel         |
"""

from __future__ import annotations

import torch

from kmerlsh_tpu_torch.ops import lsh, transform, ttest
from kmerlsh_tpu_torch.ops.lsh import BIG_KEY
from kmerlsh_tpu_torch.ops.segment import segment_starts

MAX_CHAIN_LOG = 15   # chains are cut at positions that are multiples of 2^15

launches: dict[str, int] = {
    "abundance_transform": 0, "lsh_keys": 0, "permute_state": 0,
    "chain_collapse": 0, "finalize": 0, "wrs_verdicts": 0, "score_reads": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def free_bits(h: int) -> int:
    """Low key bits left for the secondary projection at h bucket bits."""
    return min(max(30 - h, 0), 29)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _check(t: torch.Tensor, dtype: torch.dtype, name: str,
           ndim: int = 1) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.stride(-1) != 1 or (ndim == 1 and not t.is_contiguous()):
        raise ValueError(f"{name}: the last axis must be contiguous")


def _launch(fn, *args) -> None:
    from kmerlsh_tpu_torch.kernels.build import load

    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# --- K1: abundance transform ----------------------------------------------

def abundance_transform_plain(counts: torch.Tensor, v_kmers: torch.Tensor):
    values_t, keep = transform.abundance_transform_t(counts, v_kmers)
    return values_t, keep.to(torch.int32)


def abundance_transform(counts: torch.Tensor, v_kmers: torch.Tensor):
    """uint16 counts [S, M] → (values f32 [S, M], sizes int32 [M], 1 where
    the column passes the keep filter)."""
    if not _on_cuda(counts, v_kmers):
        return abundance_transform_plain(counts, v_kmers)
    _check(counts, torch.uint16, "counts", 2)
    _check(v_kmers, torch.float32, "v_kmers")
    counts = counts.contiguous()
    S, M = counts.shape
    values = torch.empty((S, M), dtype=torch.float32, device=counts.device)
    sizes = torch.empty(M, dtype=torch.int32, device=counts.device)
    if M:
        _launch("kl_transform", counts.data_ptr(), v_kmers.data_ptr(), S, M,
                transform.keep_threshold(S), values.data_ptr(),
                sizes.data_ptr())
        launches["abundance_transform"] += 1
    return values, sizes


# --- K1: LSH keys -----------------------------------------------------------

def lsh_keys_plain(values_t, sizes, hyperplanes, h: int):
    keys, proj = lsh.signatures_t(values_t, hyperplanes, h)
    keys = torch.where(sizes > 0, keys, BIG_KEY)
    return lsh.combined_sort_key(keys, proj, sizes, h), proj


def lsh_keys(values_t: torch.Tensor, sizes: torch.Tensor,
             hyperplanes: torch.Tensor, h: int):
    """values f32 [S, M] (rows may be strided), sizes int32 [M], planes f32
    [S, H_MAX + 1], 1 ≤ h ≤ H_MAX → (combined sort key int32 [M] with dead
    columns at BIG_KEY, secondary projection f32 [M])."""
    if not _on_cuda(values_t, sizes, hyperplanes):
        return lsh_keys_plain(values_t, sizes, hyperplanes, h)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    planes = hyperplanes.to(torch.float32).contiguous()
    S, M = values_t.shape
    if planes.shape != (S, lsh.H_MAX + 1):
        raise ValueError(f"hyperplanes: want {(S, lsh.H_MAX + 1)}, got "
                         f"{tuple(planes.shape)}")
    if not 1 <= h <= lsh.H_MAX:
        raise ValueError(f"h = {h} outside [1, {lsh.H_MAX}]")
    keys = torch.empty(M, dtype=torch.int32, device=values_t.device)
    proj = torch.empty(M, dtype=torch.float32, device=values_t.device)
    minmax = torch.empty(2, dtype=torch.int32, device=values_t.device)
    if M:
        _launch("kl_lsh_keys", values_t.data_ptr(), values_t.stride(0), S, M,
                planes.data_ptr(), sizes.data_ptr(), h, free_bits(h),
                keys.data_ptr(), proj.data_ptr(), minmax.data_ptr())
        launches["lsh_keys"] += 1
    return keys, proj


# --- K2: permute ------------------------------------------------------------

def permute_state_plain(values_t, sizes, slots, order):
    return values_t[:, order], sizes[order], slots[order]


def permute_state(values_t: torch.Tensor, sizes: torch.Tensor,
                  slots: torch.Tensor, order: torch.Tensor):
    """Move the state by a permutation: column i of the output is column
    order[i] of the input (values f32 [S, M], rows may be strided)."""
    if not _on_cuda(values_t, sizes, slots, order):
        return permute_state_plain(values_t, sizes, slots, order)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    _check(slots, torch.int32, "slots")
    _check(order, torch.int64, "order")
    S, M = values_t.shape
    out = torch.empty((S, M), dtype=torch.float32, device=values_t.device)
    osizes = torch.empty_like(sizes)
    oslots = torch.empty_like(slots)
    if M:
        _launch("kl_permute_state", values_t.data_ptr(), values_t.stride(0),
                S, M, order.data_ptr(), sizes.data_ptr(), slots.data_ptr(),
                out.data_ptr(), osizes.data_ptr(), oslots.data_ptr())
        launches["permute_state"] += 1
    return out, osizes, oslots


# --- K3 + K4: chain collapse and parent fold ----------------------------------

def _shift(x: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """out[i] = x[i - d] along the last axis, ``fill`` where i < d."""
    pad = torch.full((*x.shape[:-1], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - d]], dim=-1)


def _scan_levels(m: int) -> int:
    return min(MAX_CHAIN_LOG, max(m - 1, 1).bit_length())


def _seg_scan(head, w, wv, scs, m: int):
    """Hillis–Steele segmented scan, the reference's order: inclusive
    within-chain sums of w and wv, and the head's slot filled forward."""
    f, W, fill, d = head, w, scs, 1
    for _ in range(_scan_levels(m)):
        keep = ~f
        W = W + torch.where(keep, _shift(W, d), 0)
        wv = wv + torch.where(keep[None, :], _shift(wv, d), 0.0)
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return W, wv, fill


def _rev_fill(last, scs, m: int):
    """Every position gets the slot of its chain's last member."""
    f, fill, d = last.flip(0), scs.flip(0), 1
    for _ in range(_scan_levels(m)):
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return fill.flip(0)


def chain_collapse_plain(svals, ssizes, sslots, skey, threshold: float,
                         h: int, smi=None, parent=None):
    s, m = svals.shape
    starts = segment_starts(skey >> free_bits(h))
    alive = (ssizes > 0) & (skey != BIG_KEY)
    prev = _shift(svals, 1)
    dot = torch.zeros(m, dtype=torch.float32, device=svals.device)
    na = torch.zeros_like(dot)
    nb = torch.zeros_like(dot)
    for i in range(s):
        dot = dot + svals[i] * prev[i]
        na = na + svals[i] * svals[i]
        nb = nb + prev[i] * prev[i]
    nn = torch.sqrt(na * nb)
    sim = dot / torch.where(nn > 0, nn, 1.0)
    pos = torch.arange(m, device=svals.device)
    uncut = (pos & ((1 << MAX_CHAIN_LOG) - 1)) != 0
    link = (alive & _shift(alive, 1, False) & ~starts & uncut
            & (sim >= threshold))
    head = alive & ~link
    is_last = alive & ~torch.cat([link[1:], link.new_zeros(1)])
    W, WV, head_scs = _seg_scan(
        head, ssizes, svals * ssizes.to(torch.float32)[None, :], sslots, m)
    denom = torch.clamp(W, min=1).to(torch.float32)
    new_vt = torch.where(is_last[None, :], WV / denom[None, :], svals)
    new_size = torch.where(is_last, W, torch.where(alive, 0, ssizes))
    last_scs = _rev_fill(is_last, sslots, m)
    new_scs = torch.where(is_last, head_scs,
                          torch.where(head, last_scs, sslots))
    dying = alive & ~is_last
    mi_in = smi if smi is not None else torch.full_like(sslots, -1)
    new_mi = torch.where(dying, head_scs, mi_in)
    if parent is not None:
        parent[new_scs[dying].long()] = head_scs[dying]
    return new_vt, new_size, new_scs, new_mi


def chain_collapse(svals: torch.Tensor, ssizes: torch.Tensor,
                   sslots: torch.Tensor, skey: torch.Tensor,
                   threshold: float, h: int,
                   smi: torch.Tensor | None = None,
                   parent: torch.Tensor | None = None):
    """Collapse every chain of the sorted state (values f32 [S, M]
    contiguous; sizes, slots, combined keys int32 [M]; optional
    merged_into int32 [M]). Returns (values, sizes, slots, merged_into) in
    the same positions; when ``parent`` (int32 [cap0]) is given, each dying
    slot's parent is set to its chain head's slot in place."""
    if not _on_cuda(svals, ssizes, sslots, skey, smi, parent):
        return chain_collapse_plain(svals, ssizes, sslots, skey, threshold,
                                    h, smi, parent)
    _check(svals, torch.float32, "svals", 2)
    if not svals.is_contiguous():
        raise ValueError("svals must be contiguous")
    for name, t in (("ssizes", ssizes), ("sslots", sslots), ("skey", skey),
                    ("smi", smi), ("parent", parent)):
        if t is not None:
            _check(t, torch.int32, name)
    S, M = svals.shape
    out_v = torch.empty_like(svals)
    out_size = torch.empty_like(ssizes)
    out_slot = torch.empty_like(sslots)
    out_mi = torch.empty_like(sslots)
    if M:
        _launch("kl_chain_collapse", svals.data_ptr(), S, M,
                ssizes.data_ptr(), sslots.data_ptr(), skey.data_ptr(),
                _ptr(smi), float(threshold), free_bits(h), out_v.data_ptr(),
                out_size.data_ptr(), out_slot.data_ptr(), out_mi.data_ptr(),
                _ptr(parent))
        launches["chain_collapse"] += 1
    return out_v, out_size, out_slot, out_mi


# --- K5: finalize -------------------------------------------------------------

def finalize_plain(values_t, sizes, slots, parent):
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
    flat = torch.sort(member_key, stable=True).indices.to(torch.int32)
    cluster_key = torch.where(sizes > 0, first[slots.long()], cap0)
    order = torch.sort(cluster_key, stable=True).indices
    alive = sizes[order] > 0
    lens = torch.where(alive, count[slots[order].long()], 0).to(torch.int32)
    csizes = torch.where(alive, sizes[order], 0).to(torch.int32)
    cents = torch.where(alive[None, :], values_t[:, order], 0.0)
    return flat, lens, csizes, cents


def finalize(values_t: torch.Tensor, sizes: torch.Tensor,
             slots: torch.Tensor, parent: torch.Tensor):
    """Group rows by the root of their merge forest.

    State columns (values f32 [S, fc], sizes, slots int32 [fc]) and the
    parent forest (int32 [cap0]) → (flat int32 [cap0]: member rows, clusters
    by smallest member, members ascending, rows of dead roots last;
    lens, sizes int32 [fc] and centroids f32 [S, fc] in the same cluster
    order; entries past the alive count are 0)."""
    if not _on_cuda(values_t, sizes, slots, parent):
        return finalize_plain(values_t, sizes, slots, parent)
    _check(values_t, torch.float32, "values_t", 2)
    if not values_t.is_contiguous():
        raise ValueError("values_t must be contiguous")
    for name, t in (("sizes", sizes), ("slots", slots), ("parent", parent)):
        _check(t, torch.int32, name)
    S, fc = values_t.shape
    cap0 = parent.shape[0]
    dev = parent.device
    i32 = dict(dtype=torch.int32, device=dev)
    alive_of_slot = torch.zeros(cap0, **i32)
    root_key = torch.empty(cap0, **i32)
    first = torch.full((cap0,), cap0, **i32)
    count = torch.zeros(cap0, **i32)
    member_key = torch.empty(cap0, **i32)
    cluster_key = torch.empty(fc, **i32)
    lens = torch.empty(fc, **i32)
    csizes = torch.empty(fc, **i32)
    cents = torch.empty((S, fc), dtype=torch.float32, device=dev)
    if cap0 == 0:
        return torch.empty(0, **i32), lens, csizes, cents
    _launch("kl_finalize_keys", cap0, fc, sizes.data_ptr(), slots.data_ptr(),
            parent.data_ptr(), alive_of_slot.data_ptr(), root_key.data_ptr(),
            first.data_ptr(), count.data_ptr(), member_key.data_ptr(),
            cluster_key.data_ptr())
    flat = torch.sort(member_key, stable=True).indices.to(torch.int32)
    order = torch.sort(cluster_key, stable=True).indices
    if fc:
        _launch("kl_finalize_gather", fc, S, order.data_ptr(),
                sizes.data_ptr(), slots.data_ptr(), count.data_ptr(),
                values_t.data_ptr(), lens.data_ptr(), csizes.data_ptr(),
                cents.data_ptr())
    launches["finalize"] += 1
    return flat, lens, csizes, cents


# --- K6: t-test and WRS verdicts ----------------------------------------------

def wrs_verdicts_plain(values, sizes, n1: int, n2: int, pval_thresh: float,
                       size_thresh: int):
    _, left, right = ttest.studentttest2(values, n1, n2)
    verdict = ttest.verdicts_of(left, right, sizes, pval_thresh, size_thresh)
    return verdict, left, right


def wrs_verdicts(values: torch.Tensor, sizes: torch.Tensor, n1: int, n2: int,
                 pval_thresh: float, size_thresh: int):
    """Cluster rows (values f32 [N, ≥ n1+n2], group A columns first, each
    row contiguous; sizes int32 [N]) → (verdict int8 [N]: 2 where the left
    tail ≤ p, else 1 where the right tail ≤ p, else 0, and 0 for sizes ≤
    size_thresh; left and right tails f32 [N])."""
    if not _on_cuda(values, sizes):
        return wrs_verdicts_plain(values, sizes, n1, n2, pval_thresh,
                                  size_thresh)
    _check(values, torch.float32, "values", 2)
    _check(sizes, torch.int32, "sizes")
    N, S = values.shape
    if n1 < 1 or n2 < 1 or n1 + n2 > S or sizes.shape[0] != N:
        raise ValueError(f"n1 = {n1}, n2 = {n2} for values {tuple(values.shape)}"
                         f" and sizes {tuple(sizes.shape)}")
    dev = values.device
    verdict = torch.empty(N, dtype=torch.int8, device=dev)
    left = torch.empty(N, dtype=torch.float32, device=dev)
    right = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        _launch("kl_wrs_verdicts", values.data_ptr(), values.stride(0), N, n1,
                n2, sizes.data_ptr(), 1.0 / n1 + 1.0 / n2, float(pval_thresh),
                min(int(size_thresh), 2**31 - 1), verdict.data_ptr(),
                left.data_ptr(), right.data_ptr())
        launches["wrs_verdicts"] += 1
    return verdict, left, right


# --- K7: read scorer ------------------------------------------------------------

_SIGN = torch.iinfo(torch.int64).min   # flips the top bit: unsigned order


def _bswap64(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    for i in range(8):
        out |= ((v >> (8 * i)) & 0xFF) << (8 * (7 - i))
    return out


def _reverse_bases64(v: torch.Tensor) -> torch.Tensor:
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    v = ((v >> 2) & m2) | ((v & m2) << 2)
    v = ((v >> 4) & m4) | ((v & m4) << 4)
    return _bswap64(v)


def score_reads_plain(codes, win_start, n_win, lens, keys, k: int,
                      vote: float):
    """The sliding k-mers of the flat code array, their canonical keys with
    the top bit flipped (int64 order is then unsigned order), a lower-bound
    ``searchsorted`` in the flipped keys and per-read hit counts as
    cumulative-sum differences."""
    dev = codes.device
    nw = max(codes.shape[0] - (k - 1), 0)
    c = codes.to(torch.int64)
    x = torch.zeros(nw, dtype=torch.int64, device=dev)
    for j in range(k):
        x |= c[j:j + nw] << (2 * j)
    # revcomp = reverse_bases64(~x) >> (64 − 2k), a logical shift
    rc = (_reverse_bases64(~x) >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)
    q = torch.minimum(_bswap64(x) ^ _SIGN, _bswap64(rc) ^ _SIGN)
    skeys = keys ^ _SIGN
    D = skeys.shape[0]
    if D:
        idx = torch.searchsorted(skeys, q)
        hit = (idx < D) & (skeys[idx.clamp(max=D - 1)] == q)
    else:
        hit = torch.zeros(nw, dtype=torch.bool, device=dev)
    chit = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(hit.to(torch.int64), 0)])
    ws = win_start.to(torch.int64)
    counts = (chit[(ws + n_win).clamp(0, nw)] - chit[ws.clamp(0, nw)])
    denom = torch.clamp(lens - (k - 1), min=1).to(torch.float32)
    ratio = counts.to(torch.float32) / denom
    v = torch.tensor(vote, dtype=torch.float32, device=dev)
    return (lens >= k + 10) & (n_win > 0) & (ratio > v)


def score_reads(codes: torch.Tensor, win_start: torch.Tensor,
                n_win: torch.Tensor, lens: torch.Tensor, keys: torch.Tensor,
                k: int, vote: float) -> torch.Tensor:
    """Score the reads of one part (``ops.reads.pack_part``): codes uint8
    [L], the reads' first windows, window counts and lengths int32 [n],
    and the differential keys as int64 [D] holding unsigned 64-bit keys in
    unsigned ascending order → bool [n], selected reads. Every read's
    windows must lie inside ``codes``: win_start + n_win + k − 1 ≤ L."""
    if not _on_cuda(codes, win_start, n_win, lens, keys):
        return score_reads_plain(codes, win_start, n_win, lens, keys, k, vote)
    _check(codes, torch.uint8, "codes")
    for name, t in (("win_start", win_start), ("n_win", n_win),
                    ("lens", lens)):
        _check(t, torch.int32, name)
    _check(keys, torch.int64, "keys")
    n = lens.shape[0]
    if win_start.shape[0] != n or n_win.shape[0] != n:
        raise ValueError("win_start, n_win and lens differ in length")
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k} outside [1, 31]")
    out = torch.empty(n, dtype=torch.uint8, device=codes.device)
    if n:
        _launch("kl_score_reads", codes.data_ptr(), win_start.data_ptr(),
                n_win.data_ptr(), lens.data_ptr(), n, keys.data_ptr(),
                keys.shape[0], k, float(vote), out.data_ptr())
        launches["score_reads"] += 1
    return out.view(torch.bool)
