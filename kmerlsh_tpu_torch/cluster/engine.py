"""LSH clustering engine on PyTorch tensors (port of
kmerlsh_tpu/cluster/engine.py).

A session keeps the cluster profiles sample-major (values f32 [S, M]) with
sizes and stable slot ids (int32 [M]) and a parent forest over the input
rows (int32 [cap0]). Each iteration, run eagerly one at a time:

  1. ``lsh_keys`` kernel: projections on the iteration's hyperplanes, the h
     bucket bits and the secondary projection quantized into one int32 key;
  2. the ``sort_keys`` kernel's stable sort of the key, and the
     ``permute_state`` kernel moving the state into sorted order;
  3. ``chain_collapse`` kernel: neighbour chains collapse onto their last
     position; the dying slots are folded into the parent forest in place.
     With ``merge="pairing"`` the ``pairing_rounds`` kernel runs R rounds
     of adjacent rank pairs within each bucket instead (the reference keeps
     it for comparison); with ``deep_init`` the first iteration is still a
     chain collapse.

After every iteration the host reads one int, the alive count: the sort put
every dead column behind the alive ones, so the next iteration runs on the
first ``n_alive_before`` columns only (a view, no copy). Merge decisions do
not depend on capacity (the quantization range is taken over alive rows
only), so the result is the same at any capacity. Once per session the
``finalize`` kernel groups the rows by root.

State is float32 throughout. The reference's TPU workarounds are not
carried over: f16 sort payloads, f16 pulls, scanned chunk programs and
buffer donation. Its hyperplanes are reproduced bit for bit up to a few
ulp (:mod:`kmerlsh_tpu_torch.ops.rng`); a ``hyperplanes`` hook takes
planes from elsewhere (``it → [S, 31]``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster.groups import Groups
from kmerlsh_tpu_torch.ops import lsh, rng, xlamath
from kmerlsh_tpu_torch.utils.timing import span

# wall-clock split of the most recent cluster_counts/cluster session, each
# part a timing.span (traced as kmerlsh.<span>):
#   device_seconds — the transform, iterations and finalize, dispatch to the
#                    host's read of their result (spans transform, iter,
#                    finalize)
#   pull_seconds   — device→host copies of the finalize result (span
#                    pull.copy; a deferred pull's go to its own stats instead)
#   pull_bytes     — their size;  programs — (name, seconds) per step;
#   clusters       — the session's cluster count
LAST_SESSION: dict = {}

Hyperplanes = Callable[[int], "np.ndarray | torch.Tensor"]


def _active_h_of(n_alive: int) -> int:
    """h = floor(log2(float32(max(n_alive, 2)))) clipped to [1, H_MAX],
    with the reference's float32 log2."""
    x = torch.tensor([float(max(n_alive, 2))], dtype=torch.float32)
    h = int(torch.floor(xlamath.log2(x)).item())
    return min(max(h, 1), lsh.H_MAX)


def _active_h(sizes: torch.Tensor) -> int:
    return _active_h_of(int((sizes > 0).sum()))


def chain_collapse(values_t, sizes, keys, proj, threshold: float,
                   merged_into=None, cur_slot=None, h: int | None = None,
                   parent=None):
    """Sort the state by the combined key of (keys, proj) and collapse every
    chain. Same contract as the reference: returns (values_t, sizes,
    merged_into, cur_slot) in sorted position order."""
    m = values_t.shape[1]
    if cur_slot is None:
        cur_slot = torch.arange(m, dtype=torch.int32, device=values_t.device)
    combined = lsh.combined_sort_key(keys, proj, sizes, h)
    skey, order = kernels.sort_keys(combined, lsh.KEY_BITS)
    svt, ssize, scs = kernels.permute_state(values_t, sizes, cur_slot, order)
    smi = None if merged_into is None else merged_into[order]
    new_vt, new_size, new_scs, new_mi = kernels.chain_collapse(
        svt, ssize, scs, skey, threshold, h, smi, parent)
    return new_vt, new_size, new_mi, new_scs


def _float_order(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) with the order of ``jax.lax.sort`` on float32:
    zeros of either sign and subnormals (which XLA flushes) equal 0.0, and
    every NaN equals the others and sorts last."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    tiny = torch.finfo(torch.float32).tiny
    b = torch.where(x.abs() < tiny, 0,
                    torch.where(torch.isnan(x), 0x7FC00000, b))
    return torch.where(b < 0, -1 - b, b + 2**31)


def _lex_order(keys: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The reference's ``jnp.lexsort((proj, keys))`` (keys first, then proj,
    ties in input order) as four stable 16-bit ``sort_keys`` passes, least
    significant first: int32 order [M]."""
    words = (_float_order(proj), keys.to(torch.int64) + 2**31)
    order = None
    for word in words:
        for shift in (0, 16):
            digit = ((word >> shift) & 0xFFFF).to(torch.int32)
            if order is not None:
                digit = digit[order]
            step = kernels.sort_keys(digit, 16)[1]
            order = step if order is None else order[step]
    return order


def pairing_merge(values_t, sizes, keys, proj, threshold: float,
                  rounds: int, merged_into=None, h: int | None = None,
                  cur_slot=None, unsort: bool = True, parent=None):
    """R pairing-merge rounds over key segments, the reference's contract
    (kmerlsh_tpu/cluster/engine.py:pairing_merge): keys int32 [M] bucket
    keys (BIG_KEY for dead slots), proj f32 [M] the secondary ordering.
    With ``h``, the state is sorted by the combined key (keys < 2^h);
    without, by (keys, proj). With ``unsort`` (values_t, sizes,
    merged_into) come back in input slot order, ``merged_into[slot]`` the
    slot that absorbed it (-1 while alive); without, in sorted position
    order with a 4th output, ``cur_slot`` (position → stable slot id).
    ``parent``, when given, gets each dying slot's absorber in place."""
    m = values_t.shape[1]
    dev = values_t.device
    if cur_slot is None:
        cur_slot = torch.arange(m, dtype=torch.int32, device=dev)
    if h is None:
        order = _lex_order(keys, proj)
        skey, shift = keys[order], 0
    else:
        combined = lsh.combined_sort_key(keys, proj, sizes, h)
        skey, order = kernels.sort_keys(combined, lsh.KEY_BITS)
        shift = kernels.free_bits(h)
    svt, ssize, scs = kernels.permute_state(values_t, sizes, cur_slot, order)
    smi = None if merged_into is None else merged_into[order]
    svt, ssize, smi = kernels.pairing_rounds(
        svt, ssize, scs, skey, shift, threshold, rounds, smi,
        parent)
    if not unsort:
        return svt, ssize, smi, scs
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(m, dtype=torch.int32, device=dev)
    return kernels.permute_state(svt, ssize, smi, inv)


def _one_iteration(values_t, sizes, slots, parent, hyperplanes, threshold,
                   h: int, merge: str = "chain", rounds: int = 4):
    """One LSH iteration: (values_t, sizes, slots) in sorted order, with the
    merges folded into ``parent`` in place. ``merge`` picks the
    within-bucket primitive: ``"chain"`` (one neighbour-chain collapse) or
    ``"pairing"`` (``rounds`` adjacent rank-pair rounds)."""
    key, _ = kernels.lsh_keys(values_t, sizes, hyperplanes, h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    svt, ssize, sslots = kernels.permute_state(values_t, sizes, slots, order)
    if merge == "pairing":
        svt, ssize, _ = kernels.pairing_rounds(
            svt, ssize, sslots, skey, kernels.free_bits(h), threshold,
            rounds, None, parent)
        return svt, ssize, sslots
    new_vt, new_size, new_slots, _ = kernels.chain_collapse(
        svt, ssize, sslots, skey, threshold, h, None, parent)
    return new_vt, new_size, new_slots


def compact_sort(values_t, sizes, slots):
    """Alive-first stable compaction: a stable sort on ``sizes == 0`` and
    the same permute as an iteration."""
    dead = (sizes == 0).to(torch.int32)
    order = kernels.sort_keys(dead, 1)[1]
    return kernels.permute_state(values_t, sizes, slots, order)


def _finalize_grouped(values_t, sizes, slots, parent):
    """Root resolution and membership grouping (``finalize`` kernel):
    (flat members, lens, sizes, centroids [S, fc]); see kernels.finalize."""
    return kernels.finalize(values_t.contiguous(), sizes, slots, parent)


def state_from_numpy(values_t, sizes, slots, parent, device):
    """Session state pulled from the reference (numpy) as this engine's
    tensors on ``device``."""
    dev = torch.device(device)
    return (torch.tensor(np.asarray(values_t, np.float32), device=dev),
            torch.tensor(np.asarray(sizes, np.int32), device=dev),
            torch.tensor(np.asarray(slots, np.int32), device=dev),
            torch.tensor(np.asarray(parent, np.int32), device=dev))


def _planes_fn(seed: int, s: int, hook: Hyperplanes | None, device):
    def planes(it: int) -> torch.Tensor:
        p = hook(it) if hook is not None else rng.draw_hyperplanes(seed, it, s)
        if not isinstance(p, torch.Tensor):
            p = torch.from_numpy(np.array(p, np.float32))
        return p.to(device, torch.float32)
    return planes


def _record(name: str, seconds: float) -> None:
    LAST_SESSION["device_seconds"] += seconds
    LAST_SESSION["programs"].append((name, round(seconds, 4)))


def _drive_session(values_t, sizes, slots, parent, thr, planes, verbose,
                   sync, defer_pull: bool = False, merge: str = "chain",
                   rounds: int = 4, deep_init: bool = True):
    """Run every iteration of ``thr``, then finalize and pull. Returns
    (centroids [K, S], sizes [K], members), or with ``defer_pull`` the
    (finish, stats) of :func:`_deferred`. With ``merge="pairing"`` every
    iteration runs ``rounds`` pairing rounds, but with ``deep_init`` the
    first, a chain collapse (the reference's deep init pass)."""
    if merge not in ("chain", "pairing"):
        raise ValueError(f"merge = {merge!r}: chain or pairing")
    na = int((sizes > 0).sum())
    for it, threshold in enumerate(thr):
        if na == 0:
            break
        with span("iter.h"):
            h = _active_h_of(na)
        cap = values_t.shape[1]
        kind = "chain" if deep_init and it == 0 else merge
        with span("iter") as sp:
            with span("iter.planes"):
                p = planes(it)
            with span("iter.enqueue"):
                values_t, sizes, slots = _one_iteration(
                    values_t, sizes, slots, parent, p, float(threshold), h,
                    kind, rounds)
            with span("iter.wait"):                # the one read per iteration
                na_next = int((sizes > 0).sum())
        _record(f"iter[{it}]@{cap}", sp.seconds)
        # alive columns now all sit before na: the rest is dead tail
        values_t, sizes, slots = values_t[:, :na], sizes[:na], slots[:na]
        na = na_next
        if verbose:
            print(f"[torch] iter {it + 1}: {na} clusters")

    with span("finalize") as sp:
        with span("finalize.enqueue"):
            values_t, sizes, slots = compact_sort(values_t, sizes, slots)
            out = _finalize_grouped(values_t[:, :na], sizes[:na], slots[:na],
                                    parent)
        with span("finalize.wait"):
            sync()
    _record(f"finalize@{na}", sp.seconds)
    LAST_SESSION["clusters"] = na
    if defer_pull:
        return _deferred(out)
    return _pull(*out, LAST_SESSION)


def _pull(flat, lens, csizes, cents, stats: dict, stream=None):
    """The finalize outputs on the host: (centroids [K, S], sizes [K],
    members), the copies' seconds and bytes added to ``stats``. Lens,
    sizes and centroids come first, then the members the lens count. By
    ``.cpu()`` on the current stream, or on a CUDA side ``stream`` into
    pinned host memory (:func:`_to_pinned`)."""
    with span("pull.copy", stats, "pull_seconds"):
        if stream is None:
            lens, csizes, cents = lens.cpu(), csizes.cpu(), cents.cpu()
        else:
            lens, csizes, cents = _to_pinned(stream, lens, csizes, cents)
        offs = np.concatenate([[0], np.cumsum(lens.numpy(), dtype=np.int64)])
        flat = flat[:int(offs[-1])]
        flat = flat.cpu() if stream is None else _to_pinned(stream, flat)[0]
    with span("pull.host"):
        stats["pull_bytes"] += sum(t.numel() * t.element_size()
                                   for t in (lens, csizes, cents, flat))
        return (np.ascontiguousarray(cents.numpy().T),
                csizes.numpy().astype(np.int64),
                Groups(flat.numpy().astype(np.int64), offs))


def _to_pinned(stream, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Copies of CUDA ``tensors`` in pinned host memory, made on ``stream``
    and waited for. Each source is marked as used by ``stream``, so that
    the caching allocator gives none of its memory to a later allocation
    of another stream before these copies are done, whenever the caller
    drops it."""
    hosts = []
    with torch.cuda.stream(stream):
        for t in tensors:
            if not t.is_contiguous():   # a copy, and no kernel, on stream
                raise ValueError("a deferred pull copies contiguous tensors")
            t.record_stream(stream)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
    stream.synchronize()
    return hosts


def _deferred(out):
    """(finish, stats) of a session whose pull is deferred: ``stats`` is a
    copy of LAST_SESSION now, and ``finish()``, called on any thread, pulls
    the finalize outputs ``out`` as the immediate path does (the same
    triple, byte for byte), adding its seconds and bytes to ``stats`` and
    never to LAST_SESSION, which the next session resets. On a card the
    copies run on a side stream of ``out``'s device that first waits on an
    event recorded now on the kernels' stream (after the finalize), so
    that they overlap whatever the caller's thread launches next there; a
    failed copy raises."""
    stats = dict(LAST_SESSION, programs=list(LAST_SESSION["programs"]))
    dev = out[0].device
    if dev.type != "cuda":
        return (lambda: _pull(*out, stats)), stats
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def finish():
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_event(done)
            return _pull(*out, stats, stream=side)
    return finish, stats


def _sync_for(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _reset_session() -> None:
    LAST_SESSION.clear()
    LAST_SESSION.update(device_seconds=0.0, pull_seconds=0.0, pull_bytes=0,
                        programs=[])


def upload_counts(counts: np.ndarray, device) -> tuple[torch.Tensor, int]:
    """Place a uint16 [S, N] count matrix on ``device``. Returns (tensor
    [S, N], N); no capacity padding is needed."""
    arr = np.ascontiguousarray(counts, dtype=np.uint16)
    if not arr.flags.writeable:      # torch.from_numpy needs a writable array
        arr = arr.copy()
    return torch.from_numpy(arr).to(device), counts.shape[1]


def _empty(s: int):
    return (np.zeros((0, s), np.float32), np.zeros(0, np.int64),
            Groups(np.empty(0, np.int64), np.zeros(1, np.int64)))


def cluster_counts(
    counts,                        # uint16 [S, N] numpy, or a tensor
    v_kmers: np.ndarray,           # f32 [S] per-sample coverage offsets
    thresholds: np.ndarray,        # f32 [I] anneal schedule (incl. init pass)
    seed: int = 0,
    rounds: int = 4,
    deep_init: bool = True,
    verbose: bool = False,
    n: int | None = None,          # real column count of a padded tensor
    merge: str = "chain",
    device=None,
    hyperplanes: Hyperplanes | None = None,
    defer_pull: bool = False,
):
    """Single-batch mode C: abundance transform, the schedule's iterations,
    finalize. A tensor ``counts`` runs where it lies (columns past ``n``
    must be zero: they are filtered out); a numpy matrix is uploaded to
    ``device``. ``merge``, ``rounds`` and ``deep_init`` as in
    :func:`_drive_session`. Returns (centroids [K, S], sizes [K], members)
    ordered by smallest member id; with ``defer_pull``, (finish, stats)
    instead, where ``finish()`` returns that triple (see
    :func:`_deferred`)."""
    if isinstance(counts, torch.Tensor):
        dev = counts.device
        if n is not None and n > counts.shape[1]:
            raise ValueError(f"n = {n} exceeds the {counts.shape[1]} columns")
    else:
        if device is None:
            raise ValueError("pass device= for a numpy count matrix")
        dev = torch.device(device)
        if counts.shape[1] == 0:
            _reset_session()
            empty = _empty(counts.shape[0])
            if defer_pull:
                return (lambda: empty), dict(LAST_SESSION, programs=[])
            return empty
        counts, n = upload_counts(counts, dev)
    S, cap0 = counts.shape
    thr = np.asarray(thresholds, np.float32)
    v = torch.as_tensor(np.asarray(v_kmers, np.float32), device=dev)
    sync = _sync_for(dev)
    _reset_session()
    with span("transform") as sp:
        values_t, sizes = kernels.abundance_transform(counts, v)
        slots = torch.arange(cap0, dtype=torch.int32, device=dev)
        parent = torch.arange(cap0, dtype=torch.int32, device=dev)
        sync()
    _record(f"transform@{cap0}", sp.seconds)
    return _drive_session(values_t, sizes, slots, parent, thr,
                          _planes_fn(seed, S, hyperplanes, dev), verbose,
                          sync, defer_pull, merge, rounds, deep_init)


def cluster(
    values,
    sizes=None,
    min_similarity: float = 0.8,
    iterations: int = 100,
    seed: int = 0,
    rounds: int = 4,
    verbose: bool = False,
    thresholds: np.ndarray | None = None,
    init_rounds: int | None = None,
    merge: str = "chain",
    transposed: bool = False,
    device=None,
    hyperplanes: Hyperplanes | None = None,
):
    """Cluster rows of ``values`` [N, S] ([S, N] with ``transposed``) with
    the annealed threshold 0.95 → min_similarity over ``iterations`` (or an
    explicit ``thresholds`` schedule). Rows of size 0 are filtered.
    ``merge`` and ``rounds`` as in :func:`_drive_session`; any
    ``init_rounds`` but None makes the first iteration the deep init pass
    (a chain collapse), which matters only for ``merge="pairing"``.
    Returns (centroids [K, S], sizes [K], members) ordered by smallest
    member id."""
    if isinstance(values, torch.Tensor):
        dev = values.device
        vt = (values if transposed else values.T).to(torch.float32)
    else:
        if device is None:
            raise ValueError("pass device= for numpy values")
        dev = torch.device(device)
        arr = np.array(values, np.float32)
        vt = torch.from_numpy(arr if transposed else arr.T).to(dev)
    s, n = vt.shape
    _reset_session()
    if n == 0:
        return _empty(s)
    vt = vt.contiguous()
    if sizes is None:
        sz = torch.ones(n, dtype=torch.int32, device=dev)
    else:
        if not isinstance(sizes, torch.Tensor):
            sizes = torch.from_numpy(np.array(sizes, np.int32))
        sz = sizes.to(dev, torch.int32).contiguous()
    if thresholds is None:
        sim_step = (0.95 - min_similarity) / iterations
        thr = (0.95 - sim_step * np.arange(iterations)).astype(np.float32)
    else:
        thr = np.asarray(thresholds, np.float32)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    return _drive_session(vt, sz, slots, parent, thr,
                          _planes_fn(seed, s, hyperplanes, dev), verbose,
                          _sync_for(dev), merge=merge, rounds=rounds,
                          deep_init=init_rounds is not None)
