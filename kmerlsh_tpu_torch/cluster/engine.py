"""LSH clustering engine on PyTorch tensors (port of
kmerlsh_tpu/cluster/engine.py).

A session keeps the cluster profiles sample-major (values f32 [S, M]) with
sizes and stable slot ids (int32 [M]) and a parent forest over the input
rows (int32 [cap0]). Each iteration, run eagerly one at a time:

  1. ``lsh_keys`` kernel: projections on the iteration's hyperplanes, the h
     bucket bits and the secondary projection quantized into one int32 key;
  2. the ``sort_keys`` kernel's stable sort of the key;
  3. ``chain_collapse`` kernel: the state moves into sorted order (its
     rows staged by the order) and neighbour chains collapse onto their
     last position; the dying slots are folded into the parent forest in
     place. With ``merge="pairing"`` the ``permute_state`` kernel moves the
     state into sorted order and the ``pairing_rounds`` kernel runs R
     rounds of adjacent rank pairs within each bucket instead (the
     reference keeps it for comparison); with ``deep_init`` the first
     iteration is still a chain collapse.

A chain session (``merge="chain"``) carries its state between iterations
as rows (``kernels.to_rows``: row m column m's values, size and slot), made
once after the transform: ``lsh_keys_rows`` reads them and
``chain_collapse_rows`` stages them by the order and writes the collapsed
rows, so no iteration transposes the state. Its compaction takes them back
to [S, M] columns. A pairing session, the sharded path and
:func:`chain_collapse` keep the [S, M] columns throughout.

After every iteration the host reads one int, the alive count: the sort put
every dead column behind the alive ones, so the next iteration runs on the
first ``n_alive_before`` columns only (a view, no copy). Merge decisions do
not depend on capacity (the quantization range is taken over alive rows
only), so the result is the same at any capacity, nor on slot ids, which
say only where the forest is written. Once per session the ``finalize``
kernel groups the rows by root; a sharded session (parallel/dist.py) ends
so too, through :func:`_session` on its gathered survivors and forest.

State is float32 throughout. The reference's TPU workarounds are not
carried over: f16 sort payloads, f16 pulls, scanned chunk programs and
buffer donation. Its hyperplanes are reproduced bit for bit up to a few
ulp (:mod:`kmerlsh_tpu_torch.ops.rng`), a session's all at once by the
``draw_planes`` kernel; a ``hyperplanes`` hook takes planes from elsewhere
(``it → [S, 31]``), one iteration at a time.
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
#   pull_host_allocs — pinned host blocks the copies had to allocate rather
#                    than take from PyTorch's caching host allocator (0 on
#                    the CPU, and in a run of same-shape sessions that drops
#                    each result before the next pull); a delta of the
#                    process-wide count, so where pulls overlap (the out-of-
#                    core flush thread's beside a merge round's) each may
#                    also count the other's;
#   clusters       — the session's cluster count
#   planes_launches — the session's draws of its planes on the card (1 on a
#                    card without a hyperplanes hook, else 0)
#   permute_launches — the session's K2 gathers, calls of
#                    kernels.permute_state or permute_rows (on the CPU too):
#                    the compaction's one and one a pairing iteration (a
#                    chain iteration moves its state inside
#                    kernels.chain_collapse); calls outside a session, as
#                    pairing_merge's, are in no session's count
#   sorted_keys    — the keys the session passed to kernels.sort_keys or its
#                    plain twin (on the CPU too): each iteration's capacity,
#                    compact_sort's, and finalize's two (the forest's rows
#                    and the clusters)
#   state_transposes — the session's changes of state layout (on the CPU
#                    too): a chain session 2 whatever its iterations (into
#                    rows after the transform, back to columns in its
#                    compaction), a pairing session 0
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
    new_vt, new_size, new_scs, new_mi = kernels.chain_collapse(
        values_t, sizes, cur_slot, order, skey, threshold, h, merged_into,
        parent)
    return new_vt, new_size, new_mi, new_scs


_permutes = 0   # K2 gathers (_permute, compact_rows) in this process


def _permute(values_t, sizes, slots, order):
    """``kernels.permute_state``, counted in ``_permutes`` (a session
    records its delta as LAST_SESSION["permute_launches"])."""
    global _permutes
    _permutes += 1
    return kernels.permute_state(values_t, sizes, slots, order)


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
    svt, ssize, scs = _permute(values_t, sizes, cur_slot, order)
    smi = None if merged_into is None else merged_into[order]
    svt, ssize, smi = kernels.pairing_rounds(
        svt, ssize, scs, skey, shift, threshold, rounds, smi,
        parent)
    if not unsort:
        return svt, ssize, smi, scs
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(m, dtype=torch.int32, device=dev)
    return _permute(svt, ssize, smi, inv)


def _one_iteration(values_t, sizes, slots, parent, hyperplanes, threshold,
                   h: int, merge: str = "chain", rounds: int = 4,
                   base: int = 0, merged: bool = True):
    """One LSH iteration: (values_t, sizes, slots, merged_into) in sorted
    order, ``merged_into`` the slot that absorbed a position (-1 where none
    did), with the merges folded into ``parent`` (the entry of slot s at
    s - ``base``; None folds nothing) in place. ``merge`` picks the
    within-bucket primitive: ``"chain"`` (one neighbour-chain collapse) or
    ``"pairing"`` (``rounds`` adjacent rank-pair rounds). With ``merged``
    False merged_into comes back None: a chain iteration allocates none, a
    pairing one drops its own."""
    key, _ = kernels.lsh_keys(values_t, sizes, hyperplanes, h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    del key   # not held into the collapse's peak
    if merge == "pairing":
        svt, ssize, sslots = _permute(values_t, sizes, slots, order)
        svt, ssize, smi = kernels.pairing_rounds(
            svt, ssize, sslots, skey, kernels.free_bits(h), threshold,
            rounds, None, parent, base)
        return svt, ssize, sslots, smi if merged else None
    return kernels.chain_collapse(values_t, sizes, slots, order, skey,
                                  threshold, h, None, parent, base, merged)


def _row_iteration(rows, sizes, s: int, parent, hyperplanes, threshold,
                   h: int):
    """One chain iteration on a chain session's row state (rows int32
    [M, W] of ``s`` values, sizes int32 [M]): (rows, sizes) in sorted
    order, what :func:`_one_iteration` gives as columns, with the merges
    folded into ``parent`` in place."""
    key, _ = kernels.lsh_keys_rows(rows, sizes, hyperplanes, h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    del key   # not held into the collapse's peak
    return kernels.chain_collapse_rows(rows, s, order, skey, threshold, h,
                                       parent)


def compact_sort(values_t, sizes, slots):
    """Alive-first stable compaction: a stable sort on ``sizes == 0`` and
    the same permute as an iteration."""
    dead = (sizes == 0).to(torch.int32)
    order = kernels.sort_keys(dead, 1)[1]
    return _permute(values_t, sizes, slots, order)


def compact_rows(rows, sizes, s: int):
    """:func:`compact_sort` of a row state (``s`` values a row, sizes int32
    [M] as a column): the same sort, then K2's gather alone back to [S, M]
    columns (values, sizes, slots), counted in ``_permutes``."""
    global _permutes
    dead = (sizes == 0).to(torch.int32)
    order = kernels.sort_keys(dead, 1)[1]
    _permutes += 1
    return kernels.permute_rows(rows, s, order)


def _finalize_grouped(values_t, sizes, slots, parent):
    """Root resolution and membership grouping (``finalize`` kernel):
    (flat members, lens, sizes, centroids [fc, S]); see kernels.finalize."""
    return kernels.finalize(values_t.contiguous(), sizes, slots, parent)


def state_from_numpy(values_t, sizes, slots, parent, device):
    """Session state pulled from the reference (numpy) as this engine's
    tensors on ``device``, in fresh C-order copies: the kernels take a last
    stride of 1, which numpy need not give an axis of length 1."""
    dev = torch.device(device)
    return (torch.tensor(np.array(values_t, np.float32, order="C"),
                         device=dev),
            torch.tensor(np.asarray(sizes, np.int32), device=dev),
            torch.tensor(np.asarray(slots, np.int32), device=dev),
            torch.tensor(np.asarray(parent, np.int32), device=dev))


def _planes_fn(seed: int, s: int, hook: Hyperplanes | None, device,
               iterations: int):
    """``it → [s, H_MAX + 1]`` planes on ``device`` for a session of
    ``iterations``. Without a hook the first call draws the whole
    schedule (``kernels.draw_planes``: one launch on a card, counted in
    LAST_SESSION["planes_launches"]) and each call returns its contiguous
    slice; with one, each call uploads what the hook gives."""
    if hook is not None:
        def planes(it: int) -> torch.Tensor:
            p = hook(it)
            if not isinstance(p, torch.Tensor):
                p = torch.from_numpy(np.array(p, np.float32))
            return p.to(device, torch.float32)
        return planes
    drawn = None

    def planes(it: int) -> torch.Tensor:
        nonlocal drawn
        if drawn is None:
            drawn = kernels.draw_planes(seed, iterations, s, device)
            if drawn.is_cuda:
                LAST_SESSION["planes_launches"] += 1
        return drawn[it]
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
    first, a chain collapse (the reference's deep init pass). A chain
    session carries its state as rows from here to its compaction
    (``kernels.to_rows``, :func:`_row_iteration`, :func:`compact_rows`)."""
    if merge not in ("chain", "pairing"):
        raise ValueError(f"merge = {merge!r}: chain or pairing")
    permutes0, sorted0 = _permutes, kernels.sorted_keys
    s = values_t.shape[0]
    na = int((sizes > 0).sum())
    rows = None   # a chain session's row state, in place of the columns
    transposes = 0   # the session's changes of the state's layout
    if merge == "chain":
        rows = kernels.to_rows(values_t, sizes, slots)
        values_t = slots = None
        transposes += 1
    for it, threshold in enumerate(thr):
        if na == 0:
            break
        with span("iter.h"):
            h = _active_h_of(na)
        cap = sizes.shape[0]
        kind = "chain" if deep_init and it == 0 else merge
        with span("iter") as sp:
            with span("iter.planes"):
                p = planes(it)
            with span("iter.enqueue"):
                # merged_into is not needed here, and not held into the
                # next iteration's peak
                if rows is not None:
                    rows, sizes = _row_iteration(rows, sizes, s, parent, p,
                                                 float(threshold), h)
                else:
                    values_t, sizes, slots, _ = _one_iteration(
                        values_t, sizes, slots, parent, p, float(threshold),
                        h, kind, rounds, merged=False)
            with span("iter.wait"):                # the one read per iteration
                na_next = int((sizes > 0).sum())
        _record(f"iter[{it}]@{cap}", sp.seconds)
        # alive columns now all sit before na: the rest is dead tail
        if rows is not None:
            rows, sizes = rows[:na], sizes[:na]
        else:
            values_t, sizes, slots = values_t[:, :na], sizes[:na], slots[:na]
        na = na_next
        if verbose:
            print(f"[torch] iter {it + 1}: {na} clusters")

    with span("finalize") as sp:
        with span("finalize.enqueue"):
            if rows is not None:
                values_t, sizes, slots = compact_rows(rows, sizes, s)
                transposes += 1
                del rows   # not held through finalize
            else:
                values_t, sizes, slots = compact_sort(values_t, sizes, slots)
            out = _finalize_grouped(values_t[:, :na], sizes[:na], slots[:na],
                                    parent)
        with span("finalize.wait"):
            sync()
    _record(f"finalize@{na}", sp.seconds)
    LAST_SESSION["clusters"] = na
    LAST_SESSION["permute_launches"] = _permutes - permutes0
    LAST_SESSION["sorted_keys"] = kernels.sorted_keys - sorted0
    LAST_SESSION["state_transposes"] = transposes
    if defer_pull:
        return _deferred(out)
    return _pull(*out, LAST_SESSION)


def _pull(flat, lens, csizes, cents, stats: dict, stream=None):
    """The finalize outputs on the host: (centroids [K, S], sizes [K],
    members), the copies' seconds, bytes and pinned allocations added to
    ``stats``. finalize leaves each output in the layout and type the host
    returns, so on a card the pull is one copy of each (all of ``flat``,
    the members and the dead-rooted tail, so that one wait serves) into
    pinned host memory (:func:`_to_pinned`), on the current stream or a
    side ``stream``, and the triple is views of those copies; on the CPU
    it is views of the outputs themselves."""
    with span("pull.copy", stats, "pull_seconds"):
        if flat.is_cuda:
            if stream is None:
                stream = torch.cuda.current_stream(flat.device)
            allocs = _host_allocs()
            flat, lens, csizes, cents = _to_pinned(stream, flat, lens, csizes,
                                                   cents)
            stats["pull_host_allocs"] += _host_allocs() - allocs
    with span("pull.host"):
        stats["pull_bytes"] += sum(t.numel() * t.element_size()
                                   for t in (flat, lens, csizes, cents))
        offs = np.concatenate([[0], np.cumsum(lens.numpy(), dtype=np.int64)])
        return (cents.numpy(), csizes.numpy(),
                Groups(flat.numpy()[:offs[-1]], offs))


def _host_allocs() -> int:
    """Blocks PyTorch's caching host allocator has allocated so far in
    this process (its cudaHostAlloc calls for pinned memory)."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def _to_pinned(stream, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Copies of CUDA ``tensors`` in pinned host memory from PyTorch's
    caching host allocator, made on ``stream`` and waited for. Each source
    is marked as used by ``stream``, so that the caching allocator gives
    none of its memory to a later allocation of another stream before
    these copies are done, whenever the caller drops it."""
    hosts = []
    with torch.cuda.stream(stream):
        for t in tensors:
            if not t.is_contiguous():   # a copy, and no kernel, on stream
                raise ValueError("a pull copies contiguous tensors")
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
                        pull_host_allocs=0, planes_launches=0,
                        permute_launches=0, sorted_keys=0,
                        state_transposes=0, programs=[])


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
    planes = _planes_fn(seed, S, hyperplanes, dev, len(thr))
    return _drive_session(values_t, sizes, slots, parent, thr, planes,
                          verbose, sync, defer_pull, merge, rounds, deep_init)


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
    if n == 0:
        _reset_session()
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
    return _session(vt, sz, slots, slots.clone(), thr, seed, hyperplanes,
                    verbose, merge, rounds, deep_init=init_rounds is not None)


def _session(values_t, sizes, slots, parent, thresholds, seed: int,
             hyperplanes: Hyperplanes | None = None, verbose: bool = False,
             merge: str = "chain", rounds: int = 4, deep_init: bool = False):
    """Run a given state (values f32 [S, n], sizes, slots int32 [n]) and
    forest (int32 [cap0], slot s at s) through the schedule ``thresholds``
    to the end, a new session: the planes of ``seed`` (none drawn for an
    empty schedule), then :func:`_drive_session`, which ends in
    compact_sort, finalize and the pull."""
    _reset_session()
    dev = values_t.device
    planes = _planes_fn(seed, values_t.shape[0], hyperplanes, dev,
                        len(thresholds))
    return _drive_session(values_t, sizes, slots, parent, thresholds, planes,
                          verbose, _sync_for(dev), merge=merge, rounds=rounds,
                          deep_init=deep_init)
