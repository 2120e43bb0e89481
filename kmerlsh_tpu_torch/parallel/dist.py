"""Sharded clustering over the ranks of a process group (port of
kmerlsh_tpu/parallel/dist.py).

Each rank holds a column shard of the state (values f32 [S, c_loc], sizes,
slots) and the parent forest of its original slots [rank·c0_loc,
(rank+1)·c0_loc). One iteration, run eagerly on every rank:

  1. **local phase**: the rank's shard runs a single-device iteration
     (``engine._one_iteration``: ``lsh_keys`` against the replicated
     hyperplanes, ``sort_keys``, ``permute_state``, ``chain_collapse``),
     its merges folded into the parent shard at the rank's slot base;
  2. **exchange**: the ``exchange_window`` kernel takes a fixed window of
     ``e`` alive survivors, rotating with the iteration so that every
     survivor is exchanged within ⌈alive/e⌉ iterations, and ONE all_gather
     moves (values, sizes, slots) of every rank's window: D·e·(S + 2)
     elements, independent of the row count;
  3. **global phase**: every rank runs the same iteration on the D·e
     gathered columns identically, with no parent and keeping its
     merged_into, and the ``exchange_fold`` kernel folds this rank's global
     merges into its parent shard and writes its window back.

The host reads the global alive count after every iteration (it sets the
next iteration's h) and takes the reference's decisions at its program
boundaries only: after ``HEAD_ITERS`` iterations, then after chunks of
``MID_CHUNK`` (or all that remain once the shard capacity is at most
``SMALL_LOCAL_CAP``), shrinking capacity there by ``engine.compact_sort``.
Then every rank gathers the state and the parent forest and ends the
session as a single-device one does (``engine._session``): the survivors,
with their global slots, and the gathered forest on the rank's device run
the tail's iterations, compact_sort, the ``finalize`` kernel and the pull.
The tail is the rest of the anneal once the global alive count fits
``HANDOFF_CAP``, else ``TERMINAL_ITERS`` rounds at the final threshold; a
one-rank mesh runs the whole anneal sharded and no tail. The tail's merges
do not depend on slot ids, so this equals the reference's separate session
over the survivors composed into the row roots on the host.

Every rank computes the same clustering: the collectives deliver the same
data everywhere, and the kernels are deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.parallel.mesh import Mesh, make_mesh
from kmerlsh_tpu_torch.parallel.multihost import gather_np
from kmerlsh_tpu_torch.utils.timing import span

EXCHANGE_CAP = 4096   # survivor summaries exchanged per rank per iteration

# wall-clock split of the most recent sharded session, with the split of
# its ending (engine._session: the tail, finalize and the pull) folded in:
#   device_seconds, pull_seconds, pull_bytes, programs — as engine's (spans
#     dist.transform and dist.iters, a head or chunk each; dist.pull, the
#     gather to the host; the ending's programs prefixed tail_);
#   sharded_iterations — iterations run sharded (the tail starts there);
#   alive — the global alive count then;
#   tail — "handoff", "terminal" or None;  gathered — elements the
#   exchanges gathered on this rank;  exchanges — their number;
#   planes_launches — the planes' draws on the card (the schedule's once,
#     a tail of more than one survivor's once)
LAST_SESSION: dict = {}

HEAD_ITERS = 3        # iterations before the first host decision
MID_CHUNK = 4         # iterations per chunk thereafter
SMALL_LOCAL_CAP = 1 << 13  # at or below this shard capacity, run the rest
HANDOFF_CAP = 1 << 22   # once the global alive count fits this, the anneal
                        # tail runs single-device (exact one-device merge
                        # semantics), as in the reference
TERMINAL_ITERS = 5   # = the reference's per-merge-round iteration count
                     # (Cluster(..., iters=5), app/kmerLSH.cc:375-387); only
                     # used when survivors never fit the handoff


def _one_dist_iteration(mesh: Mesh, values_t, sizes, slots, parent,
                        n_alive: int, planes, threshold: float, it: int,
                        e: int, c0_loc: int):
    """One sharded iteration. Returns (values_t, sizes, slots, global alive
    count); ``parent`` is updated in place."""
    h = engine._active_h_of(n_alive)               # from the GLOBAL count
    base = mesh.rank * c0_loc

    # ---- local phase: hash + single-pass chain collapse on my shard, its
    #      merges folded into my parent shard ----
    values_t, sizes, slots, _ = engine._one_iteration(
        values_t, sizes, slots, parent, planes, threshold, h, base=base,
        merged=False)

    # ---- exchange: a rotating window of e alive survivors ----
    pos, w_vals, w_sizes, w_slots = kernels.exchange_window(
        values_t, sizes, slots, e, it)
    s = values_t.shape[0]
    packed = torch.cat([w_vals.view(torch.int32), w_sizes[None],
                        w_slots[None]])                          # [S+2, e]
    g = mesh.all_gather(packed, dim=1)                           # [S+2, D·e]
    g_vals, g_sizes, g_slots = g[:s].view(torch.float32), g[s], g[s + 1]

    # ---- global phase: replicated merge of the gathered summaries ----
    m_vals, m_sizes, m_scs, m_mi = engine._one_iteration(
        g_vals, g_sizes, g_slots, None, planes, threshold, h)
    kernels.exchange_fold(m_vals, m_sizes, m_mi, m_scs, w_slots, pos,
                          values_t, sizes, parent, base)
    return values_t, sizes, slots, mesh.all_sum(int((sizes > 0).sum()))


def _local_cap(n: int, n_dev: int) -> int:
    """Per-rank capacity: a power of two of at least 512 per shard,
    n_dev · cap ≥ n."""
    per = -(-n // n_dev)
    return max(512, 1 << math.ceil(math.log2(max(per, 1))))


def _slice_to(values_t, sizes, slots, new_c: int):
    values_t, sizes, slots = engine.compact_sort(values_t, sizes, slots)
    return values_t[:, :new_c], sizes[:new_c], slots[:new_c]


def _drive(mesh: Mesh, values_t, sizes, slots, parent, thresholds, seed: int,
           e: int, verbose: bool):
    """The host loop: the head iterations, then chunks with capacity
    shrinking, then the final compaction and the pull of every rank's shard.
    Returns ((values_t [S, D·Cf], sizes, slots, parent [D·c0]) as NumPy,
    the un-run rest of the schedule)."""
    thr = np.asarray(thresholds, np.float32)
    total = len(thr)
    s, c0_loc = values_t.shape[0], parent.shape[0]
    dev = values_t.device
    sync = engine._sync_for(dev)
    gathered0 = mesh.gathered
    LAST_SESSION["exchanges"] = 0
    na = mesh.all_sum(int((sizes > 0).sum()))

    planes = kernels.draw_planes(seed, total, s, dev)   # the schedule's
    LAST_SESSION["planes_launches"] += int(planes.is_cuda and total > 0)

    def run(tag: str, lo: int, hi: int) -> None:
        nonlocal values_t, sizes, slots, na
        with span("dist.iters", LAST_SESSION, "device_seconds") as sp:
            for it in range(lo, hi):
                values_t, sizes, slots, na = _one_dist_iteration(
                    mesh, values_t, sizes, slots, parent, na, planes[it],
                    float(thr[it]), it, e, c0_loc)
            sync()
        LAST_SESSION["programs"].append((tag, round(sp.seconds, 4)))
        LAST_SESSION["exchanges"] += hi - lo

    head_k = min(total, HEAD_ITERS)
    run(f"dist_head[{head_k}]", 0, head_k)
    it = head_k
    max_alive = mesh.all_max(int((sizes > 0).sum()))
    c_loc = sizes.shape[0]
    if verbose:
        print(f"[dist] head ({head_k} iters): {na} clusters")

    while it < total and (na > HANDOFF_CAP or mesh.size == 1):
        new_c = min(c_loc, _local_cap(max(max_alive, 1), 1))
        if new_c < c_loc:
            values_t, sizes, slots = _slice_to(values_t, sizes, slots, new_c)
            c_loc = new_c
        c = total - it if c_loc <= SMALL_LOCAL_CAP else min(MID_CHUNK,
                                                            total - it)
        run(f"dist_chunk[{c}]@{c_loc}", it, it + c)
        max_alive = mesh.all_max(int((sizes > 0).sum()))
        it += c
        if verbose:
            print(f"[dist] iter {it}: {na} clusters")

    LAST_SESSION["gathered"] = mesh.gathered - gathered0
    LAST_SESSION["sharded_iterations"] = it
    LAST_SESSION["alive"] = na
    fin_c = min(c_loc, _local_cap(max(max_alive, 1), 1))
    values_t, sizes, slots = _slice_to(values_t, sizes, slots, fin_c)
    with span("dist.pull", LAST_SESSION, "pull_seconds"):
        pulled = (gather_np(values_t.contiguous(), mesh, dim=1),
                  gather_np(sizes, mesh), gather_np(slots, mesh),
                  gather_np(parent, mesh))
    LAST_SESSION["pull_bytes"] += sum(a.nbytes for a in pulled)
    return pulled, thr[it:]


def _tail_schedule(rest: np.ndarray, thresholds, mesh: Mesh):
    """The single-device tail after the sharded prefix: the handed-off rest
    of the anneal, else terminal rounds at the final threshold (meshes of
    more than one rank only)."""
    if mesh.size <= 1:
        return None
    if len(rest):
        return rest
    return np.full(TERMINAL_ITERS, float(np.asarray(thresholds)[-1]),
                   np.float32)


def _reset_session() -> None:
    LAST_SESSION.clear()
    LAST_SESSION.update(device_seconds=0.0, pull_seconds=0.0, pull_bytes=0,
                        planes_launches=0, programs=[], tail=None)


def _run(mesh: Mesh, values_t, sizes, n_rows: int, thresholds, seed: int,
         exchange_cap: int, verbose: bool):
    """The session from a rank's initial shard (values [S, c], sizes [c]):
    the sharded iterations, then its ending on this rank's device
    (``engine._session``) over the survivors, in their gathered order with
    their global slots, and the gathered forest: the tail schedule (empty
    where there is no tail or one survivor), then finalize, which leaves
    the rows past ``n_rows`` dead-rooted, out of every cluster."""
    c = values_t.shape[1]
    slots = torch.arange(c, dtype=torch.int32, device=values_t.device) \
        + mesh.rank * c
    (values_t, sizes, slots, parent), rest = _drive(
        mesh, values_t, sizes, slots, slots.clone(), thresholds, seed,
        exchange_cap, verbose)
    tail = _tail_schedule(rest, thresholds, mesh)
    if tail is not None:
        LAST_SESSION["tail"] = "handoff" if len(rest) else "terminal"
    alive = np.flatnonzero((sizes > 0) & (slots < n_rows))
    if tail is None or len(alive) <= 1:
        tail = np.zeros(0, np.float32)
    out = engine._session(
        *engine.state_from_numpy(values_t[:, alive], sizes[alive],
                                 slots[alive], parent, mesh.device),
        tail, seed + 99_991, verbose=verbose)
    for k in ("device_seconds", "pull_seconds", "pull_bytes",
              "planes_launches"):
        LAST_SESSION[k] += engine.LAST_SESSION[k]
    LAST_SESSION["programs"].extend(
        ("tail_" + t, d) for t, d in engine.LAST_SESSION["programs"])
    if verbose and len(tail):
        print(f"[dist] single-device tail ({len(tail)} iters): "
              f"{len(alive)} -> {len(out[1])} clusters")
    return out


def shard_cols(mesh: Mesh, array: np.ndarray) -> torch.Tensor:
    """This rank's block of the LAST axis of ``array`` (length divisible by
    the mesh size) on the mesh's device: the layout of the sample-major
    [S, N] matrices."""
    n = array.shape[-1] // mesh.size
    part = np.ascontiguousarray(array[..., mesh.rank * n:(mesh.rank + 1) * n])
    return torch.from_numpy(part).to(mesh.device)


def shard_rows(mesh: Mesh, array: np.ndarray) -> torch.Tensor:
    """This rank's block of the FIRST axis of ``array`` (length divisible by
    the mesh size) on the mesh's device."""
    n = array.shape[0] // mesh.size
    part = np.ascontiguousarray(array[mesh.rank * n:(mesh.rank + 1) * n])
    return torch.from_numpy(part).to(mesh.device)


def upload_counts_sharded(counts: np.ndarray, mesh: Mesh):
    """Pad a uint16 [S, N] count matrix (the same on every rank) to the
    sharded capacity and place this rank's columns on its device. Returns
    (tensor [S, c_loc], N)."""
    S, n = counts.shape
    c_loc = _local_cap(n, mesh.size)
    padded = np.zeros((S, mesh.size * c_loc), np.uint16)
    padded[:, :n] = counts
    return shard_cols(mesh, padded), n


def upload_counts_process_local(bin_path: str, num_samples: int,
                                kmap_size: int, mesh: Mesh):
    """Each rank reads ONLY its own column slice of the sample-major
    ``kmer_count.bin`` (ReadHT layout, io/ioHT.cc:65-66) onto its device:
    the full matrix never lives in one process. Returns (tensor [S, c_loc],
    N)."""
    from kmerlsh_tpu_torch.io import counts as countsio

    c_loc = _local_cap(kmap_size, mesh.size)
    lo = mesh.rank * c_loc
    local = np.zeros((num_samples, c_loc), np.uint16)
    rlo, rhi = min(lo, kmap_size), min(lo + c_loc, kmap_size)
    if rhi > rlo:
        local[:, :rhi - rlo] = countsio.read_count_batch(
            bin_path, num_samples, kmap_size, rlo, rhi - rlo)
    return torch.from_numpy(local).to(mesh.device), kmap_size


def shard_state_from_numpy(values_t, sizes, slots, parent, rank: int,
                           world: int, device):
    """This rank's shard of a global [S, D·c] state and [D·c0] parent
    forest (NumPy, e.g. pulled from the reference), as the tensors of
    :func:`engine.state_from_numpy` on ``device``."""
    def block(a, r, n):
        a = np.asarray(a)
        k = a.shape[-1] // n
        return a[..., r * k:(r + 1) * k]

    return engine.state_from_numpy(
        np.ascontiguousarray(block(values_t, rank, world)),
        block(sizes, rank, world), block(slots, rank, world),
        block(parent, rank, world), device)


def cluster_counts_sharded(
    counts,                      # uint16 [S, N] (np), or this rank's shard
    v_kmers: np.ndarray,         # f32 [S] coverage offsets
    thresholds: np.ndarray,      # f32 [I] anneal schedule
    mesh: Mesh | None = None,
    seed: int = 0,
    exchange_cap: int = EXCHANGE_CAP,
    verbose: bool = False,
    n: int | None = None,        # real column count when counts is a shard
):
    """Sharded twin of ``engine.cluster_counts``: the abundance transform
    on this rank's shard, the schedule sharded over ``mesh``. Same output
    contract, the same on every rank. ``counts`` may be this rank's shard
    [S, c_loc] from :func:`upload_counts_process_local` (with ``n``)."""
    mesh = mesh or make_mesh()
    if isinstance(counts, torch.Tensor):
        if n is None:
            raise ValueError("pass n (the real column count) with a shard")
        local = counts
    else:
        if counts.shape[1] == 0:
            return engine._empty(counts.shape[0])
        local, n = upload_counts_sharded(counts, mesh)
    _reset_session()
    with span("dist.transform", LAST_SESSION, "device_seconds") as sp:
        v = torch.as_tensor(np.asarray(v_kmers, np.float32),
                            device=local.device)
        values_t, sizes = kernels.abundance_transform(local, v)
        engine._sync_for(local.device)()
    LAST_SESSION["programs"].append((f"transform@{local.shape[1]}",
                                     round(sp.seconds, 4)))
    return _run(mesh, values_t, sizes, n, thresholds, seed, exchange_cap,
                verbose)


def cluster_sharded(
    values,
    sizes=None,
    mesh: Mesh | None = None,
    min_similarity: float = 0.8,
    iterations: int = 100,
    seed: int = 0,
    thresholds: np.ndarray | None = None,
    exchange_cap: int = EXCHANGE_CAP,
    verbose: bool = False,
    **_ignored,
):
    """Sharded version of ``engine.cluster``: the same annealed loop (0.95 →
    min_similarity over ``iterations``, or ``thresholds``), the rows of
    ``values`` [N, S] (the same on every rank) sharded over ``mesh``. Same
    output contract, the same on every rank. Other keywords of
    ``engine.cluster`` (``merge``, ``rounds``, ...) are accepted and
    ignored, as the reference's are: the sharded path runs the chain
    merge."""
    mesh = mesh or make_mesh()
    values = np.asarray(values, dtype=np.float32)
    n, s = values.shape
    if n == 0:
        return engine._empty(s)
    if thresholds is None:
        sim_step = (0.95 - min_similarity) / iterations
        thresholds = (0.95 - sim_step * np.arange(iterations)).astype(
            np.float32)
    c_loc = _local_cap(n, mesh.size)
    host_vals = np.zeros((s, mesh.size * c_loc), np.float32)
    host_vals[:, :n] = values.T
    host_sizes = np.zeros(mesh.size * c_loc, np.int32)
    host_sizes[:n] = (np.asarray(sizes, np.int32) if sizes is not None
                      else np.ones(n, np.int32))
    _reset_session()
    return _run(mesh, shard_cols(mesh, host_vals),
                shard_cols(mesh, host_sizes), n, thresholds, seed,
                exchange_cap, verbose)


def sharded_wrs(mesh: Mesh, n1: int, n2: int, pval_thresh: float,
                size_thresh: int):
    """Cluster-sharded WRS verdicts: each rank tests its row shard of the
    clusters (``wrs_verdicts``); gathering the verdicts is the only
    collective. Returns fn(values shard [N/D, ≥ n1+n2], sizes shard [N/D])
    → int8 verdicts [N] (NumPy) on every rank."""
    def step(values: torch.Tensor, sizes: torch.Tensor) -> np.ndarray:
        verdict, _, _ = kernels.wrs_verdicts(
            values.to(torch.float32).contiguous(),
            sizes.to(torch.int32).contiguous(), n1, n2, pval_thresh,
            size_thresh)
        return gather_np(verdict.to(torch.int32), mesh).astype(np.int8)

    return step
