"""Time lsh_keys and finalize, the read scorer or the cross-shard exchange
on one CUDA card and split each call's card time by kernel; or measure a
mode-C session's bytes a row.

    python3 tools/kernel_split.py [M ...]      (default 2^21 and 2^24)
    python3 tools/kernel_split.py reads
    python3 tools/kernel_split.py exchange [c ...]   (default 2^20 and 2^22)
    python3 tools/kernel_split.py chain [M[xS] ...]  (default 2^24 x 124)
    python3 tools/kernel_split.py memory
    python3 tools/kernel_split.py wrs

It runs whichever ``kmerlsh_tpu_torch`` comes first on the path, so that
two trees can be compared on one card in one session: put a tree's root
first on PYTHONPATH (its kernels then build inside that tree). The inputs
are chip_smoke.py phase 3's at M x 20: counts with the distribution of
bench.py make_data, the transform, the keys of the first iteration at the
data's h, and for finalize the state and forest after six iterations.
Prints, for each M: each call's time (chip_smoke.cuda_ms: CUDA events
around 10 back-to-back calls, median of 5), the card's time of one call by
kernel (torch.profiler; the key sorts as ``sort``), and the forest's depth.
``reads`` times score_reads on phase 3's part (2^16 reads of 150 bp, k =
31, 2^22 keys); in a tree with a key directory, the directory's build on
its own and the kernel with the directory built beforehand, at 16 to 22
directory bits (the kernel's masks equal the plain version's at each).
``exchange`` times one sharded exchange of rank 1 of four at c columns of
20 samples, e = 4096 (chip_smoke.py phase 3's local phase, then
testdata.exchange_inputs): exchange_window, exchange_fold, and
chain_collapse at the rank's base as the tree's sharded iteration calls it
(with the local fold where the tree folds there, and without; where its
chain_collapse takes the order, K2's move of the state included), and the
sum of one exchange's chain_collapse and exchange_fold. ``chain`` times K2,
the chain collapse and K9 at M x S (by default 2^24 x 124, the metahit124
cells' shape; 100000000x18 is the kostic18 cell's) on a session's first
iteration (fused in this tree, K2 then K3 in a parent tree), beside their
plain versions and bounds, in a tree with a chain session's row state also
its launches (K2's transpose into the rows, K1b and K3 on them) at the
engine's row width and at the scratch's sector-padded one where they
differ, beside the column K1b and K3, then K5 on the forest of a whole
session of the cells' schedule at that shape. ``wrs`` times
wrs_verdicts (checked against its plain version: verdicts exact, tails
within rtol 1e-5 / atol 1e-6) on testdata.wrs_rows at 2^20 x (10 + 10)
and 2^20 x (50 + 50) (chip_smoke.py phase 3's rows), at 2^18 x (300 +
300), and on the cluster rows of chip_smoke.py phase 6's clustering (its
count matrix remade from the same seeds, clustered by mode C through the
CLI, read back as mode E reads it), with the continued fraction's steps
where the tree counts them (``ttest.fraction_steps``): the mean a row, the
mean of the slowest row of each 32 consecutive rows, and that of each
warp's 32 rows after each block's sort by bucket of x. ``memory`` runs the
engine's ``cluster_counts`` at 2^16 to 2^24 columns of 20 samples, on
uniform random counts and on counts with the distribution of bench.py
make_data, with 3 and with 21 iterations, and prints each session's peak
of allocated memory above what was allocated before it, over its columns,
and the growth from the session of half its columns,
beside ``utils/hbm.measure_per_row_bytes``.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits where there is no card)

torch = cs.torch
from kmerlsh_tpu_torch import kernels, testdata  # noqa: E402
from kmerlsh_tpu_torch.cli import main as cli_main  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.io import clusterio  # noqa: E402
from kmerlsh_tpu_torch.ops import reads, rng, ttest  # noqa: E402
from kmerlsh_tpu_torch.utils import hbm  # noqa: E402

SCHEDULES = {
    "I = 3": np.asarray([0.95, 0.9, 0.85], np.float32),
    "I = 21": np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)]).astype(
        np.float32),
}


def split(fn) -> dict[str, float]:
    """ms of the card's time in one fn() by kernel name."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    by: dict[str, float] = {}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").split("(")[0]
            name = "sort" if "sort" in name.lower() else name
            by[name] = by.get(name, 0.0) + (e.time_range.end
                                            - e.time_range.start) * 1e-3
    return by


def host_ms(fn, calls: int = 50) -> float:
    """ms the host spends a call enqueuing fn() (after a synchronize; the
    card runs behind it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def report(what: str, M: int, fn) -> float:
    """Log fn's time a call, the host's time to enqueue one and its card
    time by kernel; returns the first."""
    by = split(fn)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(by.items(), key=lambda kv: -kv[1]))
    ms = cs.cuda_ms(fn)
    cs.log(f"{what} at {M}: {ms:.4f} ms a call (the host enqueues one in "
           f"{host_ms(fn):.4f} ms); card time of one call "
           f"{sum(by.values()):.4f} ms: {parts}")
    return ms


def measure(M: int) -> None:
    S, dev = cs.S, cs.DEV
    counts = torch.from_numpy(cs.make_counts(M, seed=1)).to(dev)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / M).float())
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    planes = rng.draw_hyperplanes(0, 0, S).to(dev)
    report(f"lsh_keys (h = {h})", M,
           lambda: kernels.lsh_keys(vt, sz, planes, h))
    sl = torch.arange(M, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(6):
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(dev),
            0.95 - 0.01 * it, engine._active_h_of(int((sz > 0).sum())))[:3]
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    args = (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)
    depth = getattr(testdata, "forest_depth", None)   # not in older trees
    forest = ("" if depth is None else
              ", forest {} deep at most, {:.3f} on average".format(
                  *depth(parent)))
    report(f"finalize ({na} clusters{forest})", M,
           lambda: kernels.finalize(*args))


def measure_reads() -> None:
    seqs, keys, _ = testdata.read_part(reads.READS_CAP, 1 << 22, k=cs.K_E,
                                       read_len=cs.READ_LEN, seed=4)
    part = [torch.from_numpy(a).to(cs.DEV)
            for a in reads.pack_part(seqs, cs.K_E)]
    dkeys = torch.from_numpy(keys.view(np.int64)).to(cs.DEV)
    args = (*part, dkeys, cs.K_E, 0.5)
    if not hasattr(kernels, "key_directory"):
        report("score_reads", len(seqs), lambda: kernels.score_reads(*args))
        return
    want = kernels.score_reads_plain(*args)
    chosen = kernels.key_directory_bits
    for bits in (16, 18, 20, 21, 22):
        kernels.key_directory_bits = lambda n, bits=bits: bits
        directory = kernels.key_directory(dkeys)
        if not torch.equal(kernels.score_reads(*args, directory), want):
            raise AssertionError(f"score_reads at {bits} bits differs")
        report(f"key_directory ({bits} bits)", len(keys),
               lambda: kernels.key_directory(dkeys))
        report(f"score_reads ({bits} bits)", len(seqs),
               lambda: kernels.score_reads(*args, directory))
    kernels.key_directory_bits = chosen


def _fused() -> bool:
    """Whether this tree's chain_collapse moves the state itself (takes
    the order), or takes K2's sorted copy (a parent tree's)."""
    import inspect

    return "order" in inspect.signature(kernels.chain_collapse).parameters


def _rows_at(W: int, vt, sz, sl, planes, h: int, order, skey, parent):
    """The row state's three launches at a row of W words, through the C
    entries (W = kernels.row_words(S) is what the engine runs; the
    scratch's sector-padded W the other width): (to_rows, the keys and
    projections, K3's rows and sizes, and a function of each that runs
    it again)."""
    S, M = vt.shape
    dev = vt.device
    move = kernels._move_plan(S, W, M, "rows")
    rows = torch.empty((M, W), dtype=torch.int32, device=dev)
    lp = kernels.lsh_plan(S, h, rows=True)
    keys = torch.empty(M, dtype=torch.int32, device=dev)
    proj = torch.empty(M, dtype=torch.float32, device=dev)
    minmax = torch.empty(2, dtype=torch.int32, device=dev)
    cp = (kernels.chain_plan(S, M, rows=True) if W == kernels.row_words(S)
          else kernels.chain_plan(S, M))
    if cp["W"] != W:
        raise ValueError(f"no K3 plan at W = {W}")
    status = torch.zeros(cp["blocks"] + 1, dtype=torch.int32, device=dev)
    agg = torch.empty(cp["blocks"] * (3 + S), dtype=torch.int32, device=dev)
    out = torch.empty_like(rows)
    osz = torch.empty(M, dtype=torch.int32, device=dev)

    def entry():
        kernels._launch("kl_state_rows", vt.data_ptr(), vt.stride(0), S, M,
                        sz.data_ptr(), sl.data_ptr(), W, move["cols"],
                        move["smem"], rows.data_ptr())

    def k1b():
        kernels._launch("kl_lsh_keys_rows", rows.data_ptr(), W, S, M,
                        planes.data_ptr(), sz.data_ptr(), h, lp["planes"],
                        lp["smem"], kernels.free_bits(h), keys.data_ptr(),
                        proj.data_ptr(), minmax.data_ptr())

    def k3():
        status.zero_()
        kernels._launch("kl_chain_collapse_rows", rows.data_ptr(), W, S, M,
                        order.data_ptr(), skey.data_ptr(), 0.95,
                        kernels.free_bits(h), cp["P"], cp["threads"],
                        cp["smem"], status.data_ptr(), agg.data_ptr(),
                        out.data_ptr(), osz.data_ptr(), parent.data_ptr(), 0)

    entry()
    k1b()
    k3()
    torch.cuda.synchronize()
    return rows, (keys, proj), (out, osz), (entry, k1b, k3)


def measure_rows(vt, sz, sl, planes, h: int, order, skey) -> None:
    """The row state's launches at a session's first iteration: K2's
    transpose into the rows, K1b and K3 on them, at the engine's row width
    and, where it differs (S = 18: 20 words against 24), at the scratch's
    sector-padded width, each checked against the other and K1b against
    the column K1b; beside the column K1b and K3 (its transpose too) and
    the bounds of the functions (K1b 4 S M + 12 M bytes or 2 S (h + 1) M
    operations, K3 8 S M + 24 M + 4 a dying slot)."""
    S, M = vt.shape
    widths = sorted({kernels.row_words(S), kernels.permute_plan(S, M)["W"]})
    col_keys = kernels.lsh_keys(vt, sz, planes, h)
    k1b_col = report("lsh_keys on columns (K1b)", M,
                     lambda: kernels.lsh_keys(vt, sz, planes, h))
    k3_col = report("chain_collapse on columns (K2's transpose + K3)", M,
                    lambda: kernels.chain_collapse(vt, sz, sl, order, skey,
                                                   0.95, h, None, sl.clone(),
                                                   merged=False))
    seen = None
    bound = 1e3 / cs.HBM_BYTES_PER_S
    for W in widths:
        parent = sl.clone()
        rows, keys, k3_out, (entry, k1b, k3) = _rows_at(
            W, vt, sz, sl, planes, h, order, skey, parent)
        same = (torch.equal(keys[0], col_keys[0])
                and torch.equal(keys[1], col_keys[1]))
        vals = kernels.rows_values(k3_out[0], S)
        if seen is not None:
            same = (same and torch.equal(k3_out[1], seen[0])
                    and torch.equal(vals, seen[1]))
        dying = int((k3_out[1] == 0).sum() - (sz == 0).sum())
        t = [report(f"{what} at W = {W}", M, fn) for what, fn in (
            ("to_rows (K2's transpose)", entry),
            ("lsh_keys_rows (K1b on rows)", k1b),
            ("chain_collapse_rows (K3 on rows)", k3))]
        k1b_bound = max((4 * S * M + 12 * M) * bound,
                        1e3 * 2 * S * (h + 1) * M / cs.F32_FLOPS)
        cs.log(f"rows at {M} x {S}, W = {W} ({4 * W * M} bytes of rows, h = "
               f"{h}, {dying} slots die): keys equal the column K1b's and "
               f"K3 the other width's: {same}; to_rows {t[0]:.4f} ms, K1b "
               f"{t[1]:.4f} (columns {k1b_col:.4f}, bound {k1b_bound:.4f}), "
               f"K3 {t[2]:.4f} (columns with its transpose {k3_col:.4f}, "
               f"bound {(8 * S * M + 24 * M + 4 * dying) * bound:.4f}); an "
               f"iteration's K1b + K3 {t[1] + t[2]:.4f} against "
               f"{k1b_col + k3_col:.4f} ms")
        if seen is None:
            seen = (k3_out[1], vals.clone())
        del rows, keys, k3_out, vals
        torch.cuda.empty_cache()


def measure_chain(M: int, s: int = cs.CELL_S) -> None:
    """K2, K3 and K9 where a benchmark cell runs them first: a session's
    first iteration at M x s (testdata.session_input, seed 11; h of the
    alive count, the planes of iteration 0, 0.95, the parent fold). K2
    (permute_state) alone; the chain collapse as the tree calls it (fused:
    K2's transpose and K3's staging by the order; a parent tree: K2 then
    K3 on its sorted copy, and K3 alone); the plain versions; K9 on the
    iteration's keys; the bounds of the functions
    (benchmark/harness/roofline.py's counts: K2 8 S M + 20 M bytes, K3 8 S
    M + 24 M + 4 a dying slot, K9 12 a key). Then K5 on the forest of a
    whole session at M x s (the cells' schedule, seed 11), exact against
    its plain version (chip_smoke.finalize_checked)."""
    dev = cs.DEV
    counts, v = testdata.session_input(M, s, 11, dev)
    vt, sz = kernels.abundance_transform(counts, torch.from_numpy(v).to(dev))
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    planes = rng.draw_hyperplanes(11, 0, s).to(dev)
    key, _ = kernels.lsh_keys(vt, sz, planes, h)
    skey, order = kernels.sort_keys(key, 31)
    sl = torch.arange(M, dtype=torch.int32, device=dev)
    if hasattr(kernels, "chain_collapse_rows"):
        measure_rows(vt, sz, sl, planes, h, order, skey)
    parent = sl.clone()
    k2_bytes = 8 * s * M + 20 * M
    k2 = report("permute_state (K2)", M,
                lambda: kernels.permute_state(vt, sz, sl, order))
    sv, ss, ssl = kernels.permute_state(vt, sz, sl, order)
    if _fused():
        k = kernels.chain_collapse(vt, sz, sl, order, skey, 0.95, h, None,
                                   parent)
        fused = report("chain_collapse, fused (K2's transpose + K3)", M,
                       lambda: kernels.chain_collapse(
                           vt, sz, sl, order, skey, 0.95, h, None, parent))
    else:
        k = kernels.chain_collapse(sv, ss, ssl, skey, 0.95, h, None, parent)
        k3 = report("chain_collapse on K2's sorted copy (K3)", M,
                    lambda: kernels.chain_collapse(sv, ss, ssl, skey, 0.95,
                                                   h, None, parent))
        fused = report("permute_state + chain_collapse (K2 + K3)", M,
                       lambda: kernels.chain_collapse(
                           *kernels.permute_state(vt, sz, sl, order), skey,
                           0.95, h, None, parent))
        cs.log(f"K2 + K3 at {M} x {s}: {k2:.4f} + {k3:.4f} = "
               f"{k2 + k3:.4f} ms")
    pp = torch.arange(M, dtype=torch.int32, device=dev)
    p = kernels.chain_collapse_plain(sv, ss, ssl, skey, 0.95, h, None, pp)
    same = all(torch.equal(a, b) for a, b in zip((*k[1:], parent),
                                                  (*p[1:], pp)))
    gap = float((k[0] - p[0]).abs().max())
    dying = int((k[3] >= 0).sum())
    del k, p
    k2_plain = cs.cuda_ms(
        lambda: kernels.permute_state_plain(vt, sz, sl, order), 3, 1)
    k3_plain = cs.cuda_ms(lambda: kernels.chain_collapse_plain(
        sv, ss, ssl, skey, 0.95, h, None, pp.clone()), 3, 1)
    k3_bytes = 8 * s * M + 24 * M + 4 * dying
    bound = 1e3 / cs.HBM_BYTES_PER_S
    cs.log(f"chain at {M} x {s} (h = {h}, {dying} slots die): ints and "
           f"parent exact against the plain collapse of the sorted state: "
           f"{same}, centroids within {gap:.3g}; K2 kernel {k2:.4f} / plain "
           f"{k2_plain:.4f} / bound {k2_bytes * bound:.4f} ms; K2 + K3 "
           f"{fused:.4f} / plain {k2_plain + k3_plain:.4f} (K3's "
           f"{k3_plain:.4f}) / bound {(k2_bytes + k3_bytes) * bound:.4f} ms "
           f"(K3's {k3_bytes * bound:.4f})")
    k9 = report("sort_keys (K9, 31 bits)", M,
                lambda: kernels.sort_keys(key, 31))
    k9_plain = cs.cuda_ms(lambda: kernels.sort_keys_plain(key, 31), 3, 1)
    cs.log(f"K9 at {M}: {k9:.4f} ms / plain {k9_plain:.4f} / bound "
           f"{12 * M * bound:.4f} ms")
    del vt, sz, sl, parent, pp, key, skey, order, sv, ss, ssl
    torch.cuda.empty_cache()
    counts, v = testdata.session_input(M, s, 11, dev)
    seen, real = [], kernels.finalize

    def capture(*args):
        seen.append(args)
        return real(*args)

    kernels.finalize = capture
    try:
        engine.cluster_counts(counts, v, cs.CELL_THR, seed=11, n=M)
    finally:
        kernels.finalize = real
    del counts
    args, = seen
    res, _ = cs.finalize_checked(*args)
    cs.log(f"finalize at {M} x {s} ({args[0].shape[1]} clusters of a "
           f"session): exact against its plain version, kernel "
           f"{res['ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  bound "
           f"{res['bound_ms']:.4f} ms ({res['bound_by']})")


def measure_exchange(c: int) -> None:
    import inspect

    S, dev, e = cs.S, cs.DEV, 4096
    counts = torch.from_numpy(cs.make_counts(c, seed=1)).to(dev)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / c).float())
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    key, _ = kernels.lsh_keys(vt, sz, rng.draw_hyperplanes(0, 0, S).to(dev), h)
    skey, order = (kernels.sort_keys(key, 31) if hasattr(kernels, "sort_keys")
                   else torch.sort(key, stable=True))   # a parent tree's
    sl = torch.arange(c, dtype=torch.int32, device=dev)
    if _fused():   # K3 takes the state and the order
        state = (vt, sz)
        local = kernels.chain_collapse(vt, sz, sl, order, skey, 0.95, h)
    else:          # a parent tree's K3 takes K2's sorted copy
        vt, sz, sl = kernels.permute_state(vt, sz, sl, order)
        state = (vt, sz)
        local = kernels.chain_collapse(vt, sz, sl, skey, 0.95, h)
    (*glob, w_slots, pos, lv, ls, lsl, lmi, parent,
     base) = testdata.exchange_inputs(*local, 4, 1, e)
    slb = sl + base
    rest = (order, skey) if _fused() else (skey,)
    values, sizes, slots, _ = local
    report("exchange_window", c,
           lambda: kernels.exchange_window(values, sizes, slots, e, 1))
    bare = report("chain_collapse without the fold", c,
                  lambda: kernels.chain_collapse(*state, slb, *rest, 0.95,
                                                 h))
    # the fold and the write-back run in place: each call writes the same
    # entries again
    if "mi" in inspect.signature(kernels.exchange_fold).parameters:
        k3 = bare   # this tree folds the local merges in exchange_fold
        fold = report("exchange_fold (local and global merges)", c,
                      lambda: kernels.exchange_fold(*glob, w_slots, pos, lv,
                                                    ls, lsl, lmi, parent,
                                                    base))
    else:
        k3 = report("chain_collapse with the local fold", c,
                    lambda: kernels.chain_collapse(*state, slb, *rest, 0.95,
                                                   h, None, parent, base))
        fold = report("exchange_fold (global merges)", c,
                      lambda: kernels.exchange_fold(*glob, w_slots, pos, lv,
                                                    ls, parent, base))
    cs.log(f"one exchange at {c}: chain_collapse as the sharded iteration "
           f"calls it {k3:.4f} + exchange_fold {fold:.4f} = "
           f"{k3 + fold:.4f} ms")


def phase6_rows() -> tuple[np.ndarray, np.ndarray]:
    """The cluster rows and sizes of chip_smoke.py phase 6's clustering:
    its 2^24 x 20 count matrix made from the same seeds (the k-mers of
    random 150-bp sources, one abundance profile a source, 3% shifted up in
    each group), clustered by mode C through the CLI (-K 31 -I 20 -N 0.8
    --seed 0) and read back as mode E reads it."""
    S, n_w = cs.S, cs.READ_LEN - cs.K_E + 1
    r = np.random.default_rng(7)
    n_src = -(-cs.FULL // n_w)
    r.integers(0, 4, size=(n_src, cs.READ_LEN), dtype=np.uint8)  # sources
    pool = testdata.profile_pool(r, max(64, cs.FULL >> 7), S)
    prof = pool[r.integers(0, len(pool), size=n_src)]
    kind = r.random(n_src)
    prof[kind < 0.03, :S // 2] += 0.6
    prof[(kind >= 0.03) & (kind < 0.06), S // 2:] += 0.6
    g = torch.Generator(device=cs.DEV).manual_seed(7)
    rows = torch.arange(cs.FULL, device=cs.DEV) // n_w
    counts = cs.counts_of(torch.from_numpy(prof.T.copy()).to(cs.DEV), rows, g)
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_matrix(tmp, counts)
        del counts
        clust = os.path.join(tmp, "result.txt")
        cli_main(["-a", os.path.join(tmp, "l1"), "-b", os.path.join(tmp, "l2"),
                  "--only", "-M", "C", "-I", "20", "-N", "0.8", "--seed", "0",
                  "-K", str(cs.K_E), "--work-dir", tmp, "-F", clust, "-D",
                  os.path.join(tmp, "tmp")])
        values, ids = clusterio.read_cluster_all(clust, S)
    return values, ids.sizes.astype(np.int32)


def sorted_warp_steps(v: torch.Tensor, n: int, steps: torch.Tensor) -> float:
    """The mean over warps of their slowest row's steps when, as in
    csrc/ttest.cu, each block's rows that need the fraction are sorted by
    the bucket of their x (kernels.WRS_BUCKETS a pair) and each warp takes
    32 of them in that order (the block's rows as kernels.wrs_plan gives
    them)."""
    _, _, ok, stat, df = ttest._statistic(v, n, n)
    x = df / (df + stat * stat)
    a = df / 2.0
    thr = (a + 1.0) / (a + 0.5 + 2.0)
    rapid = x < thr
    xx = torch.where(rapid, x, 1.0 - x)
    K = kernels.WRS_BUCKETS
    u = xx / torch.where(rapid, thr, 1.0 - thr)
    key = (torch.where(rapid, 0, K)
           + torch.clamp((u * K).to(torch.int64), 0, K - 1))
    rows = kernels.wrs_plan(len(v), 2 * n, 2 * n, 0)["tile_rows"]
    idx = torch.nonzero(ok).flatten()
    block = idx // rows
    order = torch.argsort(block * 2 * K + key[idx], stable=True)
    block, s = block[order], steps[idx[order]]
    first = torch.searchsorted(block, block)   # the block's first entry
    batch = block * (rows // 32) + (torch.arange(len(s), device=s.device)
                                    - first) // 32
    most = torch.zeros(int(batch.max()) + 1, dtype=s.dtype, device=s.device)
    most.scatter_reduce_(0, batch, s, "amax")
    return float(most[torch.unique(batch)].double().mean())


def measure_wrs() -> None:
    cases = [(f"{N} rows of {n} + {n}", *testdata.wrs_rows(N, n, n, seed=3), n)
             for N, n in ((cs.SMALL, cs.S // 2), (cs.SMALL, 50),
                          (cs.SMALL >> 2, 300))]
    cases.append(("phase 6's clusters", *phase6_rows(), cs.S // 2))
    for what, values, sizes, n in cases:
        v = torch.from_numpy(values).to(cs.DEV)
        sz = torch.from_numpy(sizes).to(cs.DEV)
        args = (v, sz, n, n, 0.01, 5)
        k = kernels.wrs_verdicts(*args)
        p = kernels.wrs_verdicts_plain(*args)
        if not torch.equal(k[0], p[0]):
            raise AssertionError(f"wrs_verdicts on {what}: verdicts differ")
        for a, b in zip(k[1:], p[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        report(f"wrs_verdicts on {what}", len(values),
               lambda: kernels.wrs_verdicts(*args))
        if hasattr(ttest, "fraction_steps"):   # not in older trees
            steps = ttest.fraction_steps(v, n, n)
            cs.log(f"wrs_verdicts on {what}: " + cs.step_stats(steps)
                   + "; sorted by bucket in each block, the slowest of a "
                   f"warp's rows {sorted_warp_steps(v, n, steps):.3f} on "
                   "average")
        del v, sz, k, p


def session_peak(counts, v, thr) -> int:
    torch.cuda.synchronize(cs.DEV)
    base = torch.cuda.memory_allocated(cs.DEV)
    torch.cuda.reset_peak_memory_stats(cs.DEV)
    engine.cluster_counts(counts, v, thr, device=cs.DEV)
    torch.cuda.synchronize(cs.DEV)
    return torch.cuda.max_memory_allocated(cs.DEV) - base


def measure_memory() -> None:
    cs.log(f"measure_per_row_bytes({cs.S}): "
           f"{hbm.measure_per_row_bytes(cs.S, cs.DEV)}")
    rng_ = np.random.default_rng(0)
    for data in ("uniform", "make_data"):
        prev: dict[str, int] = {}
        for e in range(16, 25):
            cap = 1 << e
            if data == "uniform":
                counts = rng_.integers(1, 100, size=(cs.S, cap)).astype(
                    np.uint16)
                v = np.zeros(cs.S, np.float32)
            else:
                counts = cs.make_counts(cap, seed=1)
                v = (np.log(np.maximum(counts, 1).astype(np.float64)).sum(1)
                     / cap).astype(np.float32)
            parts = []
            for name, thr in SCHEDULES.items():
                peak = session_peak(counts, v, thr)
                grow = ((peak - prev[name]) / (cap // 2) if name in prev
                        else float("nan"))
                prev[name] = peak
                parts.append(f"{name}: peak {peak} = {peak / cap:.3f} a row, "
                             f"{grow:.3f} a row more than at {cap // 2}")
            cs.log(f"{data} at {cap}: " + "; ".join(parts))


def main() -> None:
    cs.log(f"kmerlsh_tpu_torch from {os.path.dirname(kernels.__file__)}")
    if sys.argv[1:] in (["reads"], ["memory"], ["wrs"]):
        {"reads": measure_reads, "memory": measure_memory,
         "wrs": measure_wrs}[sys.argv[1]]()
        return
    if sys.argv[1:2] == ["chain"]:
        for shape in sys.argv[2:] or [str(cs.FULL)]:
            M, _, s = shape.partition("x")
            measure_chain(int(M), int(s or cs.CELL_S))
        return
    if sys.argv[1:2] == ["exchange"]:
        for c in [int(a) for a in sys.argv[2:]] or [1 << 20, 1 << 22]:
            measure_exchange(c)
        return
    for M in [int(a) for a in sys.argv[1:]] or [cs.LATE, cs.FULL]:
        measure(M)


if __name__ == "__main__":
    main()
