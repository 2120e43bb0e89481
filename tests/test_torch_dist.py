"""The port's sharded path (kmerlsh_tpu_torch/parallel) against the JAX
package's (kmerlsh_tpu/parallel/dist.py on the suite's virtual devices).

The exchange kernels' plain versions are held to the reference exactly. The
sharded cases of tests/test_dist.py run on D = 2 and 4 gloo ranks on the CPU:
one spawn of D processes per D runs every case (``WORKER``), and each rank
returns its result, so the tests also hold the ranks to one another. Both
spawns and the reference's side of the same cases, one process per device
count, run side by side (``runs``): the file takes 49 s alone on an 8-core
CPU, 41 s of it in that fixture."""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.ops import ttest as jttest
from kmerlsh_tpu.parallel import dist as jdist, mesh as jmeshlib
from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import ttest
from kmerlsh_tpu_torch.parallel import dist, mesh as meshlib

from test_torch_session import bench_counts, partition_of, same_partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- inputs, made with numpy from seeds (the cases of tests/test_dist.py) ---

def planted(rng, n_clusters, members, S, noise=0.01):
    centers = rng.normal(size=(n_clusters, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows, labels = [], []
    for c in range(n_clusters):
        rows.append((centers[c] + noise * rng.normal(size=(members, S)))
                    .astype(np.float32))
        labels += [c] * members
    rows = np.concatenate(rows)
    perm = rng.permutation(len(rows))
    return rows[perm], np.asarray(labels)[perm]


def hierarchy_rows(n, S=16, seed=0):
    """The anneal-sensitive 3-level hierarchy of test_dist.py, n rows."""
    rng = np.random.default_rng(seed)
    cur = rng.normal(size=(max(n >> 7, 8), S)).astype(np.float32)
    cur /= np.linalg.norm(cur, axis=1, keepdims=True)
    nodes = [cur]
    for lev in range(3):
        cos = 0.93 - 0.04 * lev
        sin = np.sqrt(1 - cos * cos)
        kids = []
        for sgn in (1.0, -1.0):
            orth = rng.normal(size=cur.shape).astype(np.float32)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
        cur = np.concatenate(kids)
        nodes.append(cur)
    pool = np.concatenate(nodes)
    rows = rng.integers(0, len(pool), size=n)
    return pool[rows] + 0.01 * rng.standard_normal((n, S)).astype(np.float32)


def gamma_counts():
    rng = np.random.default_rng(5)
    S, n_prof, reps = 10, 8, 40
    prof = rng.gamma(2.0, 20.0, size=(n_prof, S))
    rows = np.repeat(np.arange(n_prof), reps)
    counts = np.ascontiguousarray(
        np.minimum(rng.poisson(prof[rows]), 65535).astype(np.uint16).T)
    v = (np.log(np.maximum(counts, 1)).sum(axis=1) / counts.shape[1]).astype(
        np.float32)
    return counts, v


ANNEAL = (0.95 - (0.15 / 20) * np.arange(20)).astype(np.float32)
# bench.py's schedule for -I 20 -N 0.8: the first threshold, then the anneal
HIER_THR = np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)]).astype(
    np.float32)
FRAG_N = 1 << 16        # the fragmentation bound's rows (2^18 in JAX's test)
TERMINAL_N = 1 << 14    # the terminal-rounds fallback's rows (2^16 there)
HIER_N = 1 << 14
GATHER_E, GATHER_C = 256, 1 << 15   # window, per-rank capacity


def wrs_inputs():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(64, 8)).astype(np.float32)
    vals[5, :4] += 4
    vals[9, 4:] += 4
    sizes = rng.integers(1, 100, size=64).astype(np.int32)
    big_v, big_s = testdata.wrs_rows(4000, 10, 10, seed=11)
    return (vals, sizes, 4, 4, 0.01, 20), (big_v, big_s, 10, 10, 0.01, 5)


def one_chunk_state(D):
    """A planted global state [S, D·c] with slot and parent arrays, for
    one chunk of four iterations from the same state in both packages."""
    X, _ = planted(np.random.default_rng(8), 8, 30, 12, noise=0.005)
    c = dist._local_cap(len(X), D)
    vt = np.zeros((12, D * c), np.float32)
    vt[:, :len(X)] = X.T
    sizes = np.zeros(D * c, np.int32)
    sizes[:len(X)] = 1
    slots = np.arange(D * c, dtype=np.int32)
    return vt, sizes, slots, slots.copy()


def cases(D):
    """Every call the ranks make: name → (function, args, kwargs)."""
    cs, c_thr = gamma_counts(), (0.95 - 0.0075 * np.arange(20)).astype(
        np.float32)
    hier, hv = bench_counts(HIER_N)
    dup = np.random.default_rng(2)
    base = dup.normal(size=16).astype(np.float32)
    dups = np.tile(base, (64, 1)) + 1e-4 * dup.normal(size=(64, 16)).astype(
        np.float32)
    wrs_small, wrs_big = wrs_inputs()
    gather_rows = np.random.default_rng(6).normal(
        size=(D * GATHER_C, 16)).astype(np.float32)
    out = {
        "planted": ("cluster_sharded",
                    (planted(np.random.default_rng(0), 10, 24, 16)[0],),
                    dict(min_similarity=0.90, iterations=25, seed=3)),
        "vs_single": ("cluster_sharded",
                      (planted(np.random.default_rng(1), 6, 20, 12,
                               noise=0.005)[0],),
                      dict(min_similarity=0.9, iterations=20, seed=2)),
        "cross_shard": ("cluster_sharded", (dups,),
                        dict(min_similarity=0.9, iterations=10, seed=0)),
        "overflow": ("cluster_sharded",
                     (planted(np.random.default_rng(4), 6, 16, 12,
                              noise=0.003)[0],),
                     dict(min_similarity=0.92, iterations=40, seed=1,
                          exchange_cap=1)),
        "counts": ("cluster_counts_sharded", (cs[0], cs[1], c_thr),
                   dict(seed=7)),
        "gather_bound": ("cluster_sharded", (gather_rows,),
                         dict(thresholds=np.full(2, 0.99, np.float32),
                              exchange_cap=GATHER_E)),
        "frag": ("cluster_sharded", (hierarchy_rows(FRAG_N),),
                 dict(thresholds=ANNEAL, seed=0)),
        "terminal": ("cluster_sharded", (hierarchy_rows(TERMINAL_N, seed=1),),
                     dict(thresholds=ANNEAL, seed=0, HANDOFF_CAP=1)),
        "no_tail": ("cluster_sharded",
                    (planted(np.random.default_rng(0), 10, 24, 16)[0],),
                    dict(min_similarity=0.90, iterations=25, seed=3,
                         HANDOFF_CAP=1, NO_TAIL=True)),
        "hier": ("cluster_counts_sharded", (hier, hv, HIER_THR), dict(seed=0)),
        "wrs_small": ("sharded_wrs", wrs_small, {}),
        "wrs_big": ("sharded_wrs", wrs_big, {}),
        "one_chunk": ("one_chunk", one_chunk_state(D),
                      dict(thresholds=(0.95 - 0.01 * np.arange(4)).astype(
                          np.float32), seed=4, e=32)),
    }
    if D == 4:
        out["hier_terminal"] = ("cluster_counts_sharded", (hier, hv, HIER_THR),
                                dict(seed=0, HANDOFF_CAP=1))
    return out


def jax_references(D):
    """The reference's side of the cases that compare with it, on D of the
    suite's virtual devices, with the float32 payload permute."""
    saved = jengine.PERMUTE, jdist.HANDOFF_CAP
    jengine.PERMUTE = "payload_sort"
    try:
        m = jmeshlib.make_mesh(D)
        X, _ = planted(np.random.default_rng(0), 10, 24, 16)
        out = {"planted": jdist.cluster_sharded(
            X, mesh=m, min_similarity=0.90, iterations=25, seed=3)}
        if D == 1:
            return out
        counts, v = bench_counts(HIER_N)
        out["hier"] = jdist.cluster_counts_sharded(counts, v, HIER_THR,
                                                   mesh=m, seed=0)
        vt, sizes, slots, parent = one_chunk_state(D)
        chunk = jdist._dist_programs(m, 32, "payload_sort")[2]
        thr = (0.95 - 0.01 * np.arange(4)).astype(np.float32)
        res = chunk(jdist.shard_cols(m, vt), jdist.shard_rows(m, sizes),
                    jdist.shard_rows(m, slots), jdist.shard_rows(m, parent),
                    jax.random.PRNGKey(4), jnp.asarray(thr), jnp.int32(0))
        out["one_chunk"] = np.asarray(res[1]), np.asarray(res[3])
        if D == 4:
            jdist.HANDOFF_CAP = 1
            out["hier_terminal"] = jdist.cluster_counts_sharded(
                counts, v, HIER_THR, mesh=m, seed=0)
        return out
    finally:
        jengine.PERMUTE, jdist.HANDOFF_CAP = saved


# One rank: runs every case of the input file and pickles its results.
WORKER = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as tdist

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
from kmerlsh_tpu_torch.ops import rng
from kmerlsh_tpu_torch.parallel import dist, mesh as meshlib

m = meshlib.make_mesh("cpu")
res = {}
# each session's gathered state and tail schedule, as its ending takes them
ending, drive, tail_schedule = {}, dist._drive, dist._tail_schedule


def spy_drive(*a, **kw):
    ending["state"], rest = drive(*a, **kw)
    return ending["state"], rest


def spy_tail(*a, **kw):
    ending["tail"] = None if no_tail else tail_schedule(*a, **kw)
    return ending["tail"]


dist._drive, dist._tail_schedule = spy_drive, spy_tail
for name, (fn, args, kw) in pickle.load(open(inp, "rb")).items():
    kw = dict(kw)
    no_tail = kw.pop("NO_TAIL", False)
    handoff = kw.pop("HANDOFF_CAP", None)
    saved = dist.HANDOFF_CAP
    if handoff is not None:
        dist.HANDOFF_CAP = handoff
    if fn == "sharded_wrs":
        vals, sizes, n1, n2, p, st = args
        pad = -len(vals) % world
        vp = np.pad(vals, ((0, pad), (0, 0)))
        sp = np.pad(sizes, (0, pad))
        got = dist.sharded_wrs(m, n1, n2, p, st)(dist.shard_rows(m, vp),
                                                 dist.shard_rows(m, sp))
        res[name] = got[:len(vals)]
    elif fn == "one_chunk":
        vt, sz, sl, par = dist.shard_state_from_numpy(*args, rank, world,
                                                      "cpu")
        na = m.all_sum(int((sz > 0).sum()))
        for it, thr in enumerate(kw["thresholds"]):
            planes = rng.draw_hyperplanes(kw["seed"], it, vt.shape[0])
            vt, sz, sl, na = dist._one_dist_iteration(
                m, vt, sz, sl, par, na, planes, float(thr), it, kw["e"],
                par.shape[0])
        res[name] = tuple(dist.gather_np(t, m, dim=d) for t, d in
                          ((vt.contiguous(), 1), (sz, 0), (sl, 0), (par, 0)))
    else:
        cents, sizes, members = getattr(dist, fn)(*args, mesh=m, **kw)
        n_rows = args[0].shape[0 if fn == "cluster_sharded" else 1]
        res[name] = (cents, sizes, members.flat, members.offsets,
                     dict(dist.LAST_SESSION),
                     dict(ending, n_rows=n_rows, seed=kw.get("seed", 0))
                     if rank == 0 else None)
    dist.HANDOFF_CAP = saved
pickle.dump(res, open(out, "wb"))
tdist.destroy_process_group()
"""


# The reference's side on D virtual devices, in a process of its own.
REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_dist
pickle.dump(test_torch_dist.jax_references(int(sys.argv[2])),
            open(sys.argv[3], "wb"))
"""


def _start(argvs, outs, env):
    """One process per argv, output to <out>.log, not waited for."""
    procs = []
    for argv, out in zip(argvs, outs):
        with open(out + ".log", "w") as log:
            procs.append(subprocess.Popen(argv, stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
    return procs, outs


def _collect(procs, outs):
    """Each process's <out>.pkl, once every one has exited 0."""
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, p in zip(outs, procs):
        assert p.returncode == 0, \
            f"{out} failed:\n{open(out + '.log').read()[-3000:]}"
    return [pickle.load(open(o + ".pkl", "rb")) for o in outs]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def start_ranks(D, work, case_set):
    """D worker processes in one gloo group, started and not waited for."""
    inp = os.path.join(work, "cases.pkl")
    with open(inp, "wb") as f:
        pickle.dump(case_set, f)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    outs = [os.path.join(work, f"rank{r}") for r in range(D)]
    return _start([[sys.executable, script, str(r), str(D), port, inp,
                    outs[r] + ".pkl"] for r in range(D)], outs, _env())


def start_reference(D, work):
    out = os.path.join(work, f"reference{D}")
    return _start([[sys.executable, "-c", REFERENCE,
                    os.path.dirname(os.path.abspath(__file__)), str(D),
                    out + ".pkl"]], [out], _env())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """D → (every rank's results, the reference's) for D = 2 and 4, and
    the reference's one-device mesh under 1. The spawns and the reference
    run side by side, each in processes of its own."""
    work = str(tmp_path_factory.mktemp("runs"))
    started = {D: start_ranks(D, str(tmp_path_factory.mktemp(f"d{D}")),
                              cases(D)) for D in (2, 4)}
    refs = {D: start_reference(D, work) for D in (1, 2, 4)}
    try:
        got = {D: _collect(*started[D]) for D in (2, 4)}
        ref = {D: _collect(*refs[D])[0] for D in (1, 2, 4)}
    finally:
        for procs, _ in (*started.values(), *refs.values()):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {1: (None, ref[1]), **{D: (got[D], ref[D]) for D in (2, 4)}}


@pytest.fixture(params=[2, 4], ids=["D2", "D4"])
def ranks(request, runs):
    D = request.param
    return D, runs[D][0]


@pytest.fixture(params=[2, 4], ids=["D2", "D4"])
def ranks_and_jax(request, runs):
    D = request.param
    return (D, *runs[D])


def groups_of(r):
    from kmerlsh_tpu_torch.cluster.groups import Groups
    return Groups(r[2], r[3])


# --- K8a / K8b plain versions against the reference, exactly -------------------

@pytest.mark.parametrize("n_alive", [0, 5, 64, 200, 1000])
@pytest.mark.parametrize("rot", [0, 3])
def test_exchange_window_plain_matches_reference(n_alive, rot):
    """n_local below, equal to and above e = 64, and an all-padding window."""
    r = np.random.default_rng(n_alive + rot)
    c, e, S = 1024, 64, 5
    sizes = np.zeros(c, np.int32)
    sizes[r.choice(c, size=n_alive, replace=False)] = r.integers(
        1, 9, size=n_alive)
    slots = (r.permutation(c) + 3 * c).astype(np.int32)
    vals = r.normal(size=(S, c)).astype(np.float32)
    pos, wv, ws, wsl = kernels.exchange_window_plain(
        torch.from_numpy(vals), torch.from_numpy(sizes),
        torch.from_numpy(slots), e, rot)
    jpos, jvalid = jdist._window_positions(jnp.asarray(sizes > 0), e,
                                           jnp.int32(rot))
    jpos, jvalid = np.asarray(jpos), np.asarray(jvalid)
    posc = np.minimum(jpos, c - 1)
    assert np.array_equal(pos.numpy(), jpos)
    assert np.array_equal(pos.numpy() < c, jvalid)
    assert np.array_equal(wv.numpy(), vals[:, posc])
    assert np.array_equal(ws.numpy(), np.where(jvalid, sizes[posc], 0))
    assert np.array_equal(wsl.numpy(), np.where(jvalid, slots[posc], -1))
    assert int((pos < c).sum()) == min(n_alive, e)


def _synthetic_exchange(D, rank, c, e, S, seed):
    """D shards through the plain local phase (hash, sort, chain collapse
    at 0.9), their windows gathered, and the replicated global phase
    through the plain kernels: (the global result, g_slots, this rank's
    window, its sorted state before the local collapse and after it,
    parent, base)."""
    r = np.random.default_rng(seed)
    c0 = c
    planes = torch.from_numpy(r.normal(size=(S, 31)).astype(np.float32))
    # a few profiles shared by the shards, so that the global phase merges
    # across shards; noise enough that the local phase leaves survivors
    prof = r.normal(size=(8, S)).astype(np.float32)
    wins, pre, local = [], None, None
    for d in range(D):
        n_alive = [0, e // 2, e, 3 * e][(d + seed) % 4]
        sizes = np.zeros(c, np.int32)
        sizes[r.choice(c, size=min(n_alive, c), replace=False)] = (
            r.integers(1, 9, size=min(n_alive, c)))
        vals = (prof[r.integers(0, 8, size=c)].T
                + 0.3 * r.normal(size=(S, c))).astype(np.float32)
        slots = (r.permutation(c) + d * c0).astype(np.int32)
        t = [torch.from_numpy(a) for a in (vals, sizes, slots)]
        key, _ = kernels.lsh_keys_plain(t[0], t[1], planes, 2)
        skey, order = torch.sort(key, stable=True)
        sorted_d = (*kernels.permute_state_plain(*t, order), skey)
        st = kernels.chain_collapse_plain(*sorted_d, 0.9, 2)
        wins.append(kernels.exchange_window_plain(st[0], st[1], st[2], e,
                                                  seed))
        if d == rank:
            pre, local = sorted_d, st
    g_vals = torch.cat([w[1] for w in wins], dim=1)
    g_sizes = torch.cat([w[2] for w in wins])
    g_slots = torch.cat([w[3] for w in wins])
    key, _ = kernels.lsh_keys_plain(g_vals, g_sizes, planes, 2)
    skey, order = torch.sort(key, stable=True)
    gv, gs, gsl = kernels.permute_state_plain(g_vals, g_sizes, g_slots, order)
    m = kernels.chain_collapse_plain(gv, gs, gsl, skey, 0.9, 2)
    parent = torch.from_numpy(
        (rank * c0 + r.permutation(c0)).astype(np.int32))
    return m, g_slots, wins[rank], pre, local, parent, rank * c0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("D,rank", [(1, 0), (4, 0), (4, 3)])
def test_exchange_fold_plain_matches_reference(D, rank, seed):
    """The local phase's fold (chain_collapse_plain with the parent shard
    and its base) and then the plain exchange fold, against a numpy
    transcription of dist.py:112-113 and 134-157 with the reference's
    _realign_to."""
    c, e, S = 512, 64, 6
    (m_vals, m_sizes, m_scs, m_mi), g_slots, win, pre, local, parent, base = \
        _synthetic_exchange(D, rank, c, e, S, seed)
    vals, sizes, slots, mi = (t.clone() for t in local)
    pos = win[0]
    assert D == 1 or int((m_mi >= 0).sum()) > 0    # the global phase merged

    # the reference, in numpy
    want_par = parent.numpy().copy()
    li = slots.numpy() - base
    want_par[li] = np.where(mi.numpy() >= 0, mi.numpy(), want_par[li])
    sel = np.asarray(jdist._realign_to(jnp.asarray(g_slots.numpy()),
                                       jnp.asarray(m_scs.numpy())))
    r_vals, r_sizes, r_mi = (m_vals.numpy()[:, sel], m_sizes.numpy()[sel],
                             m_mi.numpy()[sel])
    gi = g_slots.numpy().astype(np.int64) - base
    ok = (r_mi >= 0) & (gi >= 0) & (gi < c)
    want_par[gi[ok]] = r_mi[ok]
    want_vals, want_sizes = vals.numpy().copy(), sizes.numpy().copy()
    keep = pos.numpy() < c
    p = pos.numpy()[keep]
    want_vals[:, p] = r_vals[:, rank * e:(rank + 1) * e][:, keep]
    want_sizes[p] = r_sizes[rank * e:(rank + 1) * e][keep]

    again = kernels.chain_collapse_plain(*pre, 0.9, 2, None, parent, base)
    assert all(torch.equal(a, b) for a, b in zip(again, local))
    kernels.exchange_fold_plain(m_vals, m_sizes, m_mi, m_scs, win[3], pos,
                                vals, sizes, parent, base)
    assert np.array_equal(parent.numpy(), want_par)
    assert np.array_equal(sizes.numpy(), want_sizes)
    assert np.array_equal(vals.numpy(), want_vals)


def test_exchange_fold_drops_padding_and_foreign_slots():
    """Padding and other ranks' entries never touch the parent shard: the
    reference's fix for writes masked onto index 0 (dist.py:141-147)."""
    c, e, S, base = 8, 4, 2, 100
    parent = torch.arange(base, base + c, dtype=torch.int32)
    # global result: one foreign slot merged, padding with mi >= 0 planted
    m_vals = torch.zeros((S, 2 * e))
    m_sizes = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    m_scs = torch.tensor([7, -1, -1, -1, 103, -1, -1, -1], dtype=torch.int32)
    m_mi = torch.tensor([5, 0, 0, 0, -1, 0, 0, 0], dtype=torch.int32)
    w_slots = torch.tensor([103, -1, -1, -1], dtype=torch.int32)
    pos = torch.tensor([2, c, c, c], dtype=torch.int32)
    vals, sizes = torch.ones((S, c)), torch.ones(c, dtype=torch.int32)
    kernels.exchange_fold_plain(m_vals, m_sizes, m_mi, m_scs, w_slots, pos,
                                vals, sizes, parent, base)
    assert parent.tolist() == list(range(base, base + c))
    assert sizes.tolist() == [1] * c and vals[:, 2].tolist() == [0.0, 0.0]


def test_shard_state_round_trip():
    vt, sizes, slots, parent = one_chunk_state(4)
    parts = [dist.shard_state_from_numpy(vt, sizes, slots, parent, r, 4,
                                         "cpu") for r in range(4)]
    assert np.array_equal(np.concatenate([p[0].numpy() for p in parts], 1),
                          vt)
    for i, a in enumerate((sizes, slots, parent), start=1):
        assert np.array_equal(np.concatenate([p[i].numpy() for p in parts]),
                              a)


def test_one_rank_mesh_runs_the_whole_anneal_sharded(runs):
    """A one-rank mesh (no process group) runs every iteration sharded with
    no tail, as the reference's n_dev == 1, and equals its result."""
    X, _ = planted(np.random.default_rng(0), 10, 24, 16)
    c, s, m = dist.cluster_sharded(X, mesh=meshlib.Mesh("cpu"),
                                   min_similarity=0.9, iterations=25, seed=3)
    assert dist.LAST_SESSION["tail"] is None
    assert dist.LAST_SESSION["sharded_iterations"] == 25
    jc, js, jm = runs[1][1]["planted"]
    assert all(np.array_equal(a, b) for a, b in zip(m, jm))
    np.testing.assert_allclose(c, jc, rtol=1e-5, atol=1e-6)


# --- the sharded cases on D gloo ranks ----------------------------------------

def test_all_ranks_return_the_same_result(ranks):
    D, res = ranks
    for name in res[0]:
        for r in range(1, D):
            a, b = res[0][name], res[r][name]
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), name
                continue
            for x, y in zip(a[:4], b[:4]):
                assert np.array_equal(x, y), (name, r)


def test_sharded_cluster_recovers_planted(ranks):
    D, res = ranks
    X, labels = planted(np.random.default_rng(0), 10, 24, 16)
    r = res[0]["planted"]
    members = groups_of(r)
    assert len(members) == 10
    assert sorted(r[1].tolist()) == [24] * 10
    assert same_partition(partition_of(members, len(X)), labels)


def test_separated_data_same_partition_as_jax(ranks_and_jax):
    """The planted case's partition and cluster order equal JAX's sharded
    run on the same number of devices."""
    D, res, ref = ranks_and_jax
    jc, js, jm = ref["planted"]
    r = res[0]["planted"]
    assert all(np.array_equal(a, b) for a, b in zip(groups_of(r), jm))
    assert np.array_equal(r[1], js)
    np.testing.assert_allclose(r[0], jc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,tail", [
    ("no_tail", None), ("cross_shard", "one survivor"),
    ("planted", "handoff"), ("counts", "handoff"), ("terminal", "terminal")])
def test_sharded_ending_equals_the_host_assembly(ranks, name, tail,
                                                 monkeypatch):
    """Each ending of a sharded session (the whole anneal sharded and no
    tail; a handoff left with one survivor, which runs no tail; the
    handoff; the terminal rounds) gives, byte for byte and in the same
    types, what the host assembly gives on the same gathered state and
    tail schedule: the reference's dist._assemble, whose single-device
    tail is the port's engine.cluster over the survivors, composed into
    the row roots and grouped on the host."""
    D, res = ranks
    got = res[0][name]
    end = got[5]
    values_t, sizes, slots, parent = end["state"]
    alive = int(((sizes > 0) & (slots < end["n_rows"])).sum())
    if tail is None:
        assert end["tail"] is None and got[4]["tail"] is None
    elif tail == "one survivor":
        assert len(end["tail"]) and alive == 1
    else:
        assert got[4]["tail"] == tail and alive > 1
    monkeypatch.setattr(jengine, "cluster", lambda v, **kw: engine.cluster(
        v, device="cpu", **kw))
    monkeypatch.setattr(jdist, "LAST_SESSION", {})
    cents, csizes, members = jdist._assemble(
        values_t, sizes, slots, parent, end["n_rows"],
        extra_thresholds=end["tail"], seed=end["seed"] + 99_991)
    for a, b in zip(got[:4], (cents, csizes, members.flat, members.offsets)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(csizes) > 1 or name == "cross_shard"


def test_sharded_matches_single_device_partition(ranks):
    D, res = ranks
    X, _ = planted(np.random.default_rng(1), 6, 20, 12, noise=0.005)
    _, s1, m1 = engine.cluster(X, min_similarity=0.9, iterations=20, seed=2,
                               device="cpu")
    r = res[0]["vs_single"]
    assert sorted(r[1].tolist()) == sorted(s1.tolist())
    assert same_partition(partition_of(groups_of(r), len(X)),
                          partition_of(m1, len(X)))


def test_cross_shard_merging_actually_happens(ranks):
    D, res = ranks
    r = res[0]["cross_shard"]
    assert len(r[1]) == 1 and r[1][0] == 64


def test_exchange_overflow_still_converges(ranks):
    """exchange_cap = 1: one survivor per rank per iteration, far fewer than
    the alive clusters; the rest merge on later iterations."""
    D, res = ranks
    r = res[0]["overflow"]
    assert len(r[1]) == 6 and sorted(r[1].tolist()) == [16] * 6


def test_counts_path_matches_engine_cluster_counts(ranks):
    D, res = ranks
    counts, v = gamma_counts()
    thr = (0.95 - 0.0075 * np.arange(20)).astype(np.float32)
    _, s1, m1 = engine.cluster_counts(counts, v, thr, seed=7, device="cpu")
    r = res[0]["counts"]
    assert sorted(r[1].tolist()) == sorted(s1.tolist())
    n = counts.shape[1]
    assert same_partition(partition_of(groups_of(r), n), partition_of(m1, n))


def test_exchange_gathers_only_summaries(ranks):
    """Every exchange gathers at most D·e·(S + 2) elements (values, sizes,
    slots of every rank's window), read from the mesh's counter, far below
    the D·c rows of the sharded state."""
    D, res = ranks
    sess = res[0]["gather_bound"][4]
    assert sess["exchanges"] == 2
    per = sess["gathered"] / sess["exchanges"]
    assert per <= D * GATHER_E * (16 + 2)
    assert per < D * GATHER_C / 4


def test_cross_shard_fragmentation_bound(ranks):
    """The hierarchy at 2^16 rows, I = 20: the sharded count within 10% of
    the port's single device (the handoff tail keeps it close)."""
    D, res = ranks
    _, _, g1 = engine.cluster(hierarchy_rows(FRAG_N), thresholds=ANNEAL,
                              seed=0, device="cpu")
    r = res[0]["frag"]
    assert r[4]["tail"] == "handoff"
    assert len(r[1]) / len(g1) - 1 < 0.10


def test_terminal_rounds_fallback_bounds_inflation(ranks):
    """HANDOFF_CAP = 1: the whole anneal runs sharded, then TERMINAL_ITERS
    single-device rounds at the final threshold; an exact partition, the
    count within 15% of the single device."""
    D, res = ranks
    X = hierarchy_rows(TERMINAL_N, seed=1)
    _, _, g1 = engine.cluster(X, thresholds=ANNEAL, seed=0, device="cpu")
    r = res[0]["terminal"]
    assert r[4]["tail"] == "terminal"
    assert r[4]["sharded_iterations"] == len(ANNEAL)
    partition_of(groups_of(r), len(X))
    assert int(r[1].sum()) == len(X)
    assert len(r[1]) / len(g1) - 1 < 0.15


def test_hierarchy_cluster_count_close_to_jax(ranks_and_jax):
    """bench.py's hierarchy at 2^14 x 20, I = 20, through the counts path:
    the sharded count within 3% of JAX's sharded count on as many devices
    (measured on this file's data: 1,113 clusters in both packages at
    D = 2 and at D = 4, a gap of 0%; one device gives 1,123).
    The single-device port holds 2% (test_torch_session.py)."""
    D, res, ref = ranks_and_jax
    counts = bench_counts(HIER_N)[0]
    _, js, jm = ref["hier"]
    r = res[0]["hier"]
    assert r[4]["tail"] == "handoff"
    assert abs(len(r[1]) - len(jm)) <= 0.03 * len(jm)
    assert r[1].sum() == js.sum() == counts.shape[1]
    assert len(jm) < counts.shape[1] // 4


def test_terminal_rounds_count_matches_jax(runs):
    """HANDOFF_CAP = 1 in both packages, D = 4, the hierarchy of
    test_hierarchy_cluster_count_close_to_jax: neither hands off, both run
    the whole anneal sharded and then the terminal rounds, and the counts
    agree within 3%. Measured on this file's data: 935 clusters in both
    packages (a gap of 0%) against 1,123 on one device, -16.7%; at 2^16
    rows 4,176 in both against 5,040. The terminal rounds' count departs
    from one device's by the reference's design, in either direction with
    the size; the reference bounds its rise at 15% (tests/test_dist.py)."""
    res, ref = runs[4]
    counts = bench_counts(HIER_N)[0]
    _, js, jm = ref["hier_terminal"]
    r = res[0]["hier_terminal"]
    assert r[4]["tail"] == "terminal"
    assert r[4]["sharded_iterations"] == len(HIER_THR)
    assert abs(len(r[1]) - len(jm)) <= 0.03 * len(jm)
    assert r[1].sum() == js.sum() == counts.shape[1]
    assert abs(len(jm) - len(ref["hier"][2])) > 0.03 * len(jm)


def test_one_chunk_from_a_common_state(ranks_and_jax):
    """Four sharded iterations from one state in both packages (the port's
    shards cut by shard_state_from_numpy): the same alive sizes and the same
    merge forest up to the roots."""
    D, res, ref = ranks_and_jax
    j_sizes, j_parent = ref["one_chunk"]
    t_vt, t_sizes, t_slots, t_parent = res[0]["one_chunk"]
    assert sorted(t_sizes[t_sizes > 0].tolist()) == sorted(
        j_sizes[j_sizes > 0].tolist())

    def roots(p):
        r = p.astype(np.int64)
        while not np.array_equal(r[r], r):
            r = r[r]
        return r

    n = 8 * 30
    assert same_partition(roots(t_parent)[:n], roots(j_parent)[:n])


def test_sharded_wrs_matches_single_device_and_jax(ranks):
    """Bit for bit the port's single-device verdicts; JAX's except where a
    tail lies within rtol 1e-4 of -P."""
    D, res = ranks
    for name, args in zip(("wrs_small", "wrs_big"), wrs_inputs()):
        vals, sizes, n1, n2, p, st = args
        got = res[0][name]
        single = ttest.wrs_verdicts(vals, sizes, n1, n2, p, st, "cpu")
        assert np.array_equal(got, single), name
        want = np.asarray(jttest.wrs_verdicts(vals, sizes, n1, n2, p, st))
        _, left, right = jttest.studentttest2(jnp.asarray(vals), n1, n2)
        near = ((np.abs(np.asarray(left) - p) <= 1e-4 * p)
                | (np.abs(np.asarray(right) - p) <= 1e-4 * p))
        assert np.array_equal(got[~near], want[~near]), name
    assert (res[0]["wrs_big"] > 0).sum() > 100
