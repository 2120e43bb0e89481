"""The pairing-merge path of the port against the JAX package: the segment
helpers, the row-major and p-stable signatures, ``pairing_merge`` in both
key modes and both output orders, whole ``merge="pairing"`` sessions, and
K10 ``pairing_rounds``'s three steps transcribed into numpy against its
plain version (the kernel itself runs only on the card:
tests/test_torch_kernels.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.ops import lsh as jlsh
from kmerlsh_tpu.ops import segment as jsegment
from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.ops import lsh, segment
from test_torch_session import (bench_counts, partition_of, planted,
                                same_partition)

BIG = lsh.BIG_KEY
CPU = "cpu"


@pytest.fixture(autouse=True)
def f32_reference(monkeypatch):
    # the reference's default rounds sort payloads to float16
    monkeypatch.setattr(jengine, "PERMUTE", "payload_sort")


def t(a):
    return torch.from_numpy(np.array(a))


# --- ops/segment.py -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 17, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_helpers_match_jax(n, seed):
    r = np.random.default_rng(seed)
    starts = r.random(n) < 0.2
    starts[0] = seed == 0          # seed 1: elements before the first start
    alive = r.random(n) < 0.6
    values = r.integers(-5, 9, n).astype(np.int32)
    want = jsegment.segmented_cumsum(jnp.asarray(values), jnp.asarray(starts))
    got = segment.segmented_cumsum(t(values), t(starts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.array(want))
    want = jsegment.alive_rank_in_segment(jnp.asarray(alive),
                                          jnp.asarray(starts))
    got = segment.alive_rank_in_segment(t(alive), t(starts))
    # the rank is defined where the element is alive
    assert np.array_equal(got.numpy()[alive], np.array(want)[alive])


# --- ops/lsh.py ---------------------------------------------------------------

def exact_rows(seed, m=300, s=12):
    """Values and planes whose products and sums are exact in float32 (small
    integers and quarters), so that any order of summation agrees."""
    r = np.random.default_rng(seed)
    values = r.integers(-8, 9, (m, s)).astype(np.float32)
    values[:5] = 0.0            # projections of exactly 0 hash to bit 1
    planes = (r.integers(-8, 9, (s, lsh.H_MAX + 1)) / 4).astype(np.float32)
    return values, planes


@pytest.mark.parametrize("h", [1, 7, 30])
def test_signatures_match_jax(h):
    values, planes = exact_rows(h)
    jk, jp = jlsh.signatures(jnp.asarray(values), jnp.asarray(planes), h)
    tk, tp = lsh.signatures(t(values), t(planes), h)
    assert np.array_equal(tk.numpy(), np.array(jk))
    assert np.array_equal(tp.numpy(), np.array(jp))
    tk_t, _ = lsh.signatures_t(t(values.T.copy()), t(planes), h)
    assert torch.equal(tk, tk_t)


@pytest.mark.parametrize("h,b,r", [(1, 0.0, 1.0), (9, 0.5, 2.0),
                                   (30, -1.25, 0.5)])
def test_p_stable_signatures_match_jax(h, b, r):
    values, planes = exact_rows(h + 100)
    want = jlsh.p_stable_signatures(jnp.asarray(values), jnp.asarray(planes),
                                    h, b, r)
    got = lsh.p_stable_signatures(t(values), t(planes), h, b, r)
    assert got.dtype == torch.int32 and got.shape == (len(values), lsh.H_MAX)
    assert np.array_equal(got.numpy(), np.array(want))
    assert not got[:, h:].any()


# --- pairing_merge --------------------------------------------------------------

def pair_case(kind: str, seed: int = 0, s: int = 8):
    """(values_t [S, M], sizes, keys, proj) whose cosines lie far from any
    threshold in (0.1, 0.99): each row is one of S orthogonal profiles
    (cosine 0 between profiles) with noise 1e-4 (cosine ~1 within one)."""
    r = np.random.default_rng(seed)
    if kind == "one":
        m, n_keys = 1, 1
    elif kind == "duplicates":       # a 2,000-row bucket of one profile
        m, n_keys = 2000, 1
    else:
        m, n_keys = 501, 6
    prof = r.integers(0, s if kind != "duplicates" else 1, m)
    values = np.eye(s, dtype=np.float32)[prof] * 3.0
    values = values + 1e-4 * r.standard_normal((m, s)).astype(np.float32)
    sizes = r.integers(1, 5, m).astype(np.int32)
    if kind == "holes":              # dead slots between alive ones
        sizes[r.random(m) < 0.3] = 0
    if kind == "dead":
        sizes[:] = 0
    keys = r.integers(0, n_keys, m).astype(np.int32)
    if kind == "odd_even":           # segments of every length 1..12
        lens = np.arange(1, 13)
        keys = np.repeat(np.arange(len(lens)), lens)[r.permutation(
            lens.sum())].astype(np.int32)
        m = len(keys)
        values, sizes = values[:m], sizes[:m]
    keys[sizes == 0] = BIG
    proj = r.standard_normal(m).astype(np.float32)
    return np.ascontiguousarray(values.T), sizes, keys, proj


CASES = ["random", "odd_even", "holes", "dead", "one", "duplicates"]
ROUNDS = [0, 1, 2, 4, 16]


def _torch_in(values_t, sizes, keys, proj):
    return t(values_t), t(sizes), t(keys), t(proj)


@pytest.mark.parametrize("rounds", ROUNDS)
@pytest.mark.parametrize("kind", CASES)
def test_pairing_merge_sorted_matches_jax(kind, rounds):
    """With h: the combined key's order, results in sorted positions."""
    values_t, sizes, keys, proj = pair_case(kind, seed=rounds)
    h, thr = 4, 0.9
    mi = np.full(len(sizes), -1, np.int32)
    mi[::7] = 3                           # earlier merges ride along
    jv, js, jmi, jcs = jengine.pairing_merge(
        jnp.asarray(values_t), jnp.asarray(sizes), jnp.asarray(keys),
        jnp.asarray(proj), jnp.float32(thr), rounds, jnp.asarray(mi),
        h=jnp.int32(h), unsort=False)
    tv, ts, tmi, tcs = engine.pairing_merge(
        *_torch_in(values_t, sizes, keys, proj), thr, rounds, t(mi), h=h,
        unsort=False)
    for a, b in ((ts, js), (tmi, jmi), (tcs, jcs)):
        assert np.array_equal(a.numpy(), np.array(b))
    # merged means: separately rounded products here, XLA's order there
    np.testing.assert_allclose(tv.numpy(), np.array(jv), rtol=0, atol=1e-6)
    if kind in ("random", "duplicates") and rounds:
        assert (tmi.numpy() >= 0).sum() > (mi >= 0).sum()   # some merged


@pytest.mark.parametrize("rounds", ROUNDS)
@pytest.mark.parametrize("kind", CASES)
def test_pairing_merge_unsorted_matches_jax(kind, rounds):
    """Without h: the (keys, proj) lexicographic order, results back in
    input slot order, and the parent forest folded in place."""
    values_t, sizes, keys, proj = pair_case(kind, seed=rounds + 50)
    thr = 0.5
    jv, js, jmi = jengine.pairing_merge(
        jnp.asarray(values_t), jnp.asarray(sizes), jnp.asarray(keys),
        jnp.asarray(proj), jnp.float32(thr), rounds)
    parent = torch.arange(len(sizes), dtype=torch.int32)
    tv, ts, tmi = engine.pairing_merge(
        *_torch_in(values_t, sizes, keys, proj), thr, rounds, parent=parent)
    assert np.array_equal(ts.numpy(), np.array(js))
    assert np.array_equal(tmi.numpy(), np.array(jmi))
    np.testing.assert_allclose(tv.numpy(), np.array(jv), rtol=0, atol=1e-6)
    want = np.arange(len(sizes))
    want[np.array(jmi) >= 0] = np.array(jmi)[np.array(jmi) >= 0]
    assert np.array_equal(parent.numpy(), want)


def test_lex_order_matches_jax_lexsort():
    """jax.lax.sort's float order: -0.0 and subnormals tie 0.0, NaNs of
    either sign tie and sort last; keys of either sign, ties in input
    order."""
    r = np.random.default_rng(3)
    special = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45,
                        -1e-45, 3.0, -3.0], np.float32)
    proj = np.concatenate([special, special,
                           r.standard_normal(200).astype(np.float32)])
    keys = r.choice(np.array([-2**31, -7, 0, 5, BIG], np.int32), len(proj))
    want = np.array(jnp.lexsort((jnp.asarray(proj), jnp.asarray(keys))))
    got = engine._lex_order(t(keys), t(proj))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_dead_bucket_never_equals_an_alive_one():
    """Dead slots carry BIG_KEY: BIG_KEY >> free_bits(h) lies above every
    bucket of h bits, so a dead run never continues an alive segment."""
    for h in range(1, lsh.H_MAX + 1):
        assert BIG >> kernels.free_bits(h) >= 1 << h
        alive_max = (((1 << h) - 1) << kernels.free_bits(h)) | (
            (1 << kernels.free_bits(h)) - 1)
        assert alive_max >> kernels.free_bits(h) == (1 << h) - 1
        assert alive_max < BIG


# --- whole sessions ------------------------------------------------------------

@pytest.mark.parametrize("init_rounds", [None, 2])
@pytest.mark.parametrize("transposed", [False, True])
def test_pairing_cluster_same_partition_as_jax(init_rounds, transposed):
    """Separated data: the same partition in the same order, centroids to
    float32 rounding (rtol 1e-5: means summed in another order)."""
    rng = np.random.default_rng(5)
    X, labels = planted(rng, n_clusters=6, members=40, S=12, noise=0.005)
    arg = np.ascontiguousarray(X.T) if transposed else X
    kw = dict(min_similarity=0.92, iterations=25, seed=2, rounds=4,
              init_rounds=init_rounds, merge="pairing", transposed=transposed)
    jc, js, jm = jengine.cluster(arg, **kw)
    tc, ts, tm = engine.cluster(arg, device=CPU, **kw)
    assert sorted(ts.tolist()) == sorted(js.tolist()) == [40] * 6
    assert same_partition(partition_of(tm, len(X)), partition_of(jm, len(X)))
    assert same_partition(partition_of(tm, len(X)), labels)
    assert all(np.array_equal(a, b) for a, b in zip(tm, jm))
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deep_init", [True, False])
def test_pairing_cluster_counts_close_to_jax(deep_init):
    """The hierarchy at 2^14 x 20, I = 20: the count within 2% of the
    reference's (its projections differ by ulps, as on the chain path)."""
    counts, v = bench_counts(1 << 14)
    thr = np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)]).astype(
        np.float32)
    kw = dict(seed=0, rounds=4, deep_init=deep_init, merge="pairing")
    _, js, jm = jengine.cluster_counts(counts, v, thr, **kw)
    _, ts, tm = engine.cluster_counts(counts, v, thr, device=CPU, **kw)
    assert abs(len(tm) - len(jm)) <= 0.02 * len(jm)
    assert ts.sum() == js.sum() == counts.shape[1]
    assert len(jm) < counts.shape[1] // 4


def test_deep_pairing_session_matches_jax(monkeypatch):
    """I·R = 80: the forest deepens by up to R an iteration and finalize
    follows it to the roots; the partition is the reference's."""
    rng = np.random.default_rng(9)
    X, _ = planted(rng, n_clusters=5, members=200, S=10, noise=0.002)
    kw = dict(min_similarity=0.9, iterations=20, seed=4, rounds=4,
              merge="pairing")
    depth = {}
    real = kernels.finalize

    def keep(vt, sz, sl, parent):
        up = parent.long()
        d = torch.zeros_like(up)
        x = torch.arange(len(up))
        while bool((up[x] != x).any()):
            moved = up[x] != x
            d += moved
            x = torch.where(moved, up[x], x)
        depth["max"] = int(d.max())
        return real(vt, sz, sl, parent)

    monkeypatch.setattr(kernels, "finalize", keep)
    _, js, jm = jengine.cluster(X, **kw)
    _, ts, tm = engine.cluster(X, device=CPU, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(tm, jm))
    assert sorted(ts.tolist()) == sorted(js.tolist()) == [200] * 5
    assert 1 < depth["max"] <= 20 * 4 + 1


@pytest.mark.parametrize("rounds", [0, 7])
def test_explicit_chain_merge_is_the_chain_path(rounds):
    rng = np.random.default_rng(3)
    X, _ = planted(rng, n_clusters=8, members=10)
    want = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7,
                          device=CPU)
    got = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7,
                         device=CPU, merge="chain", rounds=rounds,
                         init_rounds=rounds)
    assert np.array_equal(want[0], got[0])
    assert all(np.array_equal(a, b) for a, b in zip(want[2], got[2]))


def test_merge_must_be_chain_or_pairing():
    with pytest.raises(ValueError):
        engine.cluster(np.ones((4, 3), np.float32), device=CPU,
                       merge="pairs")


@pytest.mark.parametrize("iterations,want", [(1, 16), (5, 4)])
def test_cluster_fn_passes_the_reference_rounds(monkeypatch, iterations,
                                                want):
    """pipeline._cluster_fn's engine branch passes rounds as the
    reference's run() does (kmerlsh_tpu/pipeline.py:82-86)."""
    from kmerlsh_tpu_torch import pipeline

    seen = {}

    def fake(values, sizes, **kw):
        seen.update(kw)
        return None

    monkeypatch.setattr(engine, "cluster", fake)
    run = pipeline._cluster_fn(HyperParams(merge_rounds=4), CPU)
    run(np.ones((3, 2), np.float32), None, iterations, 0.8, 0)
    assert seen["rounds"] == want


def test_cluster_sharded_ignores_engine_keywords():
    from kmerlsh_tpu_torch.parallel import dist, mesh

    rng = np.random.default_rng(2)
    X, _ = planted(rng, n_clusters=4, members=10, S=8)
    m = mesh.Mesh(CPU)
    want = dist.cluster_sharded(X, mesh=m, iterations=6, seed=1)
    got = dist.cluster_sharded(X, mesh=m, iterations=6, seed=1,
                               merge="pairing", rounds=4, init_rounds=1)
    assert np.array_equal(want[0], got[0])
    assert all(np.array_equal(a, b) for a, b in zip(want[2], got[2]))


# --- K10's steps in numpy ---------------------------------------------------------

def _cat(a, b):
    """kl_seg_cat: run a, then run b."""
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1],
            b[2] if b[2] >= 0 else a[2])


def k10_numpy(vals, sizes, slots, key, shift, thr, rounds, threads, items,
              mutation=None, seed=0):
    """pairing.cu in numpy: per round (a) each tile's aggregate from its
    threads' item runs, (b) the tiles' exclusive scan, (c) each block, in
    a shuffled order (blocks run in none), stages its sizes, scans its
    threads' runs after the carry-in, marks the right-role elements and
    applies their pairs with float32 operations rounded one at a time."""
    v, sz = vals.copy(), sizes.copy()
    mi = np.full(len(sz), -1, np.int32)
    M, tile = len(sz), threads * items
    nt = -(-M // tile)
    order = np.random.default_rng(seed).permutation(nt)
    none = (0, 0, -1)

    def runs(b, s_size):
        """Each thread's run over its items: (start, alive, position)."""
        out = []
        for th in range(threads):
            a = none
            for j in range(items):
                p = b * tile + th * items + j
                if p >= M:
                    break
                if p == 0 or (key[p] >> shift) != (key[p - 1] >> shift):
                    a = (1, 0, a[2])
                if s_size[p - b * tile] > 0 and key[p] != BIG:
                    a = (a[0], a[1] + 1, p)
            out.append(a)
        return out

    def stage(b):
        return sz[b * tile:(b + 1) * tile].copy()

    for r in range(rounds):
        ph = r & 1
        aggs = []
        for b in range(nt):                                     # (a)
            tot = none
            for a in runs(b, stage(b)):
                tot = _cat(tot, a)
            aggs.append(tot)
        carry, c = [], none                                     # (b)
        for a in aggs:
            carry.append(c)
            c = (_cat(c, a) if mutation != "carry_ignores_starts"
                 else (c[0] | a[0], c[1] + a[1], _cat(c, a)[2]))
        if mutation == "no_carry":
            carry = [none] * nt
        for b in order:                                         # (c)
            s_size = stage(b)
            pre = carry[b]
            pairs = []
            for th, a in enumerate(runs(b, s_size)):
                cnt, last = pre[1], pre[2]
                for j in range(items):
                    i = th * items + j
                    p = b * tile + i
                    if p >= M:
                        break
                    if p == 0 or (key[p] >> shift) != (key[p - 1] >> shift):
                        cnt = 0
                    if s_size[i] > 0 and key[p] != BIG:
                        if cnt >= ph + 1 and (cnt - ph) & 1:
                            pairs.append((p, last))
                        cnt += 1
                        last = p
                pre = _cat(pre, a)
            for p, q in pairs:
                f = np.float32
                dot = nr = nl = f(0)
                for s in range(v.shape[0]):
                    vr, vl = v[s, p], v[s, q]
                    dot = f(dot + f(vr * vl))
                    nr = f(nr + f(vr * vr))
                    nl = f(nl + f(vl * vl))
                nn = f(np.sqrt(f(nr * nl)))
                if not f(dot / (nn if nn > 0 else f(1))) >= f(thr):
                    continue
                sr, sl = s_size[p - b * tile], sz[q]
                for s in range(v.shape[0]):
                    v[s, q] = f(f(f(v[s, q] * f(sl)) + f(v[s, p] * f(sr)))
                                / f(sl + sr))
                sz[q] = sl + sr
                sz[p] = 0
                mi[p] = slots[q]
    return v, sz, mi


def k10_case(seed, m=700, s=5):
    """A sorted state whose segments (runs of one key >> 2) cross tiles of
    4 x 3 positions, with dead columns inside them and a dead tail; half
    the pairs merge at 0.5 (two profiles a segment, noise 0.3)."""
    r = np.random.default_rng(seed)
    lens = r.integers(1, 40, 60)
    seg = np.repeat(np.arange(len(lens)), lens)[:m - 40]
    key = np.full(m, BIG, np.int32)
    key[:len(seg)] = (seg << 2) | r.integers(0, 4, len(seg))
    prof = r.standard_normal((2 * len(lens), s)).astype(np.float32)
    pick = 2 * np.append(seg, np.zeros(40, int)) + r.integers(0, 2, m)
    vals = (prof[pick] + 0.3 * r.standard_normal((m, s))).astype(np.float32)
    sizes = r.integers(1, 6, m).astype(np.int32)
    sizes[r.random(m) < 0.15] = 0
    sizes[len(seg):] = 0
    slots = r.permutation(m).astype(np.int32)
    return np.ascontiguousarray(vals.T), sizes, slots, key


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mutation",
                         [None, "no_carry", "carry_ignores_starts"])
def test_k10_steps_give_the_plain_rounds(seed, rounds, mutation):
    vals, sizes, slots, key = k10_case(seed)
    stats = []
    want = kernels.pairing_rounds_plain(t(vals), t(sizes), t(slots), t(key),
                                        2, 0.5, rounds, stats=stats)
    assert all(0 < merged < formed for formed, merged in stats)
    got = k10_numpy(vals, sizes, slots, key, 2, 0.5, rounds, threads=4,
                    items=3, mutation=mutation, seed=seed)
    same = all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    # the transcription agrees bit for bit; each mutation must be caught
    assert same == (mutation is None)
