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

NONE = (0, 0, -1)


def _cat(a, b):
    """kl_seg_cat: run a, then run b."""
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1],
            b[2] if b[2] >= 0 else a[2])


def _cat_no_starts(a, b):
    """A faulty carry: counts summed across segment starts."""
    return (a[0] | b[0], a[1] + b[1], b[2] if b[2] >= 0 else a[2])


def _exclusive(runs):
    """Each run's exclusive prefix (a block scan), and the total."""
    pre, c = [], NONE
    for a in runs:
        pre.append(c)
        c = _cat(c, a)
    return pre, c


def _thread_runs(start, alive, lo, hi, threads, items):
    """kl_seg_block_scan's input: each thread's run over ``items``
    consecutive positions of [lo, hi) (start and alive by position), as
    (start seen, alive after the last start, last alive position)."""
    out = []
    for th in range(threads):
        a = NONE
        for p in range(lo + th * items, min(lo + (th + 1) * items, hi)):
            if start(p):
                a = (1, 0, a[2])
            if alive(p):
                a = (a[0], a[1] + 1, p)
        out.append(a)
    return out


def _merge(v, sz, mi, slots, parent, base, p, q, thr, sr=None):
    """The pair (left q, right p) in float32 operations rounded one at a
    time; True where it merged."""
    f = np.float32
    dot = nr = nl = f(0)
    for s in range(v.shape[0]):
        vr, vl = v[s, p], v[s, q]
        dot = f(dot + f(vr * vl))
        nr = f(nr + f(vr * vr))
        nl = f(nl + f(vl * vl))
    nn = f(np.sqrt(f(nr * nl)))
    if not f(dot / (nn if nn > 0 else f(1))) >= f(thr):
        return False
    sr = sz[p] if sr is None else sr
    sl = sz[q]
    for s in range(v.shape[0]):
        v[s, q] = f(f(f(v[s, q] * f(sl)) + f(v[s, p] * f(sr))) / f(sl + sr))
    sz[q] = sl + sr
    sz[p] = 0
    mi[p] = slots[q]
    if parent is not None:
        parent[slots[p] - base] = slots[q]
    return True


def k10_numpy(vals, sizes, slots, key, shift, thr, rounds, C, threads=8,
              long_threads=4, long_items=3, grid=3, mutation=None, seed=0,
              parent=None, base=0, record=None):
    """pairing.cu in numpy. Launch (1): window blocks of C positions, in a
    shuffled order (blocks run in none), each finding its segments from
    the keys, listing a last segment longer than C, and running every
    round of its range on a copy (its shared memory) with ``threads``
    threads' runs, block scans and the packed list of pairs (applied in a
    shuffled order), stopping after two rounds without a merge; then the
    changed sizes and columns are written back. Launch (2): the listed
    segments (at C = 0 the whole array), their ends from the windows'
    first starts, tiles of long_threads x long_items positions; a segment
    of one tile runs every round in one block, the others' tiles in
    contiguous chunks of ``grid`` blocks: per round (a) the tiles' and
    chunks' aggregates, (b) blocks in a shuffled order, each with its
    carry from the chunks before it, ranking and applying its tiles' pairs
    in place. ``record`` (a dict) gets the ranges of each launch.
    Mutations: owner_off_by_one (a window one position too long),
    dropped_long (the first listed segment lost), parity_reversed, and in
    launch (2) no_carry and carry_ignores_starts."""
    v, sz = vals.copy(), sizes.copy()
    mi = np.full(len(sz), -1, np.int32)
    M = len(sz)
    rng = np.random.default_rng(seed)
    lift = 1 if mutation == "parity_reversed" else 0

    def start(p):
        return p == 0 or (key[p] >> shift) != (key[p - 1] >> shift)

    nw = -(-M // C) if C else 1
    fs = np.full(nw, -1, np.int64)
    listed, short = [], []
    if C == 0:
        listed.append([0, M])
    for b in rng.permutation(nw) if C else []:                # (1)
        w0 = b * C
        w1 = min(w0 + C + (mutation == "owner_off_by_one"), M)
        starts = [p for p in range(w0, w1) if start(p)]
        if not starts:
            continue
        first, last = starts[0], starts[-1]
        fs[b] = first
        ends = [p for p in range(last + 1, min(last + C, M - 1) + 1)
                if start(p)]
        if ends:
            r1 = ends[0]
        elif last + C >= M:
            r1 = M
        else:
            if mutation == "dropped_long" and not listed:
                mutation = "dropped"
            else:
                listed.append([last, -1])
            r1 = last
        if r1 <= first:
            continue
        short.append((first, r1))
        r0, n = first, r1 - first
        sv, ssz = v[:, r0:r1].copy(), sz[r0:r1].copy()
        dirty = np.zeros(n, np.int64)
        loc_slots = slots[r0:r1]

        def alive(i):
            return ssz[i] > 0 and key[r0 + i] != BIG

        k = -(-n // threads)
        quiet = 0
        for r in range(rounds):
            if quiet >= 2:
                break
            ph = (r + lift) & 1
            pre, _ = _exclusive(_thread_runs(lambda i: start(r0 + i), alive,
                                             0, n, threads, k))
            pairs = []
            for th in range(threads):
                cnt, prev = pre[th][1], pre[th][2]
                for i in range(th * k, min((th + 1) * k, n)):
                    if start(r0 + i):
                        cnt = 0
                    if alive(i):
                        if cnt >= ph + 1 and (cnt - ph) & 1:
                            pairs.append((i, prev))
                        cnt += 1
                        prev = i
            merged = False
            loc_mi = np.full(n, -1, np.int32)
            for i in rng.permutation(len(pairs)):   # threads in any order
                p, q = pairs[i]
                if _merge(sv, ssz, loc_mi, loc_slots, None, 0, p, q, thr):
                    merged = True
                    dirty[q] |= 12
                    dirty[p] |= 4
                    mi[r0 + p] = loc_mi[p]
                    if parent is not None:
                        parent[loc_slots[p] - base] = loc_slots[q]
            quiet = 0 if merged else quiet + 1
        for i in range(n):
            if dirty[i] & 4:
                sz[r0 + i] = ssz[i]
            if dirty[i] & 8:
                v[:, r0 + i] = sv[:, i]
    if record is not None:
        record.update(short=short, listed=listed)
    if not listed:                                            # (2)
        return v, sz, mi
    for seg in listed:
        if seg[1] < 0:
            later = np.nonzero(fs[seg[0] // C + 1:] >= 0)[0]
            seg[1] = int(fs[seg[0] // C + 1 + later[0]]) if len(later) else M
    tile = long_threads * long_items
    tiles = [-(-(e - a) // tile) for a, e in listed]

    def alive(p):
        return sz[p] > 0 and key[p] != BIG

    def apply(p0, p1, carry, ph):
        """kl_long_apply: tile [p0, p1)'s ranks after the carry, then its
        right-role elements' pairs in place."""
        staged = sz[p0:p1].copy()
        pre, _ = _exclusive(_thread_runs(start, alive, p0, p1,
                                         long_threads, long_items))
        rights = []
        for th in range(long_threads):
            c = _cat(carry, pre[th])
            cnt, last = c[1], c[2]
            for p in range(p0 + th * long_items,
                           min(p0 + (th + 1) * long_items, p1)):
                if start(p):
                    cnt = 0
                if staged[p - p0] > 0 and key[p] != BIG:
                    if cnt >= ph + 1 and (cnt - ph) & 1:
                        rights.append((p, last))
                    cnt += 1
                    last = p
        for p, q in rights:
            _merge(v, sz, mi, slots, parent, base, p, q, thr,
                   staged[p - p0])

    for j in rng.permutation(len(listed)):   # one tile: one block
        if tiles[j] == 1:
            for r in range(rounds):
                apply(*listed[j], NONE, (r + lift) & 1)
    lb = np.concatenate([[0], np.cumsum([x if x > 1 else 0
                                         for x in tiles])])
    T = int(lb[-1])
    ch = -(-T // grid)

    def span(t):
        j = int(np.searchsorted(lb, t, side="right")) - 1
        p0 = listed[j][0] + (t - int(lb[j])) * tile
        return p0, min(p0 + tile, listed[j][1])

    cat = _cat_no_starts if mutation == "carry_ignores_starts" else _cat
    agg = [None] * T
    for r in range(rounds):
        ph = (r + lift) & 1
        chunks = []
        for b in range(grid):                                 # (a)
            mine = NONE
            for t in range(min(b * ch, T), min(b * ch + ch, T)):
                if r == 0 or agg[t][2] >= 0:
                    p0, p1 = span(t)
                    agg[t] = _exclusive(_thread_runs(start, alive, p0, p1,
                                                     long_threads,
                                                     long_items))[1]
                mine = _cat(mine, agg[t])
            chunks.append(mine)
        for b in rng.permutation(grid):                       # (b)
            carry = NONE
            for c in chunks[:b]:
                carry = cat(carry, c)
            for t in range(min(b * ch, T), min(b * ch + ch, T)):
                if mutation == "no_carry":
                    carry = NONE
                if agg[t][2] >= 0:
                    apply(*span(t), carry, ph)
                carry = cat(carry, agg[t])
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


K10_C = 6     # the transcription's capacity: segments of k10_case cross it
K10_MUTATIONS = ["no_carry", "carry_ignores_starts", "owner_off_by_one",
                 "dropped_long", "parity_reversed"]


def k10_same(got, want):
    return all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mutation", [None] + K10_MUTATIONS)
def test_k10_steps_give_the_plain_rounds(seed, rounds, mutation):
    """Both launches at C = 6 (short segments in shared memory, the longer
    ones listed for the cooperative launch) and the cooperative launch
    alone (C = 0), bit for bit against the plain rounds; each mutation
    must be caught."""
    vals, sizes, slots, key = k10_case(seed)
    stats = []
    want = kernels.pairing_rounds_plain(t(vals), t(sizes), t(slots), t(key),
                                        2, 0.5, rounds, stats=stats)
    assert all(0 < merged < formed for formed, merged in stats)
    same = all(
        k10_same(k10_numpy(vals, sizes, slots, key, 2, 0.5, rounds, C,
                           mutation=mutation, seed=seed), want)
        for C in (K10_C, 0))
    assert same == (mutation is None)


def straddle_case(length, offset, C=K10_C, s=4, m=None, seed=0):
    """A sorted state of segments of ``length`` (alternating with short
    ones of 1 to 3) whose first starts ``offset`` positions after a window
    edge of C, one profile a segment with noise 0.05 (most pairs merge at
    0.5), a dead column in 9."""
    r = np.random.default_rng(seed)
    lens = [offset] if offset else []
    while sum(lens) < (m or 8 * C + 40):
        lens += [length, int(r.integers(1, 4))]
    seg = np.repeat(np.arange(len(lens)), lens)[:m or sum(lens)]
    n = len(seg)
    key = ((seg << 2) | r.integers(0, 4, n)).astype(np.int32)
    prof = r.standard_normal((len(lens), s)).astype(np.float32)
    vals = (prof[seg] + 0.05 * r.standard_normal((n, s))).astype(np.float32)
    sizes = r.integers(1, 6, n).astype(np.int32)
    sizes[r.random(n) < 1 / 9] = 0
    slots = r.permutation(n).astype(np.int32)
    return np.ascontiguousarray(vals.T), sizes, slots, key


@pytest.mark.parametrize("offset", [0, 1, K10_C - 1])
@pytest.mark.parametrize("length", [K10_C - 1, K10_C, K10_C + 1,
                                    2 * K10_C + 1])
def test_k10_steps_on_segments_that_straddle_windows(length, offset):
    """Segments of C - 1, C, C + 1 and 2C + 1 positions across window
    edges, with a parent forest at a base: bit for bit, and a segment goes
    to the cooperative launch exactly when it is longer than C."""
    vals, sizes, slots, key = straddle_case(length, offset)
    base = 7
    parent = np.arange(base, base + len(sizes), dtype=np.int32)
    want_parent = torch.from_numpy(parent.copy())
    want = kernels.pairing_rounds_plain(t(vals), t(sizes), t(slots + base),
                                        t(key), 2, 0.5, 4,
                                        parent=want_parent, base=base)
    rec = {}
    got_parent = parent.copy()
    got = k10_numpy(vals, sizes, slots + base, key, 2, 0.5, 4, K10_C,
                    parent=got_parent, base=base, record=rec)
    assert k10_same(got, want)
    assert np.array_equal(got_parent, want_parent.numpy())
    listed = {a for a, _ in rec["listed"]}
    starts = np.flatnonzero(np.diff(key >> 2, prepend=-1))
    ends = np.append(starts[1:], len(key))
    assert listed == {a for a, e in zip(starts, ends) if e - a > K10_C}
    assert (length > K10_C) == bool(listed)


@pytest.mark.parametrize("C", [K10_C, 0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k10_ranges_cover_every_position_once(seed, C):
    """Launch (1)'s ranges and launch (2)'s segments tile [0, M) without
    overlap, with blocks in any order."""
    vals, sizes, slots, key = k10_case(seed)
    rec = {}
    k10_numpy(vals, sizes, slots, key, 2, 0.5, 1, C, seed=seed, record=rec)
    spans = sorted(rec["short"] + [tuple(x) for x in rec["listed"]])
    assert spans[0][0] == 0 and spans[-1][1] == len(key)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert (C == 0) == (spans == [(0, len(key))])


@pytest.mark.parametrize("rounds", [1, 4, 16])
def test_k10_steps_on_one_segment_across_the_array(rounds):
    """One segment over 500 positions of one profile: launch (1) lists it,
    the cooperative launch's 42 tiles in three chunks carry the ranks."""
    r = np.random.default_rng(rounds)
    n = 500
    vals = (np.ones((3, n)) + 1e-3 * r.standard_normal((3, n))).astype(
        np.float32)
    sizes = np.ones(n, np.int32)
    slots = np.arange(n, dtype=np.int32)
    key = np.full(n, 3, np.int32)
    want = kernels.pairing_rounds_plain(t(vals), t(sizes), t(slots), t(key),
                                        0, 0.9, rounds)
    rec = {}
    got = k10_numpy(vals, sizes, slots, key, 0, 0.9, rounds, K10_C,
                    record=rec)
    assert k10_same(got, want)
    assert rec["listed"] == [[0, n]] and not rec["short"]
