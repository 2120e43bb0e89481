"""One iteration of the port's engine against the JAX engine (f32 payload
sort) on identical inputs: chain collapse, compaction, finalize."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.ops import lsh as jlsh
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.cluster.groups import Groups
from kmerlsh_tpu_torch.ops.lsh import BIG_KEY

T = torch.from_numpy


def run_chain(values, sizes, keys, proj, threshold, h=5):
    vt, s, mi, cs = engine.chain_collapse(
        T(np.ascontiguousarray(values.T)), T(np.asarray(sizes, np.int32)),
        T(np.asarray(keys, np.int32)), T(np.asarray(proj, np.float32)),
        threshold, h=h)
    return vt.T.numpy(), s.numpy(), mi.numpy(), cs.numpy()


# --- ports of tests/test_chain_collapse.py -----------------------------------

def test_chain_merges_full_bucket_exactly():
    base = np.array([1.0, 2.0, -1.0, 0.5], np.float32)
    n = 64
    rng = np.random.default_rng(0)
    V = np.tile(base, (n, 1)) + 1e-5 * rng.normal(size=(n, 4)).astype(np.float32)
    sizes = rng.integers(1, 5, size=n).astype(np.int32)
    keys = np.zeros(n, np.int32)
    proj = rng.normal(size=n).astype(np.float32)
    v, s, mi, cs = run_chain(V, sizes, keys, proj, 0.9)
    alive = s > 0
    assert alive.sum() == 1
    W = int(sizes.sum())
    assert s[alive][0] == W
    want = (V * sizes[:, None]).sum(0) / W
    np.testing.assert_allclose(v[alive][0], want, rtol=1e-4, atol=1e-5)
    head_slot = cs[np.nonzero(alive)[0][0]]
    losers = mi >= 0
    assert losers.sum() == n - 1
    assert (mi[losers] == head_slot).all()


def test_chain_respects_buckets_and_threshold():
    a = np.array([1.0, 0.0], np.float32)
    b = np.array([0.0, 1.0], np.float32)
    V = np.stack([a, a, b, b, a, a])
    keys = np.array([0, 0, 0, 0, 7, 7], np.int32)
    proj = np.array([0.0, 0.1, 5.0, 5.1, 0.0, 0.1], np.float32)
    v, s, mi, cs = run_chain(V, np.ones(6, np.int32), keys, proj, 0.9)
    assert (s > 0).sum() == 3
    assert sorted(s[s > 0].tolist()) == [2, 2, 2]


def test_chain_skips_dead_slots():
    V = np.tile(np.array([1.0, 1.0], np.float32), (8, 1))
    sizes = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.int32)
    keys = np.zeros(8, np.int32)
    keys[sizes == 0] = BIG_KEY
    v, s, mi, cs = run_chain(V, sizes, keys, np.arange(8, dtype=np.float32),
                             0.9)
    assert (s > 0).sum() == 1
    assert s[s > 0][0] == 6


def _finalize_case():
    rng = np.random.default_rng(3)
    cap0, fc, S = 4096, 1024, 5
    n_alive = 300
    alive_slots = np.sort(rng.choice(cap0 // 2, size=n_alive, replace=False))
    parent = rng.permutation(np.repeat(alive_slots,
                                       -(-cap0 // n_alive))[:cap0])
    parent[alive_slots] = alive_slots
    dead = rng.choice(np.setdiff1d(np.arange(cap0), alive_slots), size=200,
                      replace=False)
    parent[dead] = dead
    slots = np.full(fc, 0, np.int32)
    slots[:n_alive] = alive_slots
    slots[n_alive:] = np.setdiff1d(np.arange(cap0), alive_slots)[:fc - n_alive]
    sizes = np.zeros(fc, np.int32)
    sizes[:n_alive] = rng.integers(1, 50, size=n_alive)
    vals_t = rng.normal(size=(S, fc)).astype(np.float32)
    return vals_t, sizes, slots, parent.astype(np.int32), alive_slots


def test_finalize_grouped_matches_jax_and_host_grouping():
    vals_t, sizes, slots, parent, alive_slots = _finalize_case()
    cap0, fc, S, n_alive = len(parent), len(sizes), len(vals_t), 300
    flat, lens, csizes, cents = engine._finalize_grouped(
        T(vals_t), T(sizes), T(slots), T(parent))
    buf = np.asarray(jengine._finalize_grouped(
        jnp.asarray(vals_t), jnp.asarray(sizes), jnp.asarray(slots),
        jnp.asarray(parent), fc, 4))
    jlens = buf[cap0:cap0 + fc][:n_alive]
    offs = np.concatenate([[0], np.cumsum(jlens)])
    assert np.array_equal(flat.numpy()[:offs[-1]], buf[:offs[-1]])
    assert np.array_equal(lens.numpy()[:n_alive], jlens)
    assert np.array_equal(csizes.numpy()[:n_alive],
                          buf[cap0 + fc:cap0 + 2 * fc][:n_alive])
    jvals = buf[cap0 + 2 * fc:].view(np.float32).reshape(S, fc)[:, :n_alive]
    assert np.array_equal(cents.numpy()[:n_alive], jvals.T)

    roots = parent
    for _ in range(4):
        roots = roots[roots]
    want_c, want_s, want_m = jengine._group_by_roots(
        roots, alive_slots, sizes[:n_alive], vals_t[:, :n_alive])
    got = Groups(flat.numpy()[:offs[-1]], offs)
    assert np.array_equal(got.flat, want_m.flat)
    assert np.array_equal(got.offsets, want_m.offsets)
    np.testing.assert_array_equal(cents.numpy()[:n_alive], want_c)


def test_finalize_at_smaller_capacity_than_session():
    rng = np.random.default_rng(0)
    n, S, k = 8192, 8, 64
    prof = rng.normal(size=(k, S)).astype(np.float32)
    prof /= np.linalg.norm(prof, axis=1, keepdims=True)
    rows = rng.integers(0, k, size=n)
    counts = np.clip(np.rint(np.expm1(4.0 + prof[rows])), 1,
                     65535).astype(np.uint16)
    cents, sizes, members = engine.cluster_counts(
        np.ascontiguousarray(counts.T), np.zeros(S, np.float32),
        np.asarray([0.95], np.float32), seed=0, device="cpu")
    assert len(members) < 4096
    assert members.offsets[-1] == n
    assert sizes.sum() == n


# --- one iteration on a JAX session state --------------------------------------

def _poisson_counts(seed, S=8, n_prof=40, reps=60):
    rng = np.random.default_rng(seed)
    prof = rng.gamma(2.0, 20.0, size=(n_prof, S))
    rows = rng.integers(0, n_prof, size=n_prof * reps)
    counts = np.minimum(rng.poisson(prof[rows]), 65535).astype(np.uint16).T
    v = (np.log(np.maximum(counts, 1)).sum(axis=1)
         / counts.shape[1]).astype(np.float32)
    return np.ascontiguousarray(counts), v


def _jax_head_state(seed):
    counts, v = _poisson_counts(seed)
    base = jax.random.PRNGKey(seed)
    vt, sizes, slots, parent, na, _ = jengine._head_program(
        jnp.asarray(counts), jnp.asarray(v), base,
        jnp.asarray([0.95], np.float32), 4, "chain", True, "payload_sort")
    return base, vt, sizes, slots, parent


def _neighbour_sims(vt, key):
    order = np.argsort(key, kind="stable")
    sv = vt[:, order]
    a, b = sv[:, 1:].astype(np.float64), sv[:, :-1].astype(np.float64)
    nn = np.sqrt((a * a).sum(0) * (b * b).sum(0))
    return (a * b).sum(0) / np.where(nn > 0, nn, 1.0)


def test_iteration_matches_jax_on_its_state():
    """The JAX head program's state, carried over with state_from_numpy,
    then one chain-collapse iteration on JAX's keys and projections:
    sizes, slots, merged_into and the folded parent forest exact, values
    to rounding."""
    thr = 0.93
    base, vt, sizes, slots, parent = _jax_head_state(4)
    h = jengine._active_h(sizes)
    planes = jlsh.draw_hyperplanes(jax.random.fold_in(base, 1), vt.shape[0])
    keys, proj = jlsh.signatures_t(vt, planes, h)
    keys = jnp.where(sizes > 0, keys, BIG_KEY)
    comb = np.asarray(jengine._combined_sort_key(keys, proj, sizes, h))
    sims = _neighbour_sims(np.asarray(vt), comb)
    assert np.abs(sims - thr).min() > 1e-5       # no link on a knife edge
    mi0 = jnp.full(vt.shape[1], -1, jnp.int32)
    jv, js, jmi, jcs = jengine.chain_collapse(
        vt, sizes, keys, proj, jnp.float32(thr), mi0, slots, h=h,
        permute="payload_sort")
    jparent = parent.at[jcs].set(jnp.where(jmi >= 0, jmi, parent[jcs]))

    tv, ts, tslots, tparent = engine.state_from_numpy(
        vt, sizes, slots, parent, "cpu")
    v2, s2, mi2, cs2 = engine.chain_collapse(
        tv, ts, T(np.array(keys)), T(np.array(proj)), thr,
        cur_slot=tslots, h=int(h), parent=tparent)
    assert int((np.asarray(jmi) >= 0).sum()) > 100   # merges happened
    assert np.array_equal(s2.numpy(), np.asarray(js))
    assert np.array_equal(cs2.numpy(), np.asarray(jcs))
    assert np.array_equal(mi2.numpy(), np.asarray(jmi))
    assert np.array_equal(tparent.numpy(), np.asarray(jparent))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)


def test_stride_cut_matches_jax():
    """A chain of near-identical rows longer than 2^15 positions is cut at
    position 32768 exactly as the reference cuts it."""
    rng = np.random.default_rng(7)
    m, S = 34000, 4
    vals = (np.array([1.0, 0.5, -0.3, 2.0], np.float32)[:, None]
            + 1e-4 * rng.normal(size=(S, m)).astype(np.float32))
    sizes = np.ones(m, np.int32)
    keys = np.zeros(m, np.int32)
    proj = rng.normal(size=m).astype(np.float32)
    jv, js, jmi, jcs = jengine.chain_collapse(
        jnp.asarray(vals), jnp.asarray(sizes), jnp.asarray(keys),
        jnp.asarray(proj), jnp.float32(0.9), h=jnp.int32(1),
        permute="payload_sort")
    v2, s2, mi2, cs2 = engine.chain_collapse(
        T(vals), T(sizes), T(keys), T(proj), 0.9, h=1)
    assert sorted(s2[s2 > 0].tolist()) == [m - 32768, 32768]
    assert np.array_equal(s2.numpy(), np.asarray(js))
    assert np.array_equal(cs2.numpy(), np.asarray(jcs))
    assert np.array_equal(mi2.numpy(), np.asarray(jmi))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("keep", [[3, 1, 7, 20], [3]])
def test_state_from_numpy_is_contiguous(keep):
    """A column selection of a state, as the sharded ending takes its
    survivors (one of them too), reaches the engine with a last stride of
    1, which the card's kernels check: numpy's selection of one column is
    C-contiguous with a stride of a row."""
    r = np.random.default_rng(0)
    vt = r.normal(size=(5, 40)).astype(np.float32)
    keep = np.array(keep)
    state = engine.state_from_numpy(vt[:, keep], np.ones(len(keep)), keep,
                                    np.arange(40), "cpu")
    assert all(t.is_contiguous() and t.stride(-1) == 1 for t in state)
    assert np.array_equal(state[0].numpy(), vt[:, keep])


def test_one_iteration_folds_parent_like_the_reference():
    """engine._one_iteration (keys from the port's own projection) on the
    JAX head state: a valid forest step — every slot kept or pointing at an
    alive head, total size preserved."""
    base, vt, sizes, slots, parent = _jax_head_state(5)
    tv, ts, tslots, tparent = engine.state_from_numpy(
        vt, sizes, slots, parent, "cpu")
    before = tparent.clone()
    planes = np.array(jlsh.draw_hyperplanes(jax.random.fold_in(base, 1),
                                            vt.shape[0]))
    v2, s2, sl2, _ = engine._one_iteration(
        tv, ts, tslots, tparent, T(planes), 0.9, engine._active_h(ts))
    assert int(s2.sum()) == int(ts.sum())
    changed = (tparent != before).nonzero().flatten()
    assert len(changed) == int((ts > 0).sum()) - int((s2 > 0).sum())
    alive_slots = set(sl2[s2 > 0].tolist())
    assert set(tparent[changed].tolist()) <= alive_slots


def test_compact_sort_matches_jax():
    rng = np.random.default_rng(9)
    S, m = 6, 5000
    vals = rng.normal(size=(S, m)).astype(np.float32)
    sizes = rng.integers(0, 3, size=m).astype(np.int32)
    slots = rng.permutation(m).astype(np.int32)
    jv, js, jsl = jengine.compact_sort(jnp.asarray(vals), jnp.asarray(sizes),
                                       jnp.asarray(slots), "payload_sort")
    tv, ts, tsl = engine.compact_sort(T(vals), T(sizes), T(slots))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tsl.numpy(), np.asarray(jsl))


# --- a session's hyperplanes, drawn at once --------------------------------

def test_session_draws_its_planes_as_the_hook_would():
    """cluster_counts on the CPU without a hook (the schedule's planes
    drawn at once) gives the session a hook of per-iteration draws gives,
    and neither draws on a card."""
    from kmerlsh_tpu_torch import testdata
    from kmerlsh_tpu_torch.ops import rng

    counts, v = testdata.session_input(3000, 20, 5, "cpu")
    thr = np.r_[0.95, 0.95 - 0.015 * np.arange(10)].astype(np.float32)
    seed = 2**32 - 3
    got = engine.cluster_counts(counts, v, thr, seed=seed)
    assert engine.LAST_SESSION["planes_launches"] == 0
    want = engine.cluster_counts(
        counts, v, thr, seed=seed,
        hyperplanes=lambda it: rng.draw_hyperplanes(seed, it, 20))
    assert engine.LAST_SESSION["planes_launches"] == 0
    for a, b in zip(got[:2] + (got[2].flat, got[2].offsets),
                    want[:2] + (want[2].flat, want[2].offsets)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 1 < len(got[1]) < 3000


# --- the state's moves into sort order ---------------------------------------

@pytest.mark.parametrize("merge,deep_init", [("chain", True),
                                             ("pairing", True),
                                             ("pairing", False)])
def test_session_counts_its_permutes(merge, deep_init):
    """LAST_SESSION["permute_launches"] on the CPU: a chain session calls
    kernels.permute_state once (compact_sort; each chain iteration moves
    its state inside kernels.chain_collapse), a pairing session once more
    for each pairing iteration."""
    from kmerlsh_tpu_torch import testdata

    counts, v = testdata.session_input(3000, 20, 7, "cpu")
    thr = np.r_[0.95, 0.95 - 0.015 * np.arange(6)].astype(np.float32)
    engine.cluster_counts(counts, v, thr, seed=3, merge=merge,
                          deep_init=deep_init)
    iters = sum(name.startswith("iter[")
                for name, _ in engine.LAST_SESSION["programs"])
    assert iters == len(thr)
    pairing = 0 if merge == "chain" else iters - deep_init
    assert engine.LAST_SESSION["permute_launches"] == 1 + pairing


def test_permutes_outside_a_session_are_not_counted():
    """pairing_merge called outside any session moves its state through
    kernels.permute_state twice, and leaves the last session's
    LAST_SESSION["permute_launches"] as it was."""
    from kmerlsh_tpu_torch import testdata

    counts, v = testdata.session_input(3000, 20, 7, "cpu")
    engine.cluster_counts(counts, v, np.float32([0.95, 0.9]), seed=3)
    assert engine.LAST_SESSION["permute_launches"] == 1
    r = np.random.default_rng(5)
    m = 64
    values = torch.from_numpy(r.standard_normal((20, m)).astype(np.float32))
    keys = torch.from_numpy(r.integers(0, 4, m).astype(np.int32))
    proj = torch.from_numpy(r.standard_normal(m).astype(np.float32))
    before = engine._permutes
    engine.pairing_merge(values, torch.ones(m, dtype=torch.int32), keys,
                         proj, 0.5, 2)
    assert engine._permutes == before + 2
    assert engine.LAST_SESSION["permute_launches"] == 1


def test_pairing_iteration_without_merged_into():
    """A pairing iteration that its caller asks for no merged_into returns
    None for it, and the same state and forest as one that returns it."""
    from kmerlsh_tpu_torch import kernels, testdata
    from kmerlsh_tpu_torch.ops import rng

    counts, v = testdata.session_input(3000, 20, 9, "cpu")
    values, sizes = kernels.abundance_transform(counts, torch.from_numpy(v))
    slots = torch.arange(3000, dtype=torch.int32)
    planes = rng.draw_hyperplanes(4, 0, 20)
    outs = []
    for merged in (True, False):
        parent = slots.clone()
        outs.append((engine._one_iteration(values, sizes, slots, parent,
                                           planes, 0.95, 11, "pairing", 4,
                                           merged=merged), parent))
    (full, p_full), (bare, p_bare) = outs
    assert bare[3] is None and int((full[3] >= 0).sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(full[:3], bare[:3]))
    assert torch.equal(p_full, p_bare)


def test_chain_iteration_without_merged_into():
    """A chain iteration that its caller asks for no merged_into returns
    None for it, and the same state and forest as one that makes it."""
    from kmerlsh_tpu_torch import kernels, testdata
    from kmerlsh_tpu_torch.ops import rng

    counts, v = testdata.session_input(3000, 20, 9, "cpu")
    values, sizes = kernels.abundance_transform(counts, torch.from_numpy(v))
    slots = torch.arange(3000, dtype=torch.int32)
    planes = rng.draw_hyperplanes(4, 0, 20)
    outs = []
    for merged in (True, False):
        parent = slots.clone()
        outs.append((engine._one_iteration(values, sizes, slots, parent,
                                           planes, 0.95, 11, merged=merged),
                     parent))
    (full, p_full), (bare, p_bare) = outs
    assert bare[3] is None and int((full[3] >= 0).sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(full[:3], bare[:3]))
    assert torch.equal(p_full, p_bare)
