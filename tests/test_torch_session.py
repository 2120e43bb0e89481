"""Whole sessions of the port against the JAX engine run with float32 sort
payloads (PERMUTE = payload_sort), and the engine properties of
tests/test_cluster.py."""

import math

import numpy as np
import jax
import pytest
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.ops import lsh as jlsh
from kmerlsh_tpu_torch.cluster import engine

CPU = "cpu"


@pytest.fixture(autouse=True)
def f32_reference(monkeypatch):
    monkeypatch.setattr(jengine, "PERMUTE", "payload_sort")


def jax_planes(seed, s):
    """The reference's hyperplanes for the engine's hyperplanes= hook."""
    def planes(it):
        return np.array(jlsh.draw_hyperplanes(
            jax.random.fold_in(jax.random.PRNGKey(seed), it), s))
    return planes


def planted(rng, n_clusters=12, members=25, S=16, noise=0.01):
    centers = rng.normal(size=(n_clusters, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows, labels = [], []
    for c in range(n_clusters):
        rows.append((centers[c][None, :]
                     + noise * rng.normal(size=(members, S))).astype(
                         np.float32))
        labels += [c] * members
    rows = np.concatenate(rows)
    perm = rng.permutation(len(rows))
    return rows[perm], np.asarray(labels)[perm]


def partition_of(members, n):
    lab = np.full(n, -1)
    for c, ids in enumerate(members):
        lab[np.asarray(ids, int)] = c
    assert (lab >= 0).all()
    return lab


def same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_separated_data_same_partition_as_jax():
    rng = np.random.default_rng(5)
    X, labels = planted(rng, n_clusters=6, members=40, S=12, noise=0.005)
    jc, js, jm = jengine.cluster(X, min_similarity=0.92, iterations=25,
                                 seed=2)
    tc, ts, tm = engine.cluster(X, min_similarity=0.92, iterations=25,
                                seed=2, device=CPU)
    assert sorted(ts.tolist()) == sorted(js.tolist()) == [40] * 6
    assert same_partition(partition_of(tm, len(X)), partition_of(jm, len(X)))
    assert same_partition(partition_of(tm, len(X)), labels)
    # same order (smallest member first) and centroids to float32 rounding
    assert all(np.array_equal(a, b) for a, b in zip(tm, jm))
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)


def bench_counts(n_rows, S=20, seed=0):
    """bench.py make_data's distribution at a small row count."""
    rng = np.random.default_rng(seed)
    n_base = max(64, n_rows >> 7)
    cur = rng.normal(size=(n_base, S)).astype(np.float32)
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
    rows = rng.integers(0, len(pool), size=n_rows)
    vals = 4.0 + pool[rows]
    vals += 0.01 * rng.standard_normal((n_rows, S)).astype(np.float32)
    counts = np.clip(np.rint(np.expm1(vals)), 1, 65535).astype(np.uint16)
    cov = np.log(np.maximum(counts, 1).astype(np.float64)).sum(axis=0)
    return np.ascontiguousarray(counts.T), (cov / n_rows).astype(np.float32)


def test_hierarchy_cluster_count_close_to_jax():
    """The anneal-sensitive hierarchy at 2^14 x 20, I = 20: the port's own
    hyperplanes and projections differ from the reference's by ulps, which
    moves near-threshold links, so the count agrees within 2%; with the
    reference's hyperplanes handed in it agrees within 1%."""
    counts, v = bench_counts(1 << 14)
    thr = np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)]).astype(
        np.float32)
    _, js, jm = jengine.cluster_counts(counts, v, thr, seed=0)
    _, ts, tm = engine.cluster_counts(counts, v, thr, seed=0, device=CPU)
    _, hs, hm = engine.cluster_counts(counts, v, thr, seed=0, device=CPU,
                                      hyperplanes=jax_planes(0, 20))
    assert abs(len(tm) - len(jm)) <= 0.02 * len(jm)
    assert abs(len(hm) - len(jm)) <= 0.01 * len(jm)
    assert ts.sum() == js.sum() == counts.shape[1]
    assert len(jm) < counts.shape[1] // 4      # the anneal merged a lot


def test_deterministic():
    rng = np.random.default_rng(3)
    X, _ = planted(rng, n_clusters=8, members=10)
    r1 = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7,
                        device=CPU)
    r2 = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7,
                        device=CPU)
    assert np.array_equal(r1[0], r2[0])
    assert all(np.array_equal(a, b) for a, b in zip(r1[2], r2[2]))


def test_dissimilar_rows_never_merge():
    X = np.eye(8, dtype=np.float32)
    _, sizes, members = engine.cluster(X, min_similarity=0.8, iterations=20,
                                       seed=0, device=CPU)
    assert len(members) == 8
    assert sizes.tolist() == [1] * 8


def hierarchy(rng, n_base, levels, S, step=0.025):
    base = rng.normal(size=(n_base, S)).astype(np.float64)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    all_vecs, all_labels = [base], [np.arange(n_base)]
    cur, cur_lab = base, np.arange(n_base)
    for lev in range(levels):
        cos = 0.95 - (lev + 1) * step
        sin = np.sqrt(1 - cos * cos)
        kids, kid_lab = [], []
        for sgn in (1.0, -1.0):
            orth = rng.normal(size=cur.shape)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
            kid_lab.append(cur_lab)
        cur = np.concatenate(kids)
        cur_lab = np.concatenate(kid_lab)
        all_vecs.append(cur)
        all_labels.append(cur_lab)
    vecs = np.concatenate(all_vecs)
    labels = np.concatenate(all_labels)
    perm = rng.permutation(len(vecs))
    return vecs[perm].astype(np.float32), labels[perm]


def test_adversarial_chain_depth_resolves():
    rng = np.random.default_rng(0)
    X, labels = hierarchy(rng, n_base=4, levels=5, S=16)
    _, sizes, members = engine.cluster(X, min_similarity=0.70,
                                       iterations=60, seed=1, device=CPU)
    assert sum(len(g) for g in members) == len(X)
    assert int(sizes.sum()) == len(X)
    got = partition_of(members, len(X))
    assert len(set(zip(got.tolist(), labels.tolist()))) == len(set(got))
    assert len(members) < len(X) // 3
    assert max(len(g) for g in members) >= 8


def test_finalize_resolves_a_deep_chain():
    """A pure chain of depth 60 (one deepening per iteration of the
    adversarial run): every member resolves to the root, as the
    reference's pointer-jump bound guarantees."""
    total = 60
    cap = 128
    parent = np.arange(cap, dtype=np.int32)
    parent[1:total + 1] = np.arange(total)
    sizes = np.zeros(1, np.int32)
    sizes[0] = total + 1
    flat, lens, csizes, cents = engine._finalize_grouped(
        torch.zeros((4, 1)), torch.from_numpy(sizes),
        torch.zeros(1, dtype=torch.int32), torch.from_numpy(parent))
    assert lens.tolist() == [total + 1]
    assert flat[:total + 1].tolist() == list(range(total + 1))
    assert csizes.tolist() == [total + 1]
    jumps = max(6, math.ceil(math.log2(total + 2)) + 1)
    roots = parent
    for _ in range(jumps):
        roots = roots[roots]
    assert (roots[:total + 1] == 0).all()


def test_weighted_mean_exact():
    X = np.array([[1.0, 0.0], [0.999, 0.01]], np.float32)
    w = np.array([3, 1], np.int32)
    cents, sizes, members = engine.cluster(X, sizes=w, min_similarity=0.9,
                                           iterations=5, seed=0, device=CPU)
    assert len(members) == 1 and sizes[0] == 4
    want = (3 * X[0] + 1 * X[1]) / 4
    np.testing.assert_allclose(cents[0], want, atol=1e-6)
    jc, _, _ = jengine.cluster(X, sizes=w, min_similarity=0.9, iterations=5,
                               seed=0)
    np.testing.assert_array_equal(cents, jc)


def test_padded_and_unpadded_capacity_agree():
    """Zero columns past n are filtered rows: a padded count tensor gives
    the same clusters as the unpadded matrix."""
    counts, v = bench_counts(3000, S=8, seed=2)
    thr = (0.95 - 0.01 * np.arange(8)).astype(np.float32)
    c0, s0, m0 = engine.cluster_counts(counts, v, thr, seed=3, device=CPU)
    padded = np.zeros((counts.shape[0], 4096), np.uint16)
    padded[:, :counts.shape[1]] = counts
    c1, s1, m1 = engine.cluster_counts(torch.from_numpy(padded), v, thr,
                                       seed=3, n=counts.shape[1])
    assert np.array_equal(s0, s1)
    assert len(m0) == len(m1)
    assert all(np.array_equal(a, b) for a, b in zip(m0, m1))
    np.testing.assert_array_equal(c0, c1)
    assert engine.LAST_SESSION["pull_bytes"] > 0
    assert {"device_seconds", "pull_seconds", "programs"} <= set(
        engine.LAST_SESSION)


def test_filtered_rows_never_cluster():
    """Columns failing Σcount > 0.1·S are dead from the start and belong to
    no cluster; a matrix of such columns gives no clusters at all."""
    S = 10
    counts = np.zeros((S, 6), np.uint16)
    counts[:, 0] = 50
    counts[:, 1] = 50
    counts[0, 2] = 1
    counts[:, 3] = 30
    thr = np.full(4, 0.5, np.float32)
    _, sizes, members = engine.cluster_counts(counts, np.zeros(S, np.float32),
                                              thr, seed=0, device=CPU)
    covered = np.concatenate(list(members))
    assert not {2, 4, 5} & set(covered.tolist())
    assert int(sizes.sum()) == 3
    _, sizes, members = engine.cluster_counts(
        np.zeros((S, 5), np.uint16), np.zeros(S, np.float32), thr, seed=0,
        device=CPU)
    assert len(members) == 0 and len(sizes) == 0
