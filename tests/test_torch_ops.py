"""The port's transform, signatures, sort key and active-h against the JAX
package on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.ops import lsh as jlsh, transform as jtransform
from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import lsh, segment, transform

BIG = lsh.BIG_KEY


def _planes(seed, it, s):
    return np.array(jlsh.draw_hyperplanes(
        jax.random.fold_in(jax.random.PRNGKey(seed), it), s))


@pytest.mark.parametrize("s", [3, 10, 20])
def test_abundance_transform_matches_jax(s):
    r = np.random.default_rng(s)
    counts = r.integers(0, 3, size=(s, 500)).astype(np.uint16)
    counts[:, :100] = r.integers(0, 65536, size=(s, 100))
    counts[:, 100:110] = 0
    v = r.normal(3.0, 1.0, size=s).astype(np.float32)
    jv, jkeep = jtransform.abundance_transform_t(counts, v)
    tv, tkeep = transform.abundance_transform_t(
        torch.from_numpy(counts), torch.from_numpy(v))
    # float32 log1p of two libraries: a few ulp on values of magnitude ~1-10
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    kv, ks = kernels.abundance_transform(torch.from_numpy(counts),
                                         torch.from_numpy(v))
    assert torch.equal(kv, tv) and torch.equal(ks, tkeep.to(torch.int32))


@pytest.mark.parametrize("h", [1, 5, 14, 30])
def test_signatures_match_jax_on_its_planes(h):
    s, m = 20, 4000
    r = np.random.default_rng(h)
    vals = r.normal(size=(s, m)).astype(np.float32)
    vals[:, 0] = 0.0                        # projections exactly 0 → bit 1
    planes = _planes(3, h, s)
    jk, jp = jlsh.signatures_t(jnp.asarray(vals), jnp.asarray(planes), h)
    tk, tp = lsh.signatures_t(torch.from_numpy(vals),
                              torch.from_numpy(planes), h)
    jk, jp = np.asarray(jk), np.asarray(jp)
    # the reference's jnp.dot sums in another order: ulps of sums of S
    # terms of magnitude ~1
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5, atol=1e-5)
    assert tk[0] == jk[0] == (1 << h) - 1
    full = np.asarray(jnp.dot(jnp.asarray(planes).T, jnp.asarray(vals)))
    safe = (np.abs(full[:h]) > 1e-4).all(axis=0)
    assert safe.mean() > 0.9
    assert np.array_equal(tk.numpy()[safe], jk[safe])


def _jax_key(keys, proj, sizes, h):
    return np.asarray(jengine._combined_sort_key(
        jnp.asarray(keys), jnp.asarray(proj), jnp.asarray(sizes),
        jnp.int32(h)))


@pytest.mark.parametrize("h", [1, 2, 13, 28, 29, 30])
def test_combined_sort_key_exact(h):
    r = np.random.default_rng(h)
    m = 3000
    sizes = r.integers(0, 4, size=m).astype(np.int32)
    keys = r.integers(0, 1 << h, size=m).astype(np.int32)
    keys[sizes == 0] = BIG
    proj = r.normal(size=m).astype(np.float32)
    proj[sizes == 0] *= 100.0        # dead rows outside the alive range
    want = _jax_key(keys, proj, sizes, h)
    got = lsh.combined_sort_key(torch.from_numpy(keys),
                                torch.from_numpy(proj),
                                torch.from_numpy(sizes), h)
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy()[sizes == 0] == BIG).all()


def test_combined_sort_key_range_is_alive_only():
    """Dead rows never move the quantization: adding dead columns with
    extreme projections leaves every alive key as it was."""
    r = np.random.default_rng(1)
    keys = r.integers(0, 32, size=100).astype(np.int32)
    proj = r.normal(size=100).astype(np.float32)
    sizes = np.ones(100, np.int32)
    base = lsh.combined_sort_key(torch.from_numpy(keys),
                                 torch.from_numpy(proj),
                                 torch.from_numpy(sizes), 5)
    keys2 = np.concatenate([keys, np.full(50, BIG, np.int32)])
    proj2 = np.concatenate([proj, np.full(50, 1e6, np.float32)])
    sizes2 = np.concatenate([sizes, np.zeros(50, np.int32)])
    got = lsh.combined_sort_key(torch.from_numpy(keys2),
                                torch.from_numpy(proj2),
                                torch.from_numpy(sizes2), 5)
    assert torch.equal(got[:100], base)
    assert np.array_equal(got.numpy(), _jax_key(keys2, proj2, sizes2, 5))


def test_lsh_keys_wrapper_composes_the_plain_steps():
    r = np.random.default_rng(2)
    s, m, h = 6, 700, 9
    vals = torch.from_numpy(r.normal(size=(s, m)).astype(np.float32))
    sizes = torch.from_numpy(r.integers(0, 3, size=m).astype(np.int32))
    planes = torch.from_numpy(_planes(0, 0, s))
    key, proj = kernels.lsh_keys(vals, sizes, planes, h)
    k0, p0 = lsh.signatures_t(vals, planes, h)
    k0 = torch.where(sizes > 0, k0, BIG)
    assert torch.equal(proj, p0)
    assert torch.equal(key, lsh.combined_sort_key(k0, p0, sizes, h))


def test_active_h_matches_jax():
    ns = sorted({max(n, 0) for k in range(1, 31)
                 for n in (2**k - 2, 2**k - 1, 2**k, 2**k + 1)}
                | set(range(0, 3000, 7))
                | set(np.random.default_rng(0).integers(0, 2**30, 3000)
                      .tolist()))
    n = np.asarray(ns, np.int64)
    want = np.asarray(jax.jit(lambda x: jnp.clip(jnp.floor(jnp.log2(
        jnp.maximum(x, 2).astype(jnp.float32))).astype(jnp.int32), 1,
        jlsh.H_MAX))(n.astype(np.int32)))
    got = np.asarray([engine._active_h_of(int(x)) for x in n])
    assert np.array_equal(got, want)
    for m in (0, 1, 2, 8191, 8192, 8193):
        sizes = np.zeros(9000, np.int32)
        sizes[:m] = 1
        assert engine._active_h(torch.from_numpy(sizes)) == \
            int(jengine._active_h(jnp.asarray(sizes)))


def test_segment_starts():
    k = np.array([3, 3, 5, 5, 5, 9, BIG, BIG], np.int32)
    from kmerlsh_tpu.ops import segment as jsegment

    assert np.array_equal(
        segment.segment_starts(torch.from_numpy(k)).numpy(),
        np.asarray(jsegment.segment_starts(jnp.asarray(k))))
