"""Each CUDA kernel against its plain PyTorch version on the same CUDA
inputs (the checks of chip_smoke.py phase 3, at small sizes). They need the
card: on a machine without one they skip."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import rng

pytestmark = pytest.mark.cuda

S = 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts(n, dev, seed=0, n_prof=None):
    r = np.random.default_rng(seed)
    prof = r.normal(size=(n_prof or max(8, n // 8), S)).astype(np.float32)
    prof /= np.linalg.norm(prof, axis=1, keepdims=True)
    rows = r.integers(0, len(prof), size=n)
    vals = 4.0 + prof[rows] + 0.01 * r.normal(size=(n, S))
    c = np.clip(np.rint(np.expm1(vals)), 0, 65535).astype(np.uint16)
    c[: n // 50] = 0                       # some columns fail the filter
    return torch.from_numpy(np.ascontiguousarray(c.T)).to(dev)


def _state(n, dev, n_prof=None):
    counts = _counts(n, dev, n_prof=n_prof)
    v = torch.full((S,), 3.5, dtype=torch.float32, device=dev)
    values, sizes = kernels.abundance_transform(counts, v)
    return counts, v, values, sizes


@pytest.mark.parametrize("n", [1000, 1 << 16])
def test_transform_and_keys_exact(dev, n):
    counts, v, values, sizes = _state(n, dev)
    pv, ps = kernels.abundance_transform_plain(counts, v)
    assert torch.equal(values, pv) and torch.equal(sizes, ps)
    planes = rng.draw_hyperplanes(0, 0, S).to(dev)
    for h in (1, engine._active_h(sizes), 30):
        k = kernels.lsh_keys(values, sizes, planes, h)
        p = kernels.lsh_keys_plain(values, sizes, planes, h)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    # a column slice of a wider matrix (the engine's shrunk capacity)
    half = n // 2
    k = kernels.lsh_keys(values[:, :half], sizes[:half], planes, 9)
    p = kernels.lsh_keys_plain(values[:, :half].contiguous(), sizes[:half],
                               planes, 9)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_permute_exact(dev):
    _, _, values, sizes = _state(1 << 16, dev)
    slots = torch.randperm(1 << 16, device=dev).to(torch.int32)
    order = torch.randperm(40000, device=dev)
    k = kernels.permute_state(values[:, :40000], sizes[:40000],
                              slots[:40000], order)
    p = kernels.permute_state_plain(values[:, :40000], sizes[:40000],
                                    slots[:40000], order)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.parametrize("n,thr", [(1 << 16, 0.95), (70000, 0.5)])
def test_chain_collapse_matches_plain(dev, n, thr):
    # 16 profiles in 8 buckets: chains thousands long, across tile borders
    _, _, values, sizes = _state(n, dev, n_prof=16)
    h = 3
    key, _ = kernels.lsh_keys(values, sizes,
                              rng.draw_hyperplanes(1, 1, S).to(dev), h)
    skey, order = torch.sort(key, stable=True)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    sv, ss, sl = kernels.permute_state(values, sizes, slots, order)
    smi = torch.where(torch.rand(n, device=dev) < 0.1, 7, -1).to(torch.int32)
    pk = torch.arange(n, dtype=torch.int32, device=dev)
    pp = pk.clone()
    k = kernels.chain_collapse(sv, ss, sl, skey, thr, h, smi, pk)
    p = kernels.chain_collapse_plain(sv, ss, sl, skey, thr, h, smi, pp)
    assert int((k[3] >= 0).sum()) > n // 4
    for a, b in ((k[1], p[1]), (k[2], p[2]), (k[3], p[3]), (pk, pp)):
        assert torch.equal(a, b)
    # the kernel sums each chain in another order than the log-step scan
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)


def test_finalize_exact(dev):
    n = 1 << 15
    _, _, vt, sz = _state(n, dev)
    sl = torch.arange(n, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(6):
        na = int((sz > 0).sum())
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(2, it, S).to(dev),
            0.95 - 0.02 * it, engine._active_h_of(na))
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    args = (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int(k[1].sum()) == n - n // 50


def test_wrappers_refuse_bad_input(dev):
    counts, v, values, sizes = _state(1000, dev)
    with pytest.raises(ValueError):
        kernels.lsh_keys(values, sizes.to(torch.int64),
                         rng.draw_hyperplanes(0, 0, S).to(dev), 5)
    with pytest.raises(ValueError):
        kernels.lsh_keys(values, sizes.cpu(),
                         rng.draw_hyperplanes(0, 0, S).to(dev), 5)
