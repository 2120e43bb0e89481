"""The port's t-test (ops/ttest.py and the plain version of the
``wrs_verdicts`` kernel) against the JAX package and scipy on the same
numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import special, stats

from kmerlsh_tpu.ops import ttest as jttest
from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.ops import ttest

# p-values of two float32 libraries: rtol 1e-4 / atol 1e-6 (measured on
# these inputs: at most 4.3e-6 absolute, 3e-5 relative). The port stops
# each row's continued fraction at its own convergence and sums each row in
# column order; XLA iterates until the whole batch has converged and sums
# in its own order, and its lgamma is another approximation.
RTOL, ATOL = 1e-4, 1e-6


def _rows(n, n1, n2, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, n1 + n2)).astype(np.float32)
    q = n // 10
    v[:q, :n1] += r.uniform(0, 30, size=(q, 1)).astype(np.float32)  # right
    v[q:2 * q, n1:] += 1e3                                     # |t| > 50
    v[2 * q:3 * q, n1:] += r.uniform(0, 3, size=(q, 1)).astype(np.float32)
    v[3 * q] = 1.0                                             # s = 0
    # t = 0: both groups symmetric around 0
    v[3 * q + 1, :n1] = np.arange(n1) - (n1 - 1) / 2
    v[3 * q + 1, n1:] = np.arange(n2) - (n2 - 1) / 2
    return v


@pytest.mark.parametrize("n,n1,n2", [(500, 10, 10), (50, 5, 7), (200, 2, 1),
                                     (200, 1, 2)])
def test_studentttest2_matches_jax(n, n1, n2):
    v = _rows(n, n1, n2, seed=n + n1)
    want = [np.asarray(a) for a in jttest.studentttest2(jnp.asarray(v), n1,
                                                        n2)]
    got = [a.numpy() for a in ttest.studentttest2(torch.from_numpy(v), n1,
                                                  n2)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (n,)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert got[1].min() < 1e-3 and got[2].max() > 1 - 1e-3   # |t| > 50
    zero = 3 * (n // 10) + 1
    assert got[1][zero] == 0.5 and got[2][zero] == 0.5


def test_t_zero_and_df_one():
    t = torch.tensor([0.0, 1e-3, -1e-3, 60.0, -60.0], dtype=torch.float32)
    got = ttest.t_cdf(t, 1.0).numpy()
    np.testing.assert_allclose(got, stats.t.cdf(t.numpy().astype(np.float64),
                                                 1), atol=2e-4)
    assert got[0] == 0.5


@pytest.mark.parametrize("df", [1, 2, 5, 18, 100])
def test_t_cdf_matches_scipy(df):
    """As test_ops.py holds JAX: within 2e-4 of scipy."""
    t = np.concatenate([np.linspace(-60, 60, 241), [0.0]]).astype(np.float32)
    got = ttest.t_cdf(torch.from_numpy(t), float(df)).numpy()
    np.testing.assert_allclose(got, stats.t.cdf(t.astype(np.float64), df),
                               atol=2e-4)


def test_betainc_edges():
    a = torch.tensor([2.0, 2.0, 2.0, float("nan"), 0.0, 2.0])
    x = torch.tensor([0.0, 1.0, 0.5, 0.5, 0.5, 1.5])
    got = ttest.betainc(a, torch.full_like(a, 0.5), x).numpy()
    assert got[0] == 0 and got[1] == 1
    assert got[2] == pytest.approx(special.betainc(2.0, 0.5, 0.5), abs=1e-6)
    assert np.isnan(got[3]) and got[4] == 1 and np.isnan(got[5])


def test_degenerate_zero_variance():
    """The s = 0 cases of test_ops.py, exactly."""
    rows = np.array([[1, 1, 1, 1, 1, 1],
                     [2, 2, 2, 1, 1, 1],
                     [1, 1, 1, 2, 2, 2]], dtype=np.float32)
    both, left, right = (a.tolist() for a in ttest.studentttest2(
        torch.from_numpy(rows), 3, 3))
    assert both == [1, 0, 0]
    assert left == [1, 1, 0]
    assert right == [1, 0, 1]


def test_tail_mapping_and_strict_size():
    """The tail → group mapping and the strict size_thresh of test_ops.py."""
    n1 = n2 = 4
    rows = np.zeros((3, 8), np.float32)
    rows[0, :n1] = 5.0
    rows[1, n1:] = 5.0
    rows[2] = np.random.default_rng(3).normal(size=8)
    sizes = np.array([100, 100, 100])
    v = ttest.wrs_verdicts(rows, sizes, n1, n2, 0.01, 10, device="cpu")
    assert v.dtype == np.int8 and list(v) == [1, 2, 0]
    v2 = ttest.wrs_verdicts(rows, sizes, n1, n2, 0.01, 100, device="cpu")
    assert list(v2) == [0, 0, 0]


@pytest.mark.parametrize("pval", [0.01, 0.05])
def test_wrs_verdicts_match_jax(pval):
    """Verdicts equal JAX's wherever JAX's tail lies outside 1e-4 relative
    of the threshold."""
    n1 = n2 = 10
    v = _rows(2000, n1, n2, seed=11)
    sizes = np.random.default_rng(12).integers(0, 60, size=2000)
    want = np.asarray(jttest.wrs_verdicts(v, sizes, n1, n2, pval, 20))
    got = ttest.wrs_verdicts(v, sizes, n1, n2, pval, 20, device="cpu")
    _, jl, jr = (np.asarray(a) for a in jttest.studentttest2(
        jnp.asarray(v), n1, n2))
    near = ((np.abs(jl - pval) <= 1e-4 * pval)
            | (np.abs(jr - pval) <= 1e-4 * pval))
    assert np.array_equal(got[~near], want[~near])
    assert (got == 1).sum() > 50 and (got == 2).sum() > 50


def test_kernel_wrapper_plain_on_cpu():
    """The K6 wrapper on CPU tensors is the plain version: verdicts and
    tails of ops.ttest."""
    v = torch.from_numpy(_rows(300, 10, 10, seed=4))
    sizes = torch.full((300,), 50, dtype=torch.int32)
    before = kernels.launches["wrs_verdicts"]
    verdict, left, right = kernels.wrs_verdicts(v, sizes, 10, 10, 0.01, 5)
    assert kernels.launches["wrs_verdicts"] == before
    _, pl, pr = ttest.studentttest2(v, 10, 10)
    assert torch.equal(left, pl) and torch.equal(right, pr)
    assert verdict.dtype == torch.int8
    assert torch.equal(verdict, ttest.verdicts_of(pl, pr, sizes, 0.01, 5))
