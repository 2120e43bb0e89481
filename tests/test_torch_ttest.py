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


# --- the wrs_verdicts kernel's arithmetic, transcribed ------------------------

def _step_table(a: torch.Tensor):
    """csrc/ttest.cu wrs_constants: each step's partial-numerator
    coefficient and denominator for the pairs (a, b) and (b, a), b = 1/2,
    in the kernel's float32 operations → (coef, den), each f32
    [2, MAX_ITER, len(a)] (steps 0 and 1 hold 1)."""
    b = torch.full_like(a, 0.5)
    coef = torch.ones(2, ttest.MAX_ITER, len(a))
    den = torch.ones(2, ttest.MAX_ITER, len(a))
    for pair, (aa, bb) in enumerate(((a, b), (b, a))):
        for it in range(2, ttest.MAX_ITER):
            mi = (it - 1) // 2
            m = float(mi)
            a2m = aa + 2.0 * m
            if it % 2 == 0 and mi == 0:
                coef[pair, it], den[pair, it] = -(aa + bb), aa + 1.0
            elif it % 2 == 0:
                coef[pair, it] = -(aa + m) * ((aa + bb) + m)
                den[pair, it] = a2m * (a2m + 1.0)
            else:
                coef[pair, it] = m * (bb - m)
                den[pair, it] = (a2m - 1.0) * a2m
    return coef, den


def test_step_table_gives_the_partial_numerators_bit_for_bit():
    """For every df from 0 to 600 and both pairs after the swap, a step's
    (coef · x) / den is _partial_numerator's value, bit for bit."""
    df = torch.arange(601, dtype=torch.float32)
    a = df / 2.0
    coef, den = _step_table(a)
    x = torch.tensor([0.0, 1.0, 2.0 ** -24, 1e-30, 0.3, 0.5, 0.8696, 0.9999,
                      1 - 2.0 ** -24, 0.123456], dtype=torch.float32)
    b = torch.full_like(a, 0.5)
    for pair, (aa, bb) in enumerate(((a, b), (b, a))):
        A, B, X = (t.to(torch.float32) for t in torch.broadcast_tensors(
            aa[:, None], bb[:, None], x[None, :]))
        for it in range(2, ttest.MAX_ITER):
            got = (coef[pair, it][:, None] * X) / den[pair, it][:, None]
            want = ttest._partial_numerator(it, A, B, X)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (pair, it)


def _kernel_fraction(stat: np.ndarray, ok: np.ndarray, df: int) -> dict:
    """A numpy transcription of kl_wrs_kernel's continued fraction for rows
    whose t statistics (and whether each needs the fraction) are ``stat``
    and ``ok`` (studentttest2's: the kernel's sums repeat them, but torch's
    CPU square root is not correctly rounded everywhere): the swap against
    the launch's threshold, the state after the first step (the same for
    every row), then the tabulated steps, each row to its own convergence.
    Returns {row: (h, x after the swap)} for every row that needs it."""
    f = np.float32
    dff = f(df)
    a, b = dff / f(2), f(0.5)
    thr = (a + f(1)) / ((a + b) + f(2))
    coef, den = (t[:, :, 0].numpy() for t in
                 _step_table(torch.tensor([a], dtype=torch.float32)))
    small = f(ttest.SMALL)
    cn1 = f(1) + f(1) / small          # step 1: pn = 1, c = small, d = 0
    dn1 = f(1) / (f(1) + f(1) * f(0))
    rows = np.flatnonzero(ok)
    t = stat[rows]
    x = dff / (dff + t * t)
    rapid = x < thr
    xx = np.where(rapid, x, f(1) - x)
    pair = np.where(rapid, 0, 1)
    h = np.full(len(rows), small * (cn1 * dn1), f)
    c = np.full(len(rows), cn1, f)
    d = np.full(len(rows), dn1, f)
    active = np.ones(len(rows), bool)
    for it in range(2, ttest.MAX_ITER):
        with np.errstate(all="ignore"):
            pn = (coef[pair, it] * xx) / den[pair, it]
            cn = f(1) + pn / c
            cn = np.where(np.abs(cn) < small, small, cn)
            dn = f(1) + pn * d
            dn = f(1) / np.where(np.abs(dn) < small, small, dn)
            delta = cn * dn
        h = np.where(active, h * delta, h)
        c, d = np.where(active, cn, c), np.where(active, dn, d)
        active &= np.abs(delta - f(1)) >= small
        if not active.any():
            break
    return {int(r): (h[i], xx[i]) for i, r in enumerate(rows)}


@pytest.mark.parametrize("n,n1,n2", [(5000, 10, 10), (700, 50, 50),
                                     (33, 1, 2), (2, 10, 10), (600, 3, 4)])
def test_kernel_fraction_gives_the_plain_tails(monkeypatch, n, n1, n2):
    """The kernel's continued fraction (the first step's state shared, each
    later step's partial numerator from the table) gives each row the
    plain version's value bit for bit: the plain tails, exactly, with the
    transcription's values in place of the fraction."""
    v = torch.from_numpy(_rows(n, n1, n2, seed=n + n1))
    _, _, ok, stat, df = ttest._statistic(v, n1, n2)
    got = _kernel_fraction(stat.numpy(), ok.numpy(), df)
    _, want_l, want_r = ttest.studentttest2(v, n1, n2)
    steps = ttest.fraction_steps(v, n1, n2)
    assert sorted(got) == np.flatnonzero(steps.numpy() > 0).tolist()
    rows = np.array(sorted(got), dtype=np.int64)

    def kernel_fraction(a, b, x):
        assert np.array_equal(x.numpy()[rows].view(np.int32), np.array(
            [got[r][1] for r in rows], np.float32).view(np.int32))
        h = torch.ones_like(x)
        h[rows] = torch.tensor([got[r][0] for r in rows])
        return h, torch.zeros_like(x, dtype=torch.int32)

    monkeypatch.setattr(ttest, "_continued_fraction", kernel_fraction)
    _, left, right = ttest.studentttest2(v, n1, n2)
    assert torch.equal(left, want_l) and torch.equal(right, want_r)


def test_fraction_steps_count_the_plain_iterations():
    """Rows with s = 0 take no step, t = 0 rows two (x reflects to 0), and
    the steps of the rest are those of the loop in _continued_fraction."""
    v = _rows(400, 10, 10, seed=5)
    steps = ttest.fraction_steps(torch.from_numpy(v), 10, 10).numpy()
    q = 400 // 10
    assert steps[3 * q] == 0 and steps[3 * q + 1] == 2
    assert steps.dtype == np.int32 and (steps[steps > 0] >= 2).all()
    assert (steps < ttest.MAX_ITER).all() and steps.max() > 10
