"""Batched two-sample pooled Student's t-test (port of
kmerlsh_tpu/ops/ttest.py).

Semantics of the reference (``alglib::studentttest2`` per cluster):

  s     = sqrt( (SSx + SSy) · (1/n + 1/m) / (n + m − 2) )
  stat  = (x̄ − ȳ) / s
  left  = P(T_{n+m−2} ≤ stat),  right = 1 − left,  both = 2·min(left, right)
  s = 0 degenerate: left = [x̄ ≥ ȳ], right = [x̄ ≤ ȳ], both = [x̄ = ȳ]

and ``AB::WRS``: only clusters with size > size_thresh are tested;
left ≤ p ⇒ group 2, else right ≤ p ⇒ group 1.

torch has no ``betainc``. :func:`betainc` is the algorithm of XLA's
``regularized_incomplete_beta`` in float32 (jax/_src/lax/special.py): a
Lentz–Thompson–Barnett continued fraction of at most 200 steps with
small = threshold = eps/2, the symmetry swap at x ≥ (a+1)/(a+b+2), and an
lgamma prefactor. XLA iterates until every element of the batch has
converged; here each element stops at its own convergence, so p-values
agree with JAX to a tolerance, not bit for bit.

The column sums run in column order, one add at a time, and every division
is a true division, so that the CUDA kernel (``kernels.wrs_verdicts``,
csrc/ttest.cu) can repeat every rounding step of these plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

SMALL = 2.0 ** -24                  # float32 eps / 2: XLA's small and threshold
MAX_ITER = 200                      # XLA's float32 iteration cap
VERY_SMALL = float(np.finfo(np.float32).tiny) * 2


def _partial_numerator(it: int, a, b, x):
    """The it-th partial numerator of the fraction (DLMF 8.17.23), in
    XLA's evaluation order."""
    if it == 1:
        return torch.ones_like(x)
    m = (it - 1) // 2
    if it % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / (
            (a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _continued_fraction(a, b, x):
    """(the fraction's value, the steps each element took)."""
    h = torch.full_like(x, SMALL)    # partial denominator 0 is 0 < small
    c = h.clone()
    d = torch.zeros_like(x)
    active = torch.ones_like(x, dtype=torch.bool)
    steps = torch.zeros_like(x, dtype=torch.int32)
    for it in range(1, MAX_ITER):
        steps += active
        pn = _partial_numerator(it, a, b, x)
        cn = 1.0 + pn / c
        cn = torch.where(cn.abs() < SMALL, SMALL, cn)
        dn = 1.0 + pn * d
        dn = torch.reciprocal(torch.where(dn.abs() < SMALL, SMALL, dn))
        delta = cn * dn
        c = torch.where(active, cn, c)
        d = torch.where(active, dn, d)
        h = torch.where(active, h * delta, h)
        active &= (delta - 1.0).abs() >= SMALL
        if not bool(active.any()):
            break
    return h, steps


def _swap(a, b, x):
    """XLA's symmetry swap: (rapid, a, b, x), a and b exchanged and x
    reflected where x ≥ (a+1)/(a+b+2)."""
    rapid = x < (a + 1.0) / (a + b + 2.0)
    return (rapid, torch.where(rapid, a, b), torch.where(rapid, b, a),
            torch.where(rapid, x, 1.0 - x))


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    """Regularized incomplete beta I_x(a, b), float32, elementwise."""
    a, b, x = torch.broadcast_tensors(*(t.to(torch.float32) for t in (a, b, x)))
    inf = float("inf")
    a_zero = (a == 0) | (b == inf)
    b_zero = (b == 0) | (a == inf)
    x_zero, x_one = x == 0, x == 1
    res_zero = (b_zero & ~x_one) | (a_zero & x_zero)
    res_one = (a_zero & ~x_zero) | (b_zero & x_one)
    res_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero)
               | a.isnan() | b.isnan() | x.isnan())
    rapid, a, b, x = _swap(a, b, x)
    cf, _ = _continued_fraction(a, b, x)
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    l1x = torch.log1p(-x)
    factor = torch.where(
        a < VERY_SMALL, torch.exp(l1x * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + l1x * b - lbeta) / a)
    r = cf * factor
    r = torch.where(rapid, r, 1.0 - r)
    r = torch.where(res_zero, 0.0, r)
    r = torch.where(res_one, 1.0, r)
    return torch.where(res_nan, float("nan"), r)


def t_cdf(t: torch.Tensor, df) -> torch.Tensor:
    """Student's t CDF via the regularized incomplete beta function."""
    t = t.to(torch.float32)
    df = torch.as_tensor(df, dtype=torch.float32, device=t.device)
    x = df / (df + t * t)
    ib = betainc(df / 2.0, torch.full_like(t, 0.5), x)
    return torch.where(t >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def _row_sum(m: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(m.shape[0], dtype=torch.float32, device=m.device)
    for j in range(m.shape[1]):
        acc = acc + m[:, j]
    return acc


def _statistic(values: torch.Tensor, n1: int, n2: int):
    """(x̄, ȳ, ok, the t statistic, df) of each row: ok where s > 0 and
    df > 0; the statistic is (x̄ − ȳ) / s there."""
    v = values.to(torch.float32)

    def f32(c):
        # a divisor on the values' device: PyTorch's CUDA division by a
        # host scalar multiplies by its reciprocal, which rounds otherwise
        return torch.tensor(float(c), dtype=torch.float32, device=v.device)

    x, y = v[:, :n1], v[:, n1:n1 + n2]
    xm = _row_sum(x) / f32(n1)
    ym = _row_sum(y) / f32(n2)
    dx, dy = x - xm[:, None], y - ym[:, None]
    ss = _row_sum(dx * dx) + _row_sum(dy * dy)
    df = n1 + n2 - 2
    s = torch.sqrt(ss * (1.0 / n1 + 1.0 / n2) / f32(max(df, 1)))
    ok = (s > 0) & (df > 0)
    return xm, ym, ok, (xm - ym) / torch.where(ok, s, 1.0), df


def studentttest2(values: torch.Tensor, n1: int, n2: int):
    """values f32 [N, ≥ n1+n2] (group A columns first) → (bothtails,
    lefttail, righttail), each f32 [N]."""
    xm, ym, ok, stat, df = _statistic(values, n1, n2)
    p = t_cdf(stat, float(df))
    left = torch.where(ok, p, (xm >= ym).to(torch.float32))
    right = torch.where(ok, 1.0 - p, (xm <= ym).to(torch.float32))
    both = torch.where(ok, 2.0 * torch.minimum(p, 1.0 - p),
                       (xm == ym).to(torch.float32))
    return both, left, right


def fraction_steps(values: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """int32 [N]: the steps of each row's continued fraction in
    studentttest2 (0 where s = 0 or df = 0), the work a lane of the
    ``wrs_verdicts`` kernel spends on the row."""
    _, _, ok, stat, df = _statistic(values, n1, n2)
    dff = torch.tensor(float(df), dtype=torch.float32, device=stat.device)
    x = dff / (dff + stat * stat)
    a, b, x = torch.broadcast_tensors(dff / 2.0, torch.full_like(x, 0.5), x)
    _, a, b, x = _swap(a, b, x)
    _, steps = _continued_fraction(a, b, x)
    return torch.where(ok, steps, 0)


def verdicts_of(left, right, sizes, pval_thresh: float, size_thresh: int):
    """int8 [N]: 2 where left ≤ p (checked first), else 1 where right ≤ p,
    else 0; 0 wherever size ≤ size_thresh."""
    p = torch.tensor(pval_thresh, dtype=torch.float32, device=left.device)
    v = torch.where(left <= p, 2, torch.where(right <= p, 1, 0))
    return torch.where(sizes > size_thresh, v, 0).to(torch.int8)


def wrs_verdicts(values, sizes, n1: int, n2: int, pval_thresh: float,
                 size_thresh: int, device="cuda") -> np.ndarray:
    """Vectorized ``AB::WRS`` over all clusters on ``device`` (the
    ``wrs_verdicts`` kernel on a card): values f32 [N, n1+n2] and sizes
    [N] (numpy) → int8 [N] verdicts (0 / 1 / 2) on the host."""
    from kmerlsh_tpu_torch import kernels

    dev = torch.device(device)
    vals = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(dev)
    sz = torch.from_numpy(np.ascontiguousarray(sizes, np.int32)).to(dev)
    verdict, _, _ = kernels.wrs_verdicts(vals, sz, n1, n2, pval_thresh,
                                         size_thresh)
    return verdict.cpu().numpy()
