"""float32 ``log``, ``log1p`` and ``log2`` in XLA's CPU operation order.

Two host-side decisions of the engine go through a float32 logarithm: the
hyperplane draw (``normal`` = ``sqrt(2)·erfinv(u)``, whose ``erfinv`` starts
with ``log1p(-u²)``) and the active hyperplane count
``h = floor(log2(float32(n_alive)))``. XLA evaluates both with its own
polynomial (the Cephes ``logf`` coefficients and the Cephes ``log1p``
rational), which is not correctly rounded: ``floor(log2(8192.0))`` is 12
there. To give the reference's hyperplanes and the reference's ``h``, these
helpers repeat XLA's evaluation step by step on CPU tensors, with fused
multiply-adds emulated in float64.
"""

from __future__ import annotations

import torch

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_SQRT_HALF = 0.707106781186547524
_LOG1P_SMALL = 0.41421356237309504880      # sqrt(2) - 1
_INV_LN2 = 1.4426950408889634        # 1 / ln 2


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c with one rounding (the product is exact in float64)."""
    return (a.double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v, dtype=torch.float32)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal ``x``, XLA CPU order."""
    m, ex = torch.frexp(x)                  # x = m·2^ex, m in [0.5, 1)
    small = m < _SQRT_HALF
    e = ex.float() - small.float()
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    p = [_f32(v, t) for v in _LOG_P]
    y = fma(t, p[0], p[1])
    y1 = fma(t, p[3], p[4])
    y2 = fma(t, p[6], p[7])
    y = fma(y, t, p[2])
    y1 = fma(y1, t, p[5])
    y2 = fma(y2, t, p[8])
    y = fma(y, t3, y1)
    y = fma(y, t3, y2)
    y = y * t3
    y = fma(_f32(-2.12194440e-4, t), e, y)
    t = t - t2 * 0.5
    t = t + y
    return t + _f32(0.693359375, t) * e


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x): the Cephes rational below |x| < sqrt(2) - 1,
    ``log(1 + x)`` above, as XLA's elemental emitter does."""
    x2 = x * x
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for c in _LOG1P_NUM:
        num = fma(num, x, _f32(c, x))
    for c in _LOG1P_DEN:
        den = fma(den, x, _f32(c, x))
    r = (x * x2) * (num / den)
    r = fma(_f32(-0.5, x), x2, r)
    small = x + r
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(1.0 + x))


def log2(x: torch.Tensor) -> torch.Tensor:
    """float32 log2 as ``log(x) · (1 / ln 2)``."""
    return log(x) * _f32(_INV_LN2, x)
