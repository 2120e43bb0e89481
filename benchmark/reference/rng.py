"""Frozen copies of kmerlsh_tpu_torch/ops/xlamath.py (float32 log, log1p
and log2 in XLA's CPU operation order) and kmerlsh_tpu_torch/ops/rng.py
(Threefry-2x32 keys and float32 normals as ``jax.random`` draws them): the
hyperplanes of iteration ``it`` of a session with seed ``seed``, and the
engine's bucket bits at a given alive count. Imports nothing of the
program."""

from __future__ import annotations

import numpy as np
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


H_MAX = 30   # keys fit int32; the extra plane H_MAX is the secondary order

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key: tuple[int, int], x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block (20 rounds) of the counter pairs (x1, x2)."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def PRNGKey(seed: int) -> tuple[int, int]:
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (0, seed)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    a, b = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                        torch.full((1,), data & _M32, dtype=torch.int64))
    return int(a), int(b)


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), partitionable
    layout."""
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    a, b = threefry2x32(key, i >> 32, i & _M32)
    return (a ^ b).reshape(shape)


def uniform(key, shape, minval: float, maxval: float) -> torch.Tensor:
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo, (mant - 1.0) * span + lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv (Giles): a degree-8 polynomial in
    ``w - 2.5`` or ``sqrt(w) - 3`` with ``w = -log1p(-x²)``."""
    w = -log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2.0), dtype=torch.float32) * erfinv(u)


def draw_hyperplanes(seed: int, it: int, num_samples: int) -> torch.Tensor:
    """f32 [num_samples, H_MAX + 1] on the CPU: iteration ``it``'s planes."""
    return normal(fold_in(PRNGKey(seed), it), (num_samples, H_MAX + 1))


def active_h(n_alive: int) -> int:
    """h = floor(log2(float32(max(n_alive, 2)))) clipped to [1, H_MAX],
    with XLA's float32 log2 (kmerlsh_tpu_torch/cluster/engine.py
    ``_active_h_of``)."""
    x = torch.tensor([float(max(n_alive, 2))], dtype=torch.float32)
    h = int(torch.floor(log2(x)).item())
    return min(max(h, 1), H_MAX)
