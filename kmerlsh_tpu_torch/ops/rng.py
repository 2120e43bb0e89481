"""Threefry-2x32 keys and float32 normals, bit for bit as ``jax.random``
draws them with ``jax_threefry_partitionable = True``.

The reference draws each iteration's hyperplanes as
``jax.random.normal(fold_in(PRNGKey(seed), it), (S, 31))``
(kmerlsh_tpu/ops/lsh.py:27-30). This module repeats that on CPU tensors:

* ``PRNGKey(seed)`` is the uint32 pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* in the partitionable layout the element at flat index ``i`` hashes the
  counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and its 32 random bits are the
  XOR of the two output words;
* ``uniform`` keeps the top 23 bits as a mantissa in [1, 2), subtracts 1 and
  maps to [lo, 1) with ``lo = nextafter(-1, 0)``;
* ``normal`` is ``sqrt(2) · erfinv(u)`` with XLA's single-precision erfinv
  (Giles' polynomial after ``w = -log1p(-u²)``).

Key data and uniform bits match exactly; the normals agree to a few ulp,
because ``log1p`` is evaluated by :mod:`.xlamath`'s emulation of XLA's.
uint32 words ride in int64 tensors so that wrap-around is an explicit mask.
A key's words may be int64 tensors of shape [I, 1]: the draw then has a
leading axis of I keys (:func:`draw_planes`, every iteration at once).

:func:`draw_planes` is the plain twin of the ``draw_planes`` CUDA kernel
(``csrc/planes.cu``), which draws a session's planes on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from kmerlsh_tpu_torch.ops import xlamath

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


def random_bits(key, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), partitionable
    layout; [I, *shape] for a key of [I, 1] tensors."""
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    a, b = threefry2x32(key, i >> 32, i & _M32)
    return (a ^ b).reshape(a.shape[:-1] + tuple(shape))


def uniform(key, shape, minval: float, maxval: float) -> torch.Tensor:
    return _uniform_of_bits(random_bits(key, shape), minval, maxval)


def _uniform_of_bits(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo, (mant - 1.0) * span + lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv (Giles): a degree-8 polynomial in
    ``w - 2.5`` or ``sqrt(w) - 3`` with ``w = -log1p(-x²)``."""
    w = -xlamath.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = xlamath.fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape) -> torch.Tensor:
    return normal_of_bits(random_bits(key, shape))


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The float32 normal that ``normal`` makes of 32 random bits (int64
    holding uint32); only the top 23 bits matter."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = _uniform_of_bits(bits, lo, 1.0)
    return torch.tensor(np.sqrt(2.0), dtype=torch.float32) * erfinv(u)


def draw_hyperplanes(seed: int, it: int, num_samples: int) -> torch.Tensor:
    """f32 [num_samples, H_MAX + 1] on the CPU: iteration ``it``'s planes."""
    return normal(fold_in(PRNGKey(seed), it), (num_samples, H_MAX + 1))


def draw_planes(seed: int, iterations: int, num_samples: int) -> torch.Tensor:
    """f32 [iterations, num_samples, H_MAX + 1] on the CPU: slice ``it`` is
    ``draw_hyperplanes(seed, it, num_samples)`` bit for bit, the same ops
    over every iteration's key at once."""
    its = torch.arange(iterations, dtype=torch.int64)[:, None]
    key = threefry2x32(PRNGKey(seed), torch.zeros_like(its), its & _M32)
    return normal(key, (num_samples, H_MAX + 1))
