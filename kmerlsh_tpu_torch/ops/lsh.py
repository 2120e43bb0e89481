"""Random-hyperplane LSH signatures and the fused int32 sort key.

Port of kmerlsh_tpu/ops/lsh.py (signatures_t, its row-major twin
signatures, p_stable_signatures) and
kmerlsh_tpu/cluster/engine.py:_combined_sort_key. These are the plain
versions; on the card an iteration runs the ``lsh_keys`` kernel
(kmerlsh_tpu_torch/kernels), which computes the same numbers in the same
order.

Key packing: hyperplane 0 is the most significant bit and a projection of
exactly 0 gives bit 1. The projection is accumulated over samples in a fixed
order (s = 0, 1, …), one rounded multiply and one rounded add per term, so
kernel and plain version agree bit for bit. The reference's ``jnp.dot`` sums
in another order: its projections differ from these by ulps.
"""

from __future__ import annotations

import torch

from kmerlsh_tpu_torch.ops.rng import H_MAX

BIG_KEY = 2**31 - 1  # sentinel: dead slots sort to the end
KEY_BITS = BIG_KEY.bit_length()   # bits of every combined key, BIG_KEY too


def project(values_t: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """[H_MAX + 1, M] projections, summed over s in order."""
    planes = hyperplanes.to(values_t.device, torch.float32)
    proj = torch.zeros((planes.shape[1], values_t.shape[1]),
                       dtype=torch.float32, device=values_t.device)
    for s in range(values_t.shape[0]):
        proj = proj + planes[s][:, None] * values_t[s][None, :]
    return proj


def signatures_t(values_t: torch.Tensor, hyperplanes: torch.Tensor, h: int):
    """values_t f32 [S, M]; hyperplanes [S, H_MAX + 1]; 1 ≤ h ≤ H_MAX.

    Returns (keys int32 [M] from the first h sign bits big-endian,
    proj f32 [M] the secondary projection on plane H_MAX)."""
    p = project(values_t, hyperplanes)
    keys = torch.zeros(values_t.shape[1], dtype=torch.int32,
                       device=values_t.device)
    for j in range(h):
        keys = keys | ((p[j] >= 0).to(torch.int32) << (h - 1 - j))
    return keys, p[H_MAX]


def signatures(values: torch.Tensor, hyperplanes: torch.Tensor, h: int):
    """Row-major twin of :func:`signatures_t`: values f32 [M, S], the same
    key packing and the same order of summation."""
    return signatures_t(values.T, hyperplanes, h)


def p_stable_signatures(values: torch.Tensor, hyperplanes: torch.Tensor,
                        h: int, b: float = 0.0, r: float = 1.0):
    """p-stable LSH buckets floor((x·a + b) / r) on the planes [:, :H_MAX]
    (int32 [M, H_MAX]; values f32 [M, S]), columns >= h zeroed."""
    planes = hyperplanes[:, :H_MAX].to(values.device, torch.float32)
    p = torch.matmul(values.to(torch.float32), planes)
    q = torch.floor((p + b) / r).to(torch.int32)
    i = torch.arange(H_MAX, device=values.device)
    return torch.where(i[None, :] < h, q, 0)


def combined_sort_key(keys: torch.Tensor, proj: torch.Tensor,
                      sizes: torch.Tensor, h: int) -> torch.Tensor:
    """(bucket key << (30 − h)) | secondary projection quantized into
    2^(30 − h) levels over the ALIVE rows' range; dead keys stay BIG_KEY.
    Alive-only range ⇒ the order is the same at any capacity."""
    alive = sizes > 0
    free = min(max(30 - h, 0), 29)
    levels = 1 << free
    inf = torch.tensor(float("inf"), device=proj.device)
    pmin = torch.where(alive, proj, inf).min()
    pmax = torch.where(alive, proj, -inf).max()
    span = torch.clamp(pmax - pmin, min=1e-20)
    scaled = (proj - pmin) / span * float(levels)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=0.0, neginf=0.0)
    q = torch.clamp(scaled.to(torch.int32), 0, levels - 1)
    return torch.where(keys == BIG_KEY, BIG_KEY, (keys << free) | q)
