"""Abundance transform: raw uint16 counts → centered log-abundance rows.

Port of kmerlsh_tpu/ops/transform.py (``IOMat::convertHTMat`` semantics):
  value[s, m] = log(count[s, m] + 1) − v_kmers[s]
  column m kept iff Σ_s count[s, m] > 0.1 · S

This is the plain version; on the card the head of a session runs the
``abundance_transform`` kernel (kmerlsh_tpu_torch/kernels).
"""

from __future__ import annotations

import numpy as np
import torch


def keep_threshold(num_samples: int) -> float:
    """``0.1 · S`` rounded to float32, as the reference compares it."""
    return float(np.float32(0.1 * num_samples))


def abundance_transform_t(counts: torch.Tensor, v_kmers: torch.Tensor):
    """counts uint16/int32 [S, M] (sample-major, as in kmer_count.bin);
    v_kmers f32 [S]. Returns (values_t f32 [S, M], keep bool [M])."""
    values_t = torch.log1p(counts.to(torch.float32)) - v_kmers.to(
        torch.float32)[:, None]
    total = counts.to(torch.int32).sum(0, dtype=torch.int32)
    keep = total.to(torch.float32) > keep_threshold(counts.shape[0])
    return values_t, keep
