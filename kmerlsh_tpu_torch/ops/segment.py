"""Segmented-scan primitives over sorted key arrays (port of
kmerlsh_tpu/ops/segment.py)."""

from __future__ import annotations

import torch


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Bool mask of segment starts in a sorted key array."""
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev


def segmented_cumsum(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum that resets at each segment start (elements
    before the first start sum from 0). Computed as the difference of one
    cumulative sum: exact for integers, rounded otherwise."""
    if values.numel() == 0:
        return values.clone()
    pos = torch.arange(values.shape[0], device=values.device)
    head = torch.cummax(torch.where(starts, pos, 0), 0).values
    total = torch.cumsum(values, 0, dtype=values.dtype)
    before = torch.where(starts[head], total[head] - values[head], 0)
    return total - before


def alive_rank_in_segment(alive: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """0-based rank of each alive element among the alive elements of its
    segment (undefined for dead elements)."""
    a = alive.to(torch.int32)
    return segmented_cumsum(a, starts) - a
