"""Segment boundaries of a sorted key array (port of
kmerlsh_tpu/ops/segment.py:segment_starts)."""

from __future__ import annotations

import torch


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Bool mask of segment starts in a sorted key array."""
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev
