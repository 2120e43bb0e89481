"""The row "mesh": the ranks of the default ``torch.distributed`` process
group, one device each (port of kmerlsh_tpu/parallel/mesh.py).

The k-mer row axis is sharded over the ranks in rank order; hyperplanes and
thresholds are replicated, and cross-shard merging moves only (centroid,
size, slot) summaries. A :class:`Mesh` holds this rank's place and device
and the few collectives the sharded path uses. Without a process group it
is a mesh of one rank whose collectives return their input.

Under NCCL the collectives run on the device. Under gloo (ranks that share
a card, or CPU ranks) device tensors are staged through host memory.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


class Mesh:
    """This rank's (rank, size, device) on the row axis, and its
    collectives. ``gathered`` counts the elements :meth:`all_gather` has
    returned on this rank, so that a caller can bound what a step moved."""

    def __init__(self, device, rank: int = 0, size: int = 1):
        self.device = torch.device(device)
        self.rank = rank
        self.size = size
        self.gathered = 0

    def _comm_device(self) -> torch.device:
        """Where a collective's tensors lie: the host under gloo, this
        rank's device under NCCL."""
        if tdist.get_backend() == "gloo":
            return torch.device("cpu")
        return self.device

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on ``t``'s device."""
        if self.size == 1:
            out = t
        else:
            x = t.to(self._comm_device()).contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            tdist.all_gather(parts, x)
            out = torch.cat(parts, dim=dim).to(t.device)
        self.gathered += out.numel()
        return out

    def _reduce(self, x: int, op) -> int:
        if self.size == 1:
            return int(x)
        t = torch.tensor([int(x)], dtype=torch.int64,
                         device=self._comm_device())
        tdist.all_reduce(t, op=op)
        return int(t.item())

    def all_sum(self, x: int) -> int:
        return self._reduce(x, tdist.ReduceOp.SUM)

    def all_max(self, x: int) -> int:
        return self._reduce(x, tdist.ReduceOp.MAX)

    def all_min(self, x: int) -> int:
        return self._reduce(x, tdist.ReduceOp.MIN)


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the default process group, this rank on ``device``; one
    rank when no group is initialized."""
    if tdist.is_available() and tdist.is_initialized():
        return Mesh(device, tdist.get_rank(), tdist.get_world_size())
    return Mesh(device)
