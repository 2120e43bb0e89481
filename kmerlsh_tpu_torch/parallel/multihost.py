"""Multi-process runtime on ``torch.distributed`` (port of
kmerlsh_tpu/parallel/multihost.py).

Every process runs the SAME ``kmerlsh-torch`` command with three extra
flags (``--coordinator host:port --num-processes N --process-id i``, or the
matching ``KMERLSH_*`` environment variables); :func:`maybe_initialize`
forms the process group, one rank per process and one device per rank, and
the pipeline then:

  * loads each rank's own column slice of ``kmer_count.bin``
    (``dist.upload_counts_process_local``);
  * runs the same sharded iterations on every rank (``parallel/dist.py``);
  * writes shared artifacts from rank 0 only, with barriers before any
    stage that reads them back;
  * splits per-sample work (mode K counting, mode E extraction)
    round-robin across ranks.

Backend: NCCL when every rank of a host has a card of its own, gloo when
ranks share a card or run on the CPU. The ranks of a host are
``LOCAL_WORLD_SIZE`` when it is set, else ``--num-processes``; a rank's
local index is ``LOCAL_RANK``, else its process id modulo that count.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as tdist


def _flags(params) -> tuple[str, int, int] | None:
    coord = params.coordinator or os.environ.get("KMERLSH_COORDINATOR", "")
    if not coord:
        return None
    nproc = params.num_processes or int(
        os.environ.get("KMERLSH_NUM_PROCESSES", "0"))
    pid = params.process_id if params.process_id >= 0 else int(
        os.environ.get("KMERLSH_PROCESS_ID", "-1"))
    if nproc <= 0 or pid < 0:
        raise ValueError(
            "--coordinator requires --num-processes and --process-id "
            "(or KMERLSH_NUM_PROCESSES / KMERLSH_PROCESS_ID)")
    return coord, nproc, pid


def rank_device(device: str, nproc: int, pid: int) -> tuple[str, str]:
    """(this rank's device, backend): a bare ``cuda`` becomes
    ``cuda:<local rank % device_count>``; NCCL when the host's ranks fit
    its cards one each, else gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev), "gloo"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", nproc))
    local = int(os.environ.get("LOCAL_RANK", pid % per_host))
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError(f"--device {device}: no CUDA device visible")
    if dev.index is None:
        dev = torch.device("cuda", local % n_cards)
    return str(dev), "nccl" if per_host <= n_cards else "gloo"


_formed = False   # maybe_initialize formed the current process group


def maybe_initialize(params, device: str = "cuda") -> str:
    """Form the process group when the multi-process flags (or
    environment) are set, and return the device this rank runs on
    (``device`` itself single-process). Must run before the pipeline."""
    flags = _flags(params)
    if flags is None:
        return device
    global _formed
    coord, nproc, pid = flags
    dev, backend = rank_device(device, nproc, pid)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    tdist.init_process_group(backend, init_method=f"tcp://{coord}",
                             world_size=nproc, rank=pid)
    _formed = True
    return dev


def shutdown() -> None:
    """Leave the process group that :func:`maybe_initialize` formed."""
    global _formed
    if _formed and tdist.is_initialized():
        tdist.destroy_process_group()
    _formed = False


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if _initialized() else 1


def proc0() -> bool:
    return not _initialized() or tdist.get_rank() == 0


def barrier(name: str) -> None:
    """Block until every process reaches ``name`` (no-op single-process)."""
    del name   # the reference names its barriers; torch's need no name
    if process_count() > 1:
        tdist.barrier()


def card_peers(device) -> tuple[int, bool]:
    """(the number of ranks whose device is this rank's card, whether this
    rank is the first of them): ranks share a card when they run on one
    host with the same CUDA device. On the CPU every rank counts as a
    device of its own, as the reference's virtual devices do. One process:
    (1, True)."""
    if process_count() == 1:
        return 1, True
    dev = torch.device(device)
    rank = tdist.get_rank()
    me = ((socket.gethostname(), str(dev)) if dev.type == "cuda"
          else (socket.gethostname(), str(dev), rank))
    cards = [None] * process_count()
    tdist.all_gather_object(cards, me)
    peers = [r for r, card in enumerate(cards) if card == me]
    return len(peers), peers[0] == rank


def gather_np(x: torch.Tensor, mesh=None, dim: int = 0) -> np.ndarray:
    """This rank's shard → every rank's shards concatenated along ``dim``
    in rank order, as NumPy on every rank (``x`` itself single-process)."""
    if mesh is not None and mesh.size > 1:
        x = mesh.all_gather(x, dim=dim)
    return x.cpu().numpy()


def my_items(items: list) -> list:
    """This process's round-robin share of per-sample work."""
    if not _initialized():
        return list(items)
    p, n = tdist.get_rank(), tdist.get_world_size()
    return [x for i, x in enumerate(items) if i % n == p]
