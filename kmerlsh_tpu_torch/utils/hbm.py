"""Device-memory-aware batch sizing (port of kmerlsh_tpu/utils/hbm.py).

The reference hard-codes a 100 M-row out-of-core batch (app/kmerLSH.cc:285)
because its unit of memory is host RAM (2 B × samples × rows,
kmerLSH.cc:292-295). Here the unit is the card's memory: one mode-C session
holds the uint16 count batch, the f32 [S, M] profile state, the sorted copy
and the permute's scratch, the chain collapse's output and a handful of
int32 lane arrays.

Two sizing sources:

  * **measured**: :func:`measure_per_row_bytes` runs the engine's
    ``cluster_counts`` at 2^17 columns and takes its peak of
    ``torch.cuda.max_memory_allocated`` over its columns; the result is
    cached on disk per (card name, S, a hash of the package's sources and
    the torch version), so that a change to the code measures anew. It
    decides whenever the static estimate would clamp, because the port's
    session needs more bytes a row than that model gives (424 B at S = 20
    against 344, the same at every size from 2^16 to 2^24 columns).
  * **static**: the hand-derived per-row model below, with the reference's
    constants; a card-less device reports the reference's 16 GiB default,
    so the CPU takes the same path in both packages.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
from pathlib import Path

# static: bytes per k-mer row as a function of sample count S:
#   counts uint16 (2S) + f32 state ×3 live copies (12S) + ~13 int32/f32
#   lane arrays (keys, projections, slots, parent, sort temporaries)
_PER_ROW_LANES = 64

_CAL_PATH = os.path.expanduser(
    "~/.cache/kmerlsh_tpu_torch/memory_per_row.json")


def _per_row_bytes(num_samples: int) -> int:
    return 14 * num_samples + _PER_ROW_LANES


def _cuda(device) -> bool:
    import torch

    dev = torch.device(device)
    return dev.type == "cuda" and torch.cuda.is_available()


def device_memory_bytes(device="cuda", default: int = 16 << 30) -> int:
    """Total memory of ``device``; ``default`` where it is no card."""
    import torch

    if _cuda(device):
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return default


def measure_per_row_bytes(num_samples: int, device="cuda",
                          cols: int = 1 << 17) -> int | None:
    """Bytes a row of one mode-C session on ``device``: the engine's
    ``cluster_counts`` (transform, three iterations, finalize) at ``cols``
    columns, its peak of allocated memory above what was allocated before
    it, over ``cols`` (the session's fixed bytes included, so never below
    a larger session's bytes a row). None where ``device`` is no card."""
    import numpy as np
    import torch

    from kmerlsh_tpu_torch.cluster import engine

    if not _cuda(device):
        return None
    dev = torch.device(device)
    counts = np.random.default_rng(0).integers(
        1, 100, size=(num_samples, cols)).astype(np.uint16)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    engine.cluster_counts(counts, np.zeros(num_samples, np.float32),
                          np.asarray([0.95, 0.9, 0.85], np.float32),
                          device=dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return int(math.ceil(peak / cols))


def _source_digest() -> str:
    """A hash of the package's Python and CUDA sources and the torch
    version: what decides a session's memory."""
    import torch

    root = Path(__file__).resolve().parents[1]
    h = hashlib.sha256(torch.__version__.encode())
    for p in sorted(root.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh"):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def cached_per_row_bytes(num_samples: int, device="cuda") -> int | None:
    """Measured bytes a row for (the card's name, num_samples, the
    sources), cached on disk."""
    import torch

    if not _cuda(device):
        return None
    key = (f"{torch.cuda.get_device_name(torch.device(device))}"
           f"_S{num_samples}_{_source_digest()}")
    cal = {}
    try:
        with open(_CAL_PATH) as f:
            cal = json.load(f)
    except (OSError, ValueError):
        pass
    if key in cal:
        return cal[key]
    measured = measure_per_row_bytes(num_samples, device)
    if measured is None:
        return None
    cal[key] = measured
    _write_atomically(_CAL_PATH, cal)
    return measured


def _write_atomically(path: str, obj) -> None:
    """``obj`` as JSON to ``path`` through a temporary file in the same
    directory and ``os.replace``: a concurrent reader sees the old file or
    the new one, never a part of either."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def rows_budget(num_samples: int, n_devices: int = 1, fill: float = 0.6,
                per_row: int | None = None, mem: int | None = None,
                kmap_size: int | None = None, device="cuda") -> int:
    """Largest power-of-two row count whose mode-C session fits in
    ``fill`` × the memory of ``device`` across ``n_devices``, at least
    2^16.

    When ``kmap_size`` is given and exceeds the static estimate (the budget
    then decides between one batch and out-of-core), bytes a row are
    measured on the card (cached on disk) and the budget takes a higher
    fill (the measurement already holds the sort's temporaries)."""
    if mem is None:
        mem = device_memory_bytes(device)
    if per_row is None:
        per_row = _per_row_bytes(num_samples)
        static_rows = int(mem * fill * n_devices / per_row)
        if kmap_size is not None and kmap_size > static_rows:
            measured = cached_per_row_bytes(num_samples, device)
            if measured:
                per_row, fill = measured, 0.8
    rows = int(mem * fill * n_devices / per_row)
    return max(1 << 16, 1 << int(math.floor(math.log2(max(rows, 1)))))


def batch_budget(num_samples: int, kmap_size: int, device="cuda") -> int:
    """The batch of a run on every rank of the process group: the ranks
    times the least share of a card over all ranks (one all-reduce, so
    that every rank takes the same batch). A rank's share is its card's
    :func:`rows_budget` for the rows that card holds, divided among the
    ranks on that card and rounded down to a power of two (the shard
    capacity of a sharded session, ``dist._local_cap``, stays within it).
    With one card a rank this is the reference's ``rows_budget(S, ranks)``;
    on the CPU every rank counts as a device of its own. Where bytes a row
    are measured, the first rank on each card measures them while the
    card's other ranks wait at a barrier, then read its cached result."""
    from kmerlsh_tpu_torch.parallel import multihost
    from kmerlsh_tpu_torch.parallel.mesh import make_mesh

    ranks = multihost.process_count()
    on_card, first = multihost.card_peers(device)
    rows = -(-kmap_size * on_card // ranks)     # the rows this card holds
    if not first:
        multihost.barrier("memory_per_row")
    card = rows_budget(num_samples, 1, kmap_size=rows, device=device)
    if first:
        multihost.barrier("memory_per_row")
    share = 1 << int(math.floor(math.log2(max(card // on_card, 1))))
    return ranks * make_mesh(device).all_min(share)
