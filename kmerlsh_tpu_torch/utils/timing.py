# Copy of kmerlsh_tpu/utils/timing.py; device_memory_stats reads torch's
# allocator instead of a JAX device, and a lock guards Stages' updates (the
# out-of-core flush thread records stages beside the driver's).
"""Stage timers and structured metrics.

Replaces the reference's scattered ``chrono`` spans + ``/proc/self/status``
probes (io/ioMatrix.cc:15-29, function/cluster.cc:259-308) with a context
manager that records wall-clock per named stage and an optional device-memory
snapshot; ``torch.profiler`` traces can wrap a run via ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

log = logging.getLogger("kmerlsh_tpu_torch")


class Stages:
    """Seconds by stage (``times``) and metrics by name; safe to record
    from several threads at once."""

    def __init__(self, verbose: bool = False):
        self.times: dict[str, float] = {}
        self.metrics: dict[str, float] = {}
        self.verbose = verbose
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt)
            if self.verbose:
                print(f"[stage] {name}: {dt:.3f}s")

    def add(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to stage ``name``."""
        with self._lock:
            self.times[name] = self.times.get(name, 0.0) + seconds

    def tally(self, name: str, n: int) -> None:
        """Add ``n`` to metric ``name``."""
        with self._lock:
            self.metrics[name] = self.metrics.get(name, 0) + n

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self.metrics[name] = value
        if self.verbose:
            print(f"[metric] {name}: {value}")


def host_memory_kb() -> int:
    """VmSize of this process in KB (= ``IOMat::getValue``,
    io/ioMatrix.cc:15-29)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's byte counters of ``device`` (the
    current one by default), the analog of the VmSize probe; empty without
    a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: v for k, v in stats.items() if "bytes" in k}
