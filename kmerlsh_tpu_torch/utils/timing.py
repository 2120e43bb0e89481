# Copy of kmerlsh_tpu/utils/timing.py's Stages; a lock guards its updates
# (the out-of-core flush thread and the mode-E parse thread record beside
# the main thread), and every stage is a ``span``, which also reaches a
# torch.profiler trace.
"""Spans, stage timers and structured metrics.

Replaces the reference's scattered ``chrono`` spans (io/ioMatrix.cc:15-29,
function/cluster.cc:259-308). Every timer of the port is a :class:`span`:
it measures the host's clock around a block and adds the seconds to a sink
(a :class:`Stages`, or a session dict under a key); while a
``torch.profiler`` trace runs (the CLI's ``--trace-dir``, a benchmark's
traced window), it is also a ``record_function`` named ``kmerlsh.<name>``
on the trace's clock, so that the device's idle stretches show what the
host was doing. A span opened on a thread other than the one that started
the profiler reaches the sink only.
"""

from __future__ import annotations

import threading
import time

import torch

TRACE_PREFIX = "kmerlsh."

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter


class span:
    """``with span(name, sink=None, key=None) as s:`` — the block's host
    seconds in ``s.seconds`` on exit, added to ``sink``: ``sink.add(key or
    name, seconds)`` for a :class:`Stages`, ``sink[key] += seconds`` for a
    dict. When a profiler runs on entry, the block is also the profiler's
    ``record_function("kmerlsh." + name)``, opened before the clock starts
    and closed after it stops; a span closes only what it opened. With the
    profiler off it costs a flag check and two clock reads."""

    __slots__ = ("name", "sink", "key", "seconds", "_t0", "_rf")

    def __init__(self, name: str, sink=None, key: str | None = None):
        self.name, self.sink, self.key = name, sink, key

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(TRACE_PREFIX + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = _clock()
        return self

    def __exit__(self, kind, err, tb):
        self.seconds = seconds = _clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(kind, err, tb)
        sink = self.sink
        if sink is not None:
            if isinstance(sink, dict):
                sink[self.key] += seconds
            else:
                sink.add(self.key or self.name, seconds)
        return False


class Stages:
    """Seconds by stage (``times``) and metrics by name; safe to record
    from several threads at once."""

    def __init__(self, verbose: bool = False):
        self.times: dict[str, float] = {}
        self.metrics: dict[str, float] = {}
        self.verbose = verbose
        self._lock = threading.Lock()

    def stage(self, name: str) -> span:
        """A :class:`span` of stage ``name``, printed under ``verbose``."""
        return _Stage(name, self)

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


class _Stage(span):
    __slots__ = ()

    def __exit__(self, kind, err, tb):
        super().__exit__(kind, err, tb)
        if self.sink.verbose:
            print(f"[stage] {self.name}: {self.seconds:.3f}s")
        return False
