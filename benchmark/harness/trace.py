"""Reading a ``torch.profiler`` trace of the measured window.

Frozen copies of chip_smoke.py's trace arithmetic:
  busy_seconds   chip_smoke.py:1852 ``device_busy_seconds`` (the union of
                 the device events' intervals)
  kernel_name    chip_smoke.py:1626 ``kernel_group``'s first step (the
                 kernel's name without ``void`` and its arguments)

The events are read from the profiler's Kineto results directly, not
through ``profile.events()``, whose tree of function events takes minutes
to build over a window of hundreds of thousands of events.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Trace:
    """Device events (start ns, end ns, name) and host events (start ns,
    end ns, name) of one traced window, and the window's bounds on the
    profiler's clock."""
    device: list
    host: list
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def from_profile(prof, window_span: str, spans: set[str]) -> Trace:
    """The events of ``prof`` (a finished ``torch.profiler.profile`` with
    CPU and CUDA activities). ``window_span`` names the record_function
    around the measured window; ``spans`` the harness's own record_function
    names, whose device-side shadows are no device work."""
    device, host = [], []
    start = end = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = _ns(e, "start")
        t1 = t0 + _ns(e, "duration")
        if "CUDA" in str(e.device_type()):
            user = getattr(e, "is_user_annotation", None)
            if name in spans or (user is not None and user()):
                continue
            device.append((t0, t1, name))
        elif name == window_span:
            start, end = t0, t1
        else:
            host.append((t0, t1, name))
    if start is None:
        raise ValueError(f"no {window_span!r} span in the trace")
    return Trace(device=device, host=host, start_ns=start, end_ns=end)


def _merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(intervals) -> float:
    """Seconds in which the device ran at least one operation."""
    return sum(b - a for a, b in _merged(intervals)) * 1e-9


def kernel_name(name: str) -> str:
    """A device event's name without ``void``, its template and its
    arguments; an event the trace gives no name is named so."""
    name = name.removeprefix("void ").split("(")[0].split("<")[0].strip()
    return name or "(a device event without a name)"


def seconds_by_name(intervals) -> dict[str, float]:
    out: dict[str, float] = {}
    for a, b, name in intervals:
        key = kernel_name(name)
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """The ``top`` longest stretches of the window in which the device ran
    nothing, each named by what the host was doing: the shortest host
    event that covers the gap's middle (a PyTorch operation or a CUDA
    runtime call), after the harness's span around it, or ``host work
    outside PyTorch`` inside that span."""
    busy = _merged(trace.device)
    edges = [trace.start_ns] + [x for ab in busy for x in ab] + [trace.end_ns]
    gaps = [(max(a, trace.start_ns), min(b, trace.end_ns))
            for a, b in zip(edges[::2], edges[1::2])]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    if not trace.host:
        return [["host", (b - a) * 1e-9] for a, b in gaps]
    h0 = np.array([h[0] for h in trace.host], np.int64)
    h1 = np.array([h[1] for h in trace.host], np.int64)
    names = [h[2] for h in trace.host]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        cover = np.flatnonzero((h0 <= mid) & (h1 >= mid))
        spans = [i for i in cover if names[i].startswith("bench.")]
        ops = [i for i in cover if not names[i].startswith("bench.")]
        where = min(spans, key=lambda i: h1[i] - h0[i]) if spans else None
        label = names[where] if where is not None else "outside the jobs"
        if ops:
            op = min(ops, key=lambda i: h1[i] - h0[i])
            label += ": " + names[op]
        else:
            label += ": host work outside PyTorch"
        out.append([label, (b - a) * 1e-9])
    return out


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """The ``top`` device operations by their seconds in the window."""
    by = seconds_by_name(trace.device)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
