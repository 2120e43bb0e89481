"""c_idle_unspanned_pct (%, program spans over the device trace): the share
of the mode-C window's device-idle seconds (the window less the union of
the device events' intervals) in which no ``kmerlsh.`` span of the program
is open, so that nothing names what the host was doing there. None where
the trace holds no such span."""

from harness import trace

PREFIX = "kmerlsh."


def _clipped(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b, *_ in intervals
            if min(b, hi) > max(a, lo)]


def _overlap_ns(xs, ys) -> int:
    """The length of the intersection of two unions of intervals, each
    merged and sorted."""
    out = i = j = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        out += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = [h for h in t.host if h[2].startswith(PREFIX)]
    if not spans:
        return None
    lo, hi = t.start_ns, t.end_ns
    busy = trace._merged(_clipped(t.device, lo, hi))
    spanned = trace._merged(_clipped(spans, lo, hi))
    idle = (hi - lo) - sum(b - a for a, b in busy)
    if idle <= 0:
        return 0.0
    covered = sum(b - a for a, b in spanned) - _overlap_ns(spanned, busy)
    return 100.0 * (idle - covered) / idle
