"""c_host_prep_ms (ms a job, program spans): the host's preparation of
each mode-C iteration, spans kmerlsh.iter.h (the active h from the alive
count, engine._active_h_of) and kmerlsh.iter.planes (the hyperplanes' draw
on the host and their upload), summed over the window and averaged over
its jobs."""

NAMES = ("kmerlsh.iter.h", "kmerlsh.iter.planes")


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
