"""c_wait_ms (ms a job, program spans): the host blocked on the card in
mode C, spans kmerlsh.iter.wait (each iteration's read of the alive count)
and kmerlsh.finalize.wait (the sync after K5), summed over the window and
averaged over its jobs."""

NAMES = ("kmerlsh.iter.wait", "kmerlsh.finalize.wait")


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
