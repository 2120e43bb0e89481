"""c_enqueue_ms (ms a job, program spans): the host's calls of the mode-C
kernel wrappers up to their return, spans kmerlsh.iter.enqueue (K1b, K9,
K2, K3 each iteration) and kmerlsh.finalize.enqueue (the compaction and
K5), summed over the window and averaged over its jobs."""

NAMES = ("kmerlsh.iter.enqueue", "kmerlsh.finalize.enqueue")


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
