"""c_pull_host_ms (ms a job, program spans): the host's work on the pulled
finalize outputs after the copies (span kmerlsh.pull.host: the centroids
transposed into a [K, S] array, the ids widened to int64, Groups built),
summed over the window and averaged over its jobs."""

NAMES = ("kmerlsh.pull.host",)


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
