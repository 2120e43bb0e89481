"""e_parse_wait_ms (ms a job, program spans): mode E's main thread blocked
on the FASTQ parse thread's queue (span kmerlsh.E_extract.parse_wait),
summed over the window and averaged over its jobs."""

NAMES = ("kmerlsh.E_extract.parse_wait",)


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
