"""e_score_ms (ms a job, program spans): the read scorer's dispatch of each
FASTQ part in mode E (span kmerlsh.E_extract.score: packing, the upload, the
K7 launch), summed over the window and averaged over its jobs."""

NAMES = ("kmerlsh.E_extract.score",)


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
