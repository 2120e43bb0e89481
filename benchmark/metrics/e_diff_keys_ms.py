"""e_diff_keys_ms (ms a job, program spans): the pipeline's E_diff_keys stage
(span kmerlsh.E_diff_keys: kmer_set.hex read and each group's sorted
differential keys), summed over the window and averaged over its jobs."""

NAMES = ("kmerlsh.E_diff_keys",)


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = [b - a for a, b, name in run.trace.host if name in NAMES]
    return sum(ns) * 1e-6 / len(run.done) if ns else None
