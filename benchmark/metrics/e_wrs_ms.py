"""e_wrs_ms (ms a job, host clock): the pipeline's ``E_wrs`` stage
(pipeline.LAST_STAGES.times): the clustering file's read and parse and the
t-test of every cluster, averaged over the window's jobs."""


def read(run):
    if not run.done:
        return None
    return 1e3 * sum(r["wrs"] for r in run.done) / len(run.done)
