"""c_pull_ms (ms a job, host clock): engine.LAST_SESSION["pull_seconds"],
the copies of the finalize's outputs to the host, averaged over the
window's jobs."""


def read(run):
    if not run.done:
        return None
    return 1e3 * sum(r["pull_seconds"] for r in run.done) / len(run.done)
