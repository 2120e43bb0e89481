"""c_iter_ms (ms a job, host clock): engine.LAST_SESSION["device_seconds"],
the sum of the session's ``programs``: the host's clock around the
transform, each iteration (its launches and its one read of the alive
count) and the finalize, averaged over the window's jobs."""


def read(run):
    if not run.done:
        return None
    return 1e3 * sum(r["device_seconds"] for r in run.done) / len(run.done)
