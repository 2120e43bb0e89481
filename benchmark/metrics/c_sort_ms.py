"""c_sort_ms (ms a job, device trace): the card time of K9 sort_keys, the
kernels whose names (harness.trace.kernel_name) start with ``kl_sort``, in
the window, over its jobs."""

from harness.trace import kernel_name


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = sum(b - a for a, b, name in run.trace.device
             if kernel_name(name).startswith("kl_sort"))
    return ns * 1e-6 / len(run.done) if ns else None
