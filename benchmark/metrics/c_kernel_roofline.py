"""c_kernel_roofline (%, device trace): the least time of every mode-C
kernel call of the window's jobs (harness.roofline: the larger of a call's
bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted
from each call's capacity in the session's ``programs``), summed, over
those kernels' card time in the trace."""

from harness import roofline


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = sum(b - a for a, b, name in run.trace.device
             if roofline.is_mode_c_kernel(name))
    if not ns:
        return None
    least = sum(roofline.session_least_seconds(r["programs"], r["S"],
                                               r["kept"]) for r in run.done)
    return 100.0 * least / (ns * 1e-9)
