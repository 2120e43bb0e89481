"""c_kernel_ms (ms a job, device trace): the card time of the mode-C
kernels (K1a, K1b, K9, K2, K3 + K4, K5: harness.roofline.MODE_C_KERNELS)
in the window, over its jobs."""

from harness import roofline


def read(run):
    if run.trace is None or not run.done:
        return None
    ns = sum(b - a for a, b, name in run.trace.device
             if roofline.is_mode_c_kernel(name))
    return ns * 1e-6 / len(run.done) if ns else None
