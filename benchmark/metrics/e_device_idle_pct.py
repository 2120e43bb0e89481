"""e_device_idle_pct (%, device trace): the share of the mode-E window in
which the card ran no operation: 1 − (the union of the device events'
intervals) / the window."""

from harness import trace


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(run.trace.device)
                    / run.trace.window_s)
