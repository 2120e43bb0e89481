"""The measured window: a closed loop of jobs.

One job after another, the next starting when the last has ended, as a
user runs one whole study at a time. The window lasts ``seconds`` and then
to the end of the job in progress, so that a rate is all the work of all
jobs over all of that time and no job is cut. A job that raises ends the
window: it is recorded with its error and counts no work.
"""

from __future__ import annotations

import time
import traceback

import numpy as np


class Reservoir:
    """Which window job the check takes: the k-th is kept with chance 1/k
    (k = 1, 2, …), drawn from the seed, so every job is as likely to be
    the one checked, whatever their number."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed % 2**64, 7])
        self.seen = 0

    def __call__(self) -> bool:
        self.seen += 1
        return bool(self.rng.random() * self.seen < 1.0)


def run(job, seconds: float, first: int = 1, pick=None,
        clock=time.perf_counter, span=None) -> tuple[list[dict], float]:
    """Run ``job(j, keep)`` for j = first, first + 1, … until ``seconds``
    have passed since the window opened. Returns the jobs' records and
    the window's length in seconds. ``span(name)``, where given, is a
    context manager put around each job."""
    records: list[dict] = []
    j = first
    t0 = clock()
    while True:
        keep = pick() if pick is not None else False
        t_job, cpu = clock(), time.process_time()
        try:
            if span is None:
                rec = job(j, keep)
            else:
                with span("bench.job"):
                    rec = job(j, keep)
        except Exception as e:      # noqa: BLE001 — recorded, then reported
            records.append(dict(j=j, error=f"{type(e).__name__}: {e}",
                                traceback=traceback.format_exc()))
            break
        rec["wall_s"] = clock() - t_job
        # the process's CPU seconds, for the log: a host that runs slower
        # shows in them, a job that waits does not
        rec["cpu_s"] = time.process_time() - cpu
        records.append(rec)
        j += 1
        if clock() - t0 >= seconds:
            break
    return records, clock() - t0
