"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

    set-up   the jobs module makes the cell's data from the seed and runs one
             warm job of the cell's own shape (job 0): every kernel is
             built and loaded, every shape seen, before the window opens
    window   jobs 1, 2, … in a closed loop (harness.window); with a trace,
             under torch.profiler
    check    once the window has closed and its memory peak is read: one
             window job drawn from the seed against the plain reference
             (the jobs module's ``check``), each number beside its limit from
             the cell's file
    metrics  each of the cell's metrics by its reader (metrics/<name>.py)

The result line's keys: correct, attempted, failed, metrics, device, with
a trace breakdown, and last the numbers compared beside their limits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
import time

import torch

from harness import spec, trace as tracing, window

# top-level modules a run may not load: JAX and the JAX package (compared
# as whole names: kmerlsh_tpu_torch is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "kmerlsh_tpu")
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: spec.Cell
    records: list          # the window's jobs, in order
    window_s: float
    setup_s: float
    peak_bytes: int | None    # the window's peak of allocated card memory
    trace: tracing.Trace | None
    peak_reserved: int | None = None   # and of the allocator's segments

    @property
    def done(self) -> list:
        return [r for r in self.records if "error" not in r]


def forbidden_modules() -> list[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return res.stdout.strip().replace("\n", "; ") or res.stderr.strip()


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, started: float, control: bool = False,
             clock=time.perf_counter) -> dict:
    """Run ``cell`` and return its result line's object. ``started`` is the
    clock's reading when the process began (set-up counts from there)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    limits = cell.limits
    jobs = spec.jobs_module(cell.traffic["jobs"], cell.bench_dir).setup(
        cell, seed, dev)
    try:
        jobs.run(0, False)
        sync()
        setup_s = clock() - started
        _log(f"set-up {setup_s:.3f} s, CPU {time.process_time():.3f} s; "
             f"card: {power_limit() if cuda else 'none (CPU run)'}")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        with (torch.profiler.record_function(WINDOW_SPAN) if trace
              else contextlib.nullcontext()):
            records, window_s = window.run(
                jobs.run, seconds, pick=window.Reservoir(seed), clock=clock,
                span=torch.profiler.record_function if trace else None)
            sync()
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        reserved = torch.cuda.max_memory_reserved(dev) if cuda else None
        traced = (tracing.from_profile(prof, WINDOW_SPAN, {"bench.job"})
                  if prof is not None else None)
        del prof
        failed = [r for r in records if "error" in r]
        _log(f"window {window_s:.4f} s, {len(records)} jobs; card memory "
             f"peak {peak} B allocated, {reserved} B reserved")
        for key, what in (("wall_s", "job walls (s)"),
                          ("cpu_s", "job CPU (s)")):
            _log(f"{what}: " + " ".join(
                f"{r[key]:.4f}" for r in records if key in r))
        for r in failed:
            _log(f"job {r['j']} failed: {r['traceback']}")
        t_check = clock()
        checked = (jobs.check(control) if jobs.held is not None
                   else dict(job=None, numbers={}))
        t_check = clock() - t_check
    finally:
        jobs.close()

    run = Run(cell=cell, records=records, window_s=window_s, setup_s=setup_s,
              peak_bytes=peak, peak_reserved=reserved, trace=traced)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    numbers = checked["numbers"]
    checks = {name: dict(value=numbers.get(name), limit=limit)
              for name, limit in limits.items()}
    correct = (not failed and bool(numbers)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=cell.chips if cuda else 1,
        memory_peak_bytes=peak if cuda else 0)
    result = dict(correct=correct, attempted=len(records),
                  failed=len(failed), metrics=metrics, device=device_info)
    if traced is not None:
        device_info.update(busy_s=tracing.busy_seconds(traced.device),
                           window_s=traced.window_s)
        result["breakdown"] = dict(device_ops=tracing.device_ops(traced),
                                   idle_gaps=tracing.idle_gaps(traced))
    if "control" in checked:
        for name, value in checked["control"].items():
            _log(f"control {name}: {value!r} (limit {limits.get(name)})")
    _log(f"checked job {checked['job']} of {len(records)} in {t_check:.1f} s"
         f": {checked.get('info', {})}")
    for name, c in checks.items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result
