"""Run one cell of the benchmark of kmerlsh_tpu_torch on the card(s) of
this machine and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json (at the root of
the checkout); its files under ``benchmark/`` are found by its name (see
harness/spec.py). With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
torch.profiler trace of the window. ``--control 1`` also runs the check's
control (the reference in a lower precision) and prints its numbers on
standard error; the benchmark's own runs leave it off.

Exits with another code than 0, and prints no result, without a CUDA card
(or fewer than the cell asks for), or where JAX or the JAX package was
loaded by the time the result is ready.
"""

import time

STARTED = time.perf_counter()   # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.append(str(BENCH.parent))      # the program, at the checkout's root


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # the kernel caches of any library the program might use stay in the
    # checkout, at fixed paths (the program's own build is build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(BENCH.parent / "build" / sub))

    import kmerlsh_tpu_torch  # noqa: F401 — the program; a checkout without
    #                           it stops here
    from harness import runner, spec

    cell = spec.find_cell(a.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = runner.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                             STARTED, control=bool(a.control))
    found = runner.forbidden_modules()
    if found:
        print(f"loaded modules that a run may not load: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
