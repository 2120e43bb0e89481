"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics. Each name leads to a
file of its own under ``benchmark/``:

  configs/<config>.json     the deployment: samples and groups, rows, flags
  workloads/<cell>.json     the cell: its configuration, its traffic mix,
                            chips, and the check's limits
  traffic/<traffic>.json    the mix: which jobs module, and its parameters
                            (a new mix of an existing kind of job is this
                            data file alone)
  jobs/<jobs>.py            the jobs: set-up, one job, the check
  metrics/<metric>.py       the reader of one metric

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries, never by editing one that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    chips: int
    end_to_end: list      # BENCHMARK.json entries reported by this cell
    per_layer: list
    limits: dict          # the check's numbers and their limits
    bench_dir: Path = BENCH_DIR


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` (a BENCHMARK.json entry) is read in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench_dir: Path = BENCH_DIR,
              spec_path: Path | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json (beside ``bench_dir``) with its
    files. Raises KeyError for an unknown cell and ValueError where a file
    disagrees with BENCHMARK.json."""
    spec = load_json(spec_path or bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} = {cell[key]!r}, "
                             f"BENCHMARK.json says {entry[key]!r}")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                chips=entry["chips"],
                end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if reports(m, name)],
                limits=cell["limits"], bench_dir=bench_dir)


def _load(path: Path, module: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    loaded = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(mod)
    return mod


def jobs_module(name: str, bench_dir: Path = BENCH_DIR):
    """jobs/<name>.py: ``setup(cell, seed, device) → Jobs``."""
    return _load(bench_dir / "jobs" / f"{name}.py", f"bench_jobs_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """metrics/<name>.py's ``read(run) → float | None``."""
    mod = _load(bench_dir / "metrics" / f"{name}.py",
                "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read
