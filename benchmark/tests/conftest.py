"""Fixtures of the benchmark's CPU tests: the harness on the path, and a
copy of the benchmark's files at a size a CPU run holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"metahit124": dict(rows=2048, cluster_iteration=20,
                          reads_per_fastq=256)}


def tiny_copy(dest: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``dest`` with every
    configuration cut to a few thousand rows, 20 iterations and 256 reads
    a FASTQ, and two FASTQ sets: returns the copy's benchmark folder."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TINY.items():
        path = dest / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    path = dest / "benchmark" / "traffic" / "extract.json"
    mix = json.loads(path.read_text())
    mix["fastq_sets"] = 2
    path.write_text(json.dumps(mix))
    return dest / "benchmark"


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_copy(tmp_path)
