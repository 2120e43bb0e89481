"""The readers of the program's spans (metrics/c_*, e_* of source
program_span) on hand-built traces, and in a traced tiny run of each
cell."""

from __future__ import annotations

import types

import pytest

from conftest import BENCH
from harness import spec, trace

from test_bench_run import run_tiny

SUMS = {
    "c_host_prep_ms": ("iter.h", "iter.planes"),
    "c_enqueue_ms": ("iter.enqueue", "finalize.enqueue"),
    "c_wait_ms": ("iter.wait", "finalize.wait"),
    "c_pull_host_ms": ("pull.host",),
    "e_parse_wait_ms": ("E_extract.parse_wait",),
    "e_score_ms": ("E_extract.score",),
    "e_write_ms": ("E_extract.write",),
    "e_diff_keys_ms": ("E_diff_keys",),
}
IDLE = ("c_idle_unspanned_pct", "e_idle_unspanned_pct")
NEW = {"metahit124.cluster": [m for m in (*SUMS, *IDLE) if m[0] == "c"],
       "metahit124.extract": [m for m in (*SUMS, *IDLE) if m[0] == "e"]}


def _run(host, device=(), jobs=2, start=0, end=10**9):
    return types.SimpleNamespace(
        done=[{}] * jobs, trace=trace.Trace(device=list(device),
                                            host=list(host),
                                            start_ns=start, end_ns=end))


@pytest.mark.parametrize("name", sorted(SUMS))
def test_a_span_sum_is_ms_a_job(name):
    read = spec.metric_reader(name, BENCH)
    spans = SUMS[name]
    host = [(0, 900_000_000, "bench.job"),
            (5, 7, "aten::mul"),                       # no span of its own
            (10, 10 + 3_000_000, "kmerlsh.other")]     # another span
    ms = 0.0
    for i, s in enumerate(spans):
        for j in range(3):                             # three of each
            a = 20_000_000 * (1 + i * 3 + j)
            host.append((a, a + 1_000_000 * (i + 1), "kmerlsh." + s))
            ms += i + 1
    assert read(_run(host, jobs=2)) == pytest.approx(ms / 2)
    assert read(_run(host, jobs=4)) == pytest.approx(ms / 4)
    # a trace without the program's spans (the parent's), no trace, no job
    assert read(_run(host[:3])) is None
    assert read(types.SimpleNamespace(done=[{}], trace=None)) is None
    assert read(_run(host, jobs=0)) is None


@pytest.mark.parametrize("name", IDLE)
def test_idle_unspanned_is_idle_less_the_span_union(name):
    read = spec.metric_reader(name, BENCH)
    # window [0, 100): device busy [10, 20) and [50, 60) (overlapping
    # events), so idle 80 ns
    device = [(10, 20, "k"), (12, 18, "k"), (50, 60, "k")]
    host = [(0, 100, "bench.job"),
            (0, 15, "kmerlsh.a"), (2, 8, "kmerlsh.a.child"),  # nested
            (20, 40, "aten::copy_"),                     # not a span
            (40, 70, "kmerlsh.b"), (45, 55, "kmerlsh.b.c"),
            (95, 130, "kmerlsh.tail")]                   # cut at the end
    # idle under spans: [0, 10) + [40, 50) + [60, 70) + [95, 100) = 35
    run = _run(host, device, start=0, end=100)
    assert read(run) == pytest.approx(100 * (80 - 35) / 80)
    # every idle stretch under a span: 0; no span at all: None
    full = _run([(0, 100, "kmerlsh.x")], device, start=0, end=100)
    assert read(full) == 0.0
    assert read(_run(host[:1] + host[3:4], device, 0, 100)) is None
    assert read(types.SimpleNamespace(done=[{}], trace=None)) is None
    # a device busy all the window: no idle to share out
    assert read(_run(host, [(0, 100, "k")], start=0, end=100)) == 0.0


def test_the_new_metrics_are_entries_of_their_cell():
    for cell, names in NEW.items():
        listed = {m["name"]: m for m in spec.find_cell(cell).per_layer}
        for name in names:
            m = listed[name]
            assert m["source"] == "program_span" and m["workloads"] == [cell]
            assert m["moves"] == ("c_rows_per_s" if cell.endswith("cluster")
                                  else "setup_s")


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_run_reads_every_span_metric(tiny, name):
    """Through the port's plain kernels on the CPU: each new reader finds
    the program's spans, and every idle gap is named by one."""
    res = run_tiny(tiny, name, trace=True, seconds=0.5)
    assert res["correct"], res["checks"]
    for metric in NEW[name]:
        assert metric in res["metrics"], metric
        assert res["metrics"][metric]["value"] >= 0
    for label, _ in res["breakdown"]["idle_gaps"]:
        assert "host work outside PyTorch" not in label, label
