"""The port's spans (utils/timing.span): under torch.profiler each timer of
mode C and mode E is a ``kmerlsh.<name>`` record_function, nested as the
code nests, over the same extents as the session's counters and the
pipeline's stages; with the profiler off none is opened. Also the CLI's
total, the wall of the pipeline."""

import collections
import re
import threading
import time

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import cli, pipeline, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.utils import timing

K = 15
ITERS = 12


def _session_inputs(seed=3, s=6, n=3000):
    r = np.random.default_rng(seed)
    counts = r.poisson(3, size=(s, n)).astype(np.uint16)
    v = (counts.sum(1) / n).astype(np.float32)
    thr = np.concatenate([[0.95], 0.95 - 0.01 * np.arange(ITERS - 1)])
    return torch.from_numpy(counts), v, thr.astype(np.float32)


def _traced(fn):
    """fn() under torch.profiler (CPU): (its result, the kmerlsh spans as
    (start ns, end ns, name) in start order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(timing.TRACE_PREFIX))
    return out, spans


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


class _Recorded(timing.span):
    """A span that also logs (name, host seconds) of every exit."""
    __slots__ = ()
    log: list = []

    def __exit__(self, kind, err, tb):
        super().__exit__(kind, err, tb)
        _Recorded.log.append((self.name, self.seconds))
        return False


def test_cluster_counts_spans_nest_as_the_session():
    counts, v, thr = _session_inputs()
    (cents, _, _), spans = _traced(
        lambda: engine.cluster_counts(counts, v, thr, seed=7))
    names = collections.Counter(n.removeprefix("kmerlsh.") for *_, n in spans)
    iters = sum(p.startswith("iter[") for p, _ in
                engine.LAST_SESSION["programs"])
    assert iters >= 2
    assert names == {
        "transform": 1, "iter.h": iters, "iter": iters,
        "iter.planes": iters, "iter.enqueue": iters, "iter.wait": iters,
        "finalize": 1, "finalize.enqueue": 1, "finalize.wait": 1,
        "pull.copy": 1, "pull.host": 1}
    by = collections.defaultdict(list)
    for sp in spans:
        by[sp[2].removeprefix("kmerlsh.")].append(sp)
    for child in ("iter.planes", "iter.enqueue", "iter.wait"):
        for c, it in zip(by[child], by["iter"]):
            assert _inside(c, it), child
    for child in ("finalize.enqueue", "finalize.wait"):
        assert _inside(by[child][0], by["finalize"][0])
    # the top-level spans follow one another, none inside another
    top = sorted(by["transform"] + by["iter.h"] + by["iter"]
                 + by["finalize"] + by["pull.copy"] + by["pull.host"])
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    order = [n.removeprefix("kmerlsh.") for *_, n in top]
    assert order == (["transform"] + ["iter.h", "iter"] * iters
                     + ["finalize", "pull.copy", "pull.host"])
    # the planes' draw, the launches and the read happen in that order
    for it in range(iters):
        p, e, w = (by[c][it] for c in ("iter.planes", "iter.enqueue",
                                       "iter.wait"))
        assert p[1] <= e[0] and e[1] <= w[0]
    assert len(cents) == engine.LAST_SESSION["clusters"]


def test_session_seconds_are_the_spans(monkeypatch):
    """device_seconds is the host-clock sum of the transform, iter and
    finalize spans, pull_seconds pull.copy's; each on the trace's clock
    holds its host interval."""
    monkeypatch.setattr(engine, "span", _Recorded)
    _Recorded.log = []
    counts, v, thr = _session_inputs(seed=5)
    _, spans = _traced(lambda: engine.cluster_counts(counts, v, thr, seed=2))
    session = engine.LAST_SESSION
    host = collections.defaultdict(list)
    for name, s in _Recorded.log:
        host[name].append(s)
    device = sum(sum(host[n]) for n in ("transform", "iter", "finalize"))
    assert session["device_seconds"] == pytest.approx(device, rel=1e-12)
    assert session["pull_seconds"] == pytest.approx(sum(host["pull.copy"]),
                                                    rel=1e-12)
    programs = [s for _, s in session["programs"]]
    assert programs == [round(s, 4) for s in host["transform"] + host["iter"]
                        + host["finalize"]]
    traced = collections.defaultdict(float)
    for a, b, name in spans:
        traced[name.removeprefix("kmerlsh.")] += (b - a) * 1e-9
    for name in ("transform", "iter", "finalize", "pull.copy", "pull.host"):
        n = len(host[name])
        assert sum(host[name]) - 2e-6 * n <= traced[name] \
            <= sum(host[name]) + 5e-3 * n, name


def test_profiler_off_opens_no_record_function(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    counts, v, thr = _session_inputs(seed=11)
    cents, sizes, groups = engine.cluster_counts(counts, v, thr, seed=4)
    session = engine.LAST_SESSION
    assert set(session) == {"device_seconds", "pull_seconds", "pull_bytes",
                            "pull_host_allocs", "planes_launches",
                            "permute_launches", "sorted_keys",
                            "state_transposes", "programs", "clusters"}
    names = [p for p, _ in session["programs"]]
    assert names[0] == f"transform@{counts.shape[1]}"
    assert all(re.fullmatch(r"iter\[\d+\]@\d+", p) for p in names[1:-1])
    assert [int(p[5:p.index("]")]) for p in names[1:-1]] == \
        list(range(len(names) - 2))
    assert names[-1] == f"finalize@{len(sizes)}"
    assert session["device_seconds"] == pytest.approx(
        sum(s for _, s in session["programs"]), abs=5e-5 * len(names))
    assert session["device_seconds"] > 0 and session["pull_seconds"] > 0
    assert session["clusters"] == len(sizes) == len(cents)
    assert session["pull_bytes"] == (4 * len(sizes) + 8 * len(sizes)
                                     + 4 * cents.size + 8 * counts.shape[1])
    assert session["pull_host_allocs"] == 0


def test_a_profiler_started_inside_a_span_does_no_harm():
    """A span closes only what it opened: one entered with the profiler
    off records nothing when the profiler starts inside it; one entered
    with the profiler on and left after it stopped closes cleanly."""
    sink = {"s": 0.0}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with timing.span("outer", sink, "s"):
        prof.start()
        with timing.span("inner"):
            pass
    prof.stop()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "kmerlsh.inner" in names and "kmerlsh.outer" not in names
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with timing.span("late", sink, "s"):
        prof.stop()
    assert sink["s"] > 0


def test_stage_is_a_span_and_prints_under_verbose(capsys):
    st = timing.Stages(verbose=True)

    def staged():
        with st.stage("E_wrs"):
            pass

    _, spans = _traced(staged)
    assert [n for *_, n in spans] == ["kmerlsh.E_wrs"]
    assert st.times["E_wrs"] > 0
    assert "[stage] E_wrs:" in capsys.readouterr().out
    quiet = timing.Stages()
    with timing.span("E_extract.parse", quiet):
        pass
    assert set(quiet.times) == {"E_extract.parse"}
    assert capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def mode_c_done(tmp_path_factory):
    """The fixture's modes K, B and C through the port's CLI on the CPU."""
    work = tmp_path_factory.mktemp("spans")
    m = testdata.generate(str(work / "data"), seed=99)
    for mode in ("K", "B", "C"):
        cli.main(_argv(m, work, mode))
    return work, m


def _argv(m, work, mode, scorer="host"):
    return ["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", str(K),
            "--work-dir", str(work), "-F", str(work / "clustering_result.txt"),
            "-D", str(work / "tmp"), "-I", "15", "-N", "0.85", "--seed", "5",
            "-S", "20", "-o", str(work / "outA"), "-p", str(work / "outB"),
            "--only", "-M", mode, "--device", "cpu", "--read-scorer", scorer]


def test_mode_e_spans(mode_c_done, monkeypatch):
    """Mode E with the host scorer: its stages and steps as spans on the
    main thread; the parse thread's parse in Stages only."""
    work, m = mode_c_done
    adds = []
    real_add = timing.Stages.add

    def add(self, name, seconds):
        adds.append((name, threading.current_thread()))
        real_add(self, name, seconds)

    monkeypatch.setattr(timing.Stages, "add", add)
    params, device = cli.params_from_args(_argv(m, work, "E"))
    stages, spans = _traced(lambda: pipeline.kmer_cluster(params, device))
    names = collections.Counter(n.removeprefix("kmerlsh.") for *_, n in spans)
    samples = len(m["samples"]["A"]) + len(m["samples"]["B"])
    for name in ("E_wrs", "E_wrs.clust_read", "E_wrs.ttest", "E_diff_keys",
                 "E_extract"):
        assert names[name] == 1, name
    for name in ("E_extract.parse_wait", "E_extract.score",
                 "E_extract.mask", "E_extract.write"):
        assert names[name] >= samples, name
    assert "E_extract.parse" not in names
    by = {n.removeprefix("kmerlsh."): (a, b) for a, b, n in spans}
    assert _inside(by["E_wrs.clust_read"], by["E_wrs"])
    assert _inside(by["E_wrs.ttest"], by["E_wrs"])
    assert by["E_wrs"][1] <= by["E_diff_keys"][0]
    assert by["E_diff_keys"][1] <= by["E_extract"][0]
    for a, b, n in spans:
        if n.startswith("kmerlsh.E_extract."):
            assert _inside((a, b), by["E_extract"]), n
    assert {"E_wrs", "E_diff_keys", "E_extract",
            "E_extract.parse"} <= set(stages.times)
    parse_threads = {t for n, t in adds if n == "E_extract.parse"}
    assert parse_threads and threading.main_thread() not in parse_threads
    assert stages.times["E_extract.parse"] > 0


def test_cli_total_is_the_wall(mode_c_done, capsys):
    """The printed total is the pipeline's wall, no more than the wall the
    caller measures, although mode C's stages nest (C_cluster holds
    device_seconds and pull_seconds)."""
    work, m = mode_c_done
    capsys.readouterr()
    t0 = time.perf_counter()
    cli.main(_argv(m, work, "C"))
    wall = time.perf_counter() - t0
    out = capsys.readouterr().out
    total = float(re.search(r"kmerlsh pipeline total \(secs\): (\S+)",
                            out).group(1))
    stages = pipeline.LAST_STAGES.times
    assert 0 < total <= wall + 5e-4          # printed to the millisecond
    assert total >= stages["C_cluster"] + stages["C_save"] - 5e-4
    # the nesting a sum of the stages would count twice
    assert stages["C_cluster"] >= stages["device_seconds"] + stages[
        "pull_seconds"] + stages["read_batch"]
