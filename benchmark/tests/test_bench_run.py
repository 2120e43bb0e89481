"""CPU tests of whole runs: each cell at a tiny size through the port's
plain kernels, the result line, the modules a run loads, the check's
control and the faults the check must catch."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny_copy
from harness import gen, runner, spec
from reference import compare, modec, modee

CELLS = ("metahit124.cluster", "metahit124.extract")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CARD_READINGS = {"c_peak_bytes_per_row", "e_reserved_bytes"}


def run_tiny(bench, name, trace=False, seconds=0.3, seed=2**31 + 9):
    return runner.run_cell(spec.find_cell(name, bench), seed, seconds, trace,
                           "cpu", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, name):
    res = run_tiny(tiny, name)
    assert res["correct"], res["checks"]
    assert list(res) == KEYS + ["checks"]
    cell = spec.find_cell(name, tiny)
    assert set(res["metrics"]) == {
        m["name"] for m in cell.end_to_end
        if m["name"] not in CARD_READINGS}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_per_layer_metrics(tiny, name):
    res = run_tiny(tiny, name, trace=True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    # no card: only the host clock's and the program's readings
    idle = [m for m in res["metrics"] if m.endswith("idle_pct")]
    assert idle and all(res["metrics"][m]["value"] == 100.0 for m in idle)


SCRIPT = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import runner, spec
for name in {cells!r}:
    res = runner.run_cell(spec.find_cell(name, __import__("pathlib").Path(
        {tiny!r})), 3, 0.2, False, "cpu", 0.0)
    assert res["correct"], res
print(json.dumps(runner.forbidden_modules()))
print(json.dumps(sorted(m.split(".")[0] for m in sys.modules)))
"""


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run of every mix in a fresh process: no top-level module
    named jax, jaxlib, flax or kmerlsh_tpu (whole names) is loaded; the
    program, kmerlsh_tpu_torch, is."""
    tiny = tiny_copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(bench=str(BENCH),
                                             root=str(ROOT), cells=CELLS,
                                             tiny=str(tiny))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    found, loaded = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert found == []
    assert "kmerlsh_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "kmerlsh_tpu"} & set(loaded)


def test_forbidden_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmerlsh_tpu_torchx", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmerlsh_tpu.io", sys)
    assert runner.forbidden_modules() == ["kmerlsh_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("reference", "harness"):
        for path in (BENCH / sub).glob("*.py"):
            for mod in _imports(path):
                assert mod.split(".")[0] not in (
                    "kmerlsh_tpu_torch", "kmerlsh_tpu", "jax", "flax"), (
                    path, mod)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(BENCH)!r}); "
         "from reference import compare, modec, modee, rng; "
         "print(sorted(m for m in sys.modules if m.startswith('kmerlsh')))"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_entry_refuses_without_a_card_and_without_the_program(tmp_path):
    """No card: exit code 3 and no result line. A directory of only
    BENCHMARK.json and benchmark/: a nonzero exit before anything runs."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "metahit124.cluster", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 3 and out.stdout.strip() == "", out.stderr
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    shutil.copytree(BENCH, alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "metahit124.cluster", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=alone,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "kmerlsh_tpu_torch" in out.stderr


# --- the control: the reference in the precision below the stated one ------

def test_the_cluster_control_fails():
    """The bfloat16 session against the float32 reference, at a size a
    test holds: at least one number past its limit."""
    for name, (rows, s) in {"metahit124.cluster": (2048, 124)}.items():
        limits = spec.find_cell(name).limits
        counts = gen.make_counts(rows, s, 17, "cpu")
        v = gen.coverage_offsets(counts)
        thr = np.asarray([0.95] + [0.95 - 0.0075 * i for i in range(20)],
                         np.float32)
        ref = modec.session(counts, v, thr, 17)
        sound = compare.numbers(ref, ref, counts, v)
        assert all(sound[k] <= limits[k] for k in limits), sound
        low = compare.numbers(modec.session(counts, v, thr, 17,
                                            torch.bfloat16), ref, counts, v)
        assert any(low[k] > limits[k] for k in limits), low


def test_the_extract_control_fails():
    """The t statistic in bfloat16 flips verdicts farther from p than the
    limit allows, on 20,000 clusters of 99 + 25 samples whose group
    shifts put many tails near p; the float32 statistic stays inside."""
    limit = spec.find_cell("metahit124.extract").limits["verdict_gap"]
    g = torch.Generator().manual_seed(3)
    vals = torch.randn(20000, 124, generator=g) * 0.3 + 2.0
    vals[:, :99] += torch.rand(20000, 1, generator=g) * 0.3
    vals = vals.to(torch.float32)
    sizes = torch.full((20000,), 50)
    left, right = modee.tails(vals, 99, 25)
    for dtype, fails in ((torch.float32, False), (torch.bfloat16, True)):
        lo_l, lo_r = modee.tails(vals, 99, 25, dtype)
        got = modee.verdicts(lo_l, lo_r, sizes, 0.01, 5)
        gap = modee.verdict_gap(got, left, right, sizes, 0.01, 5)
        assert (gap > limit) == fails, (dtype, gap, limit)


def test_betainc_against_closed_forms():
    """I_x(a, 1/2) at a = 1/2 is 2/π · asin(√x); I_x(1, b) = 1 − (1 − x)^b."""
    x = torch.linspace(0.0, 1.0, 101, dtype=torch.float64)
    half = torch.full_like(x, 0.5)
    np.testing.assert_allclose(modee.betainc(half, half, x).numpy(),
                               (2 / np.pi * torch.asin(x.sqrt())).numpy(),
                               rtol=1e-12, atol=1e-13)
    one, b = torch.ones_like(x), torch.full_like(x, 3.5)
    np.testing.assert_allclose(modee.betainc(one, b, x).numpy(),
                               (1 - (1 - x) ** 3.5).numpy(), rtol=1e-12,
                               atol=1e-13)


def test_clust_parse_and_fastq_reference(tmp_path):
    from kmerlsh_tpu_torch.cluster.groups import Groups
    from kmerlsh_tpu_torch.io import clusterio

    g = Groups(np.array([3, 9, 1, 4, 7, 12345678], np.int64),
               np.array([0, 2, 3, 6], np.int64))
    clusterio.save_result(g, str(tmp_path / "c.clust"))
    ids, offs = modee.read_clust(str(tmp_path / "c.clust"), "cpu")
    assert ids.tolist() == g.flat.tolist()
    assert offs.tolist() == g.offsets.tolist()
    rec = b"@a x\nACGTN\n+\nIIIII\n@b\nAC\n+\nII\n"
    names, seqs, quals = modee.parse_fastq(rec)
    assert names == [b"a", b"b"] and seqs == [b"ACGTN", b"AC"]
    assert modee.record_faults(rec, list(zip(names, seqs, quals))) == 0
    assert modee.record_faults(rec, list(zip(names, seqs, quals))[:1]) == 1


def test_centroids_are_the_means_of_their_members():
    counts = gen.to_uint16(torch.tensor([[0, 1, 3, 65535], [2, 2, 2, 2]],
                                        dtype=torch.int32))
    v = np.array([0.5, 0.25], np.float32)
    got = modee.centroids(counts, v, torch.tensor([2, 0, 1, 3]),
                          torch.tensor([1, 3]))
    want = [[np.log(4) - 0.5, np.log(3) - 0.25],
            [(np.log(1) + np.log(2) + np.log(65536)) / 3 - 0.5,
             np.log(3) - 0.25]]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def test_read_selection_is_the_port_s():
    from kmerlsh_tpu_torch import testdata
    from kmerlsh_tpu_torch.ops import reads

    for kind in testdata.SCORE_CASES:
        for k in (15, 23, 31):
            seqs, keys = testdata.score_case(kind, k, seed=4)
            diff = torch.sort(torch.from_numpy(
                keys.astype(np.uint64).view(np.int64)) ^ (-(1 << 63))).values
            want = reads.score_part(seqs, keys, k, 0.5)
            got = modee.selected_reads(seqs, diff, k, 0.5)
            assert np.array_equal(got, want), (kind, k)


# --- faults the check must catch ---------------------------------------------

def _unchanged(monkeypatch):
    """Every iteration returns its state unchanged: nothing merges."""
    from kmerlsh_tpu_torch import kernels

    def collapse(svals, ssizes, sslots, skey, *a, **kw):
        return svals, ssizes, sslots, torch.full_like(sslots, -1)
    monkeypatch.setattr(kernels, "chain_collapse", collapse)


def _half_left_out(monkeypatch):
    """The second half of the rows left out, the means taken over the
    rest."""
    from kmerlsh_tpu_torch import kernels

    orig = kernels.abundance_transform

    def transform(counts, v):
        values, sizes = orig(counts, v)
        sizes = sizes.clone()
        sizes[sizes.shape[0] // 2:] = 0
        return values, sizes
    monkeypatch.setattr(kernels, "abundance_transform", transform)


def _centroid_altered(monkeypatch):
    """One centroid value altered where the pull produces it."""
    from kmerlsh_tpu_torch.cluster import engine

    orig = engine._pull

    def pull(*a, **kw):
        cents, sizes, groups = orig(*a, **kw)
        cents = cents.copy()
        cents[len(cents) // 2, 0] += 0.01
        return cents, sizes, groups
    monkeypatch.setattr(engine, "_pull", pull)


def _member_altered(monkeypatch):
    """One member id altered where the pull produces it."""
    from kmerlsh_tpu_torch.cluster import engine
    from kmerlsh_tpu_torch.cluster.groups import Groups

    orig = engine._pull

    def pull(*a, **kw):
        cents, sizes, groups = orig(*a, **kw)
        flat = groups.flat.copy()
        flat[len(flat) // 2] = flat[len(flat) // 2 + 1]
        return cents, sizes, Groups(flat, groups.offsets)
    monkeypatch.setattr(engine, "_pull", pull)


def _no_reads(monkeypatch):
    """The read scorer's step returns nothing selected."""
    from kmerlsh_tpu_torch import kernels

    def score(codes, win_start, n_win, lens, *a, **kw):
        return torch.zeros(lens.shape[0], dtype=torch.bool)
    monkeypatch.setattr(kernels, "score_reads", score)


def _half_reads(monkeypatch):
    """Half of each part's reads left out of the scoring."""
    from kmerlsh_tpu_torch import kernels

    orig = kernels.score_reads

    def score(*a, **kw):
        mask = orig(*a, **kw).clone()
        mask[mask.shape[0] // 2:] = False
        return mask
    monkeypatch.setattr(kernels, "score_reads", score)


def _verdict_altered(monkeypatch):
    """One tested cluster's verdict altered where the t-test makes it."""
    from kmerlsh_tpu_torch import kernels

    orig = kernels.wrs_verdicts

    def wrs(values, sizes, n1, n2, pval, size_thresh):
        v, left, right = orig(values, sizes, n1, n2, pval, size_thresh)
        v = v.clone()
        i = int(torch.nonzero((v == 0) & (sizes > size_thresh))[0])
        v[i] = 1
        return v, left, right
    monkeypatch.setattr(kernels, "wrs_verdicts", wrs)


@pytest.mark.parametrize("name,fault", [
    ("metahit124.cluster", _unchanged),
    ("metahit124.cluster", _half_left_out),
    ("metahit124.cluster", _centroid_altered),
    ("metahit124.cluster", _member_altered),
    ("metahit124.extract", _no_reads), ("metahit124.extract", _half_reads),
    ("metahit124.extract", _verdict_altered)])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, name,
                                                  fault):
    fault(monkeypatch)
    res = run_tiny(tiny, name)
    assert not res["correct"], res["checks"]
