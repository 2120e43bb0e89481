"""CPU tests of the harness: finding a cell's files by name, the window's
rate on a fake clock, the roofline counts, the trace arithmetic and the
frozen generators."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from harness import gen, roofline, spec, trace, window


def test_every_cell_resolves_to_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert cell.limits
        spec.jobs_module(cell.traffic["jobs"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_a_cell_is_added_by_files_alone(tiny):
    """A new configuration, mix, cell and metric, added as files and
    BENCHMARK.json entries in a copy, run without an edit to any file
    that was there."""
    before = {p: p.read_bytes() for p in tiny.rglob("*") if p.is_file()}
    cfg = json.loads((tiny / "configs" / "metahit124.json").read_text())
    cfg.update(name="s8-m2K", samples=8, groups=[4, 4], rows=2048)
    (tiny / "configs" / "s8-m2K.json").write_text(json.dumps(cfg))
    (tiny / "traffic" / "cluster-again.json").write_text(
        json.dumps({"jobs": "cluster"}))
    cell = json.loads((tiny / "workloads" / "metahit124.cluster.json")
                      .read_text())
    cell.update(config="s8-m2K", traffic="cluster-again")
    (tiny / "workloads" / "s8-m2K.cluster-again.json").write_text(
        json.dumps(cell))
    (tiny / "metrics" / "c_jobs.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    spec_path = tiny.parent / "BENCHMARK.json"
    bench = json.loads(spec_path.read_text())
    bench["configs"].append({"name": "s8-m2K", "source": "test",
                             "file": "benchmark/configs/s8-m2K.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "s8-m2K.cluster-again",
                               "config": "s8-m2K", "traffic": "cluster-again",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "c_jobs", "unit": "jobs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["s8-m2K.cluster-again"]})
    spec_path.write_text(json.dumps(bench))

    from harness import runner

    found = spec.find_cell("s8-m2K.cluster-again", tiny)
    assert found.config["samples"] == 8
    res = runner.run_cell(found, 5, 0.2, False, "cpu", 0.0)
    assert res["correct"], res
    assert res["metrics"]["c_jobs"]["value"] == res["attempted"]
    assert {p: p.read_bytes() for p in before} == before


def test_a_cell_file_must_agree_with_benchmark_json(tiny):
    path = tiny / "workloads" / "metahit124.cluster.json"
    cell = json.loads(path.read_text())
    cell["traffic"] = "extract"
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError):
        spec.find_cell("metahit124.cluster", tiny)
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell", tiny)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("job_s,seconds,jobs", [
    (0.3, 1.0, 4), (0.25, 1.0, 4), (2.0, 1.0, 1), (0.1, 0.0, 1)])
def test_window_rate_is_all_work_over_all_time(job_s, seconds, jobs):
    clock = FakeClock()

    def job(j, keep):
        clock.t += job_s
        return dict(j=j, rows=1000)

    records, window_s = window.run(job, seconds, clock=clock)
    assert [r["j"] for r in records] == list(range(1, jobs + 1))
    assert window_s == pytest.approx(jobs * job_s)
    rate = spec.metric_reader("c_rows_per_s")(
        type("R", (), {"done": records, "window_s": window_s})())
    assert rate == pytest.approx(1000 / job_s)


def test_a_failed_job_ends_the_window_and_counts_no_work():
    clock = FakeClock()

    def job(j, keep):
        clock.t += 0.1
        if j == 3:
            raise RuntimeError("boom")
        return dict(j=j, rows=10)

    records, window_s = window.run(job, 10.0, clock=clock)
    assert len(records) == 3 and "boom" in records[-1]["error"]
    assert window_s == pytest.approx(0.3)


def test_reservoir_keeps_each_job_alike():
    hits = np.zeros(5)
    for seed in range(4000):
        pick = window.Reservoir(seed)
        kept = [k for k in range(5) if pick()]
        hits[kept[-1]] += 1
    assert np.all(np.abs(hits / 4000 - 0.2) < 0.03)


def test_roofline_counts_by_hand():
    S, M = 20, 1000
    assert roofline.transform(S, M)[0] == 2 * S * M + 4 * S + 4 * S * M + 4 * M
    assert roofline.lsh_keys(S, M, 9) == (
        4 * S * M + 4 * M + 4 * S * 10 + 8 * M, 2 * S * 10 * M)
    assert roofline.sort_keys(M) == (12 * M, 0.0)
    assert roofline.permute_state(S, M)[0] == 8 * S * M + 20 * M
    assert roofline.chain_collapse(S, M, 300)[0] == 8 * S * M + 24 * M + 1200
    assert roofline.finalize(S, 50, M)[0] == 8 * S * 50 + 16 * 50 + 8 * M
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("bits", [1, 8, 16, 25, 31])
def test_sort_bytes_do_not_follow_the_passes(bits):
    """K9's count is its function's: the same for a one-pass and a
    four-pass sort, whatever the port's plan does."""
    from kmerlsh_tpu_torch import kernels

    for m in (1 << 14, 1 << 20, 1 << 24):
        plan = kernels.sort_plan(m, bits)
        assert plan["passes"] == -(-bits // 8)
        assert roofline.sort_keys(m) == (12 * m, 0.0)


def test_session_calls_follow_the_programs():
    programs = [("transform@4096", 0.1), ("iter[0]@4096", 0.1),
                ("iter[1]@1500", 0.1), ("iter[2]@900", 0.1),
                ("finalize@800", 0.1)]
    calls = roofline.session_calls(programs, 20, 4000)
    kinds = [c[0] for c in calls]
    assert kinds == ["abundance_transform"] + [
        "lsh_keys", "sort_keys", "permute_state", "chain_collapse"] * 3 + [
        "sort_keys", "permute_state", "finalize"]
    # dying slots: 4000 − 1500, 1500 − 900, 900 − 800
    collapses = [c for c in calls if c[0] == "chain_collapse"]
    base = [roofline.chain_collapse(20, m, 0)[1] for m in (4096, 1500, 900)]
    assert [c[1] for c in collapses] == [
        roofline.chain_collapse(20, m, d)[0]
        for m, d in zip((4096, 1500, 900), (2500, 600, 100))]
    assert [c[2] for c in collapses] == base
    assert calls[-1][1:] == roofline.finalize(20, 800, 4096)
    with pytest.raises(ValueError):
        roofline.session_calls([("iter[0]@5", 0.1)], 20, 5)


def test_session_roofline_against_a_real_session():
    """The counts read the names a CPU session of the port records."""
    from kmerlsh_tpu_torch.cluster import engine

    counts = gen.make_counts(2048, 20, 3, "cpu")
    thr = np.asarray([0.95, 0.9, 0.85], np.float32)
    engine.cluster_counts(counts, gen.coverage_offsets(counts), thr, n=2048)
    calls = roofline.session_calls(engine.LAST_SESSION["programs"], 20, 2048)
    assert len(calls) == 1 + 4 * 3 + 3
    assert roofline.session_least_seconds(
        engine.LAST_SESSION["programs"], 20, 2048) > 0


def test_trace_busy_union_and_gaps():
    t = trace.Trace(device=[(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1")],
                    host=[(0, 100, "bench.job"), (32, 48, "aten::copy_")],
                    start_ns=0, end_ns=100)
    assert trace.busy_seconds(t.device) == pytest.approx(30e-9)
    gaps = trace.idle_gaps(t)
    assert gaps[0] == ["bench.job: host work outside PyTorch",
                       pytest.approx(40e-9)]
    assert ["bench.job: aten::copy_", pytest.approx(20e-9)] in gaps
    assert trace.device_ops(t)[0] == ["k1", pytest.approx(20e-9)]
    name = "void kl_sort_hist<8>(int*, int)"
    assert trace.kernel_name(name) == "kl_sort_hist"


@pytest.mark.parametrize("name,counted", [
    ("void kl_project<4>(float const*, int const*, float*, int)", True),
    ("void kl_sort_onesweep<true>(unsigned int const*, int*, int)", True),
    ("kl_chain_kernel(float*, int)", True),
    ("void kl_fin_roots(int*, int)", True),
    ("void kl_score_reads_kernel(unsigned char const*, int)", False),
    ("Memcpy DtoH (Device -> Pageable)", False),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)", False)])
def test_mode_c_kernels_are_known_by_the_trace_s_names(name, counted):
    """A kernel is matched by its name without ``void``, template and
    parameters, so that writing it as a template moves no metric."""
    assert roofline.is_mode_c_kernel(name) == counted
    run = type("R", (), {"done": [{}], "trace": trace.Trace(
        device=[(0, 2_000_000, name)], host=[], start_ns=0, end_ns=10)})()
    ms = spec.metric_reader("c_kernel_ms")(run)
    assert ms == (pytest.approx(2.0) if counted else None)


def test_profile_pool_is_testdata_s():
    from kmerlsh_tpu_torch import testdata

    r = np.random.default_rng(11)
    want = testdata.profile_pool(r, 40, 7)
    r = np.random.default_rng(11)
    got = gen.profile_pool(
        lambda shape: torch.from_numpy(
            r.normal(size=shape).astype(np.float32)),
        40, 7)
    assert got.shape == want.shape == (600, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_counts_are_the_distribution_of_make_data():
    counts = gen.make_counts(4096, 6, 2**31 + 5, "cpu")
    again = gen.make_counts(4096, 6, 2**31 + 5, "cpu")
    assert counts.dtype == torch.uint16 and counts.shape == (6, 4096)
    assert torch.equal(counts, again)
    c = counts.to(torch.int32)
    assert int(c.min()) >= 1
    # log-abundance 4 + a unit profile's entry: means near e^4
    logs = torch.log1p(c.double())
    assert abs(float(logs.mean()) - 4.0) < 0.2
    other = gen.make_counts(4096, 6, 2**31 + 6, "cpu")
    assert not torch.equal(counts, other)


@pytest.mark.parametrize("k", [1, 15, 23, 31])
def test_window_keys_are_codec_canonical_keys(k):
    from kmerlsh_tpu_torch import testdata

    src = torch.randint(0, 4, (7, 64), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(k))
    got = gen.unflip(gen.window_keys(src, k).reshape(-1))
    assert np.array_equal(got, testdata.window_keys(src.numpy(), k))


def test_fastq_records_read_back(tmp_path):
    from kmerlsh_tpu_torch.io import fastq

    codes = np.random.default_rng(1).integers(0, 4, (5, 30), dtype=np.uint8)
    path = tmp_path / "reads.fastq"
    path.write_bytes(gen.fastq_records(codes))
    reads = list(fastq.read_records(str(path)))
    assert [r.seq for r in reads] == [bytes(gen.BASES[c]) for c in codes]
    assert reads[3].name == b"r00000003"


def test_uint16_round_trip():
    x = torch.tensor([1, 2, 32767, 32768, 40000, 65535], dtype=torch.int32)
    assert gen.to_uint16(x).view(torch.int16).to(torch.int32).bitwise_and(
        0xFFFF).tolist() == x.tolist()
