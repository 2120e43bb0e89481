"""The port's CLI, modes K → B → C → E, against the JAX pipeline on the
synthetic two-group fixture."""

import os
import subprocess
import sys

import numpy as np
import pytest

from kmerlsh_tpu import pipeline as jpipeline, testdata
from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.config import HyperParams
from kmerlsh_tpu.io import clusterio as jclusterio
from kmerlsh_tpu.pipeline import kmer_cluster as jax_kmer_cluster
from kmerlsh_tpu_torch import cli, pipeline
from kmerlsh_tpu_torch.io import clusterio, counts as countsio
from kmerlsh_tpu_torch.ops import reads as readops
from kmerlsh_tpu_torch.pipeline import kmer_cluster

from test_pipeline import K, _extract_diff_keys, marker_keys

ARTIFACTS = ("kmer_set.hex", "kmer_count.bin", "kmer_count.log")


def _argv(m, work, mode):
    return ["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", str(K),
            "--work-dir", str(work), "-F", str(work / "clustering_result.txt"),
            "-D", str(work / "tmp"), "-I", "15", "-N", "0.85", "--seed", "5",
            "-S", "20", "-o", str(work / "outA"), "-p", str(work / "outB"),
            "--only", "-M", mode, "--device", "cpu"]


def _jax_params(m, work):
    return HyperParams(
        input1=m["lists"]["A"], input2=m["lists"]["B"],
        output1=str(work / "outA"), output2=str(work / "outB"),
        clust_file_name=str(work / "clustering_result.txt"),
        tmp_dir=str(work / "tmp"), work_dir=str(work), k=K,
        cluster_iteration=15, min_similarity=0.85, size_thresh=20,
        pval_thresh=0.01, kmer_vote=0.5, count_min=2, seed=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's K, B, C in one directory; the JAX package's K, B, C on a
    second copy of the same fixture, through its single-device engine with
    float32 sort payloads (the suite's 8 virtual devices would otherwise
    send it down the sharded path)."""
    out = {}
    for name in ("torch", "jax"):
        work = tmp_path_factory.mktemp(name)
        m = testdata.generate(str(work / "data"), seed=99)
        out[name] = (work, m)
    work, m = out["torch"]
    for mode in ("K", "B", "C"):
        cli.main(_argv(m, work, mode))
    work, m = out["jax"]
    p = _jax_params(m, work)
    p.extracting = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "_mesh_or_none", lambda: None)
        mp.setattr(jengine, "PERMUTE", "payload_sort")
        jax_kmer_cluster(p)
    return out


def test_modes_k_b_artifacts_byte_identical(runs):
    (tw, _), (jw, _) = runs["torch"], runs["jax"]
    for name in ARTIFACTS:
        assert (tw / name).read_bytes() == (jw / name).read_bytes(), name


def test_mode_c_result_parses_and_covers_rows(runs):
    work, _ = runs["torch"]
    kmap, covs = countsio.read_log(str(work / "kmer_count.log"))
    values, ids = clusterio.read_cluster_all(
        str(work / "clustering_result.txt"), len(covs))
    flat = ids.flat.astype(np.int64)
    assert len(ids) > 0 and values.shape == (len(ids), len(covs))
    assert len(np.unique(flat)) == len(flat) and (flat < kmap).all()
    assert np.isfinite(values).all()


def test_cluster_count_close_to_jax(runs):
    (tw, _), (jw, _) = runs["torch"], runs["jax"]
    n = {}
    for name, work in (("torch", tw), ("jax", jw)):
        _, ids = jclusterio.read_cluster_all(
            str(work / "clustering_result.txt"), 4)
        n[name] = len(ids)
    assert abs(n["torch"] - n["jax"]) <= 0.05 * n["jax"]


def test_jax_mode_e_on_port_artifacts_finds_markers(runs):
    """The reference's mode E reads the port's artifacts and recovers the
    planted differential k-mers (the assertion of test_pipeline.py:62)."""
    work, m = runs["torch"]
    p = _jax_params(m, work)
    p.apply_mode("E", only=True)
    jax_kmer_cluster(p)
    keys = countsio.read_hex(str(work / "kmer_set.hex"))
    for group, gid in (("A", 1), ("B", 2)):
        mk = marker_keys(m["markers"][group])
        got = _extract_diff_keys(p, group=gid)
        assert np.isin(mk[np.isin(mk, keys)], got).mean() > 0.8


def test_cli_imports_no_jax():
    code = ("import sys, kmerlsh_tpu_torch.cli, kmerlsh_tpu_torch.kernels, "
            "kmerlsh_tpu_torch.kernels.build, kmerlsh_tpu_torch.testdata, "
            "kmerlsh_tpu_torch.ops.ttest, kmerlsh_tpu_torch.ops.reads; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of the JAX package, nor jax: the repo's
    modules it imports are all kmerlsh_tpu_torch's."""
    import ast

    root = os.path.dirname(os.path.dirname(__file__))
    tree = ast.parse(open(os.path.join(root, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "kmerlsh_tpu_torch" in tops
    assert not tops & {"kmerlsh_tpu", "jax", "jaxlib"}, sorted(names)


# --- mode E ------------------------------------------------------------------

def _outputs(m, prefix_a, prefix_b):
    return ([f"{prefix_a}_{os.path.basename(f)}" for f in m["samples"]["A"]]
            + [f"{prefix_b}_{os.path.basename(f)}" for f in m["samples"]["B"]])


@pytest.fixture(scope="module")
def jax_mode_e(runs):
    """The JAX package's mode E on the port's artifacts, through its
    single-device t-test (the suite's 8 virtual devices would otherwise
    send it down the sharded path): the files every port scorer must
    write."""
    work, m = runs["torch"]
    p = _jax_params(m, work)
    p.output1, p.output2 = str(work / "jaxE_A"), str(work / "jaxE_B")
    p.apply_mode("E", only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "_mesh_or_none", lambda: None)
        jax_kmer_cluster(p)
    return _outputs(m, p.output1, p.output2)


@pytest.mark.parametrize("scorer", ["host", "native", "device"])
def test_mode_e_matches_jax(runs, jax_mode_e, scorer):
    """The port's mode E on the CPU writes the JAX package's extracted
    FASTQs byte for byte, and its differential sets recover the planted
    markers (the assertion of test_pipeline.py:62)."""
    work, m = runs["torch"]
    pa, pb = work / f"E_{scorer}_A", work / f"E_{scorer}_B"
    cli.main(_argv(m, work, "E") + ["--read-scorer", scorer, "-o", str(pa),
                                    "-p", str(pb)])
    assert pipeline.LAST_SCORER == scorer
    got = _outputs(m, pa, pb)
    assert any(os.path.getsize(f) for f in got)
    for mine, theirs in zip(got, jax_mode_e):
        assert open(mine, "rb").read() == open(theirs, "rb").read(), mine
    kmap, covs = countsio.read_log(str(work / "kmer_count.log"))
    _, ids = clusterio.read_cluster_all(str(work / "clustering_result.txt"),
                                        len(covs))
    keys = countsio.read_hex(str(work / "kmer_set.hex"))
    diff = pipeline.diff_key_sets(keys, ids, pipeline.LAST_VERDICTS)
    for group, got_keys in zip("AB", diff):
        mk = marker_keys(m["markers"][group])
        assert np.isin(mk[np.isin(mk, keys)], got_keys).mean() > 0.8


def test_full_default_run(tmp_path):
    """No --only: K → B → C → E on the CPU."""
    m = testdata.generate(str(tmp_path / "data"), seed=99)
    argv = _argv(m, tmp_path, "K")
    argv = argv[:argv.index("--only")] + ["--device", "cpu"]
    cli.main(argv)
    for name in ARTIFACTS + ("clustering_result.txt",
                             "clustering_result.txt.clust"):
        assert (tmp_path / name).exists(), name
    outs = _outputs(m, tmp_path / "outA", tmp_path / "outB")
    assert all(os.path.exists(f) for f in outs)
    for g, prefix in (("A", "outA"), ("B", "outB")):
        extracted = b"".join(
            open(f"{tmp_path / prefix}_{os.path.basename(f)}", "rb").read()
            for f in m["samples"][g])
        assert extracted.count(b"\n+\n") > 0
        assert any(mk.encode()[:20] in extracted for mk in m["markers"][g])


def test_auto_scorer_never_picks_device(monkeypatch):
    """As test_pipeline.py: `auto` prefers the native scorer whenever the
    extension is built, on any --device."""
    pytest.importorskip("_kmerlsh_native")

    def boom(*a, **kw):
        raise AssertionError("auto picked the device scorer")

    monkeypatch.setattr(readops, "score_part_device_async", boom)
    for device in ("cuda", "cpu"):
        fn = pipeline._pick_scorer(HyperParams(read_scorer="auto"), device)
        assert pipeline.LAST_SCORER == "native"
        assert list(fn([b""], np.empty(0, np.uint64), 7, 0.5)()) == [False]


def test_auto_scorer_fallback_order(monkeypatch):
    """Without the native extension: device on a CUDA --device, host on
    the CPU."""
    import builtins

    real_import = builtins.__import__

    def no_native(name, *a, **kw):
        if name == "_kmerlsh_native":
            raise ImportError("unbuilt")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_native)
    pipeline._pick_scorer(HyperParams(read_scorer="auto"), "cuda")
    assert pipeline.LAST_SCORER == "device"
    pipeline._pick_scorer(HyperParams(read_scorer="auto"), "cuda:0")
    assert pipeline.LAST_SCORER == "device"
    pipeline._pick_scorer(HyperParams(read_scorer="auto"), "cpu")
    assert pipeline.LAST_SCORER == "host"


def test_device_scorer_never_routes_to_host(monkeypatch):
    """--read-scorer device runs the kernel wrapper, on the CPU its plain
    version, never a host scorer."""
    def boom(*a, **kw):
        raise AssertionError("device scorer routed to a host scorer")

    monkeypatch.setattr(readops, "score_part", boom)
    monkeypatch.setattr(readops, "score_part_native", boom)
    fn = pipeline._pick_scorer(HyperParams(read_scorer="device"), "cpu")
    poly_a = np.zeros(1, np.uint64)            # the key of AAAAAAA
    assert list(fn([b"A" * 40, b"C" * 40, b""], poly_a, 7, 0.5)()) == [
        True, False, False]


def test_extract_producer_error_propagates(tmp_path, monkeypatch):
    """A parse failure mid-stream aborts extraction: the producer thread
    records it and the consumer re-raises it after the join."""
    def bad_parts(paths, part_size=1 << 16):
        yield []
        raise ValueError("corrupt FASTQ header")

    monkeypatch.setattr(pipeline.fastqio, "read_parts", bad_parts)
    p = HyperParams(read_scorer="host")
    with pytest.raises(ValueError, match="corrupt FASTQ"):
        pipeline._extract_group([str(tmp_path / "x.fastq")],
                                np.empty(0, np.uint64),
                                str(tmp_path / "out"), p, "cpu")
