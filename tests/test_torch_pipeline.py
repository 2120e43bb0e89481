"""The port's CLI, modes K → B → C, against the JAX pipeline on the
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
from kmerlsh_tpu_torch import cli
from kmerlsh_tpu_torch.io import clusterio, counts as countsio
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


def test_mode_e_refused_before_any_work(tmp_path):
    m = testdata.generate(str(tmp_path / "data"), seed=1)
    before = sorted(os.listdir(tmp_path))
    p = _jax_params(m, tmp_path)          # default mode: K, B, C and E
    with pytest.raises(NotImplementedError, match="mode E"):
        kmer_cluster(p, device="cpu")
    assert sorted(os.listdir(tmp_path)) == before
    assert not any(f.startswith("db") for f in os.listdir(tmp_path / "data"))


def test_out_of_core_refused(runs, tmp_path):
    work, m = runs["torch"]
    argv = _argv(m, work, "C") + ["--batch-thresh", "100",
                                  "-F", str(tmp_path / "r.txt")]
    with pytest.raises(NotImplementedError, match="out-of-core"):
        cli.main(argv)
    assert not (tmp_path / "r.txt").exists()


def test_cli_imports_no_jax():
    code = ("import sys, kmerlsh_tpu_torch.cli, kmerlsh_tpu_torch.kernels, "
            "kmerlsh_tpu_torch.kernels.build, kmerlsh_tpu_torch.testdata; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
