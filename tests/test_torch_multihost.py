"""kmerlsh-torch on two processes (torch.distributed over gloo, ``--device
cpu``): modes K → B → C → E on the synthetic fixture, then mode C out of
core (the ``multibatch`` case of tests/test_multihost_cli.py, and the
greedy engine on the fixture), held against the JAX package's clustering
on as many devices and against a single-process run of the port; the
choice of device and backend; and the rule that the port imports nothing
of the JAX package."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmerlsh_tpu import pipeline as jpipeline
from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu.config import HyperParams
from kmerlsh_tpu.io import clusterio as jclusterio
from kmerlsh_tpu.parallel import dist as jdist, mesh as jmeshlib
from kmerlsh_tpu.pipeline import kmer_cluster as jax_kmer_cluster
from kmerlsh_tpu_torch import cli, testdata
from kmerlsh_tpu_torch.parallel import multihost

from test_multihost_cli import S as MB_S, _write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("build_count_matrix", "save_result", "save_binary")

# One rank: the CLI once for each command of a JSON list, with the writers
# of shared artifacts recorded for each, and whether it went out of core.
RANK = r"""
import json, sys
from kmerlsh_tpu_torch import cli, pipeline
from kmerlsh_tpu_torch.io import clusterio, counts as countsio

log, commands = sys.argv[1], json.loads(sys.argv[2])
calls = []


def recorded(mod, name):
    fn = getattr(mod, name)

    def wrapper(*a, **kw):
        calls[-1].append(name)
        return fn(*a, **kw)
    setattr(mod, name, wrapper)


recorded(countsio, "build_count_matrix")
recorded(clusterio, "save_result")
recorded(clusterio, "save_binary")
runs = []
for argv in commands:
    calls.append([])
    cli.main(argv)
    st = pipeline.LAST_STAGES
    runs.append(dict(calls=calls[-1],
                     out_of_core="C_init_clustering" in st.times,
                     tmp_rounds=st.metrics.get("tmp_rounds")))
json.dump(runs, open(log, "w"))
"""


def _argv(m, work):
    """K → B → C → E on the fixture (no --only), as test_torch_pipeline."""
    return ["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", "15",
            "--work-dir", str(work), "-F", str(work / "clustering_result.txt"),
            "-D", str(work / "tmp"), "-I", "15", "-N", "0.85", "--seed", "5",
            "-S", "20", "-o", str(work / "outA"), "-p", str(work / "outB"),
            "--device", "cpu"]


def _multibatch_argv(mb):
    """The multibatch case of tests/test_multihost_cli.py."""
    return ["-a", str(mb / "l1"), "-b", str(mb / "l2"), "-M", "C", "--only",
            "-I", "6", "-N", "0.8", "--seed", "0", "--work-dir", str(mb),
            "-D", str(mb / "tmp"), "-F", str(mb / "mp_result.txt"),
            "--batch-thresh", "512", "--device", "cpu"]


def _greedy_argv(m, work):
    return _argv(m, work) + ["--only", "-M", "C", "--engine", "greedy",
                             "-F", str(work / "greedy.txt"),
                             "-D", str(work / "gtmp")]


def _outputs(m, prefix_a, prefix_b):
    return ([f"{prefix_a}_{os.path.basename(f)}" for f in m["samples"]["A"]]
            + [f"{prefix_b}_{os.path.basename(f)}" for f in m["samples"]["B"]])


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Three runs on the same two ranks: the fixture's full run (rank 0
    given the flags, rank 1 the KMERLSH_* environment variables), then
    mode C out of core on the multibatch case's inputs, then mode C with
    the greedy engine on the fixture's artifacts. Returns (work dir,
    manifest, the multibatch case's dir, each rank's runs: the shared
    writers it called, whether it went out of core and its tmp_rounds)."""
    work = tmp_path_factory.mktemp("mp")
    m = testdata.generate(str(work / "data"), seed=99)
    mb = work / "multibatch"
    mb.mkdir()
    _write_inputs(str(mb))
    script = work / "rank.py"
    script.write_text(RANK)
    coords = _free_ports(3)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env1 = dict(env, KMERLSH_COORDINATOR=coords[0], KMERLSH_NUM_PROCESSES="2",
                KMERLSH_PROCESS_ID="1")

    def flags(coord, r):
        return ["--coordinator", coord, "--num-processes", "2",
                "--process-id", str(r)]

    logs = [str(work / f"rank{r}.json") for r in range(2)]
    commands = [[_argv(m, work) + (flags(coords[0], 0) if r == 0 else []),
                 _multibatch_argv(mb) + flags(coords[1], r),
                 _greedy_argv(m, work) + flags(coords[2], r)]
                for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), logs[r], json.dumps(commands[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env if r == 0 else env1) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return work, m, mb, [json.load(open(log)) for log in logs]


def test_rank0_alone_writes_shared_artifacts(two_ranks):
    work, m, _, runs = two_ranks
    assert sorted(runs[0][0]["calls"]) == sorted(SHARED)
    assert runs[1][0]["calls"] == []
    for name in ("kmer_set.hex", "kmer_count.bin", "kmer_count.log",
                 "clustering_result.txt", "clustering_result.txt.clust"):
        assert (work / name).exists(), name
    # mode K split the samples: every KMC database was written once
    for group in "AB":
        for s in range(2):
            assert (work / "data" / f"db{group}{s}.kmc_pre").exists()


def test_partition_matches_jax_sharded_cli(two_ranks, tmp_path):
    """The two ranks' clustering file holds the same clusters as the JAX
    package's mode C on the same artifacts over a mesh of two devices."""
    work, m, _, _ = two_ranks
    p = HyperParams(
        input1=m["lists"]["A"], input2=m["lists"]["B"],
        clust_file_name=str(tmp_path / "jax_result.txt"),
        tmp_dir=str(tmp_path / "tmp"), work_dir=str(work), k=15,
        cluster_iteration=15, min_similarity=0.85, seed=5)
    p.apply_mode("C", only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "_mesh_or_none", lambda: jmeshlib.make_mesh(2))
        mp.setattr(jengine, "PERMUTE", "payload_sort")
        jax_kmer_cluster(p)
    clusters = []
    for path in (work / "clustering_result.txt", tmp_path / "jax_result.txt"):
        _, ids = jclusterio.read_cluster_all(str(path), 4)
        clusters.append({tuple(np.sort(ids[i])) for i in range(len(ids))})
    assert len(clusters[0]) > 10
    assert clusters[0] == clusters[1]


def test_fastqs_match_a_single_process_run(two_ranks):
    """Mode E on one process, on the two ranks' clustering file, writes
    the extracted FASTQs the two ranks wrote (each rank half of them)."""
    work, m, _, _ = two_ranks
    argv = _argv(m, work) + ["--only", "-M", "E", "-o", str(work / "spA"),
                             "-p", str(work / "spB")]
    cli.main(argv)
    sharded = _outputs(m, work / "outA", work / "outB")
    single = _outputs(m, work / "spA", work / "spB")
    assert any(os.path.getsize(f) for f in single)
    for a, b in zip(sharded, single):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def _jax_two_devices(p, mp):
    """The JAX package's kmer_cluster on a mesh of two of the suite's
    virtual devices (its sharded entries' default mesh too), with float32
    sort payloads."""
    mp.setattr(jpipeline, "_mesh_or_none", lambda: jmeshlib.make_mesh(2))
    mp.setattr(jdist, "make_mesh", lambda n=None: jmeshlib.make_mesh(2))
    mp.setattr(jengine, "PERMUTE", "payload_sort")
    jax_kmer_cluster(p)


def _cluster_set(path, num_samples):
    _, ids = jclusterio.read_cluster_all(str(path), num_samples)
    return {tuple(np.sort(ids[i])) for i in range(len(ids))}


def test_multibatch_cli_matches_jax(two_ranks, tmp_path):
    """The multibatch case of tests/test_multihost_cli.py (S = 8, N = 2048,
    --batch-thresh 512) on two ranks runs out of core and gives the set of
    clusters of the JAX package's run on two devices; rank 1 writes no
    file."""
    _, _, mb, runs = two_ranks
    for rank in runs:
        assert rank[1]["out_of_core"] and rank[1]["tmp_rounds"]
    assert runs[0][1]["tmp_rounds"] == runs[1][1]["tmp_rounds"]
    assert runs[0][1]["calls"] and runs[1][1]["calls"] == []
    p = HyperParams(input1=str(mb / "l1"), input2=str(mb / "l2"),
                    clust_file_name=str(tmp_path / "jax_result.txt"),
                    tmp_dir=str(tmp_path / "tmp"), work_dir=str(mb),
                    cluster_iteration=6, min_similarity=0.8, seed=0,
                    batch_thresh=512)
    p.apply_mode("C", only=True)
    with pytest.MonkeyPatch.context() as mp:
        _jax_two_devices(p, mp)
    got = _cluster_set(mb / "mp_result.txt", MB_S)
    assert len(got) > 1
    assert got == _cluster_set(tmp_path / "jax_result.txt", MB_S)


def test_greedy_two_ranks_match_jax(two_ranks, tmp_path):
    """--engine greedy on two ranks: every rank runs the oracle, rank 0
    alone writes, and the clustering file and centroid binary equal the
    JAX package's greedy run byte for byte."""
    work, m, _, runs = two_ranks
    for rank in runs:
        assert rank[2]["out_of_core"]
    assert runs[1][2]["calls"] == []
    p = HyperParams(
        input1=m["lists"]["A"], input2=m["lists"]["B"],
        clust_file_name=str(tmp_path / "jgreedy.txt"),
        tmp_dir=str(tmp_path / "tmp"), work_dir=str(work), k=15,
        cluster_iteration=15, min_similarity=0.85, seed=5, engine="greedy")
    p.apply_mode("C", only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "_mesh_or_none", lambda: None)
        jax_kmer_cluster(p)
    for ext in ("", ".clust"):
        mine = (work / f"greedy.txt{ext}").read_bytes()
        assert mine and mine == (tmp_path / f"jgreedy.txt{ext}").read_bytes()


@pytest.mark.parametrize("device,nproc,pid,cards,local_world,want", [
    ("cpu", 4, 2, 0, None, ("cpu", "gloo")),
    ("cuda", 4, 2, 4, None, ("cuda:2", "nccl")),
    ("cuda", 4, 3, 1, None, ("cuda:0", "gloo")),
    ("cuda", 8, 5, 4, "4", ("cuda:1", "nccl")),
    ("cuda:1", 2, 0, 2, None, ("cuda:1", "nccl")),
], ids=["cpu", "card-each", "shared-card", "two-hosts", "explicit-index"])
def test_rank_device_and_backend(monkeypatch, device, nproc, pid, cards,
                                 local_world, want):
    """NCCL where the host's ranks have a card each, gloo where they share
    one or run on the CPU; a bare cuda takes the rank's local card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert multihost.rank_device(device, nproc, pid) == want


def test_coordinator_needs_count_and_id(monkeypatch):
    for name in ("KMERLSH_NUM_PROCESSES", "KMERLSH_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    params, _ = cli.params_from_args(["-a", "l1", "-b", "l2",
                                      "--coordinator", "127.0.0.1:1"])
    with pytest.raises(ValueError, match="--num-processes"):
        multihost.maybe_initialize(params, "cpu")


def test_single_process_helpers():
    """Without a process group: one process, rank 0, every item, and
    gather_np the tensor itself."""
    assert multihost.process_count() == 1 and multihost.proc0()
    assert multihost.my_items([1, 2, 3]) == [1, 2, 3]
    multihost.barrier("none")
    x = torch.arange(4)
    assert np.array_equal(multihost.gather_np(x), x.numpy())


def test_port_imports_nothing_of_the_jax_package(tmp_path):
    """A fresh interpreter imports every module of kmerlsh_tpu_torch and
    runs the fixture's CLI on the CPU: neither jax nor kmerlsh_tpu is
    loaded."""
    code = r"""
import pkgutil, sys
import kmerlsh_tpu_torch
from kmerlsh_tpu_torch import cli, testdata
names = [m.name for m in pkgutil.walk_packages(kmerlsh_tpu_torch.__path__,
                                               "kmerlsh_tpu_torch.")]
assert len(names) > 20, names
for name in names:
    __import__(name)
work = sys.argv[1]
m = testdata.generate(work + "/data", seed=99)
cli.main(["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", "15",
          "--work-dir", work, "-F", work + "/r.txt", "-D", work + "/tmp",
          "-I", "5", "-o", work + "/oA", "-p", work + "/oB",
          "--device", "cpu"])
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "kmerlsh_tpu"))
assert not bad, bad
print("IMPORT_RULE_OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "IMPORT_RULE_OK" in out.stdout
