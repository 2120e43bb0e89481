"""The port's out-of-core mode C, its batch clamp and its greedy engine
against the JAX package's: init_clustering on well-separated counts, on
one process and on two gloo ranks (against JAX on two devices), the CLI at
a small --batch-thresh on the synthetic fixture, the tmp round files read
across packages, rows_budget and the batch of a multi-process run, and the
greedy oracle; the sharded batch passes never defer to the flush thread
(test_torch_flush.py has the rest of it)."""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from kmerlsh_tpu import pipeline as jpipeline, testdata
from kmerlsh_tpu.cluster import engine as jengine, greedy as jgreedy
from kmerlsh_tpu.config import HyperParams as JParams
from kmerlsh_tpu.io import clusterio as jclusterio
from kmerlsh_tpu.parallel import dist as jdist, mesh as jmeshlib
from kmerlsh_tpu.utils import hbm as jhbm
from kmerlsh_tpu.utils.timing import Stages as JStages
from kmerlsh_tpu_torch import cli, pipeline
from kmerlsh_tpu_torch.cluster import greedy
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.io import clusterio, counts as countsio
from kmerlsh_tpu_torch.utils import hbm
from kmerlsh_tpu_torch.utils.timing import Stages

from test_cluster import partition_of, planted, same_partition
from test_pipeline import K, marker_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_SEP, N_SEP = 6, 4096


def _separated_counts(work):
    """The well-separated counts of test_pipeline.py's
    test_out_of_core_f16_tmp_matches_f32: 2S profiles at transformed-space
    cosines of ~1, ~0 or ~-1, nothing near the 0.849-0.95 band."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((S_SEP, S_SEP)))
    prof = np.concatenate([q.T, -q.T])
    rows = rng.integers(0, 2 * S_SEP, size=N_SEP)
    logv = 4.0 + prof[rows] + 0.001 * rng.standard_normal((N_SEP, S_SEP))
    counts = np.clip(np.rint(np.expm1(logv)), 1, 65535).astype(np.uint16)
    work.mkdir(parents=True, exist_ok=True)
    counts.T.astype("<u2").tofile(str(work / "kmer_count.bin"))
    cov = np.log(np.maximum(counts, 1)).sum(axis=0)
    return (cov / N_SEP).astype(np.float32).tolist()


def _recording(mp, module, rounds):
    """Patch ``module.save_result`` to note the clusters of every write by
    file name, in order."""
    real = module.save_result

    def save_result(ids_list, path, *a, **kw):
        name = os.path.basename(path)
        if not rounds or rounds[-1][0] != name:
            rounds.append([name, 0])
        rounds[-1][1] += len(ids_list)
        return real(ids_list, path, *a, **kw)

    mp.setattr(module, "save_result", save_result)


def _round_file(tmp_dir):
    (name,) = [f for f in os.listdir(tmp_dir) if f.endswith(".bin")]
    return os.path.join(tmp_dir, name)


@pytest.fixture(scope="module")
def separated(tmp_path_factory):
    """init_clustering of both packages on the separated counts, batch 256
    and merge windows of 128, tmp files f16; JAX on its single-device
    engine with float32 sort payloads."""
    root = tmp_path_factory.mktemp("ooc")
    v = _separated_counts(root / "work")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "MERGE_WINDOW_MIN", 64)
        mp.setattr(jpipeline, "MERGE_WINDOW_MIN", 64)
        mp.setattr(jpipeline, "_mesh_or_none", lambda: None)
        mp.setattr(jengine, "PERMUTE", "payload_sort")
        for name, mod, params, stages, run in (
                ("torch", clusterio, HyperParams, Stages,
                 lambda p, st: pipeline.init_clustering(p, N_SEP, v, st,
                                                        "cpu")),
                ("jax", jclusterio, JParams, JStages,
                 lambda p, st: jpipeline.init_clustering(p, N_SEP, v, st))):
            rounds = []
            _recording(mp, mod, rounds)
            p = params(tmp_dir=str(root / f"tmp_{name}"),
                       work_dir=str(root / "work"), batch_thresh=256,
                       min_similarity=0.85, seed=5)
            st = stages()
            values, ids = run(p, st)
            out[name] = dict(values=values, ids=ids, rounds=rounds,
                             stages=st, tmp=_round_file(p.tmp_dir))
    return out


def test_init_clustering_matches_jax(separated):
    """The same partition in the same order, the same cluster count after
    the batch passes and after every merge round, and centroids within the
    f16 rounding of the tmp files (the JAX engine pulls f16, the port
    f32: one f16 ulp apart at most)."""
    t, j = separated["torch"], separated["jax"]
    assert len(t["rounds"]) >= 2            # batch passes + merge rounds
    assert t["rounds"] == j["rounds"]
    assert t["stages"].metrics["tmp_rounds"] == [n for _, n in t["rounds"]]
    assert np.array_equal(t["ids"].flat, j["ids"].flat)
    assert np.array_equal(t["ids"].offsets, j["ids"].offsets)
    np.testing.assert_allclose(t["values"], j["values"], rtol=2 ** -10,
                               atol=2 ** -14)
    assert t["stages"].times["device_seconds"] > 0
    assert t["stages"].metrics["tmp_bytes"] > 0


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_round_file_reads_back_in_the_other_package(separated, writer):
    """The last round file of one package, read by both packages'
    clusterio: the same <f2 values and the same ids."""
    path = separated[writer]["tmp"]
    n = len(separated[writer]["ids"])
    a_vals, a_ids = clusterio.read_cluster(path, S_SEP, 0, n, dtype="<f2")
    b_vals, b_ids = jclusterio.read_cluster(path, S_SEP, 0, n, dtype="<f2")
    assert np.array_equal(a_vals, b_vals) and a_vals.dtype == np.float32
    assert np.array_equal(a_ids.flat, b_ids.flat)
    assert np.array_equal(a_ids.offsets, b_ids.offsets)
    assert np.array_equal(a_vals, separated[writer]["values"])
    assert os.path.getsize(path) == 2 * S_SEP * n


def test_out_of_core_f16_tmp_matches_f32(tmp_path, monkeypatch):
    """The port's test_out_of_core_f16_tmp_matches_f32: on well-separated
    counts the f16 tmp rounds give exactly the f32 rounds' clusters."""
    v = _separated_counts(tmp_path / "work")
    monkeypatch.setattr(pipeline, "MERGE_WINDOW_MIN", 64)
    outs = {}
    for dt in ("<f2", "<f4"):
        monkeypatch.setattr(pipeline, "TMP_VALUES_DTYPE", dt)
        p = HyperParams(tmp_dir=str(tmp_path / f"tmp{dt.strip('<')}"),
                        work_dir=str(tmp_path / "work"), batch_thresh=256,
                        min_similarity=0.85, seed=5)
        st = Stages()
        values, ids = pipeline.init_clustering(p, N_SEP, v, st, "cpu")
        outs[dt] = ids
        assert len(st.metrics["tmp_rounds"]) >= 2
    a, b = outs["<f2"], outs["<f4"]
    assert np.array_equal(a.flat, b.flat)
    assert np.array_equal(a.offsets, b.offsets)


# --- two ranks -------------------------------------------------------------

# One gloo rank of two: the sharded init_clustering on the separated counts
# (its round-file writes recorded by file name), then the batch of a run
# (hbm.batch_budget) with the card count, each rank's card memory and the
# measurement of bytes a row stubbed.
RANK = r"""
import os, pickle, sys, threading, time
import torch
import torch.distributed as tdist

rank, port, job_path, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=2, rank=rank)
from kmerlsh_tpu_torch import pipeline
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.io import clusterio
from kmerlsh_tpu_torch.parallel import multihost
from kmerlsh_tpu_torch.utils import hbm
from kmerlsh_tpu_torch.utils.timing import Stages

job = pickle.load(open(job_path, "rb"))
res = {}
rounds = []
real_save = clusterio.save_result


def save_result(ids_list, path, *a, **kw):
    name = os.path.basename(path)
    if not rounds or rounds[-1][0] != name:
        rounds.append([name, 0])
    rounds[-1][1] += len(ids_list)
    return real_save(ids_list, path, *a, **kw)


clusterio.save_result = save_result
binaries = []
off_main = []
real_binary = clusterio.save_binary


def save_binary(cents, ids_list, path, *a, **kw):
    binaries.append(os.path.basename(path))
    off_main.append(threading.current_thread() is not threading.main_thread())
    return real_binary(cents, ids_list, path, *a, **kw)


clusterio.save_binary = save_binary
pipeline.MERGE_WINDOW_MIN = 64
p = HyperParams(tmp_dir=job["tmp"], work_dir=job["work"], batch_thresh=256,
                min_similarity=0.85, seed=5)
st = Stages()
values, ids = pipeline.init_clustering(p, job["n"], job["v"], st, "cpu")
res["init"] = dict(values=values, flat=ids.flat, offsets=ids.offsets,
                   rounds=rounds, binaries=sorted(set(binaries)),
                   tmp_rounds=list(st.metrics["tmp_rounds"]),
                   tmp_bytes=st.metrics["tmp_bytes"],
                   device_seconds=st.times.get("device_seconds", 0.0),
                   saves_off_main=sum(off_main),
                   defers=pipeline._defers(256, len(job["v"]), "cpu"))

measured = []


def measure(num_samples, device):
    measured.append(num_samples)
    time.sleep(0.5)          # long enough for another rank to miss the cache
    return 430


hbm.measure_per_row_bytes = measure
hbm._cuda = lambda device: True
torch.cuda.get_device_name = lambda device=None: "card"
for name, (cards, mems, kmap) in job["budget"].items():
    torch.cuda.device_count = lambda cards=cards: cards
    hbm.device_memory_bytes = lambda device, m=mems[rank]: m
    hbm._CAL_PATH = os.path.join(job["cal"], name, "memory_per_row.json")
    dev, _ = multihost.rank_device("cuda", 2, rank)
    measured.clear()
    res[name] = (dev, hbm.batch_budget(20, kmap, dev), len(measured))
pickle.dump(res, open(out, "wb"))
tdist.destroy_process_group()
"""

CARD = 80 * 10 ** 9
# name → (cards on the host, each rank's card memory, rows of the matrix)
BUDGET = {
    "shared": (1, (CARD, CARD), 1 << 20),
    "two_cards": (2, (CARD, CARD), 1 << 20),
    "uneven": (2, (CARD, 3 * 10 ** 10), 1 << 20),
    "measured_shared": (1, (CARD, CARD), 1 << 29),
    "measured_two_cards": (2, (CARD, CARD), 1 << 29),
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (RANK), and JAX's init_clustering on the same
    counts over a mesh of two devices, merge rounds included, with float32
    sort payloads; the two run side by side."""
    root = tmp_path_factory.mktemp("ooc2")
    v = _separated_counts(root / "work")
    job = root / "job.pkl"
    job.write_bytes(pickle.dumps(dict(
        tmp=str(root / "tmp"), work=str(root / "work"), n=N_SEP, v=v,
        cal=str(root / "cal"), budget=BUDGET)))
    script = root / "rank.py"
    script.write_text(RANK)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = {k: val for k, val in os.environ.items() if k not in (
        "XLA_FLAGS", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(root / f"rank{r}.pkl") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port, str(job), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpipeline, "MERGE_WINDOW_MIN", 64)
            mp.setattr(jpipeline, "_mesh_or_none",
                       lambda: jmeshlib.make_mesh(2))
            mp.setattr(jdist, "make_mesh", lambda n=None: jmeshlib.make_mesh(2))
            mp.setattr(jengine, "PERMUTE", "payload_sort")
            rounds = []
            _recording(mp, jclusterio, rounds)
            p = JParams(tmp_dir=str(root / "jtmp"), work_dir=str(root / "work"),
                        batch_thresh=256, min_similarity=0.85, seed=5)
            st = JStages()
            values, ids = jpipeline.init_clustering(p, N_SEP, v, st)
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    ranks = [pickle.loads(open(o, "rb").read()) for o in outs]
    return dict(ranks=ranks, tmp=root / "tmp",
                jax=dict(values=values, ids=ids, rounds=rounds))


def test_sharded_init_clustering_matches_jax(two_ranks):
    """On both ranks: the same partition in the same order as JAX's
    two-device run, the same cluster count after the batch passes and
    after every merge round, centroids within the f16 rounding of the tmp
    files, and device seconds counted."""
    j = two_ranks["jax"]
    assert len(j["rounds"]) >= 2            # batch passes + merge rounds
    for r, rank in enumerate(two_ranks["ranks"]):
        got = rank["init"]
        assert got["tmp_rounds"] == [n for _, n in j["rounds"]], r
        assert np.array_equal(got["flat"], j["ids"].flat), r
        assert np.array_equal(got["offsets"], j["ids"].offsets), r
        np.testing.assert_allclose(got["values"], j["values"],
                                   rtol=2 ** -10, atol=2 ** -14)
        assert got["device_seconds"] > 0


def test_sharded_round_files_written_by_rank0_alone(two_ranks):
    """Rank 0 writes every round file JAX writes, with the same clusters;
    rank 1 writes none; only the last round's two files remain, and both
    ranks count their bytes."""
    r0, r1 = (rank["init"] for rank in two_ranks["ranks"])
    assert r0["rounds"] == two_ranks["jax"]["rounds"]
    assert r0["binaries"] == sorted(name.removesuffix(".clust")
                                    for name, _ in r0["rounds"])
    assert r1["rounds"] == [] and r1["binaries"] == []
    last = r0["binaries"][-1]
    assert sorted(os.listdir(two_ranks["tmp"])) == [last, last + ".clust"]
    assert r0["tmp_bytes"] == r1["tmp_bytes"] > 0


def test_sharded_batches_never_defer(two_ranks):
    """The mesh branch runs its batch passes one after another: rank 0
    writes every round file on its main thread, though a single process
    would defer batches of this size (``pipeline._defers``)."""
    r0 = two_ranks["ranks"][0]["init"]
    assert r0["defers"] and r0["rounds"]
    assert r0["saves_off_main"] == 0


# --- the CLI on the synthetic fixture -----------------------------------------

def _argv(m, work, mode, *extra):
    return ["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", str(K),
            "--work-dir", str(work), "-F", str(work / "clustering_result.txt"),
            "-D", str(work / "tmp"), "-I", "15", "-N", "0.85", "--seed", "5",
            "-S", "20", "-o", str(work / "outA"), "-p", str(work / "outB"),
            "--only", "-M", mode, "--device", "cpu", *extra]


def _jax_params(m, work, **kw):
    p = JParams(
        input1=m["lists"]["A"], input2=m["lists"]["B"],
        output1=str(work / "jA"), output2=str(work / "jB"),
        clust_file_name=str(work / "jax_result.txt"),
        tmp_dir=str(work / "jtmp"), work_dir=str(work), k=K,
        cluster_iteration=15, min_similarity=0.85, size_thresh=20,
        pval_thresh=0.01, kmer_vote=0.5, count_min=2, seed=5)
    for key, val in kw.items():
        setattr(p, key, val)
    p.apply_mode("C", only=True)
    return p


@pytest.fixture(scope="module")
def fixture_bc(tmp_path_factory):
    """The port's modes K and B on the synthetic fixture."""
    work = tmp_path_factory.mktemp("fixture")
    m = testdata.generate(str(work / "data"), seed=99)
    for mode in ("K", "B"):
        cli.main(_argv(m, work, mode))
    return work, m


def _jax_mode_c(p):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "_mesh_or_none", lambda: None)
        mp.setattr(jengine, "PERMUTE", "payload_sort")
        jpipeline.kmer_cluster(p)


def test_batched_out_of_core_matches_jax(fixture_bc):
    """The port's test_batched_out_of_core_matches_single_batch: the CLI
    at --batch-thresh 500 runs out of core (merge windows of 256 rows, so
    that merge rounds run too), its mode E recovers the planted
    markers, and its cluster count lies within 2% of JAX's single-device
    run at the same batch size on the same artifacts."""
    work, m = fixture_bc
    with pytest.MonkeyPatch.context() as mp:    # merge windows of 256 rows
        mp.setattr(pipeline, "MERGE_WINDOW_MIN", 256)
        mp.setattr(jpipeline, "MERGE_WINDOW_MIN", 256)
        cli.main(_argv(m, work, "C", "--batch-thresh", "500"))
        _jax_mode_c(_jax_params(m, work, batch_thresh=500))
    st = pipeline.LAST_STAGES
    assert "C_init_clustering" in st.times and len(st.metrics["tmp_rounds"]) > 1
    n = {}
    for name in ("clustering_result.txt", "jax_result.txt"):
        _, ids = clusterio.read_cluster_all(str(work / name), 4)
        n[name] = len(ids)
    assert abs(n["clustering_result.txt"] - n["jax_result.txt"]) \
        <= 0.02 * n["jax_result.txt"]
    cli.main(_argv(m, work, "E", "--read-scorer", "host"))
    kmap, covs = countsio.read_log(str(work / "kmer_count.log"))
    _, ids = clusterio.read_cluster_all(str(work / "clustering_result.txt"),
                                        len(covs))
    keys = countsio.read_hex(str(work / "kmer_set.hex"))
    diff = pipeline.diff_key_sets(keys, ids, pipeline.LAST_VERDICTS)
    for group, got in zip("AB", diff):
        mk = marker_keys(m["markers"][group])
        assert np.isin(mk[np.isin(mk, keys)], got).mean() > 0.8


def test_greedy_cli_matches_jax(fixture_bc):
    """--engine greedy in mode C against the JAX package's greedy run on the
    same artifacts: the same clustering file and centroid binary, byte for
    byte (the transform agrees to a few float32 ulp, test_torch_ops.py,
    and the f16 tmp round absorbs them on this fixture)."""
    work, m = fixture_bc
    cli.main(_argv(m, work, "C", "--engine", "greedy", "-F",
                   str(work / "greedy.txt"), "-D", str(work / "gtmp")))
    assert "C_init_clustering" in pipeline.LAST_STAGES.times
    _jax_mode_c(_jax_params(m, work, engine="greedy",
                            clust_file_name=str(work / "jgreedy.txt"),
                            tmp_dir=str(work / "jgtmp")))
    for ext in ("", ".clust"):
        mine = (work / f"greedy.txt{ext}").read_bytes()
        assert mine and mine == (work / f"jgreedy.txt{ext}").read_bytes()


# --- the batch clamp ------------------------------------------------------------

def test_rows_budget_matches_jax():
    """test_cluster.py's test_hbm_rows_budget with a given memory size, in
    both packages: powers of two, at least 2^16, more rows with more
    devices, fewer with more samples."""
    for mem in (16 << 30, 80 * 10 ** 9, 1 << 20):
        for s, d in ((20, 1), (20, 8), (100, 1), (400, 1)):
            b = hbm.rows_budget(s, d, mem=mem)
            assert b == jhbm.rows_budget(s, d, mem=mem)
            assert b & (b - 1) == 0 and b >= 1 << 16
        assert hbm.rows_budget(20, 8, mem=mem) >= hbm.rows_budget(20, 1,
                                                                  mem=mem)
        assert hbm.rows_budget(100, 1, mem=mem) <= hbm.rows_budget(20, 1,
                                                                   mem=mem)
    # without a card, both take the reference's 16 GiB default
    assert hbm.device_memory_bytes("cpu") == jhbm.device_memory_bytes()


def test_rows_budget_measures_at_the_boundary(monkeypatch):
    """test_cluster.py's test_hbm_budget_uses_measurement_at_the_boundary:
    no measurement while the static estimate admits the matrix; where it
    would clamp, the measured bytes a row decide, at the higher fill. On
    an 80 GB card, the ~430 B a row of the port's session admit 2^27 rows
    of 20 samples (the static model: 2^27 as well), and refuse 2^28."""
    calls = []

    def fake_measured(num_samples, device):
        calls.append(num_samples)
        return 430

    monkeypatch.setattr(hbm, "cached_per_row_bytes", fake_measured)
    mem = 80 * 10 ** 9
    hbm.rows_budget(20, 1, mem=mem, kmap_size=1 << 20)
    assert calls == []
    assert hbm.rows_budget(20, 1, mem=mem, kmap_size=1 << 28) == 1 << 27
    assert calls == [20]
    # without a card nothing is measured: the static model stands
    monkeypatch.undo()
    assert hbm.cached_per_row_bytes(20, "cpu") is None
    assert hbm.rows_budget(20, 1, mem=mem, kmap_size=1 << 30,
                           device="cpu") == jhbm.rows_budget(
                               20, 1, mem=mem, kmap_size=1 << 30)


def test_measured_bytes_are_cached_by_card_samples_and_sources(
        tmp_path, monkeypatch):
    """A session's bytes a row are measured once for a card, a sample
    count and the package's sources, and read back from the cache after;
    once the sources change they are measured anew."""
    import torch

    calls = []

    def fake_measure(num_samples, device):
        calls.append(num_samples)
        return 400 + len(calls)

    monkeypatch.setattr(hbm, "_CAL_PATH", str(tmp_path / "cal" / "m.json"))
    monkeypatch.setattr(hbm, "_cuda", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    monkeypatch.setattr(hbm, "measure_per_row_bytes", fake_measure)
    assert hbm.cached_per_row_bytes(20) == 401
    assert hbm.cached_per_row_bytes(20) == 401
    assert hbm.cached_per_row_bytes(400) == 402
    monkeypatch.setattr(hbm, "_source_digest", lambda: "changed")
    assert hbm.cached_per_row_bytes(20) == 403
    assert calls == [20, 400, 20]


def test_shared_card_gets_half_of_two_cards(two_ranks):
    """Two ranks on one card (rank_device with one card) take the batch
    that card holds, half of what two cards give; two cards give the
    reference's rows_budget over two devices."""
    r0, r1 = (rank for rank in two_ranks["ranks"])
    assert r0["shared"][0] == r1["shared"][0] == "cuda:0"
    assert (r0["two_cards"][0], r1["two_cards"][0]) == ("cuda:0", "cuda:1")
    assert r0["shared"][1] == hbm.rows_budget(20, 1, mem=CARD)
    assert 2 * r0["shared"][1] == r0["two_cards"][1] \
        == jhbm.rows_budget(20, 2, mem=CARD)


@pytest.mark.parametrize("case", list(BUDGET))
def test_ranks_agree_on_one_batch(two_ranks, case):
    """Every rank takes the same batch: two ranks times the least share
    (the smaller card's in ``uneven``)."""
    r0, r1 = (rank[case][1] for rank in two_ranks["ranks"])
    assert r0 == r1 and r0 & (r0 - 1) == 0
    if case == "uneven":
        assert r0 == 2 * hbm.rows_budget(20, 1, mem=3 * 10 ** 10)


def test_one_rank_measures_a_shared_card(two_ranks):
    """Where bytes a row are measured, only the first rank on a card
    measures; the other waits and reads its cached result. On two cards
    each rank measures its own."""
    r0, r1 = (rank for rank in two_ranks["ranks"])
    assert (r0["measured_shared"][2], r1["measured_shared"][2]) == (1, 0)
    assert (r0["measured_two_cards"][2], r1["measured_two_cards"][2]) \
        == (1, 1)
    per_card = hbm.rows_budget(20, 1, mem=CARD, per_row=430, fill=0.8)
    assert r0["measured_shared"][1] == per_card
    assert r0["measured_two_cards"][1] == 2 * per_card


def test_cache_file_survives_concurrent_writers(tmp_path, monkeypatch):
    """Sixteen threads measure sixteen sample counts at once and write the
    cache while a reader parses it: every read parses, and the file ends
    as valid JSON."""
    import torch

    monkeypatch.setattr(hbm, "_CAL_PATH", str(tmp_path / "c" / "m.json"))
    monkeypatch.setattr(hbm, "_cuda", lambda device: True)
    monkeypatch.setattr(hbm, "_source_digest", lambda: "src")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    monkeypatch.setattr(hbm, "measure_per_row_bytes",
                        lambda num_samples, device: 100 + num_samples)
    stop, bad, got = threading.Event(), [], {}

    def read():
        while not stop.is_set():
            try:
                with open(hbm._CAL_PATH) as f:
                    json.load(f)
            except FileNotFoundError:
                pass
            except ValueError as e:
                bad.append(e)

    def write(s):
        for _ in range(20):
            got[s] = hbm.cached_per_row_bytes(s)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        writers = [threading.Thread(target=write, args=(s,))
                   for s in range(1, 17)]
        for w in writers:
            w.start()
        for w in writers:
            w.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not reader.is_alive() and not any(w.is_alive() for w in writers)
    assert not bad, bad[:3]
    assert got == {s: 100 + s for s in range(1, 17)}
    with open(hbm._CAL_PATH) as f:
        assert json.load(f)
    assert os.listdir(tmp_path / "c") == ["m.json"]


def test_clamp_takes_the_batched_path_in_both_packages(tmp_path, monkeypatch):
    """5·10^7 rows of 400 samples on an 80 GB card, with the measured
    bytes a row stubbed, fit no single batch: both packages lower the
    batch to the same budget and go out of core."""
    n, s = 50_000_000, 400
    with open(tmp_path / "kmer_count.log", "w") as f:
        f.write(str(n) + "".join(f"\t{1.0 * n:f}" for _ in range(s)))
    mem = 80 * 10 ** 9
    monkeypatch.setattr(hbm, "device_memory_bytes", lambda device: mem)
    monkeypatch.setattr(hbm, "cached_per_row_bytes",
                        lambda num_samples, device: 14 * num_samples + 64)
    monkeypatch.setattr(jhbm, "device_memory_bytes", lambda: mem)
    monkeypatch.setattr(jhbm, "_cached_per_row_bytes",
                        lambda num_samples: 14 * num_samples + 64)
    monkeypatch.setattr(jpipeline, "_mesh_or_none", lambda: None)
    seen = {}

    def batched(name):
        def run(params, kmap_size, v_kmers, stages, *device):
            seen[name] = (params.batch_thresh, kmap_size, len(v_kmers))
            raise StopIteration
        return run

    def single(*a, **kw):
        raise AssertionError("took the single-batch path")

    monkeypatch.setattr(pipeline, "init_clustering", batched("torch"))
    monkeypatch.setattr(pipeline, "_fused_single_batch", single)
    monkeypatch.setattr(jpipeline, "init_clustering", batched("jax"))
    monkeypatch.setattr(jpipeline, "_fused_single_batch", single)
    lists = []
    for g in "ab":
        lists.append(str(tmp_path / g))
        with open(lists[-1], "w") as f:
            f.write(f"{g}.fastq {g}db\n")
    with pytest.raises(StopIteration):
        cli.main(["-a", lists[0], "-b", lists[1], "--only", "-M", "C",
                  "--work-dir", str(tmp_path), "--device", "cpu"])
    p = JParams(input1=lists[0], input2=lists[1], work_dir=str(tmp_path))
    p.apply_mode("C", only=True)
    with pytest.raises(StopIteration):
        jpipeline.kmer_cluster(p)
    assert seen["torch"] == seen["jax"] == (1 << 23, n, s)


# --- the greedy oracle ----------------------------------------------------------

def _greedy_cases():
    rng = np.random.default_rng(0)
    X, _ = planted(rng)
    sep, _ = planted(np.random.default_rng(5), n_clusters=6, members=40, S=12,
                     noise=0.005)
    pair = np.array([[1.0, 0.0], [0.999, 0.01]], np.float32)
    return {
        "planted": (X, None, dict(min_similarity=0.90, iterations=30, seed=1)),
        "separated": (sep, None, dict(min_similarity=0.92, iterations=25,
                                      seed=2)),
        "weighted": (pair, np.array([3, 1], np.int32),
                     dict(min_similarity=0.9, iterations=5, seed=0)),
        "dissimilar": (np.eye(8, dtype=np.float32), None,
                       dict(min_similarity=0.8, iterations=20, seed=0)),
        "single": (np.ones((1, 4), np.float32), None,
                   dict(min_similarity=0.8, iterations=3, seed=0)),
    }


@pytest.mark.parametrize("case", list(_greedy_cases()))
def test_greedy_matches_jax(case):
    """The greedy cases of test_cluster.py through the port's copy and the
    JAX package's: the same centroids, sizes and members, and the
    assertions of those tests."""
    X, w, kw = _greedy_cases()[case]
    cents, sizes, members = greedy.cluster(X, sizes=w, **kw)
    jc, js, jm = jgreedy.cluster(X, sizes=w, **kw)
    assert np.array_equal(cents, jc) and np.array_equal(sizes, js)
    assert [list(a) for a in members] == [list(b) for b in jm]
    lab = partition_of(members, len(X))
    if case == "planted":
        assert sorted(sizes.tolist()) == [25] * 12
        assert same_partition(lab, planted(np.random.default_rng(0))[1])
    elif case == "separated":
        assert sorted(sizes.tolist()) == [40] * 6
    elif case == "weighted":
        assert len(members) == 1 and sizes[0] == 4
        np.testing.assert_allclose(cents[0], (3 * X[0] + X[1]) / 4,
                                   atol=1e-6)
    elif case == "dissimilar":
        assert sizes.tolist() == [1] * 8
    else:
        assert len(members) == 1 and sizes[0] == 1
