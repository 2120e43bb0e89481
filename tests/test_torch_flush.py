"""The out-of-core flush thread: a single-card batch pass leaves its pull
and tmp save to a thread that runs beside the next batch's read and
session (pipeline.init_clustering, engine.cluster_counts(defer_pull=True)).

On the CPU: the deferred and the sequential init_clustering write the same
round files, byte for byte; every batch but the last saves off the main
thread; greedy never defers (the sharded path is checked in
test_torch_out_of_core.py's two-rank fixture); an error of a flush is
raised by init_clustering and no later batch is appended; a deferred
session's finish() returns the immediate path's triple; ``_defers`` is the
JAX package's condition; Stages loses no update under threads; either
pull returns views of what it copied, in the triple's types. On the card
(marker ``cuda``): finish() on a worker thread while the main thread runs
another full session; a second same-shape pull allocates no pinned
memory.

The module imports no JAX at its top, so that the card tests run where
only torch is installed:

    python -m pytest tests/test_torch_flush.py --noconftest -q -m cuda
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import pipeline
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.cluster.groups import Groups
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.io import clusterio
from kmerlsh_tpu_torch.utils import hbm
from kmerlsh_tpu_torch.utils.timing import Stages

BATCH = 256


def _separated(work):
    """test_torch_out_of_core.py's well-separated counts: (rows, S,
    coverage offsets)."""
    from test_torch_out_of_core import N_SEP, S_SEP, _separated_counts

    return N_SEP, S_SEP, _separated_counts(work)


def _run(mp, root, name, v, n, engine_name="tpu", fail=None):
    """init_clustering at batch 256 and merge windows of 128 into
    ``root/name``, recording every clusterio write (file name, thread)
    and every round file's bytes before its removal. ``fail`` = ("save",
    k) raises in the k-th batch's save_binary, ("pull", k) in the k-th
    deferred pull."""
    rec = dict(writes=[], files={}, error=None)
    real_result, real_binary = clusterio.save_result, clusterio.save_binary
    real_remove, real_pull = os.remove, engine._pull

    def save_result(ids_list, path, *a, **kw):
        rec["writes"].append(("result", os.path.basename(path),
                              threading.get_ident()))
        return real_result(ids_list, path, *a, **kw)

    def save_binary(cents, ids_list, path, *a, **kw):
        rec["writes"].append(("binary", os.path.basename(path),
                              threading.get_ident()))
        if fail and fail[0] == "save" and os.path.basename(path) == "0.bin" \
                and sum(w[:2] == ("binary", "0.bin")
                        for w in rec["writes"]) == fail[1]:
            raise OSError(f"no space left for batch {fail[1]}")
        return real_binary(cents, ids_list, path, *a, **kw)

    pulls = []

    def pull(*a, **kw):
        if threading.current_thread() is not threading.main_thread():
            pulls.append(1)
            if fail and fail[0] == "pull" and len(pulls) == fail[1]:
                raise RuntimeError(f"copy failed for batch {fail[1]}")
        return real_pull(*a, **kw)

    def remove(path):
        rec["files"][os.path.basename(path)] = open(path, "rb").read()
        real_remove(path)

    mp.setattr(clusterio, "save_result", save_result)
    mp.setattr(clusterio, "save_binary", save_binary)
    mp.setattr(engine, "_pull", pull)
    mp.setattr(pipeline.os, "remove", remove)
    p = HyperParams(tmp_dir=str(root / f"tmp_{name}"),
                    work_dir=str(root / "work"), batch_thresh=BATCH,
                    min_similarity=0.85, seed=5, engine=engine_name)
    st = Stages()
    try:
        values, ids = pipeline.init_clustering(p, n, v, st, "cpu")
    except (OSError, RuntimeError) as e:
        rec["error"] = e
        return rec
    finally:
        for attr, fn in (("save_result", real_result),
                         ("save_binary", real_binary)):
            mp.setattr(clusterio, attr, fn)
        mp.setattr(engine, "_pull", real_pull)
        mp.setattr(pipeline.os, "remove", real_remove)
    for f in os.listdir(p.tmp_dir):
        rec["files"][f] = open(os.path.join(p.tmp_dir, f), "rb").read()
    rec.update(values=values, ids=ids, stages=st)
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The deferred (as shipped) and the sequential (``_defers`` patched
    to False) init_clustering on the separated counts."""
    root = tmp_path_factory.mktemp("flush")
    n, _, v = _separated(root / "work")
    out = dict(n=n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "MERGE_WINDOW_MIN", 64)
        out["deferred"] = _run(mp, root, "deferred", v, n)
        mp.setattr(pipeline, "_defers", lambda bs, S, device: False)
        out["sequential"] = _run(mp, root, "sequential", v, n)
    return out


def test_deferred_writes_the_sequential_rounds(runs):
    """The same round files byte for byte (every round's, read before
    its removal, and the last), the same tmp_rounds and tmp_bytes, the
    same final values and ids."""
    d, s = runs["deferred"], runs["sequential"]
    assert len(d["stages"].metrics["tmp_rounds"]) >= 2
    assert sorted(d["files"]) == sorted(s["files"])
    assert "0.bin" in d["files"] and "0.bin.clust" in d["files"]
    for name in d["files"]:
        assert d["files"][name] == s["files"][name], name
    for key in ("tmp_rounds", "tmp_bytes"):
        assert d["stages"].metrics[key] == s["stages"].metrics[key]
    assert [w[:2] for w in d["writes"]] == [w[:2] for w in s["writes"]]
    assert np.array_equal(d["values"], s["values"])
    assert np.array_equal(d["ids"].flat, s["ids"].flat)
    assert np.array_equal(d["ids"].offsets, s["ids"].offsets)
    for st in (d["stages"], s["stages"]):
        assert st.times["device_seconds"] > 0 and st.metrics["pull_bytes"] > 0


def test_batches_save_on_the_flush_thread(runs):
    """Every batch's save but the last runs on another thread than the
    main one; the last batch's, the merge rounds' and every sequential
    save run on the main thread."""
    main = threading.main_thread().ident
    batches = -(-runs["n"] // BATCH)
    d = [w for w in runs["deferred"]["writes"] if w[1].startswith("0.bin")]
    assert len(d) == 2 * batches
    for kind, name, ident in d[:-2]:
        assert ident != main, (kind, name)
    assert {w[2] for w in d[-2:]} == {main}
    rounds = [w for w in runs["deferred"]["writes"]
              if not w[1].startswith("0.bin")]
    assert rounds and {w[2] for w in rounds} == {main}
    assert {w[2] for w in runs["sequential"]["writes"]} == {main}


def test_greedy_never_defers(tmp_path, monkeypatch):
    """--engine greedy saves every batch on the main thread, even where
    ``_defers`` would say yes."""
    n, _, v = _separated(tmp_path / "work")
    monkeypatch.setattr(pipeline, "MERGE_WINDOW_MIN", 64)
    monkeypatch.setattr(pipeline, "_defers", lambda bs, S, device: True)
    rec = _run(monkeypatch, tmp_path, "greedy", v, n, engine_name="greedy")
    batch_saves = [w for w in rec["writes"] if w[1].startswith("0.bin")]
    assert len(batch_saves) == 2 * -(-n // BATCH)
    assert {w[2] for w in rec["writes"]} == {threading.main_thread().ident}


@pytest.mark.parametrize("fail, appended", [(("save", 2), 2),
                                            (("pull", 2), 1)])
def test_flush_error_is_raised(tmp_path, monkeypatch, fail, appended):
    """An error in batch 2's save, or in batch 2's deferred pull, raised
    on the flush thread, is raised by init_clustering once that thread is
    joined: no later batch is appended, and no flush thread is left."""
    n, _, v = _separated(tmp_path / "work")
    monkeypatch.setattr(pipeline, "MERGE_WINDOW_MIN", 64)
    before = threading.active_count()
    rec = _run(monkeypatch, tmp_path, "fail", v, n, fail=fail)
    assert rec["error"] is not None and f"batch {fail[1]}" in str(rec["error"])
    assert threading.active_count() == before
    results = [w for w in rec["writes"] if w[:2] == ("result", "0.bin.clust")]
    assert len(results) == appended
    assert {w[1] for w in rec["writes"]} <= {"0.bin", "0.bin.clust"}


def _counts(n, s, seed):
    r = np.random.default_rng(seed)
    prof = r.normal(size=(max(8, n // 8), s)).astype(np.float32)
    prof /= np.linalg.norm(prof, axis=1, keepdims=True)
    rows = r.integers(0, len(prof), size=n)
    vals = 4.0 + prof[rows] + 0.01 * r.normal(size=(n, s))
    c = np.clip(np.rint(np.expm1(vals)), 0, 65535).astype(np.uint16)
    c[: n // 50] = 0                       # some columns fail the filter
    return np.ascontiguousarray(c.T)


def _same(a, b) -> None:
    """Two (centroids, sizes, members) triples, byte for byte."""
    assert a[0].dtype == b[0].dtype and a[0].tobytes() == b[0].tobytes()
    assert a[0].shape == b[0].shape
    assert np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype
    assert np.array_equal(a[2].flat, b[2].flat)
    assert np.array_equal(a[2].offsets, b[2].offsets)


THR = (0.95 - 0.0075 * np.arange(8)).astype(np.float32)


def test_deferred_finish_matches_immediate():
    """finish() returns the immediate path's triple byte for byte, adds
    its pull to its stats (the immediate session's split), and leaves
    LAST_SESSION to the session run after it; an empty batch returns a
    finish too."""
    S = 12
    counts, other = _counts(3000, S, 5), _counts(2000, S, 6)
    v = np.full(S, 3.5, np.float32)
    want = engine.cluster_counts(counts, v, THR, seed=1, device="cpu")
    session = dict(engine.LAST_SESSION)
    finish, stats = engine.cluster_counts(counts, v, THR, seed=1,
                                          device="cpu", defer_pull=True)
    assert stats["pull_seconds"] == 0 and stats["pull_bytes"] == 0
    assert stats["clusters"] == session["clusters"]
    assert len(stats["programs"]) == len(session["programs"])
    engine.cluster_counts(other, v, THR, seed=2, device="cpu")
    after = dict(engine.LAST_SESSION, programs=list(
        engine.LAST_SESSION["programs"]))
    _same(finish(), want)
    assert engine.LAST_SESSION == after
    assert stats["pull_bytes"] == session["pull_bytes"] > 0
    assert stats["pull_seconds"] > 0

    finish, stats = engine.cluster_counts(np.zeros((S, 0), np.uint16), v,
                                          THR, device="cpu", defer_pull=True)
    _same(finish(), engine.cluster_counts(np.zeros((S, 0), np.uint16), v,
                                          THR, device="cpu"))
    assert stats["pull_bytes"] == 0


def _pulled_triple(monkeypatch, counts, v, defer: bool, device="cpu"):
    """One session's pulled triple, its pull's stats, and the tensors the
    pull hands out views of (flat, lens, sizes, centroids): on the CPU the
    finalize outputs themselves, on a card their pinned copies."""
    pulled = []
    real_pull, real_pinned = engine._pull, engine._to_pinned

    def pull(*a, **kw):
        pulled[:] = a[:4]
        return real_pull(*a, **kw)

    def to_pinned(stream, *tensors):
        pulled[:] = real_pinned(stream, *tensors)
        return pulled
    monkeypatch.setattr(engine, "_pull", pull)
    monkeypatch.setattr(engine, "_to_pinned", to_pinned)
    if defer:
        finish, stats = engine.cluster_counts(counts, v, THR, seed=1,
                                              device=device, defer_pull=True)
        triple = finish()
    else:
        triple = engine.cluster_counts(counts, v, THR, seed=1, device=device)
        stats = engine.LAST_SESSION
    return triple, stats, pulled


@pytest.mark.parametrize("case", ["immediate", "deferred", "empty"])
def test_pull_returns_views_of_what_it_copied(monkeypatch, case):
    """Either pull, and one of a batch whose every column the filter drops,
    returns centroids float32 C-contiguous [K, S], int64 sizes and int64
    Groups, each a view of a pulled tensor: no array is copied after the
    pull. It allocates no pinned memory on the CPU."""
    S = 12
    counts = _counts(3000, S, 5) if case != "empty" else np.zeros(
        (S, 500), np.uint16)
    triple, stats, pulled = _pulled_triple(
        monkeypatch, counts, np.full(S, 3.5, np.float32), case == "deferred")
    cents, sizes, groups = triple
    assert cents.dtype == np.float32 and cents.flags.c_contiguous
    assert cents.shape == (len(sizes), S) == (len(groups), S)
    assert sizes.dtype == groups.flat.dtype == groups.offsets.dtype \
        == np.int64
    assert (len(sizes) == 0) == (case == "empty")
    assert groups.offsets[-1] == len(groups.flat) == sizes.sum()
    assert len(pulled) == 4
    flat, _, csizes, cents_t = (t.numpy() for t in pulled)
    for got, src in ((cents, cents_t), (sizes, csizes), (groups.flat, flat)):
        assert got.size == 0 or np.shares_memory(got, src)
    assert stats["pull_host_allocs"] == 0


@pytest.mark.parametrize("mem", [None, 80 * 10 ** 9])
@pytest.mark.parametrize("S", [1, 6, 20, 400])
def test_defers_is_the_jax_condition(monkeypatch, mem, S):
    """``_defers(bs, S, device)`` is the JAX package's ``bs <=
    rows_budget(S, 1) // 2`` (kmerlsh_tpu/pipeline.py:246) on both sides
    of its boundary, at the CPU's default 16 GiB and an 80 GB card's
    memory (at S = 20 there: 2^26 rows)."""
    from kmerlsh_tpu.utils import hbm as jhbm

    if mem is not None:
        monkeypatch.setattr(hbm, "device_memory_bytes",
                            lambda device="cuda", default=0: mem)
        monkeypatch.setattr(jhbm, "device_memory_bytes",
                            lambda default=0: mem)
    edge = jhbm.rows_budget(S, 1) // 2
    if mem is not None and S == 20:
        assert edge == 1 << 26
    for bs in (1, BATCH, edge - 1, edge, edge + 1, 2 * edge):
        assert pipeline._defers(bs, S, "cpu") == (bs <= edge), bs


def test_stages_lose_no_update():
    """Eight threads add to one stage and one metric 10^4 times each, with
    the interpreter switching threads every microsecond: nothing is
    lost."""
    st = Stages()
    reps, n = 10_000, 8

    def work():
        for _ in range(reps):
            st.add("save_tmp", 1.0)
            st.tally("pull_bytes", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert st.times["save_tmp"] == float(n * reps)
    assert st.metrics["pull_bytes"] == 3 * n * reps


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_second_pull_reuses_the_pinned_blocks(monkeypatch, card):
    """At 2^18 x 20: a second same-shape session, run after the first's
    result was dropped, allocates no pinned host block, its triple is
    views of its pinned copies, and it equals the first byte for byte."""
    S = 20
    counts = _counts(1 << 18, S, 7)
    v = np.full(S, 3.5, np.float32)
    first, _, pulled = _pulled_triple(monkeypatch, counts, v, False, card)
    want = (first[0].copy(), first[1].copy(),
            Groups(first[2].flat.copy(), first[2].offsets.copy()))
    del first
    pulled.clear()   # the patched _to_pinned, which monkeypatch keeps, holds it
    got, stats, pulled = _pulled_triple(monkeypatch, counts, v, False, card)
    assert stats["pull_host_allocs"] == 0
    assert all(t.is_pinned() for t in pulled)
    assert np.shares_memory(got[0], pulled[3].numpy())
    assert np.shares_memory(got[2].flat, pulled[0].numpy())
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_finish_beside_a_session_on_the_card(card, device):
    """At 2^20 x 20: finish() of one session on a worker thread while the
    main thread runs another full session (21 iterations) on the same
    card; both results equal their sequential runs byte for byte."""
    S, n = 20, 1 << 20
    thr = np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)]).astype(
        np.float32)
    a, b = _counts(n, S, 1), _counts(n, S, 2)
    v = np.full(S, 3.5, np.float32)
    want_a = engine.cluster_counts(a, v, thr[:1], seed=3, device=device)
    want_b = engine.cluster_counts(b, v, thr, seed=4, device=device)
    for _ in range(2):
        finish, stats = engine.cluster_counts(a, v, thr[:1], seed=3,
                                              device=device, defer_pull=True)
        got = {}

        def flush():
            got["a"] = finish()

        th = threading.Thread(target=flush)
        th.start()
        got["b"] = engine.cluster_counts(b, v, thr, seed=4, device=device)
        th.join(timeout=300)
        assert not th.is_alive()
        _same(got["a"], want_a)
        _same(got["b"], want_b)
        assert stats["pull_bytes"] > 0
