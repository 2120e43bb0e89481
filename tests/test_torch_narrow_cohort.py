"""The benchmark's narrow two-group cohort, ``kostic18`` (18 samples in
groups of 9 and 9, one session of 10^8 rows): on the CPU the port's
session against the benchmark's plain reference (``benchmark/reference``,
loaded from the checkout), the count of keys a session sorts, the readers
of the K9 metrics and the cell at a tiny size; on the card the mode-C
kernels at 10^8 x 18, whose profile-major scratch passes 2^31 words,
against their plain twins on windows at the far end of the sort order."""

import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import lsh, rng

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness import gen, runner, spec  # noqa: E402
from reference import compare, modec  # noqa: E402

CELL = "kostic18.cluster"
CONFIG = json.loads((BENCH / "configs" / "kostic18.json").read_text())
S = sum(CONFIG["groups"])
SEEDS = [5, 2**31 + 9, 2**32 - 3]


def _schedule(steps: int = 20) -> np.ndarray:
    return gen.schedule(steps, CONFIG["min_similarity"])


def test_the_configuration_is_the_cohort():
    assert CONFIG["groups"] == [9, 9] and CONFIG["samples"] == S == 18
    assert CONFIG["rows"] == CONFIG["batch_thresh"] == 10**8
    assert CONFIG["reduced"] == {}
    assert {k: CONFIG[k] for k in CONFIG["upstream"]} == CONFIG["upstream"]
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.config == CONFIG
    assert cell.traffic["jobs"] == "cluster"
    assert cell.limits["layout"] == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rows", [1 << 13, 10_000])
def test_session_is_the_reference_s(rows, seed):
    """engine.cluster_counts on the CPU, as the cell's jobs call it, against
    the benchmark's float32 reference session at S = 18: the same
    partition, order and count, the centroids within rounding."""
    counts = gen.make_counts(rows, S, seed, "cpu")
    v = gen.coverage_offsets(counts)
    thr = _schedule()
    cents, sizes, groups = engine.cluster_counts(counts, v, thr, seed=seed,
                                                 n=rows)
    ref = modec.session(counts, v, thr, seed)
    got = compare.numbers(
        compare.as_device(dict(cents=cents, sizes=sizes, flat=groups.flat,
                               offsets=groups.offsets), "cpu"),
        ref, counts, v)
    assert (got["layout"], got["row_gap"], got["count_gap"]) == (0, 0.0, 0.0)
    np.testing.assert_allclose(cents, ref["cents"].numpy(), rtol=1e-5,
                               atol=1e-6)
    limits = spec.find_cell(CELL).limits
    assert got["centroid_gap"] <= limits["centroid_gap"]
    assert 1 < len(sizes) < rows


def test_the_control_fails_at_18_samples():
    """The reference session in bfloat16 breaks at least one of the cell's
    limits at 2^13 rows; the float32 one keeps within all of them."""
    limits = spec.find_cell(CELL).limits
    counts = gen.make_counts(1 << 13, S, 17, "cpu")
    v = gen.coverage_offsets(counts)
    thr = _schedule()
    ref = modec.session(counts, v, thr, 17)
    sound = compare.numbers(ref, ref, counts, v)
    assert all(sound[k] <= limits[k] for k in limits), sound
    low = compare.numbers(modec.session(counts, v, thr, 17, torch.bfloat16),
                          ref, counts, v)
    assert any(low[k] > limits[k] for k in limits), low


# --- the keys a session sorts ---------------------------------------------

@pytest.mark.parametrize("merge,deep_init", [("chain", True),
                                             ("pairing", True),
                                             ("pairing", False)])
def test_sorted_keys_counts_every_sort(monkeypatch, merge, deep_init):
    """LAST_SESSION["sorted_keys"] on the CPU: the sizes of every sort of
    the session, each iteration's capacity, the compaction's, and
    finalize's two (the forest's rows and the clusters)."""
    seen, real = [], kernels.sort_keys_plain

    def spy(key, bits):
        seen.append(key.shape[0])
        return real(key, bits)

    monkeypatch.setattr(kernels, "sort_keys_plain", spy)
    counts, v = testdata.session_input(3000, S, 7, "cpu")
    thr = np.r_[0.95, 0.95 - 0.015 * np.arange(6)].astype(np.float32)
    engine.cluster_counts(counts, v, thr, seed=3, merge=merge,
                          deep_init=deep_init)
    programs = [name for name, _ in engine.LAST_SESSION["programs"]]
    caps = [int(p.split("@")[1]) for p in programs[1:-1]]
    fc = engine.LAST_SESSION["clusters"]
    assert len(seen) == len(caps) + 3
    assert seen[:len(caps)] == caps and seen[-2:] == [3000, fc]
    assert caps[-1] >= seen[len(caps)] >= fc       # the compaction's
    assert engine.LAST_SESSION["sorted_keys"] == sum(seen)


def test_sorts_outside_a_session_are_not_counted():
    counts, v = testdata.session_input(3000, S, 7, "cpu")
    engine.cluster_counts(counts, v, np.float32([0.95, 0.9]), seed=3)
    before = (engine.LAST_SESSION["sorted_keys"], kernels.sorted_keys)
    kernels.sort_keys(torch.arange(100, dtype=torch.int32), 7)
    assert kernels.sorted_keys == before[1] + 100
    assert engine.LAST_SESSION["sorted_keys"] == before[0]


# --- the K9 metrics ---------------------------------------------------------

def _reader(name):
    return spec.metric_reader(name, BENCH)


def _record(programs, kept):
    return dict(programs=[(p, 0.1) for p in programs], S=S, kept=kept)


def test_sort_metrics_on_a_hand_built_trace(monkeypatch):
    """c_sort_ms: K9's card time (kernels named kl_sort...) a job;
    c_sort_roofline: 12 bytes a sorted key over 3.35 TB/s over that time,
    the last job's counter carried to the others by their named sorts."""
    from harness import trace

    jobs = [_record(["transform@4096", "iter[0]@4096", "iter[1]@4000",
                     "iter[2]@1500", "finalize@800"], 4000),
            _record(["transform@4096", "iter[0]@4096", "iter[1]@4000",
                     "iter[2]@1700", "finalize@900"], 4000)]
    device = [(0, 2_000_000, "void kl_sort_onesweep<8>(int const*, int)"),
              (5, 1_000_005, "kl_sort_hist"),
              (10, 7_000_000, "void kl_chain_kernel(float const*)")]
    run = types.SimpleNamespace(
        done=jobs, records=jobs,
        trace=trace.Trace(device=device, host=[], start_ns=0, end_ns=10**9))
    assert _reader("c_sort_ms")(run) == pytest.approx(3.0 / 2)
    named = [4096 + 4000 + 1500 + 1500 + 4096 + 800,
             4096 + 4000 + 1700 + 1700 + 4096 + 900]
    monkeypatch.setitem(engine.LAST_SESSION, "sorted_keys", named[1] - 12)
    keys = (named[1] - 12) * sum(named) / named[1]
    assert _reader("c_sort_roofline")(run) == pytest.approx(
        100 * 12 * keys / 3.35e12 / 3e-3)
    # a program without the counter (the parent's), no trace, no K9
    monkeypatch.delitem(engine.LAST_SESSION, "sorted_keys")
    assert _reader("c_sort_roofline")(run) is None
    monkeypatch.setitem(engine.LAST_SESSION, "sorted_keys", named[1])
    for name in ("c_sort_ms", "c_sort_roofline"):
        assert _reader(name)(types.SimpleNamespace(
            done=jobs, records=jobs, trace=None)) is None
        bare = types.SimpleNamespace(done=jobs, records=jobs, trace=trace.Trace(
            device=device[2:], host=[], start_ns=0, end_ns=10**9))
        assert _reader(name)(bare) is None


def test_named_sorts_bound_the_counter():
    """The sorts a real session's programs name differ from its counter
    only in the compaction's size, which lies between the clusters and
    the last capacity named."""
    named = _reader("c_sort_roofline").__globals__["named_keys"]
    counts = gen.make_counts(1 << 13, S, 9, "cpu")
    v = gen.coverage_offsets(counts)
    engine.cluster_counts(counts, v, _schedule(), seed=9, n=1 << 13)
    s = engine.LAST_SESSION
    kept = int(compare.kept_rows(counts).sum())
    rec = dict(programs=list(s["programs"]), S=S, kept=kept)
    last_cap = int(s["programs"][-2][0].split("@")[1])
    assert 0 <= named(rec) - s["sorted_keys"] <= last_cap - s["clusters"]


def test_the_cell_runs_at_a_tiny_size(tmp_path):
    """The cell through the harness on the CPU at 4,096 rows and 20
    iterations, traced: correct, and every metric the CPU can read."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = tmp_path / "benchmark" / "configs" / "kostic18.json"
    path.write_text(json.dumps(dict(CONFIG, rows=4096, cluster_iteration=20)))
    cell = spec.find_cell(CELL, tmp_path / "benchmark")
    for trace in (False, True):
        res = runner.run_cell(cell, 2**31 + 11, 0.3, trace, "cpu", 0.0)
        assert res["correct"], res["checks"]
        assert res["failed"] == 0 and res["attempted"] >= 1
    # no card: no kernel of the program in the trace, the device idle
    assert res["metrics"]["c_device_idle_pct"]["value"] == 100.0
    assert "c_sort_ms" not in res["metrics"]
    assert {m["name"] for m in cell.per_layer} >= {"c_sort_ms",
                                                   "c_sort_roofline"}
    assert not {m["name"] for m in cell.per_layer
                if m["source"] == "program_span"}


# --- on the card: 10^8 x 18 -------------------------------------------------

CARD_M = 10**8
WINDOW = 1 << 18   # positions of a compared window: a multiple of 2^15


@pytest.fixture(scope="module")
def state():
    """A session's first iteration at 10^8 x 18 on the card (make_data's
    distribution, seed 11): the transformed state, h, the sorted keys and
    the order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    counts, v = testdata.session_input(CARD_M, S, 11, dev)
    vt = torch.from_numpy(v).to(dev)
    values, sizes = kernels.abundance_transform(counts, vt)
    far = slice(CARD_M - WINDOW, CARD_M)
    pv, ps = kernels.abundance_transform_plain(counts[:, far], vt)
    assert torch.equal(values[:, far], pv) and torch.equal(sizes[far], ps)
    del counts, pv, ps
    h = engine._active_h_of(int((sizes > 0).sum()))
    planes = rng.draw_hyperplanes(11, 0, S).to(dev)
    key, _ = kernels.lsh_keys(values, sizes, planes, h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    pkey, porder = kernels.sort_keys_plain(key, lsh.KEY_BITS)
    assert torch.equal(skey, pkey) and torch.equal(order, porder)
    del key, pkey, porder
    slots = torch.arange(CARD_M, dtype=torch.int32, device=dev)
    yield types.SimpleNamespace(values=values, sizes=sizes, slots=slots,
                                skey=skey, order=order, h=h)
    torch.cuda.empty_cache()


def _windows():
    """The compared windows of positions: from the last multiple of 2^15
    at least WINDOW before the end to the end, and WINDOW from one in the
    middle; no chain enters a window at its start (a multiple of 2^15) or
    leaves it at its end (the end of the order, or a multiple of 2^15)."""
    far = (CARD_M - WINDOW) >> 15 << 15
    mid = (CARD_M // 2) >> 15 << 15
    return [slice(far, CARD_M), slice(mid, mid + WINDOW)]


@pytest.mark.cuda
def test_permute_past_2_31_scratch_words(state):
    """K2 (transpose into the [M, 24] scratch, then the gather) equals its
    plain twin where the source rows lie past word 2^31."""
    out = kernels.permute_state(state.values, state.sizes, state.slots,
                                state.order)
    for w in _windows():
        o = state.order[w]
        assert int(o.max()) * 24 >= 2**31
        p = kernels.permute_state_plain(state.values, state.sizes,
                                        state.slots, o)
        for a, b in zip((out[0][:, w], out[1][w], out[2][w]), p):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_chain_collapse_past_2_31_scratch_words(state):
    """K3 + K4 at 10^8 x 18 (P = 256), the session's first threshold:
    sizes, slots, merged_into and the parent entries of each window
    exact against the plain collapse of that window's sorted state, the
    centroids within rounding."""
    dev = state.values.device
    thr = float(_schedule()[0])
    parent = torch.arange(CARD_M, dtype=torch.int32, device=dev)
    k = kernels.chain_collapse(state.values, state.sizes, state.slots,
                               state.order, state.skey, thr, state.h, None,
                               parent)
    for w in _windows():
        pp = torch.arange(CARD_M, dtype=torch.int32, device=dev)
        sv, ss, sl = kernels.permute_state_plain(
            state.values, state.sizes, state.slots, state.order[w])
        p = kernels.chain_collapse_plain(sv, ss, sl, state.skey[w], thr,
                                         state.h, None, pp)
        for a, b in ((k[1][w], p[1]), (k[2][w], p[2]), (k[3][w], p[3])):
            assert torch.equal(a, b)
        dying = sl[p[3] >= 0].long()
        assert len(dying) > 0
        assert torch.equal(parent[sl.long()], pp[sl.long()])
        torch.testing.assert_close(k[0][:, w], p[0], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_row_state_past_2_32_bytes(state):
    """A chain session's row state at 10^8 x 18: rows of 20 words, 8 GB,
    whose windows' rows lie past byte 2^32. K1b on rows gives K1b's keys
    and projections on the columns bit for bit, all of them; K3 on rows
    gives K3's sizes and slots on the columns bit for bit, the values
    within rounding (the kernels share their arithmetic, but on rows of 20
    words a block takes 512 positions, on the scratch's 24 256: a chain's
    sums come in another order), and is held to its plain twin on the
    windows
    (sizes, the size, slot and pad words and the parent entries exact,
    the values within rounding); K2's gather back to columns equals its
    plain twin there."""
    dev = state.values.device
    rows = kernels.to_rows(state.values, state.sizes, state.slots)
    W = kernels.row_words(S)
    assert rows.shape == (CARD_M, W) == (CARD_M, 20)
    planes = rng.draw_hyperplanes(11, 0, S).to(dev)
    k = kernels.lsh_keys_rows(rows, state.sizes, planes, state.h)
    c = kernels.lsh_keys(state.values, state.sizes, planes, state.h)
    assert torch.equal(k[0], c[0]) and torch.equal(k[1], c[1])
    del k, c
    thr = float(_schedule()[0])
    parent = torch.arange(CARD_M, dtype=torch.int32, device=dev)
    out, osizes = kernels.chain_collapse_rows(rows, S, state.order,
                                              state.skey, thr, state.h,
                                              parent)
    col = kernels.chain_collapse(state.values, state.sizes, state.slots,
                                 state.order, state.skey, thr, state.h, None,
                                 None, merged=False)
    assert torch.equal(osizes, col[1]) and torch.equal(out[:, S + 1], col[2])
    for a, b in zip(kernels.rows_values(out, S), col[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    del col
    for w in _windows():
        o = state.order[w]
        assert int(o.max()) * 4 * W >= 2**32
        pp = torch.arange(CARD_M, dtype=torch.int32, device=dev)
        p = kernels.chain_collapse_rows_plain(rows, S, o, state.skey[w], thr,
                                              state.h, pp)
        assert torch.equal(osizes[w], p[1])
        assert torch.equal(out[w][:, S:], p[0][:, S:])
        torch.testing.assert_close(kernels.rows_values(out[w], S),
                                   kernels.rows_values(p[0], S), rtol=1e-5,
                                   atol=1e-6)
        sl = rows[o.long(), S + 1].long()
        assert bool((p[0][:, S] == 0).any())   # a chain merged
        assert torch.equal(parent[sl], pp[sl])
        g = kernels.permute_rows(rows, S, o)
        for a, b in zip(g, kernels.permute_rows_plain(rows, S, o)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_finalize_past_2_31_scratch_words(state):
    """K5 on 10^8 alive columns of its own (the identity forest: every row
    its cluster, so finalize's column scratch is 10^8 x 24 words),
    exact against its plain version."""
    args = (state.values, state.sizes, state.slots, state.slots.clone())
    assert int((state.sizes > 0).sum()) == CARD_M
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a, b)
    for a, b in zip(k[3].split(1 << 24), p[3].split(1 << 24)):
        assert torch.equal(a, b)
