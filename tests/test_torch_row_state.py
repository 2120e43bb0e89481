"""A chain session's row state on the CPU: the session that carries its
state between iterations as rows (``kernels.to_rows``, ``lsh_keys_rows``,
``chain_collapse_rows``, ``permute_rows``) against the loop that keeps
[S, M] columns, the row plain twins against the column ones, the layout
change counter, and the row staging's arithmetic. The kernels themselves
are held to these twins on the card (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import lsh, rng

WIDTHS = [18, 20, 124]   # the kostic18 cohort, the tests' S, metahit124


def _thresholds(n: int) -> np.ndarray:
    return np.r_[0.95, 0.95 - 0.02 * np.arange(n - 1)].astype(np.float32)


@pytest.mark.parametrize("s", WIDTHS)
def test_row_session_equals_the_column_loop(s):
    """A chain session through cluster_counts (its state as rows) gives the
    members, sizes and centroids of the [S, M] loop through
    engine._one_iteration, bit for bit, and the same forest."""
    counts, v = testdata.session_input(2500, s, 3, "cpu")
    thr = _thresholds(6)
    forests = []

    def keep(vt, sz, sl, parent):   # the session's forest, kept
        forests.append(parent.clone())
        return kernels.finalize(vt, sz, sl, parent)

    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "_finalize_grouped", keep)
    try:
        got = engine.cluster_counts(counts, v, thr, seed=21)
    finally:
        mp.undo()
    assert engine.LAST_SESSION["state_transposes"] == 2
    want, parent = testdata.column_session(counts, v, thr, 21)
    for a, b in zip(got[:2] + (got[2].flat, got[2].offsets),
                    want[:2] + (want[2].flat, want[2].offsets)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert torch.equal(forests[0], parent)
    assert 1 < len(got[1]) < 2000   # chains merged, not everything


def _state(s: int, n: int, seed: int):
    r = np.random.default_rng(seed)
    values = torch.from_numpy(r.normal(size=(s, n)).astype(np.float32))
    sizes = torch.from_numpy(r.integers(0, 4, n).astype(np.int32))
    slots = torch.from_numpy(r.permutation(n).astype(np.int32))
    return values, sizes, slots


@pytest.mark.parametrize("s", WIDTHS)
def test_rows_hold_the_state_in_row_words(s):
    """to_rows: row m holds column m's values, size and slot in
    row_words(S) words, the pads 0; rows_values views the values back and
    permute_rows moves the rows as permute_state moves the columns."""
    values, sizes, slots = _state(s, 777, s)
    rows = kernels.to_rows(values, sizes, slots)
    W = kernels.row_words(s)
    assert rows.shape == (777, W) and rows.dtype == torch.int32
    assert W % 4 == 0 and s + 2 <= W < s + 6
    assert torch.equal(kernels.rows_values(rows, s), values)
    assert torch.equal(rows[:, s], sizes) and torch.equal(rows[:, s + 1], slots)
    assert not rows[:, s + 2:].any()
    order = torch.randperm(777, generator=torch.Generator().manual_seed(s))
    order = order.to(torch.int32)
    got = kernels.permute_rows(rows, s, order)
    want = kernels.permute_state(values, sizes, slots, order)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a column slice of a wider matrix, as an iteration leaves it
    wide = torch.cat([values, values[:, :9]], 1)
    assert torch.equal(kernels.to_rows(wide[:, :777], sizes, slots), rows)


@pytest.mark.parametrize("s", WIDTHS)
def test_row_plain_twins_equal_the_column_ones(s):
    """lsh_keys_rows' keys and projections and chain_collapse_rows'
    outputs (the collapsed rows, their sizes, the parent) equal lsh_keys'
    and chain_collapse's on the same state, at every h boundary and on a
    prefix of the rows (an iteration's alive prefix)."""
    counts, v = testdata.session_input(3000, s, 5, "cpu")
    values, sizes = kernels.abundance_transform(counts, torch.from_numpy(v))
    slots = torch.arange(3000, dtype=torch.int32)
    rows = kernels.to_rows(values, sizes, slots)
    planes = rng.draw_hyperplanes(7, 0, s)
    for h in (1, 4, 5, 11, 24, 30):
        got = kernels.lsh_keys_rows(rows, sizes, planes, h)
        want = kernels.lsh_keys(values, sizes, planes, h)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for m in (3000, 2001):
        h = engine._active_h(sizes[:m])
        key, _ = kernels.lsh_keys(values[:, :m], sizes[:m], planes, h)
        skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
        for base in (0, 5):   # a parent shard that holds slots from base
            based = kernels.to_rows(values, sizes, slots + base)
            pr = slots.clone()
            pc = slots.clone()
            got = kernels.chain_collapse_rows(based[:m], s, order, skey, 0.9,
                                              h, pr, base)
            want = kernels.chain_collapse(values[:, :m], sizes[:m],
                                          slots[:m] + base, order, skey, 0.9,
                                          h, None, pc, base, merged=False)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], kernels.to_rows(*want[:3]))
            assert torch.equal(pr, pc) and not torch.equal(pr, slots)
            assert int((want[1] > 0).sum()) < int((sizes[:m] > 0).sum())


@pytest.mark.parametrize("iterations", [0, 1, 7])
def test_a_chain_session_changes_its_layout_twice(iterations):
    """LAST_SESSION["state_transposes"]: 2 for a chain session of any
    length (into rows, back to columns in its compaction), on the CPU;
    its K2 gathers (permute_launches) stay 1."""
    counts, v = testdata.session_input(1500, 20, 7, "cpu")
    thr = _thresholds(iterations) if iterations else np.zeros(0, np.float32)
    engine.cluster_counts(counts, v, thr, seed=3)
    assert engine.LAST_SESSION["state_transposes"] == 2
    assert engine.LAST_SESSION["permute_launches"] == 1
    engine.cluster(np.ones((40, 5), np.float32), thresholds=thr,
                   device="cpu")
    assert engine.LAST_SESSION["state_transposes"] == 2


@pytest.mark.parametrize("deep_init", [True, False])
def test_a_pairing_session_keeps_columns(deep_init):
    """A pairing session (deep init or not) never changes its layout."""
    counts, v = testdata.session_input(1500, 20, 7, "cpu")
    engine.cluster_counts(counts, v, _thresholds(5), seed=3, merge="pairing",
                          deep_init=deep_init)
    assert engine.LAST_SESSION["state_transposes"] == 0
    assert engine.LAST_SESSION["permute_launches"] == 1 + 5 - deep_init


def test_row_pieces_read_without_bank_conflicts():
    """csrc/lsh_keys.cu's stage on rows: kl_row_piece's places of a
    quarter warp's eight neighbouring rows (a thread a row), for either
    piece, start on eight distinct groups of four banks; the ring's places
    cover each (row, piece) of a stage once."""
    import re

    from kmerlsh_tpu_torch.kernels import build

    src = (build.CSRC / "lsh_keys.cu").read_text()
    pieces = int(re.search(r"#define KL_ROW_PIECES (\d+)", src).group(1))
    ring = int(re.search(r"#define KL_ROW_RING (\d+)", src).group(1))
    assert (pieces, ring) == (kernels.LSH_ROW_PIECES, kernels.LSH_ROW_RING)
    expr = re.search(r"kl_row_piece\(int rb, int k\) \{\s+return (.*?);",
                     src).group(1).replace("KL_ROW_PIECES", str(pieces))

    def place(rb, k):
        return eval(expr, dict(rb=rb, k=k))

    tile = 4 * 128
    assert sorted(place(rb, k) for rb in range(tile)
                  for k in range(pieces)) == list(range(tile * pieces))
    for k in range(pieces):
        for first in range(0, tile, 8):
            banks = {(4 * place(rb, k)) % 32 for rb in range(first, first + 8)}
            assert len(banks) == 8, (k, first)
