"""Each CUDA kernel against its plain PyTorch version on the same CUDA
inputs (the checks of chip_smoke.py phase 3, at small sizes). They need the
card: on a machine without one they skip."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import lsh, reads, rng

pytestmark = pytest.mark.cuda

S = 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts(n, dev, seed=0, n_prof=None):
    r = np.random.default_rng(seed)
    prof = r.normal(size=(n_prof or max(8, n // 8), S)).astype(np.float32)
    prof /= np.linalg.norm(prof, axis=1, keepdims=True)
    rows = r.integers(0, len(prof), size=n)
    vals = 4.0 + prof[rows] + 0.01 * r.normal(size=(n, S))
    c = np.clip(np.rint(np.expm1(vals)), 0, 65535).astype(np.uint16)
    c[: n // 50] = 0                       # some columns fail the filter
    return torch.from_numpy(np.ascontiguousarray(c.T)).to(dev)


def _state(n, dev, n_prof=None):
    counts = _counts(n, dev, n_prof=n_prof)
    v = torch.full((S,), 3.5, dtype=torch.float32, device=dev)
    values, sizes = kernels.abundance_transform(counts, v)
    return counts, v, values, sizes


@pytest.mark.parametrize("n", [1000, 1 << 16])
def test_transform_and_keys_exact(dev, n):
    counts, v, values, sizes = _state(n, dev)
    pv, ps = kernels.abundance_transform_plain(counts, v)
    assert torch.equal(values, pv) and torch.equal(sizes, ps)
    planes = rng.draw_hyperplanes(0, 0, S).to(dev)
    for h in (1, engine._active_h(sizes), 30):
        k = kernels.lsh_keys(values, sizes, planes, h)
        p = kernels.lsh_keys_plain(values, sizes, planes, h)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    # a column slice of a wider matrix (the engine's shrunk capacity)
    half = n // 2
    k = kernels.lsh_keys(values[:, :half], sizes[:half], planes, 9)
    p = kernels.lsh_keys_plain(values[:, :half].contiguous(), sizes[:half],
                               planes, 9)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


# h at every boundary of the sign-plane instantiations (kernels.LSH_PLANES)
H_EDGES = [1, 4, 5, 8, 9, 12, 13, 16, 17, 20, 21, 24, 25, 28, 29, 30]


def test_lsh_keys_exact_at_every_plane_count(dev):
    # a column slice of a wider matrix, M a multiple of no block's columns
    n, m = 1 << 16, 40003
    _, _, values, sizes = _state(n, dev)
    planes = rng.draw_hyperplanes(0, 0, S).to(dev)
    for h in H_EDGES:
        k = kernels.lsh_keys(values[:, :m], sizes[:m], planes, h)
        p = kernels.lsh_keys_plain(values[:, :m].contiguous(), sizes[:m],
                                   planes, h)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), h


@pytest.mark.parametrize("s", [1, 3, 600, 1565])
def test_lsh_keys_exact_at_many_samples(dev, s):
    """Few samples, and as many as the engine takes (the planes and the
    ring then fill most of a block's shared memory)."""
    r = np.random.default_rng(s)
    wide = torch.from_numpy(r.normal(size=(s, 5007)).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(r.integers(0, 3, 5000, dtype=np.int32)).to(dev)
    planes = rng.draw_hyperplanes(1, 0, s).to(dev)
    for h in (1, 9, 17, 24, 30):
        k = kernels.lsh_keys(wide[:, :5000], sizes, planes, h)
        p = kernels.lsh_keys_plain(wide[:, :5000].contiguous(), sizes, planes,
                                   h)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), h


@pytest.mark.parametrize("s", [1, 3, 20, 100])
def test_permute_exact(dev, s):
    # a column slice of a wider matrix, M a multiple of no gather run
    n, m = 1 << 16, 40003
    r = np.random.default_rng(s)
    wide = torch.from_numpy(r.normal(size=(s, n)).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(r.integers(0, 9, n, dtype=np.int32)).to(dev)
    slots = torch.randperm(n, device=dev).to(torch.int32)
    order = torch.randperm(m, device=dev).to(torch.int32)
    assert m % kernels.permute_plan(s, m)["cols"]
    k = kernels.permute_state(wide[:, :m], sizes[:m], slots[:m], order)
    p = kernels.permute_state_plain(wide[:, :m], sizes[:m], slots[:m], order)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


SORT_TILE = kernels.SORT_THREADS * kernels.SORT_KEYS_A_THREAD
ONE_MAX = kernels.SORT_ONE_MAX


def _sort_same(key, bits):
    """sort_keys exact against its plain version; then twice in a row on
    one scratch whose every byte starts at 0xFF (a status word's tag then
    reads as every pass's inclusive count): the zeroing and the tags hold
    across sorts."""
    p = kernels.sort_keys_plain(key, bits)
    k = kernels.sort_keys(key, bits)
    assert k[1].dtype == torch.int32
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if not key.numel():
        return
    plan = kernels.sort_plan(key.numel(), bits)
    scratch = torch.full((plan["scratch"],), 255, dtype=torch.uint8,
                         device=key.device)
    for _ in range(2):
        k = kernels.sort_keys(key, bits, scratch)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("n", [0, 1, 2, SORT_TILE - 1, SORT_TILE,
                               SORT_TILE + 1, ONE_MAX - 1, ONE_MAX,
                               ONE_MAX + 1, 70001,
                               (1 << 20) + 7, (1 << 24) + 5])
@pytest.mark.parametrize("bits", [1, 7, 11, 12, 25, 31])
def test_sort_keys_exact(dev, n, bits):
    """Heavy ties (300 distinct keys over the bits, a tenth at the top
    key) on either side of a tile's length and of the one-launch route's
    limit, and over 4,097 tiles whose look-backs chain."""
    r = np.random.default_rng(n + bits)
    distinct = r.integers(0, 1 << bits, size=300)
    key = distinct[r.integers(0, 300, size=n)]
    key[r.random(n) < 0.1] = (1 << bits) - 1
    _sort_same(torch.from_numpy(key.astype(np.int32)).to(dev), bits)


def test_sort_keys_exact_on_edge_keys(dev):
    """All keys equal, all BIG_KEY, keys in descending order, every 31-bit
    key distinct, random flags of 1 bit, and a session's combined keys."""
    n = 3 * SORT_TILE + 5
    r = np.random.default_rng(5)
    cases = [(np.full(n, 12345), 31), (np.full(n, lsh.BIG_KEY), 31),
             (np.arange(n)[::-1], 31), (r.integers(0, 2, size=n), 1),
             (r.permutation(1 << 20)[:n] << 11, 31)]
    for key, bits in cases:
        _sort_same(torch.from_numpy(np.ascontiguousarray(
            key, np.int32)).to(dev), bits)
    _, _, values, sizes = _state(1 << 16, dev)
    key, _ = kernels.lsh_keys(values, sizes,
                              rng.draw_hyperplanes(0, 0, S).to(dev), 12)
    _sort_same(key, lsh.KEY_BITS)


def test_sort_keys_refuses_bad_input(dev):
    key = torch.arange(100, dtype=torch.int32, device=dev)
    for bad, bits in ((key.to(torch.int64), 31), (key[::2], 31),
                      (key.view(10, 10), 31), (key, 0), (key, 32)):
        with pytest.raises(ValueError):
            kernels.sort_keys(bad, bits)
    size = kernels.sort_plan(100, 31)["scratch"]
    for bad in (torch.empty(size - 1, dtype=torch.uint8, device=dev),
                torch.empty(size, dtype=torch.int8, device=dev),
                torch.empty(size, dtype=torch.uint8)):
        with pytest.raises(ValueError):
            kernels.sort_keys(key, 31, bad)


def _random_input(dev, n):
    # 16 profiles in 8 buckets: chains thousands long, across tile borders;
    # the state as an iteration holds it, with its order and sorted keys
    _, _, values, sizes = _state(n, dev, n_prof=16)
    key, _ = kernels.lsh_keys(values, sizes,
                              rng.draw_hyperplanes(1, 1, S).to(dev), 3)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    return values, sizes, slots, order, skey


def _random_case(dev, n):
    values, sizes, slots, order, skey = _random_input(dev, n)
    return (*kernels.permute_state(values, sizes, slots, order), skey)


def _runs_case(dev, s, n):
    """A sorted state of n positions made of runs: a run shares a profile
    (cosine near 1) and a bucket, neighbouring runs differ in bucket. The
    runs cross the kernel's sub-ranges (P positions) at every offset; the
    second covers three whole sub-ranges with no head inside; one spans the
    2^15 cut. Elsewhere one column in 40 is dead; the last 500 are dead with
    the largest key, as the sort leaves them."""
    P, stride = kernels.chain_plan(s, n)["P"], 1 << kernels.MAX_CHAIN_LOG
    r = np.random.default_rng(s)
    cycle = [1, 2, 5, 33, P - 1, P + 1, 77, 2 * P]
    lengths = [300, 3 * P + 100]
    while sum(lengths) < stride - 1000:
        lengths.append(cycle[len(lengths) % len(cycle)])
    across = len(lengths)
    lengths.append(stride + 1000 - sum(lengths))
    live = n - 500
    while sum(lengths) < live:
        lengths.append(cycle[len(lengths) % len(cycle)])
    run = np.repeat(np.arange(len(lengths)), lengths)[:live]
    prof = r.normal(size=(len(lengths), s)).astype(np.float32)
    vals = np.zeros((n, s), np.float32)
    vals[:live] = prof[run] + 1e-3 * r.normal(size=(live, s))
    sizes = np.zeros(n, np.int32)
    sizes[:live] = r.integers(1, 9, live)
    dead = (r.random(live) < 1 / 40) & (run != 1) & (run != across)
    sizes[:live][dead] = 0
    key = np.full(n, 0x7FFFFFFF, np.int32)
    fb = kernels.free_bits(3)
    key[:live] = ((run % 2) << fb) | r.integers(0, 1 << fb, live)
    slots = r.permutation(n).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (vals.T, sizes, slots, key))


def _unsorted(sv, ss, sl, seed, sliced=False):
    """An input state and an order that sorts it into (sv, ss, sl):
    column order[i] of the input is column i of the sorted state. With
    ``sliced``, the values are a column slice of a wider matrix, as an
    iteration's ``[:, :na]`` leaves them."""
    n = ss.shape[0]
    g = torch.Generator(device=sv.device).manual_seed(seed)
    order = torch.randperm(n, generator=g, device=sv.device).to(torch.int32)
    wide = torch.full((sv.shape[0], n + 13 * sliced), float("nan"),
                      device=sv.device)
    values = wide[:, :n]
    values[:, order.long()] = sv
    sizes, slots = torch.empty_like(ss), torch.empty_like(sl)
    sizes[order.long()], slots[order.long()] = ss, sl
    return values, sizes, slots, order


def _collapse_same(values, sizes, slots, order, skey, thr, h, smi=None,
                   parent=None, base=0):
    """chain_collapse against permute_state_plain and chain_collapse_plain
    on the sorted state: sizes, slots, merged_into and the parent entries
    exact, the centroids within rounding. Returns the kernel's outputs."""
    pk = None if parent is None else parent.clone()
    pp = None if parent is None else parent.clone()
    k = kernels.chain_collapse(values, sizes, slots, order, skey, thr, h, smi,
                               pk, base)
    sv, ss, sl = kernels.permute_state_plain(values, sizes, slots, order)
    p = kernels.chain_collapse_plain(sv, ss, sl, skey, thr, h,
                                     None if smi is None else smi[order],
                                     pp, base)
    for a, b in ((k[1], p[1]), (k[2], p[2]), (k[3], p[3])):
        assert torch.equal(a, b)
    if parent is not None:
        assert torch.equal(pk, pp)
    # the kernel sums each chain in another order than the log-step scan
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
    return (*k, pk)


CHAIN_CASES = ([("random", S, 1 << 16, 0.95), ("random", S, 70000, 0.5)]
               + [("runs", s, 70001, 0.9) for s in (1, 20, 100, 124, 300)])


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("with_mi,with_parent",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
@pytest.mark.parametrize("kind,s,n,thr", CHAIN_CASES)
def test_chain_collapse_matches_plain(dev, kind, s, n, thr, with_mi,
                                      with_parent, sliced):
    """The state as an iteration holds it (a column slice where
    ``sliced``), its order and sorted keys: the outputs of permute_state
    and the sorted state's collapse."""
    if kind == "random":
        values, sizes, slots, order, skey = _random_input(dev, n)
        if sliced:
            wide = torch.full((s, n + 7), float("nan"), device=dev)
            wide[:, :n] = values
            values = wide[:, :n]
    else:
        sv, ss, sl, skey = _runs_case(dev, s, n)
        values, sizes, slots, order = _unsorted(sv, ss, sl, n + s, sliced)
    g = torch.Generator(device=dev).manual_seed(n)
    smi = (torch.where(torch.rand(n, device=dev, generator=g) < 0.1, 7, -1)
           .to(torch.int32) if with_mi else None)
    parent = (torch.arange(n, dtype=torch.int32, device=dev) if with_parent
              else None)
    k = _collapse_same(values, sizes, slots, order, skey, thr, 3, smi,
                       parent)
    assert int((k[1] > 0).sum()) < int((sizes > 0).sum()) * 3 // 4


def test_chain_collapse_equals_the_parent_pair_at_the_cell_width(dev):
    """At 2^20 x 124 (the benchmark cell's width), on a session's first
    iteration at 0.95 and on a looser one at 0.5: the fused entry against
    the pair it replaces on the card (permute_state, then the plain
    collapse of its sorted copy): sizes, slots, merged_into and the parent
    byte for byte, the centroids within rounding."""
    n, s = 1 << 20, 124
    counts, v = testdata.session_input(n, s, 11, dev)
    values, sizes = kernels.abundance_transform(counts,
                                                torch.from_numpy(v).to(dev))
    del counts
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    parent = slots.clone()
    for it, thr in enumerate((0.95, 0.5)):
        h = engine._active_h(sizes)
        key, _ = kernels.lsh_keys(values, sizes,
                                  rng.draw_hyperplanes(11, it, s).to(dev), h)
        skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
        pp = parent.clone()
        k = kernels.chain_collapse(values, sizes, slots, order, skey, thr, h,
                                   None, parent)
        sv, ss, sl = kernels.permute_state(values, sizes, slots, order)
        p = kernels.chain_collapse_plain(sv, ss, sl, skey, thr, h, None, pp)
        for a, b in ((k[1], p[1]), (k[2], p[2]), (k[3], p[3]),
                     (parent, pp)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
        assert int((k[3] >= 0).sum()) > n // 100
        na = int((k[1] > 0).sum())
        # the next iteration's input: the alive prefix, a column slice
        order = kernels.sort_keys((k[1] == 0).to(torch.int32), 1)[1]
        values, sizes, slots = kernels.permute_state(k[0], k[1], k[2], order)
        values, sizes, slots = values[:, :na], sizes[:na], slots[:na]


def test_chain_collapse_without_merged_into(dev):
    """merged=False: no merged_into (None), the rest as with it."""
    values, sizes, slots, order, skey = _random_input(dev, 70001)
    pk, pb = slots.clone(), slots.clone()
    k = kernels.chain_collapse(values, sizes, slots, order, skey, 0.9, 3,
                               None, pk)
    b = kernels.chain_collapse(values, sizes, slots, order, skey, 0.9, 3,
                               None, pb, merged=False)
    assert b[3] is None and int((k[3] >= 0).sum()) > 0
    assert all(torch.equal(x, y) for x, y in zip(k[:3], b[:3]))
    assert torch.equal(pk, pb)


def test_chain_collapse_refuses_bad_input(dev):
    values, sizes, slots, order, skey = _random_input(dev, 4096)
    for bad in ((values.double(), sizes, slots, order, skey),
                (values, sizes.long(), slots, order, skey),
                (values, sizes, slots, order.long(), skey),
                (values[:, ::2], sizes[:2048], slots[:2048], order[:2048],
                 skey[:2048])):
        with pytest.raises(ValueError):
            kernels.chain_collapse(*bad, 0.9, 3)


# --- a chain session's row state ----------------------------------------------

@pytest.mark.parametrize("s", [1, 3, 18, 20, 124, 300])
def test_to_rows_and_permute_rows_exact(dev, s):
    """K2's transpose alone into the row state (from a column slice of a
    wider matrix, M a multiple of no block's columns) and its gather alone
    back to columns, each exact against its plain twin; the pads 0."""
    n, m = 1 << 16, 40003
    r = np.random.default_rng(s)
    wide = torch.from_numpy(r.normal(size=(s, n)).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(r.integers(0, 9, n, dtype=np.int32)).to(dev)
    slots = torch.randperm(n, device=dev).to(torch.int32)
    order = torch.randperm(m, device=dev).to(torch.int32)
    assert m % kernels.rows_plan(s, m)["cols"]
    rows = kernels.to_rows(wide[:, :m], sizes[:m], slots[:m])
    assert torch.equal(rows, kernels.to_rows_plain(wide[:, :m], sizes[:m],
                                                   slots[:m]))
    assert not rows[:, s + 2:].any()
    k = kernels.permute_rows(rows, s, order)
    p = kernels.permute_rows_plain(rows, s, order)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.parametrize("s", [1, 3, 18, 20, 124, 600, 1400])
def test_lsh_keys_rows_equal_the_columns(dev, s):
    """K1b on the row state gives K1b's keys and projections on the same
    columns bit for bit (and its plain twin's), at every boundary of the
    sign-plane counts, on a prefix of the rows (an iteration's alive
    prefix) of a length that is a multiple of no block's columns."""
    r = np.random.default_rng(s)
    n, m = 5007, 5000
    values = torch.from_numpy(r.normal(size=(s, n)).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(r.integers(0, 3, n, dtype=np.int32)).to(dev)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    rows = kernels.to_rows(values, sizes, slots)
    planes = rng.draw_hyperplanes(1, 0, s).to(dev)
    for h in (H_EDGES if s in (18, 124) else (1, 9, 17, 24, 30)):
        k = kernels.lsh_keys_rows(rows[:m], sizes[:m], planes, h)
        c = kernels.lsh_keys(values[:, :m], sizes[:m], planes, h)
        p = kernels.lsh_keys_rows_plain(rows[:m], sizes[:m], planes, h)
        for a, b in ((k[0], c[0]), (k[1], c[1]), (k[0], p[0]), (k[1], p[1])):
            assert torch.equal(a, b), h


def test_lsh_keys_rows_refuses_bad_input(dev):
    values = torch.zeros((20, 100), device=dev)
    sizes = torch.ones(100, dtype=torch.int32, device=dev)
    rows = kernels.to_rows(values, sizes, sizes)
    planes = rng.draw_hyperplanes(1, 0, 20).to(dev)
    for bad in ((rows[:, :20], sizes, planes), (rows[::2], sizes[:50], planes),
                (rows, sizes[:99], planes), (rows, sizes, planes[:18]),
                (rows.float(), sizes, planes)):
        with pytest.raises(ValueError):
            kernels.lsh_keys_rows(*bad, 9)


def _rows_collapse_same(values, sizes, slots, order, skey, thr, h,
                        parent=None, base=0):
    """chain_collapse_rows on the row state of (values, sizes, slots)
    against its plain twin (the sizes, the size, slot and pad words and
    the parent entries exact, the values within rounding) and against
    chain_collapse on the same columns, whose kernel shares its
    arithmetic: the rows of its outputs bit for bit where the two plans
    cut the positions alike (the same P; a chain's sums are taken in the
    order of the sub-ranges), else the ints bit for bit and the values
    within rounding."""
    rows = kernels.to_rows(values, sizes, slots)
    S = values.shape[0]
    pk, pp, pc = (None if parent is None else parent.clone()
                  for _ in range(3))
    k = kernels.chain_collapse_rows(rows, S, order, skey, thr, h, pk, base)
    p = kernels.chain_collapse_rows_plain(rows, S, order, skey, thr, h, pp,
                                          base)
    c = kernels.chain_collapse(values, sizes, slots, order, skey, thr, h,
                               None, pc, base, merged=False)
    assert torch.equal(k[1], p[1]) and torch.equal(k[0][:, S:], p[0][:, S:])
    torch.testing.assert_close(kernels.rows_values(k[0], S),
                               kernels.rows_values(p[0], S), rtol=1e-5,
                               atol=1e-6)
    c_rows = kernels.to_rows(*c[:3])
    assert torch.equal(k[1], c[1]) and torch.equal(k[0][:, S:], c_rows[:, S:])
    n = sizes.shape[0]
    if kernels.chain_plan(S, n, rows=True)["P"] == kernels.chain_plan(S, n)["P"]:
        assert torch.equal(k[0], c_rows)
    else:
        torch.testing.assert_close(kernels.rows_values(k[0], S), c[0],
                                   rtol=1e-5, atol=1e-6)
    if parent is not None:
        assert torch.equal(pk, pp) and torch.equal(pk, pc)
    return k


@pytest.mark.parametrize("with_parent", [True, False])
@pytest.mark.parametrize("kind,s,n,thr",
                         CHAIN_CASES + [("runs", 18, 70001, 0.9)])
def test_chain_collapse_rows_matches_plain(dev, kind, s, n, thr,
                                           with_parent):
    """K3 on the row state: the cases of test_chain_collapse_matches_plain
    (runs across the kernel's sub-ranges, whole sub-ranges with no head,
    the 2^15 cut) and S = 18, whose rows of 20 words stage with no pad
    piece, the input state a column slice."""
    if kind == "random":
        values, sizes, slots, order, skey = _random_input(dev, n)
    else:
        sv, ss, sl, skey = _runs_case(dev, s, n)
        values, sizes, slots, order = _unsorted(sv, ss, sl, n + s, True)
    parent = (torch.arange(n, dtype=torch.int32, device=dev) if with_parent
              else None)
    k = _rows_collapse_same(values, sizes, slots, order, skey, thr, 3, parent)
    assert int((k[1] > 0).sum()) < int((sizes > 0).sum()) * 3 // 4


@pytest.mark.parametrize("s", [20, 124])
def test_chain_collapse_rows_folds_at_a_base(dev, s):
    """The parent fold at a shard's slot base (slots from base), on the
    row state: the same entries as the plain twin's and the column
    kernel's."""
    n, base = 70001, 3 * 70001
    sv, ss, sl, skey = _runs_case(dev, s, n)
    values, sizes, slots, order = _unsorted(sv, ss, sl, 7)
    parent = torch.arange(n, dtype=torch.int32, device=dev) + base
    _rows_collapse_same(values, sizes, slots + base, order, skey, 0.9, 3,
                        parent, base)


def test_chain_collapse_rows_refuses_bad_input(dev):
    values, sizes, slots, order, skey = _random_input(dev, 4096)
    rows = kernels.to_rows(values, sizes, slots)
    for bad in ((rows, S + 4, order, skey), (rows[:, :S], S, order, skey),
                (rows, S, order.long(), skey), (rows, S, order[:4000], skey),
                (rows[::2], S, order[:2048], skey[:2048])):
        with pytest.raises(ValueError):
            kernels.chain_collapse_rows(*bad, 0.9, 3)


@pytest.mark.parametrize("s,n", [(20, 1 << 16), (124, 1 << 15)])
def test_row_session_equals_the_column_session(dev, s, n):
    """A chain session on the card (its state as rows: one transpose into
    rows, K1b and K3 on rows, the compaction's gather back) gives the [S,
    M] loop's clustering byte for byte where the row and column K3 plans
    cut the positions alike: the row kernels share the column kernels'
    arithmetic. Its K2 launches: the entry and the gather."""
    assert kernels.chain_plan(s, n, rows=True) == kernels.chain_plan(s, n)
    counts, v = testdata.session_input(n, s, 5, dev)
    thr = np.r_[0.95, 0.95 - 0.01 * np.arange(20)].astype(np.float32)
    want, _ = testdata.column_session(counts, v, thr, 9)
    kernels.reset_launches()
    got = engine.cluster_counts(counts, v, thr, seed=9)
    assert engine.LAST_SESSION["state_transposes"] == 2
    assert (kernels.launches["to_rows"], kernels.launches["permute_rows"],
            kernels.launches["permute_state"]) == (1, 1, 0)
    for a, b in zip(got[:2] + (got[2].flat, got[2].offsets),
                    want[:2] + (want[2].flat, want[2].offsets)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 1 < len(got[1]) < n // 2


def test_finalize_exact(dev):
    n = 1 << 15
    _, _, vt, sz = _state(n, dev)
    sl = torch.arange(n, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(6):
        na = int((sz > 0).sum())
        vt, sz, sl, _ = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(2, it, S).to(dev),
            0.95 - 0.02 * it, engine._active_h_of(na))
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    args = (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int(k[1].sum()) == n - n // 50


@pytest.mark.parametrize("case,cap0,seed", [
    ("merges", 1 << 16, 0), ("merges", 70001, 1), ("chain", 4096, 0),
    ("empty", 1000, 0)])
def test_finalize_exact_on_forests(dev, case, cap0, seed):
    """A forest 21 deep with dead roots, roots left out of the state (fc
    below the alive count) and an alive column whose slot is no root; a
    chain 4095 deep; fc = 0."""
    arrays = testdata.finalize_case(cap0, case, s=S, seed=seed)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    depth, _ = testdata.forest_depth(args[3])
    assert depth == (21 if case == "merges" else cap0 - 1)
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


def test_finalize_exact_after_a_session(dev):
    """A session's forest: 21 iterations, thresholds annealed as mode C's
    -I 20 -N 0.8."""
    n = 1 << 16
    _, _, vt, sz = _state(n, dev, n_prof=64)
    sl = torch.arange(n, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(testdata.FOREST_ROUNDS):
        na = int((sz > 0).sum())
        vt, sz, sl, _ = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(4, it, S).to(dev),
            0.95 - 0.0075 * it, engine._active_h_of(na))
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    assert testdata.forest_depth(parent)[0] > 1
    args = (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


def test_finalize_exact_at_the_cell_shape(dev, monkeypatch):
    """finalize where mode C's benchmark cell runs it: a session of 2^24
    rows x 124 samples annealed over 101 iterations to 0.8 (~1.2 M
    clusters). Its four outputs equal the plain version's bit for bit, in
    the pull's types, and the pulled triple holds the same bytes."""
    n, s = 1 << 24, 124
    counts, v = testdata.session_input(n, s, 11, dev)
    step = (0.95 - 0.8) / 100
    thr = np.r_[0.95, 0.95 - step * np.arange(100)].astype(np.float32)
    seen, real = [], kernels.finalize

    def finalize(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    monkeypatch.setattr(kernels, "finalize", finalize)
    cents, sizes, groups = engine.cluster_counts(counts, v, thr, seed=11, n=n)
    del counts
    (args, k), = seen
    fc = args[0].shape[1]
    assert fc > 1 << 19 and args[3].shape == (n,)
    assert [(t.dtype, tuple(t.shape)) for t in k] == [
        (torch.int64, (n,)), (torch.int32, (fc,)), (torch.int64, (fc,)),
        (torch.float32, (fc, s))] and k[3].is_contiguous()
    p = kernels.finalize_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert cents.dtype == np.float32 and cents.flags.c_contiguous
    assert np.array_equal(cents, p[3].cpu().numpy())
    assert np.array_equal(sizes, p[2].cpu().numpy())
    assert np.array_equal(groups.flat, p[0].cpu().numpy()[:len(groups.flat)])
    assert np.array_equal(np.diff(groups.offsets), p[1].cpu().numpy())


def test_wrappers_refuse_bad_input(dev):
    counts, v, values, sizes = _state(1000, dev)
    with pytest.raises(ValueError):
        kernels.lsh_keys(values, sizes.to(torch.int64),
                         rng.draw_hyperplanes(0, 0, S).to(dev), 5)
    with pytest.raises(ValueError):
        kernels.lsh_keys(values, sizes.cpu(),
                         rng.draw_hyperplanes(0, 0, S).to(dev), 5)


@pytest.mark.parametrize("n1,n2", [(10, 10), (5, 7)])
def test_wrs_verdicts_matches_plain(dev, n1, n2):
    values, sizes = testdata.wrs_rows(1 << 16, n1, n2, seed=n1)
    v = torch.from_numpy(values).to(dev)
    sz = torch.from_numpy(sizes).to(dev)
    k = kernels.wrs_verdicts(v, sz, n1, n2, 0.01, 5)
    p = kernels.wrs_verdicts_plain(v, sz, n1, n2, 0.01, 5)
    assert torch.equal(k[0], p[0])
    assert int((k[0] == 1).sum()) > 100 and int((k[0] == 2).sum()) > 100
    # the same float32 operations in the same order: a few ulps at most
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # a strided row view: only the first n1 + n2 columns are read
    wide = torch.cat([v, torch.full_like(v[:, :3], 9.0)], dim=1)
    kw = kernels.wrs_verdicts(wide, sz, n1, n2, 0.01, 5)
    assert all(torch.equal(a, b) for a, b in zip(kw, k))


def _wrs_same(values, sizes, n1, n2):
    """wrs_verdicts on values (any row view) against the plain version on
    the same rows: verdicts exact, tails within rtol 1e-5 / atol 1e-6."""
    got = kernels.wrs_verdicts(values, sizes, n1, n2, 0.01, 5)
    want = kernels.wrs_verdicts_plain(values.contiguous(), sizes, n1, n2,
                                      0.01, 5)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    return got


def _wrs_views(v):
    """The row views K6 takes: rows of S + 3 floats (no row 16-byte
    aligned), rows from the second on (the base moved by a row), and rows
    whose base is one float past a 16-byte boundary."""
    N, S = v.shape
    wide = torch.cat([v, torch.full_like(v[:, :3], 9.0)], dim=1)[:, :S]
    flat = torch.empty(N * S + 1, dtype=v.dtype, device=v.device)
    shifted = flat[1:].view(N, S)
    shifted.copy_(v)
    return {"wide": wide, "from row 1": v[1:], "one float in": shifted}


# n1 + n2 = 2 (df = 0: no row runs the fraction), 3, 20, 100 and 600 (rows
# staged in five chunks); N at a warp's and a block tile's edges
@pytest.mark.parametrize("n1,n2", [(1, 1), (1, 2), (10, 10), (50, 50),
                                   (300, 300)])
@pytest.mark.parametrize("n", [1, 31, 33, 511, 512, 513, 4101])
def test_wrs_verdicts_at_every_shape_and_view(dev, n1, n2, n):
    values, sizes = testdata.wrs_rows(n, n1, n2, seed=n + n1)
    v = torch.from_numpy(values).to(dev)
    sz = torch.from_numpy(sizes).to(dev)
    _wrs_same(v, sz, n1, n2)
    for name, view in _wrs_views(v).items():
        rows = sz[1:] if name == "from row 1" else sz
        _wrs_same(view, rows, n1, n2)


@pytest.mark.parametrize("n1,n2", [(10, 10), (50, 50)])
def test_wrs_verdicts_at_2_20_rows_and_7(dev, n1, n2):
    values, sizes = testdata.wrs_rows((1 << 20) + 7, n1, n2, seed=n1 + 1)
    v = torch.from_numpy(values).to(dev)
    sz = torch.from_numpy(sizes).to(dev)
    k = _wrs_same(v, sz, n1, n2)
    assert int((k[0] == 1).sum()) > 1000 and int((k[0] == 2).sum()) > 1000
    _wrs_same(_wrs_views(v)["wide"], sz, n1, n2)


def test_wrs_verdicts_on_the_fractions_edges(dev):
    """A block tile whose rows all skip the fraction (s = 0), rows that
    converge at its first tabulated step (t = 0: x reflects to 0), and
    block tiles of the rows that take the most steps."""
    from kmerlsh_tpu_torch.ops import ttest

    n1 = n2 = 10
    values, sizes = testdata.wrs_rows(1 << 16, n1, n2, seed=9)
    steps = ttest.fraction_steps(torch.from_numpy(values), n1, n2).numpy()
    slow = values[np.argsort(-steps, kind="stable")[:1024]]
    flat = np.full((1024, n1 + n2), 4.0, np.float32)          # s = 0
    even = np.tile(np.concatenate([np.arange(n1) - 4.5, np.arange(n2) - 4.5])
                   .astype(np.float32), (512, 1))              # t = 0
    rows = np.concatenate([flat, slow, even, values[:4096]])
    got_steps = ttest.fraction_steps(torch.from_numpy(rows), n1, n2).numpy()
    assert (got_steps[:1024] == 0).all() and got_steps[1024] >= 25
    assert (got_steps[2048:2560] == 2).all()
    sz = torch.from_numpy(np.resize(sizes, len(rows))).to(dev)
    k = _wrs_same(torch.from_numpy(rows).to(dev), sz, n1, n2)
    assert torch.equal(k[1][2048:2560].cpu(), torch.full((512,), 0.5))


@pytest.mark.parametrize("k", [15, 31])
def test_score_reads_matches_plain_and_native(dev, k):
    seqs, keys, tie = testdata.read_part(4096, 1 << 14, k=k, seed=k)
    packed = [torch.from_numpy(a).to(dev) for a in reads.pack_part(seqs, k)]
    dkeys = torch.from_numpy(keys.view(np.int64)).to(dev)
    got = kernels.score_reads(*packed, dkeys, k, 0.5)
    want = kernels.score_reads_plain(*packed, dkeys, k, 0.5)
    assert torch.equal(got, want)
    mask = got.cpu().numpy()
    assert np.array_equal(mask, reads.score_part_native(seqs, keys, k, 0.5))
    assert 0 < mask.sum() < len(seqs) and not mask[tie]
    assert np.array_equal(reads.score_part_device(seqs, keys, k, 0.5, dev),
                          mask)


@pytest.mark.parametrize("k", [1, 15, 31])
@pytest.mark.parametrize("kind", testdata.SCORE_CASES)
def test_score_reads_directory_edge_cases(dev, kind, k):
    """The prefix directory and the bucket search on an empty key set, one
    key, one crowded bucket and the smallest and largest prefixes, reads
    shorter than k + 10, the last read ending where the codes end: the
    directory equal to its plain version, the mask to the plain and the
    native scorer's."""
    seqs, keys = testdata.score_case(kind, k)
    codes, ws, nw, lens = reads.pack_part(seqs, k)
    packed = [torch.from_numpy(a).to(dev)
              for a in (codes[:ws[-1] + lens[-1]], ws, nw, lens)]
    dkeys = torch.from_numpy(keys.view(np.int64)).to(dev)
    directory = kernels.key_directory(dkeys)
    assert torch.equal(directory, kernels.key_directory_plain(dkeys))
    for vote in (0.0, 0.5):
        got = kernels.score_reads(*packed, dkeys, k, vote, directory)
        assert torch.equal(got, kernels.score_reads_plain(*packed, dkeys, k,
                                                          vote))
        native = reads.score_part_native(seqs, keys, k, vote)
        assert np.array_equal(got.cpu().numpy(), native)
        if vote == 0.0:
            assert bool(got.any()) == (kind != "empty")


def test_mode_e_wrappers_refuse_bad_input(dev):
    values, sizes = testdata.wrs_rows(100, 10, 10)
    v = torch.from_numpy(values).to(dev)
    with pytest.raises(ValueError):
        kernels.wrs_verdicts(v, torch.from_numpy(sizes).to(dev), 10, 11,
                             0.01, 5)
    with pytest.raises(ValueError):
        kernels.wrs_verdicts(v, torch.from_numpy(sizes).to(dev).long(), 10,
                             10, 0.01, 5)
    codes = torch.zeros(100, dtype=torch.uint8, device=dev)
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.score_reads(codes, i32, i32, i32,
                            torch.zeros(4, dtype=torch.int32, device=dev),
                            15, 0.5)


@pytest.mark.parametrize("n", [20, 70001, 1 << 16, 1 << 22, (1 << 23) + 5])
@pytest.mark.parametrize("n_alive", [0, 100, 4096, 30000])
@pytest.mark.parametrize("rot", [0, 5])
def test_exchange_window_exact(dev, n, n_alive, rot):
    """n_local below, equal to and above e = 4096, and an all-padding
    window; the values a column slice of a wider matrix; c below 32, no
    multiple of 1024, a sharded rank's 2^22 and one past 2^23 (two groups
    of 32 mask words a chunk)."""
    e = 4096
    n_alive = min(n_alive, n)
    r = np.random.default_rng(n_alive + rot)
    sizes = np.zeros(n, np.int32)
    sizes[r.choice(n, size=n_alive, replace=False)] = r.integers(
        1, 9, size=n_alive)
    sz = torch.from_numpy(sizes).to(dev)
    sl = torch.from_numpy(r.permutation(n).astype(np.int32)).to(dev)
    wide = torch.randn((S, n + 7), device=dev)
    k = kernels.exchange_window(wide[:, :n], sz, sl, e, rot)
    p = kernels.exchange_window_plain(wide[:, :n], sz, sl, e, rot)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int((k[0] < n).sum()) == min(n_alive, e)


@pytest.mark.parametrize("n,e", [(1 << 15, 1024), (1 << 22, 4096)])
@pytest.mark.parametrize("rank", [0, 3])
def test_exchange_fold_exact(dev, rank, n, e):
    """The sharded fold as _one_dist_iteration runs it: chain_collapse with
    the rank's parent shard and base, then exchange_fold, each against its
    plain version."""
    _, _, values, sizes = _state(n, dev, n_prof=64)
    key, _ = kernels.lsh_keys(values, sizes,
                              rng.draw_hyperplanes(3, 0, S).to(dev), 4)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    local = kernels.chain_collapse(values, sizes, slots, order, skey, 0.95, 4)
    (*glob, w_slots, pos, lv, ls, lsl, lmi, parent,
     base) = testdata.exchange_inputs(*local, 4, rank, e)
    assert int((glob[2] >= 0).sum()) > 0 and int((lmi >= 0).sum()) > 0
    *k, kp = _collapse_same(values, sizes, slots + base, order, skey, 0.95, 4,
                            None, parent, base)
    assert all(torch.equal(a, b) for a, b in zip(k[1:], (ls, lsl, lmi)))
    pp = kp.clone()   # equal to the plain collapse's parent
    kv, ks = lv.clone(), ls.clone()
    kernels.exchange_fold(*glob, w_slots, pos, kv, ks, kp, base)
    pv, ps = lv.clone(), ls.clone()
    kernels.exchange_fold_plain(*glob, w_slots, pos, pv, ps, pp, base)
    for a, b in ((kv, pv), (ks, ps), (kp, pp)):
        assert torch.equal(a, b)
    assert not torch.equal(kp, parent)


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("base", [1, 70001 * 3])
def test_chain_collapse_folds_at_a_base(dev, base, sliced):
    """A parent shard of the slots [base, base + n): the kernel writes the
    entry of slot s at s - base, as the plain version does."""
    sv, ss, sl, skey = _runs_case(dev, S, 70001)
    values, sizes, slots, order = _unsorted(sv, ss, sl + base, base, sliced)
    n = sl.shape[0]
    shard = torch.arange(base, base + n, dtype=torch.int32, device=dev)
    *_, pk = _collapse_same(values, sizes, slots, order, skey, 0.9, 3, None,
                            shard, base)
    assert int((pk != shard).sum()) > n // 4


def test_exchange_wrappers_refuse_bad_input(dev):
    sz = torch.ones(64, dtype=torch.int32, device=dev)
    vals = torch.zeros((S, 64), device=dev)
    with pytest.raises(ValueError):
        kernels.exchange_window(vals, sz.long(), sz, 16, 0)
    with pytest.raises(ValueError):
        kernels.exchange_window(vals, sz, sz[:10], 16, 0)
    i32 = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.exchange_fold(vals[:, :16], i32, i32, i32, i32[:4], i32[:4],
                              vals, sz.long(), sz, 0)
    with pytest.raises(ValueError):
        kernels.exchange_fold(vals[:, :16], i32, i32, i32, i32[:4], i32[:4],
                              vals, sz[:10], sz, 0)


# --- K10 pairing_rounds ---------------------------------------------------------

def _pair_state(dev, s, n, seg_max=5000, seed=0, dead_tail=100):
    """A sorted state of n positions: segments (runs of one key >> 2) of 1
    to seg_max positions, so that many cross the kernel's tiles, two
    profiles a segment with noise 0.3 (about half the pairs merge at 0.5),
    one column in 7 dead inside the segments and a dead tail of BIG_KEY."""
    r = np.random.default_rng(seed)
    live = max(n - dead_tail, 0)
    lens = r.integers(1, seg_max + 1, 4 * live // seg_max + 4)
    seg = np.repeat(np.arange(len(lens)), lens)[:live]
    key = np.full(n, lsh.BIG_KEY, np.int32)
    key[:live] = (seg << 2) | r.integers(0, 4, live)
    prof = r.standard_normal((2 * len(lens), s)).astype(np.float32)
    pick = 2 * np.append(seg, np.zeros(n - live, int)) + r.integers(0, 2, n)
    vals = prof[pick] + 0.3 * r.standard_normal((n, s)).astype(np.float32)
    sizes = r.integers(1, 6, n).astype(np.int32)
    sizes[r.random(n) < 1 / 7] = 0
    sizes[live:] = 0
    slots = r.permutation(n).astype(np.int32)
    # copies with fresh strides: a [S, 1] view keeps the stride of its
    # size-1 axis, which the wrappers refuse
    return [torch.from_numpy(a.copy()).to(dev)
            for a in (vals.T, sizes, slots, key)]


def _pair_same(sv, ss, sl, skey, shift, thr, rounds, smi=None, parent=None,
               base=0):
    """K10 and its plain version on copies of one state: every output equal
    (both update in place), the parent forest too."""
    def copies():
        return (sv.clone(), ss.clone(), None if smi is None else smi.clone(),
                None if parent is None else parent.clone())
    kv, ks, kmi, kp = copies()
    pv, ps, pmi, pp = copies()
    before = kernels.launches["pairing_rounds"]
    on_card = kernels.card_launches["pairing_rounds"]
    k = kernels.pairing_rounds(kv, ks, sl, skey, shift, thr, rounds, kmi, kp,
                               base)
    p = kernels.pairing_rounds_plain(pv, ps, sl, skey, shift, thr, rounds,
                                     pmi, pp, base)
    torch.cuda.synchronize()
    called = int(rounds > 0 and sv.shape[1] > 0)
    assert kernels.launches["pairing_rounds"] - before == called
    # two kernel launches a call, whatever the rounds
    assert kernels.card_launches["pairing_rounds"] - on_card == 2 * called
    assert k[0] is kv and k[1] is ks
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if parent is not None:
        assert torch.equal(kp, pp)
    return k


PAIR_S = [1, 3, 20, 100, 600]
PAIR_M = [1, 4095, 4097, (1 << 20) + 7]


@pytest.mark.parametrize("m", PAIR_M)
@pytest.mark.parametrize("s", PAIR_S)
def test_pairing_rounds_matches_plain(dev, s, m):
    sv, ss, sl, skey = _pair_state(dev, s, m, seed=s + m,
                                   dead_tail=min(100, m // 2))
    with_extra = (s + m) % 2 == 0
    smi = (torch.where(ss == 0, 5, -1).to(torch.int32) if with_extra
           else None)
    parent = (torch.arange(m, dtype=torch.int32, device=dev) if with_extra
              else None)
    k = _pair_same(sv, ss, sl, skey, 2, 0.5, 4, smi, parent)
    if m > 4097:
        assert int((k[2] >= 0).sum()) > int((ss == 0).sum())   # merges


@pytest.mark.parametrize("rounds", [0, 1, 4, 16])
def test_pairing_rounds_on_one_segment_across_the_array(dev, rounds):
    """2^20 + 7 columns of one profile in one segment: every pair merges,
    so each round about halves the alive count across all the tiles."""
    n = (1 << 20) + 7
    r = np.random.default_rng(rounds)
    vals = np.ones((S, n), np.float32) + 1e-3 * r.standard_normal(
        (S, n)).astype(np.float32)
    sv = torch.from_numpy(vals).to(dev)
    ss = torch.ones(n, dtype=torch.int32, device=dev)
    sl = torch.arange(n, dtype=torch.int32, device=dev)
    skey = torch.full((n,), 3, dtype=torch.int32, device=dev)
    k = _pair_same(sv, ss, sl, skey, 0, 0.9, rounds,
                   parent=torch.arange(n, dtype=torch.int32, device=dev))
    alive = n
    for r in range(rounds):   # ranks 0-1, 2-3, ... pair; then 1-2, 3-4, ...
        alive = -(-alive // 2) if r % 2 == 0 else 1 + -(-(alive - 1) // 2)
    assert int((k[1] > 0).sum()) == alive
    assert int(k[1].sum()) == n


def test_pairing_rounds_all_dead_and_empty(dev):
    sv, ss, sl, skey = _pair_state(dev, S, 4097, seed=3)
    k = _pair_same(sv, torch.zeros_like(ss), sl, skey, 2, 0.1, 4)
    assert not (k[2] >= 0).any()
    _pair_same(sv, ss, sl, torch.full_like(skey, lsh.BIG_KEY), 2, 0.1, 4)
    e = torch.empty(0, dtype=torch.int32, device=dev)
    _pair_same(torch.empty((S, 0), device=dev), e, e, e, 2, 0.5, 4)


@pytest.mark.parametrize("base", [1, 70001 * 3])
def test_pairing_rounds_folds_at_a_base(dev, base):
    n = 70001
    sv, ss, sl, skey = _pair_state(dev, S, n, seed=base)
    sl = sl + base
    parent = torch.arange(base, base + n, dtype=torch.int32, device=dev)
    k = _pair_same(sv, ss, sl, skey, 2, 0.5, 4, None, parent, base)
    assert int((k[2] >= 0).sum()) > 0


def test_pairing_rounds_after_a_sort(dev):
    """On an iteration's sorted state (lsh_keys, sort_keys, permute_state)
    at h = 3, with the combined keys' free bits as the shift."""
    sv, ss, sl, skey = _random_case(dev, 1 << 16)
    for thr in (0.95, 0.3):
        _pair_same(sv, ss, sl, skey, kernels.free_bits(3), thr, 4)


def _segments_state(dev, s, lens, seed=0, noise=0.05):
    """A sorted state whose segments (runs of one key >> 2) have the given
    lengths, one profile a segment with noise (most pairs merge at 0.5),
    one column in 9 dead."""
    r = np.random.default_rng(seed)
    seg = np.repeat(np.arange(len(lens)), lens)
    n = len(seg)
    key = ((seg << 2) | r.integers(0, 4, n)).astype(np.int32)
    prof = r.standard_normal((len(lens), s)).astype(np.float32)
    vals = prof[seg] + noise * r.standard_normal((n, s)).astype(np.float32)
    sizes = r.integers(1, 6, n).astype(np.int32)
    sizes[r.random(n) < 1 / 9] = 0
    slots = r.permutation(n).astype(np.int32)
    return [torch.from_numpy(a.copy()).to(dev)
            for a in (vals.T, sizes, slots, key)]


@pytest.mark.parametrize("extra", ["C - 1", "C", "C + 1", "2C + 1"])
@pytest.mark.parametrize("s", [20, 600])
def test_pairing_rounds_on_segments_that_straddle_windows(dev, s, extra):
    """Segments of C - 1, C, C + 1 and 2C + 1 positions (C the plan's
    window at S) between short ones of 1 to 3, so that their starts fall
    at every offset in a window and they cross window edges; with a parent
    forest at a base."""
    C = kernels.pairing_plan(s, 1)["C"]
    length = {"C - 1": C - 1, "C": C, "C + 1": C + 1, "2C + 1": 2 * C + 1}
    r = np.random.default_rng(C)
    lens = []
    while sum(lens) < 40 * C + 100:
        lens += [length[extra], int(r.integers(1, 4))]
    sv, ss, sl, skey = _segments_state(dev, s, lens, seed=len(lens))
    base = 3
    n = sv.shape[1]
    parent = torch.arange(base, base + n, dtype=torch.int32, device=dev)
    k = _pair_same(sv, ss, sl + base, skey, 2, 0.5, 4, None, parent, base)
    assert int((k[2] >= 0).sum()) > int((ss == 0).sum())   # merges


def test_pairing_rounds_on_long_and_short_segments_mixed(dev):
    """Short segments (1 to 40 positions), segments longer than C (700 to
    20,000) and one dead run of BIG_KEY in between, at S = 20: both
    launches merge."""
    r = np.random.default_rng(5)
    lens = []
    while sum(lens) < 1 << 20:
        lens += list(r.integers(1, 41, 50)) + [int(r.integers(700, 20001))]
    sv, ss, sl, skey = _segments_state(dev, S, lens, noise=0.3)
    mid = slice(300000, 310000)
    skey[mid] = lsh.BIG_KEY
    ss[mid] = 0
    k = _pair_same(sv, ss, sl, skey, 2, 0.5, 4)
    died = (k[2] >= 0).cpu().numpy()
    seg = np.repeat(np.arange(len(lens)), lens)
    long_seg = np.asarray(lens)[seg] > kernels.pairing_plan(S, 1)["C"]
    assert died[long_seg].any() and died[~long_seg].any()


def test_pairing_rounds_refuses_bad_input(dev):
    sv, ss, sl, skey = _pair_state(dev, S, 4097)
    bad = [
        (sv.T, ss, sl, skey),                        # not contiguous
        (sv.double(), ss, sl, skey),
        (sv, ss.long(), sl, skey),
        (sv, ss, sl.cpu(), skey),
        (sv, ss[:-1], sl, skey),
        (sv, ss, sl, skey[:-1]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.pairing_rounds(*args, 2, 0.5, 4)
    with pytest.raises(ValueError):
        kernels.pairing_rounds(sv, ss, sl, skey, 2, 0.5, 4,
                               smi=torch.full((4097,), -1, device=dev))


# --- draw_planes: a session's hyperplanes -------------------------------------

def _bits32(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize("seed,s", [(0, 124), (2100000013, 124),
                                    (2**32 - 1, 124), (0, S)])
def test_draw_planes_exact(dev, seed, s):
    """The kernel's 101 iterations' planes (the benchmark cell's schedule)
    equal the plain twin's bit for bit, and each slice the per-iteration
    draw."""
    before = kernels.launches["draw_planes"]
    got = kernels.draw_planes(seed, 101, s, dev)
    assert kernels.launches["draw_planes"] == before + 1
    assert got.shape == (101, s, 31) and got.is_cuda
    assert torch.equal(_bits32(got), _bits32(rng.draw_planes(seed, 101, s)))
    for it in (0, 50, 100):
        assert torch.equal(_bits32(got[it]),
                           _bits32(rng.draw_hyperplanes(seed, it, s)))


def test_normal_of_bits_exact_on_every_mantissa(dev):
    """The uniform keeps the top 23 of the 32 bits, so the bits → normal
    map takes 2^23 values: the kernel's device function equals the plain
    ops on every one, so no seed can give a plane an ulp off."""
    m = torch.arange(1 << 23, dtype=torch.int64) << 9
    m = m | (torch.arange(1 << 23, dtype=torch.int64) * 37 & 511)
    words = (m - ((m >> 31) << 32)).to(torch.int32)
    got = kernels.normal_of_bits(words.to(dev))
    want = rng.normal_of_bits(m)
    same = _bits32(got) == _bits32(want)
    assert bool(same.all()), f"{int((~same).sum())} mantissas differ"


def test_session_draws_its_planes_once_on_the_card(dev):
    """A cluster_counts session on the card draws its planes in one launch
    and clusters as a session whose hook uploads the per-iteration draws,
    byte for byte."""
    import hashlib

    counts, v = testdata.session_input(1 << 16, S, 3, dev)
    thr = np.r_[0.95, 0.95 - 0.0075 * np.arange(20)].astype(np.float32)
    seed = 2100000013

    def digest(res) -> str:
        h = hashlib.sha256()
        for a in (res[0], res[1], res[2].flat, res[2].offsets):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    kernels.reset_launches()
    got = digest(engine.cluster_counts(counts, v, thr, seed=seed, n=1 << 16))
    assert engine.LAST_SESSION["planes_launches"] == 1
    assert kernels.launches["draw_planes"] == 1
    want = digest(engine.cluster_counts(
        counts, v, thr, seed=seed, n=1 << 16,
        hyperplanes=lambda it: rng.draw_hyperplanes(seed, it, S)))
    assert engine.LAST_SESSION["planes_launches"] == 0
    assert kernels.launches["draw_planes"] == 1
    assert got == want


def test_draw_planes_refuses_bad_input(dev):
    for seed in (-1, 2**32):
        with pytest.raises(ValueError):
            kernels.draw_planes(seed, 3, S, dev)
    with pytest.raises(ValueError):
        kernels.draw_planes(0, -1, S, dev)
    with pytest.raises(ValueError):
        kernels.normal_of_bits(torch.zeros(4, dtype=torch.int64, device=dev))
    assert kernels.draw_planes(0, 0, S, dev).shape == (0, S, 31)
