"""K9 ``sort_keys`` without the card: the wrapper (on the CPU, its plain
version) against JAX's stable sort on the three key families the port
sorts, the launch arithmetic of ``kernels.sort_plan``, the kernel's passes
transcribed into numpy, that no library sort is left on the port's paths,
and that a session's sorts go through the wrapper."""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerlsh_tpu.cluster import engine as jengine
from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.kernels import build
from kmerlsh_tpu_torch.ops import lsh

SIZES = [0, 1, 2, 4095, 4097, 70001]


def combined_keys(n: int, seed: int):
    """JAX's combined sort keys (engine._combined_sort_key) at h = 5 over
    32 buckets and 4 projection values, a third of the slots dead."""
    r = np.random.default_rng(seed)
    sizes = r.integers(0, 3, size=n).astype(np.int32)
    keys = r.integers(0, 32, size=n).astype(np.int32)
    keys[sizes == 0] = lsh.BIG_KEY
    proj = r.integers(0, 4, size=n).astype(np.float32)
    if n == 0:
        return np.zeros(0, np.int32), lsh.KEY_BITS
    key = jengine._combined_sort_key(jnp.asarray(keys), jnp.asarray(proj),
                                     jnp.asarray(sizes), 5)
    return np.array(key), lsh.KEY_BITS


def root_keys(n: int, seed: int):
    """finalize's row keys: the row's root among 40 alive roots, or the
    sentinel cap0 (= n rows) for a fifth of the rows."""
    r = np.random.default_rng(seed)
    roots = r.integers(0, max(n, 1), size=40)
    key = roots[r.integers(0, 40, size=n)]
    key[r.random(n) < 0.2] = n
    return key.astype(np.int32), max(n, 1).bit_length()


def flags(n: int, seed: int):
    """compact_sort's keys: 1 for a dead column."""
    r = np.random.default_rng(seed)
    return r.integers(0, 2, size=n).astype(np.int32), 1


FAMILIES = {"combined": combined_keys, "roots": root_keys, "flags": flags}


def jax_sort(key: np.ndarray):
    skey, order = jax.lax.sort(
        (jnp.asarray(key), jnp.arange(len(key), dtype=jnp.int32)),
        num_keys=1, is_stable=True)
    return np.asarray(skey), np.asarray(order)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", SIZES)
def test_sort_keys_matches_jax(family, n):
    key, bits = FAMILIES[family](n, seed=n)
    want = jax_sort(key)
    skey, order = kernels.sort_keys(torch.from_numpy(key), bits)
    assert order.dtype == torch.int32
    assert np.array_equal(skey.numpy(), want[0])
    assert np.array_equal(order.numpy(), want[1])


@pytest.mark.parametrize("bits", [0, 32])
def test_sort_keys_refuses_bits_outside_1_to_31(bits):
    with pytest.raises(ValueError):
        kernels.sort_keys(torch.zeros(4, dtype=torch.int32), bits)
    with pytest.raises(ValueError):
        kernels.sort_plan(4, bits)


def test_sort_plan_refuses_positions_past_int32():
    tile = kernels.SORT_THREADS * kernels.SORT_KEYS_A_THREAD
    kernels.sort_plan(2**31 - 1 - tile, 31)
    with pytest.raises(ValueError):
        kernels.sort_plan(2**31 - tile, 31)


# --- the launch arithmetic --------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 8, 11, 12, 22, 23, 25, 31])
@pytest.mark.parametrize("M", [1, 2, 4095, 4096, 4097, 70001, 1 << 24,
                               2**31 - 1 - 4096])
def test_sort_plan_covers_every_key_once_in_enough_passes(M, bits):
    plan = kernels.sort_plan(M, bits)
    d, passes, tile = plan["digit"], plan["passes"], plan["tile"]
    assert 1 <= d <= kernels.SORT_DIGIT_BITS
    assert passes * d >= bits > (passes - 1) * d   # no pass to spare
    assert passes == -(-bits // kernels.SORT_DIGIT_BITS)
    assert tile == kernels.SORT_THREADS * kernels.SORT_KEYS_A_THREAD
    # tile b holds [b tile, (b + 1) tile): disjoint, and together [0, M)
    assert (plan["blocks"] - 1) * tile < M <= plan["blocks"] * tile
    assert plan["counts"] == (1 << d) * plan["blocks"]
    assert plan["counts"] + (1 << d) < 2**31   # int offsets in the kernel
    assert (1 << d) <= kernels.SORT_THREADS   # a thread a digit
    assert plan["smem"] <= kernels.SMEM_LIMIT
    # two scatter blocks share a SM (1 KB a block and the block scan's 32
    # ints beside the dynamic bytes)
    assert 2 * (plan["smem"] + 1024 + 128) <= kernels.SMEM_SM
    # 16-bit digit counters: a tile's count of one digit fits; int32
    # positions up to the end of the last tile
    assert tile < 2**16
    assert plan["blocks"] * tile < 2**31


def test_sort_plan_follows_the_source():
    src = (build.CSRC / "sort_keys.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("KL_SORT_THREADS") == kernels.SORT_THREADS
    assert define("KL_SORT_KPT") == kernels.SORT_KEYS_A_THREAD
    assert define("KL_SORT_MAX_DIGIT") == kernels.SORT_DIGIT_BITS
    assert ("smem != 8 * KL_SORT_TILE + (8 + 2 * KL_SORT_WARPS) * "
            "(1 << digit)") in src
    warps = kernels.SORT_THREADS // 32
    for bits in range(1, 32):
        plan = kernels.sort_plan(1000, bits)
        assert plan["smem"] == (8 * plan["tile"]
                                + (8 + 2 * warps) * (1 << plan["digit"]))


# --- the kernel's passes in numpy -------------------------------------------

def sort_steps(key: np.ndarray, bits: int):
    """csrc/sort_keys.cu in numpy, pass by pass: kl_sort_hist's per-tile
    digit counts, digit-major; kl_sort_scan_rows' exclusive row scans and
    row totals; kl_sort_scatter's rank of each key (warp w takes KPT
    rounds of 32 consecutive keys of its tile: within a round the lanes
    below with the same digit, before it the warp's digit counter, and the
    warps' counters summed in warp order), its place in the staged tile and
    its place in the output. Returns (sorted keys, order)."""
    M = len(key)
    plan = kernels.sort_plan(max(M, 1), bits)
    d, tile, nb = plan["digit"], plan["tile"], plan["blocks"]
    R, KPT = 1 << d, kernels.SORT_KEYS_A_THREAD
    NW = kernels.SORT_THREADS // 32
    if M == 0:
        return key.copy(), np.zeros(0, np.int32)
    k, v = key.astype(np.int64), np.arange(M, dtype=np.int64)
    src = np.arange(nb * tile).reshape(nb, NW, KPT, 32)   # tile order
    valid = src < M
    b_ix = np.arange(nb)[:, None, None]
    w_ix = np.arange(NW)[None, :, None]
    below = np.tril(np.ones((32, 32), bool), -1)   # below[i, j]: j < i
    for p in range(plan["passes"]):
        dg = np.full(nb * tile, R)   # R: no key
        dg[:M] = (k >> (p * d)) & (R - 1)
        dg = dg.reshape(nb, NW, KPT, 32)
        # (a) counts[digit][block]
        counts = np.stack([np.bincount(t[t < R], minlength=R)
                           for t in dg.reshape(nb, tile)], axis=1)
        assert counts.size == plan["counts"]
        # (b) each row's exclusive scan and its total; a digit's start
        rows = np.cumsum(counts, axis=1) - counts
        tot = counts.sum(axis=1)
        start = np.cumsum(tot) - tot
        # (c) the warp-local rank, round by round
        cnt = np.zeros((nb, NW, R + 1), np.int64)
        rank = np.empty(dg.shape, np.int64)
        for r in range(KPT):
            dr = dg[:, :, r, :]
            same = dr[..., :, None] == dr[..., None, :]
            rank[:, :, r, :] = (np.take_along_axis(cnt, dr, axis=2)
                                + (same & below).sum(-1))
            np.add.at(cnt, (b_ix, w_ix, dr), 1)
        warp_start = np.cumsum(cnt, axis=1) - cnt   # exclusive, warp order
        tile_cnt = cnt.sum(axis=1)[:, :R]
        assert np.array_equal(tile_cnt, counts.T)
        loc = np.cumsum(tile_cnt, axis=1) - tile_cnt   # a digit's start
        gml = start[None, :] + rows.T - loc
        dd = np.where(valid, dg, 0)
        bb = np.arange(nb)[:, None, None, None]
        ww = np.arange(NW)[None, :, None, None]
        staged = loc[bb, dd] + warp_start[bb, ww, dd] + rank
        for b in range(nb):   # the staged tile is a permutation of the tile
            n_b = int(valid[b].sum())
            assert np.array_equal(np.sort(staged[b][valid[b]]),
                                  np.arange(n_b))
        out = (staged + gml[bb, dd])[valid]
        assert np.array_equal(np.sort(out), np.arange(M))
        nk, nv = np.empty_like(k), np.empty_like(v)
        nk[out], nv[out] = k[src[valid]], v[src[valid]]
        k, v = nk, nv
    return k.astype(np.int32), v.astype(np.int32)


@pytest.mark.parametrize("digit_bits", [5, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", SIZES)
def test_sort_steps_give_the_stable_order(n, family, digit_bits, monkeypatch):
    monkeypatch.setattr(kernels, "SORT_DIGIT_BITS", digit_bits)
    key, bits = FAMILIES[family](n, seed=n + 1)
    order = np.argsort(key, kind="stable")
    got = sort_steps(key, bits)
    assert np.array_equal(got[1], order)
    assert np.array_equal(got[0], key[order])


def test_sort_steps_on_distinct_31_bit_keys():
    """Every digit of every pass in use: 2^16 + 3 distinct random keys."""
    r = np.random.default_rng(0)
    key = r.choice(2**31 - 1, size=(1 << 16) + 3, replace=False)
    got = sort_steps(key.astype(np.int32), 31)
    assert np.array_equal(got[1], np.argsort(key, kind="stable"))


# --- no library sort on the port's paths --------------------------------------

SORTS = {"sort", "argsort", "msort"}


def _library_sorts(tree: ast.AST):
    """(line, enclosing function) of every torch.sort / argsort / msort and
    of every tensor-style .argsort( or .sort(dim= / stable= / descending=)
    call that is not numpy's."""
    found = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        if isinstance(node, ast.Attribute) and node.attr in SORTS:
            base = node.value
            if isinstance(base, ast.Name) and base.id == "torch":
                found.append((node.lineno, fn))
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in SORTS
                and not (isinstance(node.func.value, ast.Name)
                         and node.func.value.id in ("np", "numpy", "torch"))
                and (node.func.attr != "sort" or any(
                    kw.arg in ("dim", "stable", "descending")
                    for kw in node.keywords))):
            found.append((node.lineno, fn))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, None)
    return found


def test_no_library_sort_outside_plain_versions():
    root = pathlib.Path(kernels.__file__).resolve().parents[1]
    seen, bad = 0, []
    for path in sorted(root.rglob("*.py")):
        for line, fn in _library_sorts(ast.parse(path.read_text())):
            seen += 1
            if not (fn or "").endswith("_plain"):
                bad.append(f"{path.relative_to(root)}:{line} in {fn}")
    assert not bad, bad
    assert seen > 0   # the check finds sort_keys_plain's own


def test_library_sort_check_finds_each_form():
    src = ("import torch\n"
           "def f(x):\n    return torch.sort(x)\n"
           "def g(x):\n    return x.argsort()\n"
           "def h(x):\n    return x.sort(stable=True)\n"
           "def i_plain(x):\n    return torch.argsort(x)\n"
           "def j(x):\n    x.sort()\n    return np.argsort(x)\n")
    assert [fn for _, fn in _library_sorts(ast.parse(src))] == [
        "f", "g", "h", "i_plain"]


# --- a session sorts through the wrapper ---------------------------------------

def test_a_session_sorts_through_sort_keys(monkeypatch):
    """Each iteration sorts its combined keys (31 bits) through
    kernels.sort_keys, and the compaction its dead flags (1 bit). On the
    CPU finalize runs finalize_plain, whose two sorts (keys ≤ cap0) go
    through sort_keys_plain, the function sort_keys runs on the CPU; on
    the card they are sort_keys launches (chip_smoke counts them)."""
    calls, plain = [], []
    real, real_plain = kernels.sort_keys, kernels.sort_keys_plain

    def counted(key, bits):
        calls.append(bits)
        return real(key, bits)

    def counted_plain(key, bits):
        plain.append(bits)
        return real_plain(key, bits)

    monkeypatch.setattr(kernels, "sort_keys", counted)
    monkeypatch.setattr(kernels, "sort_keys_plain", counted_plain)
    r = np.random.default_rng(1)
    n, iters = 3000, 6
    prof = r.normal(size=(40, 8)).astype(np.float32)
    values = prof[r.integers(0, 40, size=n)] + 0.01 * r.normal(size=(n, 8))
    cents, sizes, groups = engine.cluster(values.astype(np.float32),
                                          iterations=iters, device="cpu")
    assert len(groups) == len(sizes) > 0
    assert calls == [lsh.KEY_BITS] * iters + [1]
    assert plain == calls + [n.bit_length()] * 2
