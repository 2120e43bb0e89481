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

ONE, SWEEP, THREE = kernels.SORT_ROUTES
LIMIT = kernels.SORT_ONE_MAX


@pytest.mark.parametrize("bits", [1, 2, 8, 11, 12, 22, 23, 25, 31])
@pytest.mark.parametrize("M", [1, 2, 4095, 4096, 4097, LIMIT, LIMIT + 1,
                               70001, 1 << 24, 2**31 - 1 - 4096])
def test_sort_plan_covers_every_key_once_in_enough_passes(M, bits):
    plan = kernels.sort_plan(M, bits)
    d, passes, tile = plan["digit"], plan["passes"], plan["tile"]
    R = 1 << d
    assert 1 <= d <= kernels.SORT_DIGIT_BITS
    assert passes * d >= bits > (passes - 1) * d   # no pass to spare
    assert passes == -(-bits // kernels.SORT_DIGIT_BITS)
    one = plan["route"] == ONE
    assert plan["route"] == (ONE if M <= LIMIT else SWEEP if passes > 1
                             else THREE)
    threads = kernels.SORT_THREADS
    assert tile == threads * kernels.SORT_KEYS_A_THREAD
    # tile b holds [b tile, (b + 1) tile): disjoint, and together [0, M)
    assert (plan["blocks"] - 1) * tile < M <= plan["blocks"] * tile
    assert R <= threads and R <= 1024   # a thread a digit, a starts block
    assert plan["smem"] <= kernels.SMEM_LIMIT
    pair = 2 * -(-4 * M // 256) * 256 if passes > 1 else 0
    if one:
        assert plan["launches"] == 1 and plan["hist_blocks"] == 0
        # the tiles' counts, and the pair
        assert plan["scratch"] == (-(-4 * plan["blocks"] * R // 256) * 256
                                   + pair)
    elif plan["route"] == THREE:
        assert plan["launches"] == 3 * passes and plan["hist_blocks"] == 0
        # a pass's tile counts and the digits' totals, and the pair
        assert plan["scratch"] == (
            -(-4 * (plan["blocks"] + 1) * R // 256) * 256 + pair)
    else:
        assert plan["launches"] == 2 + passes <= 6
        G = plan["hist_blocks"]
        assert 1 <= G <= plan["blocks"]   # whole tiles a block
        assert G * passes * R <= kernels.SORT_HIST_INTS
        assert G == plan["blocks"] or (
            (G + 1) * passes * R > kernels.SORT_HIST_INTS)
        # the status words, the first pass's tile counts, the histogram
        # rows, starts, tickets and pair
        assert plan["scratch"] >= (12 * plan["blocks"] * R
                                   + 4 * G * passes * R + 4 * passes * R
                                   + 4 * passes
                                   + (8 * M if passes > 1 else 0))
        assert plan["scratch"] % 256 == 0
        # two tile blocks share a SM (1 KB a block and the block scan's 32
        # ints beside the dynamic bytes)
        assert 2 * (plan["smem"] + 1024 + 128) <= kernels.SMEM_SM
    # every pass's bins fit a histogram block's shared ints
    src = (build.CSRC / "sort_keys.cu").read_text()
    assert passes * R <= define(src, "KL_SORT_MAX_PASSES") << define(
        src, "KL_SORT_MAX_DIGIT")
    # 16-bit digit counters: a tile's count of one digit fits; int32
    # positions up to the end of the last tile; 32-bit status counts
    assert tile < 2**16
    assert plan["blocks"] * tile < 2**31


@pytest.mark.parametrize("M", [1, LIMIT - 1, LIMIT, LIMIT + 1, 2 * LIMIT])
@pytest.mark.parametrize("bits", [1, 25, 31])
def test_sort_plan_routes_either_side_of_the_limit(M, bits):
    """The one-launch route up to SORT_ONE_MAX keys and never past it (the
    C entry refuses it there); above it the one-sweep route, or three
    launches a pass for a sort of one pass; those two at any size."""
    plan = kernels.sort_plan(M, bits)
    passes = plan["passes"]
    assert plan["route"] == (ONE if M <= LIMIT else SWEEP if passes > 1
                             else THREE)
    assert kernels.sort_plan(M, bits, SWEEP)["launches"] == 2 + passes
    assert kernels.sort_plan(M, bits, THREE)["launches"] == 3 * passes
    if M > LIMIT:
        with pytest.raises(ValueError):
            kernels.sort_plan(M, bits, ONE)
    with pytest.raises(ValueError):
        kernels.sort_plan(M, bits, "two launches a pass")


def define(src: str, name: str) -> int:
    """The value of a #define of sort_keys.cu (other defines in it
    resolved; C's integer division)."""
    text = re.search(rf"^#define {name} (.+?)\s*(//.*)?$", src,
                     re.M).group(1)
    for other in set(re.findall(r"KL_SORT_\w+", text)):
        text = text.replace(other, str(define(src, other)))
    return int(eval(text.replace("/", "//")))


def test_sort_plan_follows_the_source():
    src = (build.CSRC / "sort_keys.cu").read_text()
    for name, value in (("KL_SORT_THREADS", kernels.SORT_THREADS),
                        ("KL_SORT_KPT", kernels.SORT_KEYS_A_THREAD),
                        ("KL_SORT_MAX_DIGIT", kernels.SORT_DIGIT_BITS),
                        ("KL_SORT_HIST_INTS", kernels.SORT_HIST_INTS),
                        ("KL_SORT_ONE_MAX", kernels.SORT_ONE_MAX),
                        ("KL_SORT_MAX_PASSES",
                         -(-31 // kernels.SORT_DIGIT_BITS))):
        assert define(src, name) == value, name
    # the route codes, the checks of the C entry and its scratch layout
    assert "const bool sweep = route == 1;" in src
    assert "if (route < 0 || route > 2)" in src
    assert "(route == 0 && M > KL_SORT_ONE_MAX)" in src
    assert ("#define KL_SORT_SMEM(tile, warps, digit) \\\n"
            "  (8 * (tile) + (8 + 2 * (warps)) * (1 << (digit)))") in src
    assert "smem != KL_SORT_SMEM(tile, KL_SORT_THREADS / 32, digit)" in src
    for part in ("pair = passes > 1 ? 2 * kl_align(4 * M) : 0",
                 "status = sweep ? kl_align(8LL * blocks * R) : 0",
                 "counts = kl_align(4LL * (blocks + (route == 2)) * R)",
                 "rows = sweep ? kl_align(4LL * hist_blocks * passes * R) : 0",
                 "starts = sweep ? kl_align(4LL * passes * R) : 0",
                 "tickets = sweep ? kl_align(4LL * passes) : 0",
                 "scratch_bytes != status + counts + rows + starts + tickets "
                 "+ pair"):
        assert part in src, part
    assert "(bytes + 255) / 256 * 256" in src
    for bits in range(1, 32):
        for M in (1000, 70001):
            plan = kernels.sort_plan(M, bits)
            warps = kernels.SORT_THREADS // 32
            assert plan["smem"] == (8 * plan["tile"]
                                    + (8 + 2 * warps) * (1 << plan["digit"]))


# --- the kernel's steps in numpy --------------------------------------------

def rank_tiles(dg, R, NW, KPT):
    """kl_tile_rank on the digits dg [tiles, NW, KPT, 32] (R: no key):
    each key's rank among the equal digits before it in its warp's
    rounds, and each warp's counts of each digit."""
    nb = dg.shape[0]
    b_ix = np.arange(nb)[:, None, None]
    w_ix = np.arange(NW)[None, :, None]
    below = np.tril(np.ones((32, 32), bool), -1)   # below[i, j]: j < i
    cnt = np.zeros((nb, NW, R + 1), np.int64)
    rank = np.empty(dg.shape, np.int64)
    for r in range(KPT):
        dr = dg[:, :, r, :]
        same = dr[..., :, None] == dr[..., None, :]
        rank[:, :, r, :] = (np.take_along_axis(cnt, dr, axis=2)
                            + (same & below).sum(-1))
        np.add.at(cnt, (b_ix, w_ix, dr), 1)
    return rank, cnt


def look_back(status, c, own, W, rng, fault):
    """kl_sort_onesweep's offsets of one pass: the tiles publish their own
    counts and look back in a shuffled interleaving (tile b's look-back of
    digit t reads the words of tiles j, j - 1, ..., j - W + 1 at once,
    sums them up to the first unpublished word or through the first
    inclusive one, and goes on from where it stopped). ``status`` (tags,
    counts [tiles, R]) persists from pass to pass as the scratch does.
    Returns each tile's count of each digit in the tiles before it."""
    tag, cnt = status
    nb, R = c.shape
    before = np.zeros((nb, R), np.int64)
    j = np.repeat(np.arange(nb)[:, None] - 1, R, axis=1)
    done = np.zeros((nb, R), bool)
    published = np.zeros(nb, bool)
    todo = list(range(nb))
    while todo:
        b = todo[rng.integers(len(todo))]
        if not published[b]:
            tag[b], cnt[b] = (own if b else own + 1), c[b]
            published[b] = True
            if b == 0:
                done[0] = True
                todo.remove(0)
            continue
        r = np.flatnonzero(~done[b])
        s = np.zeros(len(r), np.int64)
        used = np.zeros(len(r), np.int64)
        stop = np.zeros(len(r), bool)
        fin = np.zeros(len(r), bool)
        for q in range(W):
            at = j[b, r] - q
            ok = at >= 0
            t_w = np.where(ok, tag[np.maximum(at, 0), r], 0)
            n_w = np.where(ok, cnt[np.maximum(at, 0), r], 0)
            take = ~stop & (t_w >= own)
            stop |= ~take
            s += np.where(take, n_w, 0)
            used += take
            inc = take & (t_w > own)
            stop |= inc
            fin |= inc
        before[b, r] = s if fault == "carry" else before[b, r] + s
        j[b, r] -= used
        done[b, r] = fin
        if done[b].all():
            tag[b], cnt[b] = own + 1, before[b] + c[b]
            todo.remove(b)
    return before


def sort_steps(key: np.ndarray, bits: int, route=None, fault=None,
               seed=0):
    """csrc/sort_keys.cu in numpy on the plan's route, pass by pass:
    kl_tile_rank's ranks, each digit's start (an exclusive scan of the
    pass's digit counts: on the one-sweep route kl_sort_hist_all's rows,
    tile b counted by block b mod G, summed by kl_sort_starts), each tile's
    count of each digit in the tiles before it (the one-launch route sums
    the tiles' counts after a grid-wide sync, the three-launch route scans
    a pass's histogram rows; the one-sweep route takes the first pass's
    from the histogram's scanned rows and later ones by the look-back, its
    tiles in a shuffled order), and each key's place in the
    staged tile and in the output. ``fault`` breaks one step as a wrong
    kernel would: "carry" (the look-back, or the sum of the tiles before,
    keeps only its last step), "epoch" (every pass tags its words as the
    second does), "start" (a digit's start counts its own keys). Returns
    (sorted keys, order)."""
    M = len(key)
    plan = kernels.sort_plan(max(M, 1), bits, route)
    d, tile, nb = plan["digit"], plan["tile"], plan["blocks"]
    R, NW = 1 << d, kernels.SORT_THREADS // 32
    KPT = kernels.SORT_KEYS_A_THREAD
    if M == 0:
        return key.copy(), np.zeros(0, np.int32)
    rng = np.random.default_rng(seed)
    src_text = (build.CSRC / "sort_keys.cu").read_text()
    W = define(src_text, "KL_SORT_WINDOW")
    k0 = key.astype(np.int64)
    # every pass's digit counts, from the keys as they come
    digits = np.stack([(k0 >> (p * d)) & (R - 1)
                       for p in range(plan["passes"])])
    if plan["route"] != SWEEP:
        counts = np.stack([np.bincount(x, minlength=R) for x in digits])
    else:
        # block g takes tiles g, g + G, ...: its row of every pass's counts
        G = plan["hist_blocks"]
        block = (np.arange(M) // tile) % G
        rows = np.zeros((G, plan["passes"], R), np.int64)
        for p in range(plan["passes"]):
            np.add.at(rows, (block, p, digits[p]), 1)
        counts = rows.sum(axis=0)
        # each tile's own counts of the first pass's digits, then each
        # digit's row scanned over the tiles
        heads = np.zeros((R, nb), np.int64)
        np.add.at(heads, (digits[0], np.arange(M) // tile), 1)
        heads = np.cumsum(heads, axis=1) - heads
    starts = np.cumsum(counts, axis=1) - (0 if fault == "start" else counts)
    status = (np.zeros((nb, R), np.int64), np.zeros((nb, R), np.int64))
    k, v = k0, np.arange(M, dtype=np.int64)
    src = np.arange(nb * tile).reshape(nb, NW, KPT, 32)   # tile order
    valid = src < M
    bb = np.arange(nb)[:, None, None, None]
    ww = np.arange(NW)[None, :, None, None]
    for p in range(plan["passes"]):
        dg = np.full(nb * tile, R)   # R: no key
        dg[:M] = (k >> (p * d)) & (R - 1)
        dg = dg.reshape(nb, NW, KPT, 32)
        rank, cnt = rank_tiles(dg, R, NW, KPT)
        warp_start = np.cumsum(cnt, axis=1) - cnt   # exclusive, warp order
        c = cnt.sum(axis=1)[:, :R]                  # the tiles' counts
        assert np.array_equal(c.sum(axis=0), counts[p])
        if plan["route"] != SWEEP:
            before = (np.zeros_like(c) if fault == "carry"
                      else np.cumsum(c, axis=0) - c)
        elif p == 0:
            before = heads.T
        else:
            own = 4 if fault == "epoch" else 2 * p + 2
            before = look_back(status, c, own, W, rng, fault)
        loc = np.cumsum(c, axis=1) - c   # a digit's start in the tile
        gml = starts[p][None, :] + before - loc
        dd = np.where(valid, dg, 0)
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


def steps_sort(key, bits, **kw) -> bool:
    """Whether sort_steps gives the stable order (False where one of its
    checks fails)."""
    order = np.argsort(key, kind="stable")
    try:
        got = sort_steps(key, bits, **kw)
    except AssertionError:
        return False
    return (np.array_equal(got[1], order)
            and np.array_equal(got[0], key[order]))


@pytest.mark.parametrize("route", [None, SWEEP, THREE])
@pytest.mark.parametrize("digit_bits", [5, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", SIZES)
def test_sort_steps_give_the_stable_order(n, family, digit_bits, route,
                                          monkeypatch):
    monkeypatch.setattr(kernels, "SORT_DIGIT_BITS", digit_bits)
    key, bits = FAMILIES[family](n, seed=n + 1)
    assert steps_sort(key, bits, route=route, seed=n)


def test_sort_steps_on_distinct_31_bit_keys():
    """Every digit of every pass in use: 2^16 + 3 distinct random keys
    over 17 tiles that finish in a shuffled order."""
    r = np.random.default_rng(0)
    key = r.choice(2**31 - 1, size=(1 << 16) + 3, replace=False)
    assert steps_sort(key.astype(np.int32), 31)


@pytest.mark.parametrize("route,fault", [(ONE, "carry"), (SWEEP, "carry"),
                                         (THREE, "carry"), (SWEEP, "epoch"),
                                         (ONE, "start"), (SWEEP, "start"),
                                         (THREE, "start")])
def test_sort_steps_catch_a_faulty_step(route, fault):
    """A look-back (or sum of the tiles before) that keeps only its last
    step, words whose tag names no pass, and digit starts one digit late
    each give another order; the same keys sort right without the
    fault."""
    key, bits = combined_keys(3 * kernels.SORT_THREADS
                              * kernels.SORT_KEYS_A_THREAD * 5 + 17, seed=4)
    if route == ONE:
        key = key[:LIMIT - 5]
    assert steps_sort(key, bits, route=route, seed=1)
    assert not steps_sort(key, bits, route=route, fault=fault, seed=1)


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
