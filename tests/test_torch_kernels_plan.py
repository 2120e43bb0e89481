"""What the CUDA sources rely on, checked without the card: the launch
arithmetic of the LSH-key, permute, chain-collapse, exchange-window and
pairing kernels (``kernels.lsh_plan``, ``permute_plan``, ``chain_plan``,
``window_plan``, ``pairing_plan``), the grouping identity of finalize's steps, and the read
scorer's prefix directory and bucket search."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.kernels import build
from kmerlsh_tpu_torch.kmer import codec
from kmerlsh_tpu_torch.ops import reads

STRIDE = 1 << kernels.MAX_CHAIN_LOG
SIZES = [1, 31, 512, 70001, 1 << 20, (1 << 21) - 12345, 1 << 24]


@pytest.mark.parametrize("S", [1, 3, 20, 100, 300])
@pytest.mark.parametrize("M", SIZES)
def test_chain_plan_covers_every_position_once(S, M):
    plan = kernels.chain_plan(S, M)
    P = plan["P"]
    assert P & (P - 1) == 0 and 32 <= P <= 512   # one thread a position
    # sub-range b holds [b P, (b + 1) P): disjoint, and together [0, M)
    assert (plan["blocks"] - 1) * P < M <= plan["blocks"] * P
    # no sub-range crosses a multiple of 2^15: a chain never spans the cut
    starts = range(0, M, P)
    assert all(s // STRIDE == (min(s + P, M) - 1) // STRIDE for s in starts)
    assert plan["smem"] <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("S", [1, 3, 20, 100, 300])
def test_plans_follow_s(S):
    chain = kernels.chain_plan(S, 1 << 21)
    # the staged values stay within the stage budget, down to 32 positions
    assert chain["P"] * S * 4 <= kernels.STAGE_BYTES or chain["P"] == 32
    move = kernels.permute_plan(S, 1 << 21)
    W, cols = move["W"], move["cols"]
    assert W >= S + 2 and (W * 4) % 32 == 0 and W % 4 == 0
    assert cols in (32, 64, 128) and move["threads"] % cols == 0
    assert (move["blocks"] - 1) * cols < 1 << 21 <= move["blocks"] * cols
    assert move["smem"] == 4 * cols + 4 * cols * (W + 4)   # int32 order run
    assert (W + 4) % 8 == 4   # 16-byte rows whose reads miss no bank
    assert move["smem"] <= kernels.SMEM_LIMIT


def test_plans_take_every_s_the_engine_took():
    # the kernels before these took S up to 1557 rows (chain_collapse's
    # 2^15 flag bytes and 32 threads of 4 S + 12 bytes in 227 KB)
    for S in (1, 301, 1000, 1557):
        assert kernels.chain_plan(S, 1 << 20)["smem"] <= kernels.SMEM_LIMIT
        assert kernels.permute_plan(S, 1 << 20)["smem"] <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError):
        kernels.chain_plan(4000, 1 << 20)
    with pytest.raises(ValueError):
        kernels.permute_plan(4000, 1 << 20)


def test_plans_at_the_cohort():
    """The launch plans at the benchmark's kostic18 cohort, 10^8 rows x 18
    samples, where K2's scratch of M x W words passes 2^31: the offsets
    into it are 64-bit in every kernel that reads or writes it."""
    S, M = 18, 10**8
    chain = kernels.chain_plan(S, M)
    assert (chain["W"], chain["row"], chain["P"], chain["threads"],
            chain["blocks"]) == (24, 28, 256, 256, 390_625)
    assert kernels.permute_plan(S, M)["W"] == 24
    assert kernels.sort_plan(M, 31)["blocks"] == 24_415
    assert M * chain["W"] == 2_400_000_000 > 2**31


# S: (W, row words, P, threads, shared memory bytes)
CHAIN_PLANS = {1: (8, 12, 512, 512, 35224), 20: (24, 28, 256, 256, 34276),
               124: (128, 132, 64, 128, 37436), 254: (256, 260, 32, 128, 37964)}


@pytest.mark.parametrize("S", sorted(CHAIN_PLANS))
def test_chain_plan_stages_whole_scratch_rows(S):
    """K3 stages a scratch row a position (K2's W words: the values, the
    size and the slot) into rows of W + 4 words: 16-byte aligned pieces, an
    odd number of them a row, so the 16-byte reads of eight neighbouring
    rows cover the 32 banks; P + 2 rows (a halo each side) within the stage
    budget; at least CHAIN_THREADS threads, so that the SM holds more warps
    than the positions staged; at the cell's width (124) six blocks a SM."""
    W, row, P, threads, smem = CHAIN_PLANS[S]
    plan = kernels.chain_plan(S, 1 << 24)
    assert (plan["W"], plan["row"], plan["P"], plan["threads"],
            plan["smem"]) == CHAIN_PLANS[S]
    assert W == kernels.permute_plan(S, 1 << 24)["W"] >= S + 2
    assert row == W + 4 and (4 * row) % 16 == 0 and (row // 4) % 2 == 1
    # the 16-byte pieces of eight neighbouring rows start on distinct
    # groups of four banks
    assert len({(r * row) % 32 for r in range(8)}) == 8
    assert 4 * (P + 2) * row <= kernels.STAGE_BYTES
    assert P == 512 or 4 * (2 * P + 2) * row > kernels.STAGE_BYTES
    assert threads == max(P, kernels.CHAIN_THREADS) and threads % 32 == 0
    assert P <= threads <= 512
    assert smem <= kernels.SMEM_LIMIT
    if S == 124:
        assert 6 * (smem + 1024) <= kernels.SMEM_SM


def _c_conditional(expr: str, env: dict):
    """A C expression ``cond ? a : b`` (each part a Python expression too)
    evaluated in ``env``."""
    import re

    cond, then, other = re.fullmatch(r"(.*) \? (.*) : (.*)", expr).groups()
    return eval(then if eval(cond, env) else other, env)


def test_chain_plan_follows_the_source():
    """chain_plan's shared memory is csrc/chain_collapse.cu's
    kl_chain_words, its expression evaluated at each plan, on columns and
    on rows; the staged row's words are csrc/common.cuh's kl_stage_ld."""
    import re

    common = (build.CSRC / "common.cuh").read_text()
    stage = re.search(r"kl_stage_ld\(int W\) \{\s+return (.*?);",
                      common).group(1)
    for W in (4, 8, 20, 24, 124, 128):
        assert _c_conditional(stage, dict(W=W)) == kernels.stage_words(W)
    src = (build.CSRC / "chain_collapse.cu").read_text()
    body = re.search(r"kl_chain_words\(long long S, long long W,\s+long long "
                     r"P\) \{(.*?)\n\}", src, re.S).group(1)
    scan = re.search(r"scan = (.*?);", body).group(1)
    words = re.search(r"return (.*?);", body, re.S).group(1)
    for S in (1, 3, 18, 20, 100, 124, 254, 300, 1557):
        for rows in (False, True):
            plan = kernels.chain_plan(S, 1 << 20, rows)
            env = dict(S=S, W=plan["W"], P=plan["P"], nw=plan["P"] // 32,
                       kl_stage_ld=kernels.stage_words)
            env["scan"] = _c_conditional(scan, env)
            assert (4 * eval(" ".join(words.split()), env)
                    == plan["smem"]), (S, rows)
    cap = re.search(r"#define KL_CHAIN_MAX_T (\d+)", src).group(1)
    assert all(kernels.chain_plan(S, 1 << 20)["threads"] <= int(cap)
               for S in (1, 20, 124))


def test_chain_plan_fills_the_card_at_every_capacity():
    # 132 SMs: at 2^20 x 20 and above, several blocks per SM
    for M in (1 << 20, 2_000_000, 1 << 24):
        assert kernels.chain_plan(20, M)["blocks"] >= 4 * 132


# --- K8a exchange_window --------------------------------------------------

@pytest.mark.parametrize("c,cw,nb", [
    (1, 32, 1), (31, 32, 1), (1024, 32, 1), (1025, 32, 2),
    (1 << 20, 32, 1024), (1 << 22, 32, 4096), (1 << 23, 32, 8192),
    ((1 << 23) + 1, 64, 4097), (1 << 24, 64, 8192), (1 << 26, 256, 8192)])
def test_window_plan_chunks_cover_every_column_once(c, cw, nb):
    plan = kernels.window_plan(c)
    assert (plan["cw"], plan["nb"]) == (cw, nb)
    assert plan["words"] == -(-c // 32)
    # chunk b holds columns [b cw 32, (b + 1) cw 32); the last is not empty
    assert (nb - 1) * cw * 32 < c <= nb * cw * 32
    # the offsets of every chunk, padded one word in 32, and the total fit
    # the 48 KB a block takes without opting in
    assert plan["smem"] == 4 * (nb + nb // 32 + 1) <= 48 * 1024
    assert plan["scratch"] == nb * cw + nb


def test_window_plan_follows_the_source():
    import re

    from kmerlsh_tpu_torch.kernels import build

    src = (build.CSRC / "exchange.cu").read_text()
    cap = int(re.search(r"#define KL_WIN_MAX_CHUNKS (\d+)", src).group(1))
    assert cap == kernels.WIN_MAX_CHUNKS
    with pytest.raises(ValueError):
        kernels.window_plan(0)


# --- K1b lsh_keys ---------------------------------------------------------

@pytest.mark.parametrize("h", range(1, 31))
def test_lsh_plan_computes_the_least_instantiation_at_or_above_h(h):
    T = kernels.lsh_plan(20, h)["planes"]
    assert T in kernels.LSH_PLANES and T >= h
    assert all(t < h for t in kernels.LSH_PLANES if t < T)
    assert T - h < 4          # at most three sign planes computed in vain


@pytest.mark.parametrize("S", [1, 20, 528, 529, 600, 1565, 1688])
def test_lsh_plan_stages_the_planes_in_use_and_the_ring(S):
    for h in (1, 8, 9, 24, 25, 30):
        plan = kernels.lsh_plan(S, h)
        quads = -(-(plan["planes"] + 1) // 4)   # whole float4s a plane row
        ring = 4 * kernels.LSH_RING * plan["cols"]   # value rows in flight
        assert plan["smem"] == 16 * S * quads + ring <= kernels.SMEM_LIMIT
        assert plan["cols"] == 4 * plan["threads"]


def test_lsh_plan_refuses_what_shared_memory_cannot_hold():
    ring = 4 * kernels.LSH_RING * 512
    assert kernels.lsh_plan(20, 24)["smem"] == 20 * 16 * 7 + ring
    with pytest.raises(ValueError):
        kernels.lsh_plan(1689, 30)   # 32 floats a row and the ring: past 227 KB
    assert kernels.lsh_plan(1689, 24)["smem"] <= kernels.SMEM_LIMIT
    # every S the engine's other kernels take (chain_plan: up to 1,565)
    assert kernels.lsh_plan(1565, 30)["smem"] <= kernels.SMEM_LIMIT
    for h in (0, 31):
        with pytest.raises(ValueError):
            kernels.lsh_plan(20, h)


# --- K6 wrs_verdicts --------------------------------------------------------

def _wrs_pieces(W: int) -> list[tuple[int, int, int]]:
    """kl_wrs_kernel's wrs_issue: (lane, row, piece) of every copy a warp
    makes of 32 rows of W pieces."""
    out = []
    for lane in range(32):
        r, j = divmod(lane, W)
        while r < 32:
            out.append((lane, r, j))
            r, j = r + 32 // W, j + 32 % W
            if j >= W:
                r, j = r + 1, j - W
    return out


@pytest.mark.parametrize("W", [1, 3, 5, 25, 31, 32, 33, 124])
def test_wrs_copies_take_each_piece_once_in_order(W):
    pieces = _wrs_pieces(W)
    assert sorted((r, j) for _, r, j in pieces) == [
        (r, j) for r in range(32) for j in range(W)]
    # the k-th copy of every lane: 32 consecutive pieces of the span
    by_lane = [[(r, j) for ln, r, j in pieces if ln == lane]
               for lane in range(32)]
    for k in range(len(by_lane[0])):
        flat = [r * W + j for lane in range(32) if k < len(by_lane[lane])
                for r, j in [by_lane[lane][k]]]
        assert flat == list(range(flat[0], flat[0] + len(flat)))


@pytest.mark.parametrize("S", [2, 3, 5, 20, 21, 100, 124, 125, 600, 4000])
def test_wrs_plan_stages_rows_free_of_bank_conflicts(S):
    plan = kernels.wrs_plan(1 << 20, S, S, 0)
    chunk = plan["chunk"]
    assert chunk % 8 == 4 and chunk <= kernels.WRS_CHUNK
    # each 8-lane phase of a float4 read: lane i at i * chunk floats, eight
    # distinct groups of four banks
    assert len({(i * chunk // 4) % 8 for i in range(8)}) == 8
    if S <= kernels.WRS_CHUNK:   # the whole row: the least such stride
        assert plan["chunks"] == 1 and S <= chunk < S + 8
    else:                        # chunks of WRS_CHUNK columns
        assert plan["chunks"] == -(-S // kernels.WRS_CHUNK) >= 2
    # the step table and constants, each warp's stage of 32 rows and
    # sizes, the buckets, and 15 bytes a row of the block
    assert plan["smem"] == (2 * 200 * 8 + 64 + kernels.WRS_WARPS * 4 * 32
                            * (chunk + 1) + 8 * kernels.WRS_BUCKETS
                            + 15 * plan["tile_rows"])
    assert plan["smem"] <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("ld,base,vec", [(20, 0, 16), (20, 80, 16),
                                         (20, 4, 4), (23, 0, 4), (24, 48, 16),
                                         (3, 0, 4), (3, 12, 4)])
def test_wrs_plan_copies_16_bytes_only_where_aligned(ld, base, vec):
    S = min(ld, 20)
    assert kernels.wrs_plan(1000, S, ld, base)["vec"] == vec


@pytest.mark.parametrize("N,tiles", [(1, 1), (31, 1), (33, 1), (511, 1),
                                     (131072, 1), (262144, 2), (393216, 3),
                                     (1 << 20, 4), ((1 << 20) + 7, 4)])
def test_wrs_plan_blocks_cover_the_rows(N, tiles):
    plan = kernels.wrs_plan(N, 20, 20, 0)
    rows = plan["tile_rows"]
    # the most tiles a warp that leave WRS_FILL blocks (or one a warp)
    assert plan["tiles"] == tiles and rows == 32 * kernels.WRS_WARPS * tiles
    assert plan["blocks"] >= kernels.WRS_FILL or tiles == 1
    assert plan["threads"] == 32 * kernels.WRS_WARPS
    # block b, warp w takes the 32-row tiles b rows + 32 (w + 4 i), i <
    # tiles: together every row once; a row's offset in its block fits the
    # entry's nine bits
    taken = sorted(b * rows + 32 * (w + kernels.WRS_WARPS * i) + lane
                   for b in range(min(plan["blocks"], 64))
                   for w in range(kernels.WRS_WARPS)
                   for i in range(tiles) for lane in range(32))
    assert taken == list(range(min(plan["blocks"], 64) * rows))
    assert (plan["blocks"] - 1) * rows < N <= plan["blocks"] * rows
    assert rows <= 512


@pytest.mark.parametrize("S,tiles", [(20, 4), (100, 1), (124, 4), (125, 4),
                                     (600, 4)])
def test_wrs_plan_keeps_the_blocks_a_sm_holds(S, tiles):
    """At 2^20 rows a warp takes four tiles, but fewer where the rows'
    share of shared memory would cost a block of the SM's few."""
    plan = kernels.wrs_plan(1 << 20, S, S, 0)
    assert plan["tiles"] == tiles
    one = kernels.wrs_plan(1 << 17, S, S, 0)
    assert one["tiles"] == 1

    def per_sm(p):
        return kernels.SMEM_SM // (p["smem"] + 1024)

    assert per_sm(plan) >= min(per_sm(one), kernels.WRS_MIN_BLOCKS)


def _wrs_block_order(ok, xx, rapid, thr, tiles):
    """kl_wrs_kernel's phases 1 and 2 for one block: a rank in its bucket
    for each row that needs the fraction (the atomics in tile, then lane
    order), the scan of the bucket counts and the scatter of the rows'
    offsets into the sorted order."""
    K = kernels.WRS_BUCKETS
    bucket = np.zeros(2 * K, np.int64)
    rank = np.full(len(ok), -1, np.int64)
    keys = np.zeros(len(ok), np.int64)
    for i in range(tiles):
        for w in range(kernels.WRS_WARPS):
            for lane in range(32):
                off = 32 * (w + kernels.WRS_WARPS * i) + lane
                if off >= len(ok) or not ok[off]:
                    continue
                u = xx[off] / (thr if rapid[off] else 1 - thr)
                keys[off] = (0 if rapid[off] else K) + min(K - 1,
                                                            max(0, int(u * K)))
                rank[off] = bucket[keys[off]]
                bucket[keys[off]] += 1
    start = np.cumsum(bucket) - bucket          # the warp's scan
    order = np.full(int(bucket.sum()), -1, np.int64)
    for off in np.flatnonzero(rank >= 0):
        order[start[keys[off]] + rank[off]] = off
    return order, keys


@pytest.mark.parametrize("n,tiles", [(512, 4), (128, 1), (300, 4)])
def test_wrs_block_sort_orders_rows_by_bucket(n, tiles):
    """Each row that needs the fraction takes one place in the sorted order,
    the order runs through the buckets, and a warp's 32 rows in it then
    take fewer steps at their slowest than 32 rows in their own order."""
    from kmerlsh_tpu_torch.ops import ttest

    values, _ = testdata.wrs_rows(n, 10, 10, seed=n)
    v = torch.from_numpy(values)
    _, _, ok, stat, df = ttest._statistic(v, 10, 10)
    steps = ttest.fraction_steps(v, 10, 10).numpy()
    t = stat.numpy()
    x = np.float32(df) / (np.float32(df) + t * t)
    a = np.float32(df) / np.float32(2)
    thr = (a + np.float32(1)) / (a + np.float32(0.5) + np.float32(2))
    rapid = x < thr
    xx = np.where(rapid, x, np.float32(1) - x)
    order, keys = _wrs_block_order(ok.numpy(), xx, rapid, thr, tiles)
    assert sorted(order) == np.flatnonzero(ok.numpy()).tolist()
    assert (np.diff(keys[order]) >= 0).all()

    def slowest(s):   # a warp's slowest row, on average over the warps
        return np.mean([s[i:i + 32].max() for i in range(0, len(s), 32)])

    assert slowest(steps[order]) < slowest(steps[np.flatnonzero(ok.numpy())])


def test_wrs_plan_follows_the_source():
    import re

    from kmerlsh_tpu_torch.kernels import build
    from kmerlsh_tpu_torch.ops import ttest

    src = (build.CSRC / "ttest.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWarps") == kernels.WRS_WARPS
    assert const("kMaxTiles") == kernels.WRS_TILES
    assert const("kBuckets") == kernels.WRS_BUCKETS
    assert const("kChunk") == kernels.WRS_CHUNK
    assert const("kMaxIter") == ttest.MAX_ITER
    assert const("kSmemLimit") == kernels.SMEM_LIMIT
    # the C entry point's stride rule: the least P >= S with P % 8 == 4
    assert "S + (12 - S % 8) % 8" in src
    for S in range(2, 200):
        assert (S + (12 - S % 8) % 8) == min(
            p for p in range(S, S + 8) if p % 8 == 4)
    for S, ld in ((1, 1), (20, 19)):
        with pytest.raises(ValueError):
            kernels.wrs_plan(10, S, ld, 0)


# --- K5 finalize ------------------------------------------------------------

def _finalize_steps(values_t, sizes, slots, parent):
    """csrc/finalize.cu's steps in numpy, one thread after another: the
    identity the kernel rests on. Link words as the kernel keeps them (the
    flag is bit 31 of a 64-bit word here)."""
    cap0, fc = len(parent), len(sizes)
    flag = 1 << 31
    link = parent.astype(np.int64)
    link[slots[sizes > 0]] |= flag                        # kl_fin_mark
    key = np.empty(cap0, np.int64)
    for r in range(cap0):                                 # kl_fin_roots
        x, p = r, link[r]
        while (p & ~flag) != x:
            x = p & ~flag
            p = link[x]
        key[r] = x if p & flag else cap0
    rows = np.argsort(key, kind="stable")                 # the rows' sort
    skey = key[rows]
    pos = np.arange(cap0)
    alive = skey != cap0                                  # kl_fin_heads
    first = alive & np.r_[True, skey[1:] != skey[:-1]]
    last = alive & np.r_[skey[1:] != skey[:-1], True]
    link[skey[first]] = -(pos[first] + 1)
    end = key.copy()
    end[skey[last]] = pos[last] + 1
    ckey = np.full(fc, cap0)                              # kl_fin_clusters
    clen = np.zeros(fc, np.int64)
    cstart = np.zeros(fc, np.int64)
    v = link[slots]
    seg = (sizes > 0) & (v < 0)
    cstart[seg] = -v[seg] - 1
    clen[seg] = end[slots[seg]] - cstart[seg]
    ckey[seg] = rows[cstart[seg]]
    order = np.argsort(ckey, kind="stable")               # the clusters' sort
    scratch = np.c_[values_t.T.view(np.int32), sizes,   # the transpose
                    clen.astype(np.int32)]
    rows_k = scratch[order]                               # kl_fin_gather
    cents = np.where(rows_k[:, -2:-1] == 0, 0, rows_k[:, :-2])
    cents = np.ascontiguousarray(cents, np.int32).view(np.float32)
    csizes, lens = rows_k[:, -2].astype(np.int64), rows_k[:, -1]
    off = np.cumsum(lens) - lens                          # kl_fin_place
    k = lens > 0
    link[slots[order[k]]] = off[k] - cstart[order[k]]
    d = np.where(alive, link[np.minimum(skey, cap0 - 1)], 0)
    flat = np.empty(cap0, np.int64)                       # kl_fin_scatter
    flat[pos + d] = rows
    return flat, lens, csizes, cents


def _jax_finalize_case():
    from test_torch_engine import _finalize_case

    return _finalize_case()[:4]


FINALIZE_CASES = {
    **{f"merges{seed}": (lambda seed=seed: testdata.finalize_case(
        4096, "merges", seed=seed)) for seed in range(3)},
    "chain": lambda: testdata.finalize_case(1500, "chain"),
    "empty": lambda: testdata.finalize_case(300, "empty"),
    "jax": _jax_finalize_case,
}


@pytest.mark.parametrize("case", sorted(FINALIZE_CASES))
def test_finalize_steps_give_the_plain_grouping(case):
    values_t, sizes, slots, parent = FINALIZE_CASES[case]()
    want = kernels.finalize_plain(*(torch.from_numpy(a) for a in
                                    (values_t, sizes, slots, parent)))
    got = _finalize_steps(values_t, sizes, slots, parent)
    for a, b in zip(got, want):
        assert a.dtype == b.numpy().dtype and a.shape == b.shape
        assert a.tobytes() == b.numpy().tobytes()
    assert sorted(got[0]) == list(range(len(parent)))   # flat: a permutation
    if case.startswith("merges") or case == "jax":   # rows of dead roots
        assert 0 < int(got[1].sum()) < len(parent)


def test_entry_points_take_what_ctypes_passes():
    """Every KL_EXPORT function of csrc/ has the argument types that
    build.SIGNATURES gives ctypes (a pointer for each pointer)."""
    import re

    from kmerlsh_tpu_torch.kernels import build

    scalar = {"long long": build._L, "int": build._I, "float": build._F}
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r"KL_EXPORT int (\w+)\(([^)]*)\)",
                                       src.read_text()):
            found[name] = tuple(
                build._P if "*" in p else scalar[" ".join(p.split()[:-1])]
                for p in params.split(","))
    assert found == build.SIGNATURES


# --- K7: the prefix directory and the search inside a bucket ---------------

def _directory(keys: np.ndarray, bits: int) -> np.ndarray:
    """kl_key_directory_kernel: entry p < 2^bits is the lower bound of
    p << (64 - bits) among the keys, the last entry D."""
    least = np.arange(1 << bits, dtype=np.uint64) << np.uint64(64 - bits)
    return np.append(np.searchsorted(keys, least, "left"), len(keys))


def _score_steps(codes, win_start, n_win, lens, keys, k, vote, bits):
    """kl_score_reads_kernel in numpy: each window's canonical key, the two
    directory entries of its prefix, a lower-bound search between them that
    keeps whether the probe that last lowered ``hi`` found the key, the
    hits of each read and the float32 vote."""
    directory = _directory(keys, bits)
    sel = np.zeros(len(lens), bool)
    q_all = codec.canonical_key(codec.sliding_kmers(codes, k), k)
    for r in np.flatnonzero((n_win > 0) & (lens >= k + 10)):
        q = q_all[win_start[r]:win_start[r] + n_win[r]]
        p = (q >> np.uint64(64 - bits)).astype(np.int64)
        lo, hi = directory[p], directory[p + 1]
        eq = np.zeros(len(q), bool)
        while (lo < hi).any():
            act = np.flatnonzero(lo < hi)
            mid = (lo[act] + hi[act]) >> 1
            v = keys[mid]
            less = v < q[act]
            lo[act[less]] = mid[less] + 1
            hi[act[~less]] = mid[~less]
            eq[act[~less]] = v[~less] == q[act][~less]
        ratio = np.float32(eq.sum()) / np.float32(lens[r] - k + 1)
        sel[r] = ratio > np.float32(vote)
    return sel


@pytest.mark.parametrize("n, bits", [(0, 16), (1, 16), (1 << 16, 16),
                                     ((1 << 16) + 1, 17), (1 << 20, 20),
                                     (1 << 22, 22), (1 << 30, 22)])
def test_directory_bits_follow_the_key_count(n, bits):
    assert kernels.key_directory_bits(n) == bits


@pytest.mark.parametrize("k", [1, 15, 31])
@pytest.mark.parametrize("kind", testdata.SCORE_CASES)
def test_directory_search_gives_the_plain_scores(kind, k):
    """The directory's arithmetic on the edge cases of testdata.score_case,
    the last read ending where the codes end: the same directory as
    key_directory_plain and the same mask as score_reads_plain."""
    seqs, keys = testdata.score_case(kind, k)
    bits = kernels.key_directory_bits(len(keys))
    codes, ws, nw, lens = reads.pack_part(seqs, k)
    codes = codes[:ws[-1] + lens[-1]]
    tkeys = torch.from_numpy(keys.view(np.int64))
    assert np.array_equal(_directory(keys, bits),
                          kernels.key_directory_plain(tkeys).numpy())
    for vote in (0.0, 0.5):
        want = kernels.score_reads_plain(
            *(torch.from_numpy(a) for a in (codes, ws, nw, lens)), tkeys, k,
            vote).numpy()
        got = _score_steps(codes, ws, nw, lens, keys, k, vote, bits)
        assert np.array_equal(got, want), vote
        if vote == 0.0:                 # a hit selects: some read has one
            assert got.any() == (kind != "empty")


# --- K10 pairing_rounds -----------------------------------------------------

@pytest.mark.parametrize("M", [0, 1, 2047, 2048, 2049, 4095, 4097, 70001,
                               (1 << 20) + 7, 1 << 24,
                               kernels.PAIR_M_MAX])
def test_pairing_plan_covers_every_position_once(M):
    plan = kernels.pairing_plan(20, M)
    C = plan["C"]
    assert C % 32 == 0 and 32 <= C <= kernels.PAIR_CAP_MAX
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    # window b holds [b C, (b + 1) C): disjoint, and together [0, M)
    assert plan["blocks"] * C >= M > (plan["blocks"] - 1) * C
    # int32 positions up to the keys a window reads, 2C past its start
    assert plan["blocks"] * C + 2 * C <= 2**31 - 1
    # a range of up to 2C - 1 positions, 16-byte aligned, in 2C + 4 places
    # of values, size, key, half a packed pair and flags; two blocks a SM
    assert plan["smem"] == (2 * C + 4) * (4 * 20 + 11)
    assert 2 * (plan["smem"] + kernels.PAIR_STATIC + 1024) <= kernels.SMEM_SM
    # packed pairs hold a local index in 16 bits
    assert 2 * C + 4 <= 1 << 16
    tile = plan["long_tile"]
    assert tile == plan["long_threads"] * kernels.PAIR_LONG_ITEMS
    # the count, windows' first starts, four entries a listed segment (at
    # most one a window) and a tile base, the cooperative blocks' and every
    # tile's aggregates (a segment's tiles reach past it at most once)
    assert plan["scratch"] == (2 + 5 * plan["blocks"]
                               + 3 * kernels.PAIR_LONG_GRID_MAX
                               + 3 * (-(-M // tile) + plan["blocks"]))
    assert plan["launches"] == 2


def test_pairing_plan_refuses_positions_past_int32():
    with pytest.raises(ValueError):
        kernels.pairing_plan(20, kernels.PAIR_M_MAX + 1)
    with pytest.raises(ValueError):
        kernels.pairing_plan(20, -1)
    with pytest.raises(ValueError):
        kernels.pairing_plan(-1, 10)


def test_pairing_plan_fills_the_card():
    # 132 SMs: at 2^20 and above, several blocks per SM
    for M in (1 << 20, 1 << 22, 1 << 24):
        assert kernels.pairing_plan(20, M)["blocks"] >= 3 * 132


@pytest.mark.parametrize("S,C,per_sm", [(1, 2048, 2), (20, 608, 2),
                                        (600, 32, 1)])
def test_pairing_plan_capacity(S, C, per_sm):
    """C, the most positions (a multiple of 32) whose window's range of up
    to 2C - 1 fits the blocks a SM: two at S = 1 and 20 (capped at 2048 at
    S = 1), one at S = 600."""
    plan = kernels.pairing_plan(S, 1 << 20)
    assert plan["C"] == C
    assert plan["smem"] == (2 * C + 4) * (4 * S + 11)
    room = (kernels.SMEM_SM // per_sm - 1024 - kernels.PAIR_STATIC)
    assert plan["smem"] <= room
    if C < kernels.PAIR_CAP_MAX:   # 32 more positions would not fit
        assert (2 * (C + 32) + 4) * (4 * S + 11) > room
    assert plan["smem"] <= kernels.SMEM_LIMIT - kernels.PAIR_STATIC


@pytest.mark.parametrize("S", [849, 900, 4096])
def test_pairing_plan_too_wide_sends_every_segment_to_the_second_launch(S):
    """Where not even 32 positions fit one block, C = 0: one block lists
    [0, M) and the cooperative launch takes every segment."""
    plan = kernels.pairing_plan(S, 70001)
    assert (2 * 32 + 4) * (4 * S + 11) > kernels.SMEM_LIMIT - kernels.PAIR_STATIC
    assert plan["C"] == 0 and plan["blocks"] == 1 and plan["smem"] == 0
    assert plan["launches"] == 2
    assert kernels.pairing_capacity(848) == 32


def test_pairing_plan_follows_the_source():
    src = (build.CSRC / "pairing.cu").read_text()
    for name, value in (("KL_PAIR_THREADS", kernels.PAIR_THREADS),
                        ("KL_PAIR_CAP_MAX", kernels.PAIR_CAP_MAX),
                        ("KL_LONG_THREADS", kernels.PAIR_LONG_THREADS),
                        ("KL_LONG_ITEMS", kernels.PAIR_LONG_ITEMS),
                        ("KL_LONG_GRID_MAX", kernels.PAIR_LONG_GRID_MAX)):
        assert f"#define {name} {value}" in src, name
    assert "#define KL_PAIR_POS_BYTES(S) (4 * (S) + 11)" in src
    assert "#define KL_PAIR_M_MAX (0x7FFFFFFF - 8192)" in src
    assert kernels.PAIR_M_MAX == 0x7FFFFFFF - 8192
    assert "#define KL_PAIR_SMEM_MAX (232448 - 1024)" in src
    assert kernels.SMEM_LIMIT - kernels.PAIR_STATIC == 232448 - 1024
    assert ("scratch_ints != 2 + 5 * nW + 3 * KL_LONG_GRID_MAX + 3 * tiles"
            in src)


def test_pairing_rounds_refuses_bad_arguments():
    z = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros((2, 4), dtype=torch.float32)
    for shift, rounds in ((-1, 1), (31, 1), (0, -1)):
        with pytest.raises(ValueError):
            kernels.pairing_rounds(v, z, z, z, shift, 0.9, rounds)


# --- draw_planes ---------------------------------------------------------------

def _fma64(a, b, c):
    """kl_fma64: a float64 product and sum, rounded once to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _xla_log(x):
    f = np.float32
    m, ex = np.frexp(x)
    small = m < f(0.707106781186547524)
    e = ex.astype(f) - small.astype(f)
    t = (m - f(1)) + np.where(small, m, f(0))
    t2 = t * t
    t3 = t2 * t
    p = [f(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                        -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                        2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
    y, y1, y2 = (_fma64(t, p[0], p[1]), _fma64(t, p[3], p[4]),
                 _fma64(t, p[6], p[7]))
    y, y1, y2 = _fma64(y, t, p[2]), _fma64(y1, t, p[5]), _fma64(y2, t, p[8])
    y = _fma64(_fma64(y, t3, y1), t3, y2) * t3
    y = _fma64(f(-2.12194440e-4), e, y)
    return ((t - t2 * f(0.5)) + y) + f(0.693359375) * e


def _xla_log1p(x):
    from kmerlsh_tpu_torch.ops import xlamath

    x2 = x * x
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for c in xlamath._LOG1P_NUM:
        num = _fma64(num, x, np.float32(c))
    for c in xlamath._LOG1P_DEN:
        den = _fma64(den, x, np.float32(c))
    r = _fma64(np.float32(-0.5), x2, (x * x2) * (num / den))
    return np.where(np.abs(x) < np.float32(xlamath._LOG1P_SMALL), x + r,
                    _xla_log(np.float32(1) + x))


def _kernel_normal_of_bits(bits: np.ndarray, below: np.ndarray) -> np.ndarray:
    """kl_normal_of_bits_f in numpy float32 (each op rounded once), with
    the table ``below`` of kl_twin_sqrt."""
    from kmerlsh_tpu_torch.ops import rng

    f = np.float32
    lo = np.array([0xBF7FFFFF], np.uint32).view(f)[0]
    mant = ((bits >> 9) | 0x3F800000).astype(np.uint32).view(f)
    u = np.maximum(lo, (mant - f(1)) * (f(1) - lo) + lo)
    w = -_xla_log1p(-(u * u))
    small = w < f(5)
    s = np.sqrt(w)
    s = np.where(np.isin(w.view(np.uint32), below),
                 (s.view(np.uint32) - 1).view(f), s)
    w = np.where(small, w - f(2.5), s - f(3))
    p = np.where(small, f(rng._ERFINV_SMALL[0]), f(rng._ERFINV_LARGE[0]))
    for a, b in zip(rng._ERFINV_SMALL[1:], rng._ERFINV_LARGE[1:]):
        p = _fma64(p, w, np.where(small, f(a), f(b)))
    e = np.where(np.abs(u) == 1, u * np.finfo(f).max, p * u)
    return f(1.4142135623730951) * e


def _threefry(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    a, b = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            a = a + b
            b = ((b << np.uint32(r)) | (b >> np.uint32(32 - r))) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _sqrt_table() -> np.ndarray:
    import re

    src = (build.CSRC / "planes.cu").read_text()
    body = re.search(r"kl_sqrt_below\[KL_SQRT_BELOW\] = \{([^}]*)\}", src)
    return np.array([int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u",
                                                    body.group(1))], np.uint32)


@pytest.mark.parametrize("seed,iterations,s", [(0, 3, 124), (2**32 - 1, 2, 20),
                                               (2100000013, 101, 1)])
def test_draw_planes_kernel_in_numpy_is_the_twin(seed, iterations, s):
    """kl_draw_planes_kernel transcribed into numpy: thread g folds the key
    of iteration g / (31 s), hashes counter g % (31 s) and maps the bits."""
    from kmerlsh_tpu_torch.ops import rng

    g = np.arange(iterations * s * 31, dtype=np.int64)
    it, i = (g // (31 * s)).astype(np.uint32), (g % (31 * s)).astype(np.uint32)
    zero = np.zeros_like(it)
    with np.errstate(over="ignore"):
        k0, k1 = _threefry(zero, np.full_like(it, seed), zero, it)
        a, b = _threefry(k0, k1, zero, i)
    got = _kernel_normal_of_bits(a ^ b, _sqrt_table())
    want = rng.draw_planes(seed, iterations, s).numpy().reshape(-1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_of_bits_in_numpy_is_the_twin_on_the_tails():
    """kl_normal_of_bits_f in numpy equals rng.normal_of_bits on every
    mantissa whose |u| > 0.99 (log1p's log branch, erfinv's sqrt branch and
    the sqrt table) and on every 61st of the rest."""
    from kmerlsh_tpu_torch.ops import rng

    m = np.arange(1 << 23, dtype=np.uint32)
    u = (m.astype(np.float64) * 2 ** -22 - 1)
    m = m[(np.abs(u) > 0.99) | (m % 61 == 0)]
    bits = m << np.uint32(9)
    with np.errstate(divide="ignore", invalid="ignore"):
        got = _kernel_normal_of_bits(bits, _sqrt_table())
    want = rng.normal_of_bits(torch.from_numpy(bits.astype(np.int64)))
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
