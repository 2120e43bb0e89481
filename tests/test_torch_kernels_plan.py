"""What the CUDA sources rely on, checked without the card: the launch
arithmetic of the LSH-key, permute, chain-collapse and exchange-window
kernels (``kernels.lsh_plan``, ``permute_plan``, ``chain_plan``,
``window_plan``), the grouping identity of finalize's steps, and the read
scorer's prefix directory and bucket search."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
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
    assert move["smem"] == 8 * cols + 4 * cols * (W + 4)
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
    cents, csizes, lens = values_t[:, order], sizes[order], clen[order]
    off = np.cumsum(lens) - lens                          # kl_fin_place
    k = lens > 0
    link[slots[order[k]]] = off[k] - cstart[order[k]]
    cents = np.where(csizes > 0, cents, 0.0).astype(np.float32)
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
        assert np.array_equal(a, b.numpy())
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
