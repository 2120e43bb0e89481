"""The launch arithmetic of the permute and chain-collapse kernels
(``kernels.permute_plan``, ``kernels.chain_plan``): what the CUDA sources
rely on, checked without the card."""

import pytest

from kmerlsh_tpu_torch import kernels

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
