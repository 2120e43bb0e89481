"""The port's Threefry keys, bits, uniforms and normals against jax.random
(partitionable layout, the installed default), and a session's planes
drawn at once (the draw_planes kernel's plain twin) against the
per-iteration draws."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerlsh_tpu.ops import lsh as jlsh
from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.ops import rng, xlamath

CASES = [(0, 0), (0, 5), (7, 19), (123456, 3), (2**32 - 1, 1000)]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed,it", CASES)
def test_key_data_matches_jax(seed, it):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    assert tuple(int(x) for x in jax.random.key_data(jk)) == \
        rng.fold_in(rng.PRNGKey(seed), it)


def test_known_key():
    assert rng.fold_in(rng.PRNGKey(0), 0) == (1797259609, 2579123966)


@pytest.mark.parametrize("shape", [(20, 31), (7, 31), (1001,)])
def test_bits_and_uniforms_exact(shape):
    for seed, it in CASES[:3]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        k = rng.fold_in(rng.PRNGKey(seed), it)
        jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(jb.astype(np.int64),
                              rng.random_bits(k, shape).numpy())
        lo = float(np.nextafter(np.float32(-1), np.float32(0)))
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0))
        assert np.array_equal(ju, rng.uniform(k, shape, lo, 1.0).numpy())


def test_hyperplanes_within_two_ulp():
    """The engine's draws (S = 20, 31 planes) for seeds 0-3, iterations
    0-20: float32 normals within 2 ulp of jax.random.normal. The residual
    comes from the float32 log inside erfinv, emulated (xlamath) rather than
    shared."""
    worst, differ = 0, 0
    for seed in range(4):
        for it in range(21):
            want = np.asarray(jlsh.draw_hyperplanes(
                jax.random.fold_in(jax.random.PRNGKey(seed), it), 20))
            got = rng.draw_hyperplanes(seed, it, 20)
            assert got.dtype == torch.float32 and got.shape == (20, 31)
            u = _ulps(want, got.numpy())
            worst = max(worst, int(u.max()))
            differ += int((u > 0).sum())
    assert worst <= 2
    assert differ < 0.001 * 4 * 21 * 20 * 31


def test_xla_log_emulation():
    """float32 log and log1p as XLA's CPU emitter evaluates them: exact on
    almost every input (the fused multiply-adds are emulated in float64)."""
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(1e-3, 10, 20000),
                        2.0 ** np.arange(-20, 30)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = xlamath.log(torch.from_numpy(x)).numpy()
    assert _ulps(want, got).max() <= 1
    assert (want != got).mean() < 1e-3
    y = -r.uniform(0, 0.999, 20000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(y))
    got = xlamath.log1p(torch.from_numpy(y)).numpy()
    assert _ulps(want, got).max() <= 1
    assert (want != got).mean() < 1e-3


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("iterations", [1, 101])
@pytest.mark.parametrize("s", [1, 20, 124])
@pytest.mark.parametrize("seed", [0, 7, 123456, 2**32 - 1])
def test_draw_planes_is_the_stacked_draws(seed, s, iterations):
    """A session's planes drawn at once equal each iteration's draw bit
    for bit (zeros' signs too)."""
    got = rng.draw_planes(seed, iterations, s)
    want = torch.stack([rng.draw_hyperplanes(seed, it, s)
                        for it in range(iterations)])
    assert got.shape == (iterations, s, rng.H_MAX + 1)
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


def test_draw_planes_wrapper_on_the_cpu_is_the_twin():
    before = kernels.launches["draw_planes"]
    got = kernels.draw_planes(2100000013, 5, 20, "cpu")
    assert got.device.type == "cpu"
    assert torch.equal(_bits(got), _bits(rng.draw_planes(2100000013, 5, 20)))
    assert kernels.draw_planes(3, 0, 20, "cpu").shape == (0, 20, 31)
    assert kernels.launches["draw_planes"] == before


def test_normal_of_bits_is_the_normal_draw():
    key = rng.fold_in(rng.PRNGKey(11), 4)
    bits = rng.random_bits(key, (20, 31))
    want = rng.normal(key, (20, 31))
    assert torch.equal(_bits(rng.normal_of_bits(bits)), _bits(want))
    as_int32 = (bits - ((bits >> 31) << 32)).to(torch.int32)
    assert torch.equal(_bits(kernels.normal_of_bits(as_int32)), _bits(want))


@pytest.mark.parametrize("seed", [-1, 2**32, 2**40])
def test_draw_planes_refuses_a_seed_outside_32_bits(seed):
    with pytest.raises(ValueError, match="seed"):
        rng.draw_planes(seed, 3, 20)
    with pytest.raises(ValueError, match="seed"):
        kernels.draw_planes(seed, 3, 20, "cpu")


def test_kernel_constants_are_the_twins():
    """Every constant planes.cu rounds to float32 (KL_F) is one of
    ops/rng.py's or ops/xlamath.py's, and each of theirs appears there."""
    import re

    from kmerlsh_tpu_torch.kernels import build

    src = (build.CSRC / "planes.cu").read_text()
    found = {float(v) for v in re.findall(r"KL_F\(([-+0-9.eE]+)\)", src)}
    want = {*xlamath._LOG_P, *xlamath._LOG1P_NUM, *xlamath._LOG1P_DEN,
            xlamath._SQRT_HALF, xlamath._LOG1P_SMALL, -2.12194440e-4,
            0.693359375, *rng._ERFINV_SMALL, *rng._ERFINV_LARGE,
            float(np.sqrt(2.0))}
    assert found == want


def _domain_w() -> np.ndarray:
    """The distinct float32 w >= 5 of erfinv's sqrt branch over the draw's
    2^23 uniforms (only |u| > 0.99 reach it)."""
    m = torch.arange(1 << 23, dtype=torch.int64) << 9
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = rng._uniform_of_bits(m, lo, 1.0)
    u = u[u.abs() > 0.99]
    w = -xlamath.log1p(-(u * u))
    return np.unique(w[w >= 5.0].numpy())


def test_kernel_sqrt_table_is_where_torch_sqrt_is_not_ieee():
    """planes.cu's kl_sqrt_below lists exactly the w of the draw's domain
    at which torch.sqrt on the CPU (the twin's) gives other bits than the
    correctly rounded float32 sqrt: always the float below it."""
    import re

    from kmerlsh_tpu_torch.kernels import build

    src = (build.CSRC / "planes.cu").read_text()
    body = re.search(r"kl_sqrt_below\[KL_SQRT_BELOW\] = \{([^}]*)\}", src)
    table = [int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u",
                                            body.group(1))]
    assert int(re.search(r"#define KL_SQRT_BELOW (\d+)", src).group(1)) == \
        len(table)
    assert table == sorted(set(table))
    w = _domain_w()
    got = torch.sqrt(torch.from_numpy(w)).numpy().view(np.int32)
    ieee = np.sqrt(w.astype(np.float64)).astype(np.float32).view(np.int32)
    off = got != ieee
    assert np.all(got[off] == ieee[off] - 1)
    assert w[off].view(np.uint32).tolist() == table
