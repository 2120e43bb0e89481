"""The port's Threefry keys, bits, uniforms and normals against jax.random
(partitionable layout, the installed default)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmerlsh_tpu.ops import lsh as jlsh
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
