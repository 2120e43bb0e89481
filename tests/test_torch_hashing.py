"""The port's copy of the hash layer (kmerlsh_tpu_torch/kmer/hashing.py)
against the JAX package's: bit for bit on seeded uint64 arrays, and on the
reference's golden values."""

import numpy as np
import pytest

from kmerlsh_tpu.kmer import hashing as jhashing
from kmerlsh_tpu_torch.kmer import hashing

from test_hash_and_misc import GOLDEN


def _words(n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**64, size=n, dtype=np.uint64, endpoint=False)
    # the edge words: all bits clear, all set, and the golden inputs
    return np.concatenate([words, np.array(
        [0, 2**64 - 1] + [val for _, val, _ in GOLDEN], np.uint64)])


CASES = (
    [(f"murmur3_x64_64_u64-len{n}-seed{s}", "murmur3_x64_64_u64",
      dict(length=n, seed=s)) for n in (1, 2, 5, 8) for s in (0, 7)]
    + [("murmur3_x64_128_u64-len3", "murmur3_x64_128_u64",
        dict(length=3, seed=11))]
    + [(f"kmer_hash-k{k}", "kmer_hash", dict(k=k)) for k in (1, 15, 23, 31)]
    + [("splitmix64", "splitmix64", {})]
)


@pytest.mark.parametrize("name,kw", [(fn, kw) for _, fn, kw in CASES],
                         ids=[case for case, _, _ in CASES])
def test_hash_matches_jax_package(name, kw):
    """The same uint64 values as the JAX package's function on 4,096
    seeded words and the edge words; murmur3 also equals the compiled
    reference's golden values."""
    words = _words()
    got = getattr(hashing, name)(words.copy(), **kw)
    want = getattr(jhashing, name)(words.copy(), **kw)
    for g, w in zip(*(np.atleast_2d(np.asarray(x)) for x in (got, want))):
        assert g.dtype == np.uint64 and np.array_equal(g, w)
    if name == "murmur3_x64_64_u64" and kw["seed"] == 0:
        for length, val, h in GOLDEN:
            if length == kw["length"]:
                assert int(hashing.murmur3_x64_64_u64(
                    np.array([val], np.uint64), length)[0]) == h
