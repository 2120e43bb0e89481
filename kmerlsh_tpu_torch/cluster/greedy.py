# Copy of kmerlsh_tpu/cluster/greedy.py, unchanged: it imports only math and
# numpy.
"""Host-side reference-faithful greedy LSH clustering (the oracle engine).

A deterministic NumPy re-implementation of ``Cluster`` / ``p_cluster`` /
``nestedCluster`` (function/cluster.cc:56-340) used for parity tests and
small inputs. Semantics preserved:

  * threshold anneals 0.95 → min_similarity in ``iterations`` equal steps
    (cluster.cc:190-192,330);
  * per iteration: h = ⌊log2 n⌋ fresh N(0,1) hyperplanes; bucket key packs
    sign bits big-endian with ``sum >= 0 → 1`` (hash/lshash.cc:44-59);
  * within a bucket, the greedy first-match merge of ``p_cluster``
    (cluster.cc:56-87) including the swap-from-end deletion order;
  * merged centroid = size-weighted mean, ids = current ++ candidate
    (``AB::SetConsensus``, funcAB.cc:49-71);
  * buckets larger than ``bucket_size_threshold`` get one recursive
    re-partition with fresh hyperplanes before greedy merging
    (``nestedCluster``, cluster.cc:89-178,286-288).

The only divergence: randomness is a seeded ``np.random.Generator`` and
bucket member order is deterministic slot order (the reference's order is
OpenMP thread interleave, nondeterministic run-to-run).
"""

from __future__ import annotations

import math

import numpy as np


def _bucket_keys(values: np.ndarray, rng: np.random.Generator, h: int) -> np.ndarray:
    hyper = rng.normal(size=(values.shape[1], h)).astype(np.float32)
    bits = (values @ hyper) >= 0
    weights = (1 << np.arange(h - 1, -1, -1)).astype(np.int64)
    return bits @ weights


def _cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    denom = math.sqrt(float(a @ a)) * math.sqrt(float(b @ b))
    return float(a @ b) / denom if denom else 0.0


def _p_cluster(members: list, values: list, sizes: list, threshold: float):
    """Exact p_cluster greedy semantics over one bucket (lists mutated)."""
    size = len(values)
    i = 1
    while i < size:
        j = 0
        merged = False
        while j < i:
            if _cosine_sim(values[i], values[j]) >= threshold:
                tot = sizes[i] + sizes[j]
                values[j] = (
                    values[i] * (sizes[i] / tot) + values[j] * (sizes[j] / tot)
                )
                members[j] = members[i] + members[j]  # current ++ candidate
                sizes[j] = tot
                size -= 1
                values[i], members[i], sizes[i] = values[size], members[size], sizes[size]
                merged = True
                break
            j += 1
        if not merged:
            i += 1
    del values[size:], members[size:], sizes[size:]


def _cluster_pass(
    members, values, sizes, threshold, rng, bucket_size_threshold, nested: bool
):
    n = len(values)
    if n <= 1:
        return
    h = max(int(math.floor(math.log2(n))), 0)
    if h == 0:
        _p_cluster(members, values, sizes, threshold)
        return
    keys = _bucket_keys(np.stack(values), rng, h)
    buckets: dict[int, list[int]] = {}
    for idx, key in enumerate(keys):
        buckets.setdefault(int(key), []).append(idx)

    out_m, out_v, out_s = [], [], []
    for key in sorted(buckets):
        idxs = buckets[key]
        bm = [members[i] for i in idxs]
        bv = [values[i] for i in idxs]
        bs = [sizes[i] for i in idxs]
        if not nested and len(idxs) > bucket_size_threshold:
            # nestedCluster: one recursive re-partition, then greedy
            _cluster_pass(bm, bv, bs, threshold, rng, bucket_size_threshold, True)
        else:
            _p_cluster(bm, bv, bs, threshold)
        out_m += bm
        out_v += bv
        out_s += bs
    members[:], values[:], sizes[:] = out_m, out_v, out_s


def cluster(
    values: np.ndarray,
    sizes: np.ndarray | None = None,
    members: list[list[int]] | None = None,
    min_similarity: float = 0.8,
    iterations: int = 100,
    bucket_size_threshold: int = 1_000_000,
    seed: int = 0,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """Cluster rows of ``values`` [N, S]. Returns (centroids [K, S],
    sizes [K], members: per-cluster lists of input row indices)."""
    values = [np.asarray(v, dtype=np.float32) for v in np.asarray(values)]
    n = len(values)
    sizes = list(map(int, sizes)) if sizes is not None else [1] * n
    members = [list(m) for m in members] if members is not None else [[i] for i in range(n)]
    rng = np.random.default_rng(seed)

    max_similarity = 0.95  # cluster.cc:190
    sim_step = (max_similarity - min_similarity) / iterations
    threshold = max_similarity
    for it in range(iterations):
        _cluster_pass(members, values, sizes, threshold, rng,
                      bucket_size_threshold, nested=False)
        if verbose:
            print(f"[greedy] iter {it + 1}: {len(values)} clusters, "
                  f"threshold {threshold:.4f}")
        threshold -= sim_step
    return np.stack(values), np.asarray(sizes, np.int64), members
