"""Pipeline orchestration: modes K (count) → B (bin) → C (cluster).

Port of kmerlsh_tpu/pipeline.py for the stages this package has: the same
stage boundaries and on-disk artifacts, so the two packages can restart from
each other's files.

  K: per-sample KMC database            (external kmc or native counter)
  B: kmer_set.hex + kmer_count.bin + kmer_count.log
  C: <clust_file>{,.clust} from one single-batch session on ``device``

Not ported yet, and refused before any work starts: mode E (t-test and read
extraction), the out-of-core batch rounds (a matrix of more than
``batch_thresh`` rows) and multi-process runs.
"""

from __future__ import annotations

import os

import numpy as np

from kmerlsh_tpu.config import HyperParams
from kmerlsh_tpu.utils.timing import Stages
from kmerlsh_tpu_torch.cluster.groups import Groups, as_groups
from kmerlsh_tpu_torch.io import clusterio, counts as countsio, kmc as kmcio
from kmerlsh_tpu_torch.io.samples import get_input

# (path, mtime_ns, size, S, kmap_size, device) → (device counts [S, N], N);
# one entry: re-clustering the same matrix skips the read and the upload
_DEVICE_COUNTS_CACHE: dict = {}


def _fused_single_batch(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
    device,
) -> tuple[np.ndarray, Groups]:
    """Single-batch mode C: transform → one deep init iteration at 0.95 →
    the I-step anneal → finalize, as one engine session on ``device``."""
    import torch

    from kmerlsh_tpu_torch.cluster import engine

    bin_path = os.path.join(params.work_dir, countsio.BIN_NAME)
    S = len(v_kmers)
    v = np.asarray(v_kmers, np.float32)
    dev = torch.device(device)
    st = os.stat(bin_path)
    cache_key = (os.path.abspath(bin_path), st.st_mtime_ns, st.st_size, S,
                 kmap_size, str(dev))
    with stages.stage("read_batch"):
        cached = _DEVICE_COUNTS_CACHE.get(cache_key)
        if cached is None:
            _DEVICE_COUNTS_CACHE.clear()   # hold at most one matrix
            cmat = countsio.read_count_batch(bin_path, S, kmap_size, 0,
                                             kmap_size)
            cached = engine.upload_counts(cmat, dev)
            _DEVICE_COUNTS_CACHE[cache_key] = cached
        counts, n = cached

    i = params.cluster_iteration
    sim_step = (0.95 - params.min_similarity) / i
    schedule = np.concatenate([
        [0.95],                                   # init pass (kmerLSH.cc:487)
        0.95 - sim_step * np.arange(i),           # final anneal
    ]).astype(np.float32)
    cents, _, groups = engine.cluster_counts(
        counts, v, schedule, seed=params.seed, verbose=params.verbose, n=n)
    for key in ("device_seconds", "pull_seconds"):
        stages.times[key] = engine.LAST_SESSION[key]
    stages.record("pull_bytes", int(engine.LAST_SESSION["pull_bytes"]))
    return cents, groups


def kmer_cluster(params: HyperParams, device="cuda") -> Stages:
    """Modes K, B and C of the pipeline (= ``kmerCluster``,
    app/kmerLSH.cc:432-603), clustering on ``device``."""
    if params.extracting:
        raise NotImplementedError(
            "mode E (t-test and read extraction) is not ported to "
            "kmerlsh_tpu_torch yet: run K, B or C with --only, or use "
            "kmerlsh_tpu for mode E")
    if params.num_processes > 1 or params.coordinator:
        raise NotImplementedError(
            "multi-process runs are not ported to kmerlsh_tpu_torch yet")
    stages = Stages(params.verbose)
    samples1, kmc_names1 = get_input(params.input1)
    samples2, kmc_names2 = get_input(params.input2)
    samples = samples1 + samples2
    kmc_names = kmc_names1 + kmc_names2
    if params.verbose:
        print(f"# samples in group 1: {len(samples1)}\n"
              f"# samples in group 2: {len(samples2)}")

    kmap_size: int | None = None
    v_kmers: list[float] | None = None

    if params.kmc:
        with stages.stage("K_kmc"):
            for fq, name in zip(samples, kmc_names):
                kmcio.run_kmc(fq, name, params.k, params.count_min,
                              params.threads_to_use, params.max_memory,
                              params.work_dir, params.verbose)
    if params.bin:
        with stages.stage("B_bin"):
            kmap_size, v_kmers = countsio.build_count_matrix(
                kmc_names, params.k, params.work_dir, params.verbose)

    if params.clustering:
        if not params.bin:
            kmap_size, covs = countsio.read_log(
                os.path.join(params.work_dir, countsio.LOG_NAME))
            v_kmers = [c / kmap_size for c in covs]
        if kmap_size > params.batch_thresh:
            raise NotImplementedError(
                f"{kmap_size} rows exceed batch_thresh={params.batch_thresh}: "
                "the out-of-core batch rounds are not ported to "
                "kmerlsh_tpu_torch yet")
        with stages.stage("C_cluster"):
            cents, final_ids = _fused_single_batch(
                params, kmap_size, v_kmers, stages, device)
        clust_path = params.clust_file_name
        with stages.stage("C_save"):
            clusterio.save_result(final_ids, clust_path + ".clust",
                                  ignore_small=params.ignore_small)
            clusterio.save_binary(cents, final_ids, clust_path,
                                  ignore_small=params.ignore_small)
        stages.record("clusters", int(np.sum(
            as_groups(final_ids).sizes > params.ignore_small)))
    return stages
