"""Pipeline orchestration: modes K (count) → B (bin) → C (cluster) → E
(extract).

Port of kmerlsh_tpu/pipeline.py: the same stage boundaries and on-disk
artifacts, so the two packages can restart from each other's files.

  K: per-sample KMC database            (external kmc or native counter)
  B: kmer_set.hex + kmer_count.bin + kmer_count.log
  C: <clust_file>{,.clust} from one single-batch session on ``device``
  E: the t-test of every cluster on ``device``, then
     <output1>_<basename>, <output2>_<basename> extracted FASTQ

Not ported yet, and refused before any work starts: the out-of-core batch
rounds (a matrix of more than ``batch_thresh`` rows) and multi-process runs.
"""

from __future__ import annotations

import functools
import os
import queue
import threading

import numpy as np
import torch

from kmerlsh_tpu.config import HyperParams
from kmerlsh_tpu.utils.timing import Stages
from kmerlsh_tpu_torch.cluster.groups import Groups, as_groups
from kmerlsh_tpu_torch.io import (clusterio, counts as countsio,
                                  fastq as fastqio, kmc as kmcio)
from kmerlsh_tpu_torch.io.samples import get_input
from kmerlsh_tpu_torch.ops import reads as readops, ttest

# (path, mtime_ns, size, S, kmap_size, device) → (device counts [S, N], N);
# one entry: re-clustering the same matrix skips the read and the upload
_DEVICE_COUNTS_CACHE: dict = {}


def _fused_single_batch(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
    device,
) -> tuple[np.ndarray, Groups]:
    """Single-batch mode C: transform → one deep init iteration at 0.95 →
    the I-step anneal → finalize, as one engine session on ``device``."""
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
    """The pipeline (= ``kmerCluster``, app/kmerLSH.cc:432-603), clustering
    and testing clusters on ``device``."""
    global LAST_VERDICTS
    if params.num_processes > 1 or params.coordinator:
        raise NotImplementedError(
            "multi-process runs are not ported to kmerlsh_tpu_torch yet")
    stages = Stages(params.verbose)
    samples1, kmc_names1 = get_input(params.input1)
    samples2, kmc_names2 = get_input(params.input2)
    samples = samples1 + samples2
    kmc_names = kmc_names1 + kmc_names2
    n1, n2 = len(samples1), len(samples2)
    if params.verbose:
        print(f"# samples in group 1: {n1}\n# samples in group 2: {n2}")

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

    clust_path = params.clust_file_name

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
        with stages.stage("C_save"):
            clusterio.save_result(final_ids, clust_path + ".clust",
                                  ignore_small=params.ignore_small)
            clusterio.save_binary(cents, final_ids, clust_path,
                                  ignore_small=params.ignore_small)
        stages.record("clusters", int(np.sum(
            as_groups(final_ids).sizes > params.ignore_small)))

    if params.extracting:
        with stages.stage("E_wrs"):
            values, ids_list = clusterio.read_cluster_all(
                clust_path, len(samples))
            verdicts = ttest.wrs_verdicts(
                values, ids_list.sizes, n1, n2, params.pval_thresh,
                params.size_thresh, device)
        LAST_VERDICTS = verdicts
        keys = countsio.read_hex(os.path.join(params.work_dir,
                                              countsio.HEX_NAME))
        gk1, gk2 = diff_key_sets(keys, ids_list, verdicts)
        if params.verbose:
            print(f"# of differential kmers in group A : {len(gk1)}")
            print(f"# of differential kmers in group B : {len(gk2)}")
        with stages.stage("E_extract"):
            _extract_group(samples1, gk1, params.output1, params, device)
            _extract_group(samples2, gk2, params.output2, params, device)
        stages.record("diff_kmers_group1", len(gk1))
        stages.record("diff_kmers_group2", len(gk2))
    return stages


def diff_key_sets(keys: np.ndarray, ids_list: Groups,
                  verdicts: np.ndarray) -> list[np.ndarray]:
    """The sorted uint64 differential keys of groups 1 and 2: the
    ``kmer_set.hex`` keys of every member of a cluster with that verdict."""
    out = []
    for g in (1, 2):
        gids = ids_list.select(verdicts == g).flat.astype(np.int64)
        out.append(np.sort(keys[gids]) if len(gids)
                   else np.empty(0, np.uint64))
    return out


# the verdicts (int8 per cluster of the clustering file) of the most recent
# mode-E run, and the name of the scorer the most recent _pick_scorer call
# selected ("native" / "device" / "host"): what a caller checking a run reads
LAST_VERDICTS: np.ndarray | None = None
LAST_SCORER: str | None = None


def _pick_scorer(params: HyperParams, device):
    """Mode-E read scorer: host NumPy, the native C++ scorer, or the
    ``score_reads`` kernel on ``device`` (ops/reads.py). All come in async
    form (dispatch → zero-argument resolver), so that ``_extract_group``
    can pack the next part while the device scores this one.

    ``auto`` takes the reference's policy: the native scorer whenever the
    extension is built; without it, the device scorer when ``device`` is a
    CUDA device, else the host scorer. ``device`` is never chosen over
    native by ``auto``; ask for it with ``read_scorer="device"``."""
    global LAST_SCORER

    def sync_async(fn):
        return lambda seqs, dk, k, v: (lambda m=fn(seqs, dk, k, v): m)

    device_scorer = functools.partial(readops.score_part_device_async,
                                      device=device)
    if params.read_scorer == "device":
        LAST_SCORER = "device"
        return device_scorer
    if params.read_scorer == "host":
        LAST_SCORER = "host"
        return sync_async(readops.score_part)
    if params.read_scorer == "native":
        LAST_SCORER = "native"
        return sync_async(readops.score_part_native)
    try:
        import _kmerlsh_native  # noqa: F401

        LAST_SCORER = "native"
        return sync_async(readops.score_part_native)
    except ImportError:
        pass
    if torch.device(device).type == "cuda":
        LAST_SCORER = "device"
        return device_scorer
    LAST_SCORER = "host"
    return sync_async(readops.score_part)


def _extract_group(
    sample_files: list[str], diff_keys: np.ndarray, out_prefix: str,
    params: HyperParams, device="cuda",
) -> None:
    """= ``IOFQ::Extracting`` (io/ioFastQ.cc:161-195): one output file per
    sample named ``{out_prefix}_{basename(sample)}``.

    Pipelined three ways: a producer thread parses the next part while the
    current one scores, and with the device scorer part i+1 is dispatched
    before part i's mask is pulled, so parsing and packing, the upload and
    the kernel overlap."""
    score = _pick_scorer(params, device)
    if params.verbose:
        print(f"read scorer: {LAST_SCORER}")
    for path in sample_files:
        out = f"{out_prefix}_{os.path.basename(path)}"
        if params.verbose:
            print(f"writing to {out}")
        q: queue.Queue = queue.Queue(maxsize=2)
        prod_err: list[BaseException] = []

        def produce(p=path, q=q, prod_err=prod_err):
            # a parse failure must abort the extraction, not truncate it:
            # record it here and re-raise it after the join
            try:
                for part in fastqio.read_parts([p]):
                    q.put(part)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                prod_err.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        with open(out, "wb") as f:
            pending = None                      # (reads, mask resolver)
            while True:
                part = q.get()
                if part is None:
                    break
                resolve = score([r.seq for r in part], diff_keys,
                                params.k, params.kmer_vote)
                if pending is not None:
                    _write_selected(f, *pending)
                pending = (part, resolve)
            if pending is not None:
                _write_selected(f, *pending)
        th.join()
        if prod_err:
            raise prod_err[0]


def _write_selected(f, part, resolve) -> None:
    mask = resolve()
    fastqio.write_fastq(f, (r for r, m in zip(part, mask) if m))
