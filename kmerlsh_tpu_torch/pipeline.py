"""Pipeline orchestration: modes K (count) → B (bin) → C (cluster) → E
(extract).

Port of kmerlsh_tpu/pipeline.py: the same stage boundaries and on-disk
artifacts, so the two packages can restart from each other's files.

  K: per-sample KMC database            (external kmc or native counter)
  B: kmer_set.hex + kmer_count.bin + kmer_count.log
  C: <clust_file>{,.clust} from one single-batch session on ``device``, or
     sharded over the ranks of a multi-process run (parallel/dist.py); a
     matrix of more rows than the batch size (``batch_thresh``, lowered to
     what the cards' memory holds) goes out of core through
     tmp/N.bin{,.clust} batch rounds, each session sharded over the ranks
     of a multi-process run, as does every run of the greedy engine (on
     every rank alike)
  E: the t-test of every cluster on ``device`` (cluster-sharded over the
     ranks of a multi-process run), then
     <output1>_<basename>, <output2>_<basename> extracted FASTQ

Multi-process runs (parallel/multihost.py): every rank computes the same
clustering; rank 0 alone writes shared artifacts, behind barriers;
per-sample work (K, E's extraction) is split round-robin over the ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import queue
import threading

import numpy as np
import torch

from kmerlsh_tpu_torch import kernels
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.utils import hbm
from kmerlsh_tpu_torch.utils.timing import Stages, span
from kmerlsh_tpu_torch.cluster.groups import Groups, as_groups
from kmerlsh_tpu_torch.io import (clusterio, counts as countsio,
                                  fastq as fastqio, kmc as kmcio)
from kmerlsh_tpu_torch.io.samples import get_input
from kmerlsh_tpu_torch.ops import reads as readops, ttest
from kmerlsh_tpu_torch.parallel import multihost

# (path, mtime_ns, size, S, kmap_size, device, rank, ranks) → (device counts
# [S, N] or this rank's shard, N); one entry: re-clustering the same matrix
# skips the read and the upload
_DEVICE_COUNTS_CACHE: dict = {}


def _mesh_or_none(device):
    """The row mesh over the ranks of a multi-process run, this rank on
    ``device``; None for a single process."""
    if multihost.process_count() > 1:
        from kmerlsh_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(device)
    return None


def _fused_single_batch(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
    device,
) -> tuple[np.ndarray, Groups]:
    """Single-batch mode C: transform → one deep init iteration at 0.95 →
    the I-step anneal → finalize, as one engine session on ``device``; in
    a multi-process run, one sharded session over the ranks, each reading
    only its own columns of the count matrix."""
    from kmerlsh_tpu_torch.cluster import engine
    from kmerlsh_tpu_torch.parallel import dist

    bin_path = os.path.join(params.work_dir, countsio.BIN_NAME)
    S = len(v_kmers)
    v = np.asarray(v_kmers, np.float32)
    dev = torch.device(device)
    mesh = _mesh_or_none(dev)
    st = os.stat(bin_path)
    cache_key = (os.path.abspath(bin_path), st.st_mtime_ns, st.st_size, S,
                 kmap_size, str(dev), mesh and (mesh.rank, mesh.size))
    with stages.stage("read_batch"):
        cached = _DEVICE_COUNTS_CACHE.get(cache_key)
        if cached is None:
            _DEVICE_COUNTS_CACHE.clear()   # hold at most one matrix
            if mesh is not None:
                cached = dist.upload_counts_process_local(
                    bin_path, S, kmap_size, mesh)
            else:
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
    if mesh is not None:
        cents, _, groups = dist.cluster_counts_sharded(
            counts, v, schedule, mesh=mesh, seed=params.seed,
            verbose=params.verbose, n=n)
        session = dist.LAST_SESSION     # the single-device tail folded in
    else:
        cents, _, groups = engine.cluster_counts(
            counts, v, schedule, seed=params.seed, verbose=params.verbose,
            n=n)
        session = engine.LAST_SESSION
    for key in ("device_seconds", "pull_seconds"):
        stages.times[key] = session[key]
    stages.record("pull_bytes", int(session["pull_bytes"]))
    return cents, groups


# on-disk dtype of the tmp-round centroid files: the JAX package's <f2
# (kmerlsh_tpu/pipeline.py TMP_VALUES_DTYPE), so that either package reads
# the other's round files; its ~1e-3 relative error is far below what the
# 0.8-0.95 cosine thresholds of the merge rounds resolve. The final
# <clust_file> binary stays f32 (the reference's format).
TMP_VALUES_DTYPE = "<f2"

# floor of the merge-round window (rows a merge round reads at once); the
# window is half the batch, since a merge round's session holds f32 values
# where a batch pass's holds uint16 counts
MERGE_WINDOW_MIN = 1 << 16


def _cluster_fn(params: HyperParams, device, mesh=None):
    """(values [n, S], sizes, iterations, min_similarity, seed) →
    (centroids [K, S], sizes [K], members) through the engine ``params``
    names: the LSH engine on ``device``, sharded over ``mesh`` when one is
    given, or the host greedy oracle (on every rank alike)."""
    if params.engine == "greedy":
        from kmerlsh_tpu_torch.cluster import greedy

        def run(values, sizes, iterations, min_similarity, seed):
            return greedy.cluster(
                values, sizes=sizes, min_similarity=min_similarity,
                iterations=iterations,
                bucket_size_threshold=params.bucket_size_threshold,
                seed=seed, verbose=params.verbose)
    elif mesh is not None:
        from kmerlsh_tpu_torch.parallel import dist

        def run(values, sizes, iterations, min_similarity, seed):
            return dist.cluster_sharded(
                values, sizes, mesh=mesh, min_similarity=min_similarity,
                iterations=iterations, seed=seed, verbose=params.verbose)
    else:
        from kmerlsh_tpu_torch.cluster import engine

        def run(values, sizes, iterations, min_similarity, seed):
            # the reference's rounds: 16 at least for a single-iteration
            # pass; inert with the chain merge both packages run
            rounds = max(params.merge_rounds, 16) if iterations == 1 \
                else params.merge_rounds
            return engine.cluster(
                values, sizes, min_similarity=min_similarity,
                iterations=iterations, seed=seed, rounds=rounds,
                verbose=params.verbose, device=device)
    return run


def _add_session(params: HyperParams, stages: Stages, mesh=None) -> None:
    """Add the most recent session's device and pull seconds and pull
    bytes into ``stages``: the sharded session's on a mesh (its
    single-device tail already folded in), else the engine's; nothing for
    the host greedy engine."""
    if params.engine == "greedy":
        return
    if mesh is not None:
        from kmerlsh_tpu_torch.parallel import dist

        _add_split(stages, dist.LAST_SESSION)
    else:
        from kmerlsh_tpu_torch.cluster import engine

        _add_split(stages, engine.LAST_SESSION)


def _add_split(stages: Stages, session: dict) -> None:
    """Add a session's device and pull seconds and pull bytes (its
    LAST_SESSION, or a deferred pull's stats) into ``stages``."""
    for key in ("device_seconds", "pull_seconds"):
        stages.add(key, session[key])
    stages.tally("pull_bytes", int(session["pull_bytes"]))


def _defers(bs: int, S: int, device) -> bool:
    """Whether a single-card batch pass of ``bs`` rows defers its pull and
    tmp save to the flush thread: when the batch is at most half of what
    the card holds (the static ``hbm.rows_budget(S, 1)``), so that the
    next session fits beside the finalize outputs the pull still holds
    (the JAX package's condition, kmerlsh_tpu/pipeline.py:246)."""
    return bs <= hbm.rows_budget(S, 1, device=device) // 2


def init_clustering(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
    device="cuda",
) -> tuple[np.ndarray, Groups]:
    """Out-of-core batched pre-clustering (app/kmerLSH.cc:278-430): each
    ``batch_thresh``-row slice of the count matrix once at threshold 0.95
    (the seed + 1 a batch), then the tmp round files merged again in rounds
    (similarity − 0.001 a round, 5 iterations a window of
    max(MERGE_WINDOW_MIN, batch / 2) rows) until at most one window is
    left; each round's files are deleted once the next is written. Returns
    the survivors of the last round (centroids [K, S], ids).

    In a multi-process run every rank computes the same clustering: each
    LSH session is sharded over the ranks (a batch that every rank reads
    through ``dist.cluster_counts_sharded``, a merge window through
    ``dist.cluster_sharded``), and the greedy engine runs alike on every
    rank. Rank 0 alone writes the round files. A barrier ends every round
    (the batch passes are round 0): after it every rank reads the round's
    files, and rank 0 deletes the round before it.

    On one process with the LSH engine, a batch pass that :func:`_defers`
    leaves its pull to a flush thread: the session returns once its
    finalize has run (``engine.cluster_counts(defer_pull=True)``), and at
    the top of the next batch a thread pulls it on a side stream,
    translates its ids and appends it to the round files, while this
    thread reads the next batch and runs its session. The flush thread is
    joined after that session, so that the batches are appended in order;
    the last batch is flushed here, and an error of a flush is raised
    here after its batch. Sharded sessions and the greedy engine run their
    batches one after another. The stages get ``tmp_rounds`` (the cluster
    count after the batch passes and after each merge round) and
    ``tmp_bytes`` (the bytes of every round file written)."""
    from kmerlsh_tpu_torch.cluster import engine
    from kmerlsh_tpu_torch.parallel import dist

    mesh = _mesh_or_none(device)
    cluster = _cluster_fn(params, device, mesh)
    proc0 = multihost.proc0()
    os.makedirs(params.tmp_dir, exist_ok=True)
    bin_path = os.path.join(params.work_dir, countsio.BIN_NAME)
    S = len(v_kmers)
    v = np.asarray(v_kmers, np.float32)
    similarity = params.min_similarity
    batch = params.batch_thresh
    seed = params.seed
    write_path = os.path.join(params.tmp_dir, "0.bin")
    totals: list[int] = []
    stages.metrics["tmp_rounds"] = totals
    stages.metrics["tmp_bytes"] = 0

    def save(cents, ids_list, first: bool) -> None:
        if proc0:
            with stages.stage("save_tmp"):
                clusterio.save_result(ids_list, write_path + ".clust",
                                      append=not first, ignore_small=0)
                clusterio.save_binary(cents, ids_list, write_path,
                                      append=not first, ignore_small=0,
                                      dtype=TMP_VALUES_DTYPE)
        totals[-1] += len(ids_list)

    def end_round(name: str) -> None:
        """Every rank past the round's writes, then its files counted."""
        multihost.barrier(name)
        stages.metrics["tmp_bytes"] += sum(
            os.path.getsize(write_path + ext) for ext in ("", ".clust"))

    def save_batch(cents, groups, ids, first: bool) -> None:
        # groups are sorted within and the ids monotone: the translation
        # keeps each group ascending
        with stages.stage("regroup"):
            ids_list = groups.map_ids(ids)
        save(cents, ids_list, first)

    errs: list[BaseException] = []

    def flush(finish, stats, ids, first: bool) -> None:
        """A deferred batch's pull, split and save (the flush thread's)."""
        try:
            cents, _, groups = finish()
            _add_split(stages, stats)
            save_batch(cents, groups, ids, first)
        except BaseException as e:  # noqa: BLE001 — raised by the driver
            errs.append(e)

    totals.append(0)
    pending = None      # (finish, stats, ids, first) of a deferred batch
    th = None
    try:
        for offset in range(0, kmap_size, batch):
            if pending is not None:
                th = threading.Thread(target=flush, args=pending,
                                      daemon=True)
                th.start()
                pending = None
            bs = min(batch, kmap_size - offset)
            with stages.stage("read_batch"):
                cmat = countsio.read_count_batch(bin_path, S, kmap_size,
                                                 offset, bs)
            if params.verbose:
                print(f"batch @{offset}: {bs} rows")
            if params.engine == "greedy":
                with stages.stage("transform"):
                    counts, _ = engine.upload_counts(cmat, device)
                    values_t, keep = kernels.abundance_transform(
                        counts, torch.from_numpy(v).to(counts.device))
                    keep = keep.cpu().numpy() > 0
                    values = values_t.cpu().numpy().T[keep]
                ids = (offset + np.flatnonzero(keep)).astype(np.uint64)
                with stages.stage("cluster_batch"):
                    cents, _, groups = cluster(values, None, 1, similarity,
                                               seed)
                with stages.stage("regroup"):
                    ids_list = Groups.from_list(
                        [np.sort(ids[g]) for g in groups], dtype=np.uint64)
                save(cents, ids_list, offset == 0)
            else:
                # iteration 0 of a one-threshold schedule is the
                # reference's deep init pass at 0.95 (kmerLSH.cc:323,487)
                init = np.asarray([0.95], np.float32)
                ids = (offset + np.arange(bs)).astype(np.uint64)
                defer = mesh is None and _defers(bs, S, device)
                with stages.stage("cluster_batch"):
                    if mesh is not None:
                        out = dist.cluster_counts_sharded(
                            cmat, v, init, mesh=mesh, seed=seed,
                            verbose=params.verbose)
                    else:
                        out = engine.cluster_counts(
                            cmat, v, init, seed=seed, verbose=params.verbose,
                            device=device, defer_pull=defer)
                if th is not None:
                    th.join()
                    th = None
                if defer:
                    finish, stats = out
                    pending = (finish, stats, ids, offset == 0)
                else:
                    _add_session(params, stages, mesh)
                    cents, _, groups = out
                    save_batch(cents, groups, ids, offset == 0)
            if errs:
                raise errs[0]
            seed += 1
    finally:
        if th is not None:
            th.join()
    if pending is not None:
        flush(*pending)
    if errs:
        raise errs[0]
    end_round("tmp_round_0")

    vbatch = max(MERGE_WINDOW_MIN, batch // 2)
    tmp_no = 0
    while totals[-1] > vbatch:
        similarity -= 0.001  # kmerLSH.cc:356
        read_path = write_path
        tmp_no += 1
        write_path = os.path.join(params.tmp_dir, f"{tmp_no}.bin")
        remaining = totals[-1]
        totals.append(0)
        for start in range(0, remaining, vbatch):
            with stages.stage("read_tmp"):
                values, ids_list = clusterio.read_cluster(
                    read_path, S, start, min(vbatch, remaining - start),
                    dtype=TMP_VALUES_DTYPE)
            with stages.stage("cluster_merge_round"):
                cents, _, groups = cluster(values,
                                           ids_list.sizes.astype(np.int32),
                                           5, similarity, seed)
            _add_session(params, stages, mesh)
            seed += 1
            with stages.stage("regroup"):
                ids_list = ids_list.regroup(groups)
            save(cents, ids_list, start == 0)
        # every rank has read the previous round: rank 0 deletes it
        end_round(f"tmp_round_{tmp_no}")
        if proc0:
            os.remove(read_path)
            os.remove(read_path + ".clust")
        if params.verbose:
            print(f"merge round {tmp_no}: {totals[-1]} clusters at "
                  f"{similarity:.3f}")
    return clusterio.read_cluster_all(write_path, S, dtype=TMP_VALUES_DTYPE)


def kmer_cluster(params: HyperParams, device="cuda") -> Stages:
    """The pipeline (= ``kmerCluster``, app/kmerLSH.cc:432-603), clustering
    and testing clusters on ``device``."""
    global LAST_VERDICTS, LAST_STAGES
    stages = LAST_STAGES = Stages(params.verbose)
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
            # per-sample counting splits round-robin across ranks
            for fq, name in multihost.my_items(list(zip(samples, kmc_names))):
                kmcio.run_kmc(fq, name, params.k, params.count_min,
                              params.threads_to_use, params.max_memory,
                              params.work_dir, params.verbose)
            multihost.barrier("K_kmc")
    if params.bin:
        with stages.stage("B_bin"):
            # shared artifacts (hex/bin/log) are written by rank 0 only
            if multihost.proc0():
                kmap_size, v_kmers = countsio.build_count_matrix(
                    kmc_names, params.k, params.work_dir, params.verbose)
            multihost.barrier("B_bin")
            if not multihost.proc0():
                kmap_size, covs = countsio.read_log(
                    os.path.join(params.work_dir, countsio.LOG_NAME))
                v_kmers = [c / kmap_size for c in covs]

    clust_path = params.clust_file_name

    if params.clustering:
        if not params.bin:
            kmap_size, covs = countsio.read_log(
                os.path.join(params.work_dir, countsio.LOG_NAME))
            v_kmers = [c / kmap_size for c in covs]
        # the batch size the cards' memory holds, the same on every rank
        # (the reference's 1e8 constant assumed host RAM,
        # kmerLSH.cc:285,292-295)
        eff_batch = min(params.batch_thresh,
                        hbm.batch_budget(len(v_kmers), kmap_size, device))
        if params.verbose and eff_batch < params.batch_thresh:
            print(f"batch_thresh {params.batch_thresh} -> {eff_batch} "
                  f"(device memory budget)")
        params = dataclasses.replace(params, batch_thresh=eff_batch)
        if params.engine == "tpu" and kmap_size <= eff_batch:
            with stages.stage("C_cluster"):
                cents, final_ids = _fused_single_batch(
                    params, kmap_size, v_kmers, stages, device)
        else:
            with stages.stage("C_init_clustering"):
                values, ids_list = init_clustering(
                    params, kmap_size, v_kmers, stages, device)
            mesh = _mesh_or_none(device)
            with stages.stage("C_cluster"):
                cents, _, groups = _cluster_fn(params, device, mesh)(
                    values, ids_list.sizes.astype(np.int32),
                    params.cluster_iteration, params.min_similarity,
                    params.seed + 10_000)
            _add_session(params, stages, mesh)
            with stages.stage("regroup"):
                final_ids = ids_list.regroup(groups)
        with stages.stage("C_save"):
            if multihost.proc0():
                clusterio.save_result(final_ids, clust_path + ".clust",
                                      ignore_small=params.ignore_small)
                clusterio.save_binary(cents, final_ids, clust_path,
                                      ignore_small=params.ignore_small)
            multihost.barrier("C_save")
        stages.record("clusters", int(np.sum(
            as_groups(final_ids).sizes > params.ignore_small)))

    if params.extracting:
        with stages.stage("E_wrs"):
            with span("E_wrs.clust_read"):
                values, ids_list = clusterio.read_cluster_all(
                    clust_path, len(samples))
            with span("E_wrs.ttest"):
                sizes = ids_list.sizes
                mesh = _mesh_or_none(device)
                if mesh is not None and len(ids_list) >= mesh.size:
                    from kmerlsh_tpu_torch.parallel import dist

                    pad = -len(ids_list) % mesh.size
                    vp = np.pad(values.astype(np.float32), ((0, pad), (0, 0)))
                    sp = np.pad(sizes.astype(np.int32), (0, pad))
                    fn = dist.sharded_wrs(mesh, n1, n2, params.pval_thresh,
                                          params.size_thresh)
                    verdicts = fn(dist.shard_rows(mesh, vp),
                                  dist.shard_rows(mesh, sp))[:len(ids_list)]
                else:
                    verdicts = ttest.wrs_verdicts(
                        values, sizes, n1, n2, params.pval_thresh,
                        params.size_thresh, device)
        LAST_VERDICTS = verdicts
        with stages.stage("E_diff_keys"):
            keys = countsio.read_hex(os.path.join(params.work_dir,
                                                  countsio.HEX_NAME))
            gk1, gk2 = diff_key_sets(keys, ids_list, verdicts)
        if params.verbose:
            print(f"# of differential kmers in group A : {len(gk1)}")
            print(f"# of differential kmers in group B : {len(gk2)}")
        with stages.stage("E_extract"):
            _extract_group(samples1, gk1, params.output1, params, device,
                           stages)
            _extract_group(samples2, gk2, params.output2, params, device,
                           stages)
        if params.verbose:
            print(f"[stage] E_extract.parse (parse thread): "
                  f"{stages.times.get('E_extract.parse', 0.0):.3f}s")
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
# mode-E run, the stages of the most recent run, and the name of the scorer
# the most recent _pick_scorer call selected ("native" / "device" /
# "host"): what a caller checking a run reads
LAST_VERDICTS: np.ndarray | None = None
LAST_STAGES: Stages | None = None
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
    params: HyperParams, device="cuda", stages: Stages | None = None,
) -> None:
    """= ``IOFQ::Extracting`` (io/ioFastQ.cc:161-195): one output file per
    sample named ``{out_prefix}_{basename(sample)}``. Multi-process: the
    samples are split round-robin across ranks.

    Pipelined three ways: a producer thread parses the next part while the
    current one scores, and with the device scorer part i+1 is dispatched
    before part i's mask is pulled, so parsing and packing, the upload and
    the kernel overlap. Spans ``E_extract.<step>``: the producer's
    ``parse`` of each part (its seconds into ``stages``), and on this
    thread ``parse_wait`` (blocked on the producer), ``score`` (the
    scorer's dispatch), ``mask`` (its resolver) and ``write``."""
    score = _pick_scorer(params, device)
    if params.verbose:
        print(f"read scorer: {LAST_SCORER}")
    for path in multihost.my_items(sample_files):
        out = f"{out_prefix}_{os.path.basename(path)}"
        if params.verbose:
            print(f"writing to {out}")
        q: queue.Queue = queue.Queue(maxsize=2)
        prod_err: list[BaseException] = []

        def produce(p=path, q=q, prod_err=prod_err):
            # a parse failure must abort the extraction, not truncate it:
            # record it here and re-raise it after the join
            try:
                parts = fastqio.read_parts([p])
                while True:
                    with span("E_extract.parse", stages):
                        part = next(parts, None)
                    if part is None:
                        break
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
                with span("E_extract.parse_wait"):
                    part = q.get()
                if part is None:
                    break
                with span("E_extract.score"):
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
    with span("E_extract.mask"):
        mask = resolve()
    with span("E_extract.write"):
        fastqio.write_fastq(f, (r for r, m in zip(part, mask) if m))
