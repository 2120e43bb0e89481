"""Command-line interface of the PyTorch port: the flags of
kmerlsh_tpu/cli.py (flag-compatible with the reference ``kmerLSH``) plus
``--device``.

Modes K, B, C and E run, clustering and testing on ``--device``. With
``--coordinator host:port --num-processes N --process-id i`` the same
command on N processes forms a ``torch.distributed`` group, one rank per
process: ``--device cuda`` then puts each rank on ``cuda:<local rank %
device count>`` (NCCL when the host's ranks have a card each, gloo when they
share one), ``--device cpu`` runs every rank on the CPU (gloo). A matrix of
more rows than ``--batch-thresh`` (lowered to what the cards' memory holds,
the same batch on every rank) runs out of core, on one process or sharded
over the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.parallel import multihost
from kmerlsh_tpu_torch.pipeline import kmer_cluster


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kmerlsh-torch",
        description="Clustering of k-mers from two metagenome groups "
                    "(PyTorch and CUDA)",
    )
    d = HyperParams()
    p.add_argument("-a", "--input1", required=True,
                   help="input sample list for metagenome group A")
    p.add_argument("-b", "--input2", required=True,
                   help="input sample list for metagenome group B")
    p.add_argument("-o", "--output1", default="",
                   help="prefix for extracted reads of group A")
    p.add_argument("-p", "--output2", default="",
                   help="prefix for extracted reads of group B")
    p.add_argument("-I", "--cluster_iteration", type=int,
                   default=d.cluster_iteration, help="LSH iterations")
    p.add_argument("-N", "--min_similarity", type=float,
                   default=d.min_similarity, help="minimum cosine similarity")
    p.add_argument("-K", "--kmer_size", type=int, default=d.k,
                   help="k-mer size (at most 31)")
    p.add_argument("-T", "--threads_to_use", type=int, default=d.threads_to_use,
                   help="threads for KMC etc.")
    p.add_argument("-X", "--max-memory", type=int, default=d.max_memory,
                   dest="max_memory", help="max memory (GB) for KMC")
    p.add_argument("-C", "--count-min", type=int, default=d.count_min,
                   dest="count_min", help="min k-mer count for KMC")
    p.add_argument("-S", "--size_thresh", type=int, default=d.size_thresh,
                   help="cluster size threshold for the t-test")
    p.add_argument("-P", "--pval_thresh", type=float, default=d.pval_thresh,
                   help="p-value threshold")
    p.add_argument("-V", "--kmer_vote", type=float, default=d.kmer_vote,
                   help="differential-k-mer vote fraction for read extraction")
    p.add_argument("-F", "--clust_file_name", default=d.clust_file_name,
                   help="clustering result file name")
    p.add_argument("-D", "--tmp_dir", default=d.tmp_dir,
                   help="directory for out-of-core batch files")
    p.add_argument("-M", "--mode", default="",
                   help="K: kmc, B: bin, C: clustering, E: extract")
    p.add_argument("--only", action="store_true",
                   help="run only the stage given by --mode")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--seed", type=int, default=d.seed,
                   help="PRNG seed for hyperplanes (deterministic runs)")
    p.add_argument("--engine", choices=["tpu", "greedy"], default=d.engine,
                   help="clustering engine: tpu, the LSH engine on "
                        "--device; greedy, the reference's greedy "
                        "clustering on the host (always out of core)")
    p.add_argument("--work-dir", default=d.work_dir,
                   help="directory for kmer_set.hex/kmer_count.bin artifacts")
    p.add_argument("--batch-thresh", type=int, default=d.batch_thresh,
                   help="out-of-core batch size in k-mer rows")
    p.add_argument("--merge-rounds", type=int, default=d.merge_rounds,
                   help="rounds a pairing-merge iteration runs "
                        "(engine merge=\"pairing\"); inert on the CLI, "
                        "whose engine runs the chain merge, as in the "
                        "reference")
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--read-scorer",
                   choices=["auto", "host", "native", "device"],
                   default=d.read_scorer,
                   help="mode-E read scorer: auto takes native when it is "
                        "built; device runs the CUDA scorer on --device")
    p.add_argument("--coordinator", default=d.coordinator,
                   help="multi-process: torch.distributed rendezvous "
                        "host:port (run the same command in every process)")
    p.add_argument("--num-processes", type=int, default=d.num_processes,
                   help="multi-process: total process count")
    p.add_argument("--process-id", type=int, default=d.process_id,
                   help="multi-process: this process's id (0-based)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the clustering session and the "
                        "mode-E t-test; multi-process, a bare cuda takes "
                        "the rank's local card")
    return p


def params_from_args(argv: list[str]) -> tuple[HyperParams, str]:
    a = build_parser().parse_args(argv)
    params = HyperParams(
        input1=a.input1, input2=a.input2, output1=a.output1, output2=a.output2,
        clust_file_name=a.clust_file_name, tmp_dir=a.tmp_dir,
        work_dir=a.work_dir, cluster_iteration=a.cluster_iteration,
        min_similarity=a.min_similarity, k=a.kmer_size,
        threads_to_use=a.threads_to_use, max_memory=a.max_memory,
        count_min=a.count_min, size_thresh=a.size_thresh,
        pval_thresh=a.pval_thresh, kmer_vote=a.kmer_vote,
        verbose=a.verbose, seed=a.seed, engine=a.engine,
        batch_thresh=a.batch_thresh, merge_rounds=a.merge_rounds,
        trace_dir=a.trace_dir, read_scorer=a.read_scorer,
        coordinator=a.coordinator, num_processes=a.num_processes,
        process_id=a.process_id,
    )
    params.apply_mode(a.mode, a.only)
    if params.k > 31:
        sys.exit("error: -K/--kmer_size must be at most 31")
    return params, a.device


def main(argv: list[str] | None = None) -> None:
    params, device = params_from_args(sys.argv[1:] if argv is None else argv)
    device = multihost.maybe_initialize(params, device)
    try:
        _run(params, device)
    finally:
        multihost.shutdown()


def _run(params: HyperParams, device: str) -> None:
    if params.verbose:
        print("************ kmers Cluster Params Setting ****************")
        for field, val in vars(params).items():
            print(f"{field}: {val}")
        print(f"device: {device}")
        print("**********************************************************")
    if params.trace_dir:
        from torch import profiler

        ctx = profiler.profile(
            activities=[profiler.ProfilerActivity.CPU,
                        profiler.ProfilerActivity.CUDA],
            on_trace_ready=profiler.tensorboard_trace_handler(
                params.trace_dir))
    else:
        ctx = contextlib.nullcontext()
    try:
        with ctx:
            t0 = time.perf_counter()
            kmer_cluster(params, device)
            wall = time.perf_counter() - t0
    except FileNotFoundError as e:
        sys.exit(f"error: {e.filename or e}: no such file")
    # the wall: the stages nest (C_cluster holds device_seconds), so their
    # sum would count time twice
    print(f"kmerlsh pipeline total (secs): {wall:.3f}")


if __name__ == "__main__":
    main()
