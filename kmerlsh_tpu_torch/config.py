# Copy of kmerlsh_tpu/config.py; only the comments of the port-only knobs
# changed.
"""Hyper-parameters and mode matrix.

Mirrors the reference defaults (``SetHyperParams``, app/kmerLSH.cc:128-145)
and the K/B/C/E mode-matrix semantics (``ParsingCommands``,
app/kmerLSH.cc:241-275): without ``--only``, ``-M B`` runs BCE, ``-M C`` runs
CE, ``-M E`` runs E, and default/``-M K`` runs KBCE; with ``--only`` exactly
the named stage runs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HyperParams:
    # pipeline inputs/outputs
    input1: str = ""
    input2: str = ""
    output1: str = ""
    output2: str = ""
    clust_file_name: str = "clustering_result.txt"
    tmp_dir: str = "tmp/"
    work_dir: str = "."  # directory for kmer_set.hex / kmer_count.bin / .log

    # clustering
    cluster_iteration: int = 100  # -I
    min_similarity: float = 0.80  # -N
    k: int = 23                   # -K
    # oversized-bucket re-partition cutoff (app/kmerLSH.cc:440). Honored by
    # the greedy oracle engine only: the tpu engine's chain collapse costs
    # the same regardless of bucket size, so it needs no special case
    # (cluster/engine.py docstring) and ignores this knob.
    bucket_size_threshold: int = 1_000_000
    # out-of-core batch rows (app/kmerLSH.cc:285); lowered at run time to
    # the card's memory budget (utils/hbm.py rows_budget)
    batch_thresh: int = 100_000_000

    # KMC / counting
    threads_to_use: int = 12  # -T
    max_memory: int = 12      # -X (GB, for KMC)
    count_min: int = 2        # -C

    # statistics / extraction
    size_thresh: int = 500_000  # -S
    pval_thresh: float = 0.01   # -P
    kmer_vote: float = 0.5      # -V

    # stage toggles (the mode matrix)
    kmc: bool = True
    bin: bool = True
    clustering: bool = True
    extracting: bool = True

    verbose: bool = False

    # --- framework-only knobs (no reference equivalent) ---
    seed: int = 0                 # deterministic hyperplanes (ref: random_device)
    engine: str = "tpu"           # "tpu" (the LSH engine on --device) | "greedy"
                                  # (the host greedy oracle)
    merge_rounds: int = 4         # pairing-merge rounds per LSH iteration
    ignore_small: int = 5         # final save drops clusters of size <= 5
    trace_dir: str = ""           # write a torch.profiler trace here if set
    read_scorer: str = "auto"  # "host" | "native" | "device" | "auto"
                                  # (auto = native when built, else device
                                  # on a CUDA --device, else host)
    # multi-process launch (parallel/multihost.py): every process runs the
    # same command with these three set; empty coordinator = single-process
    coordinator: str = ""         # torch.distributed rendezvous host:port
    num_processes: int = 0
    process_id: int = -1

    def apply_mode(self, mode: str, only: bool) -> None:
        """Reference mode-matrix semantics (app/kmerLSH.cc:241-275)."""
        if only:
            if mode == "K":
                self.bin = self.clustering = self.extracting = False
            elif mode == "B":
                self.kmc = self.clustering = self.extracting = False
            elif mode == "C":
                self.kmc = self.bin = self.extracting = False
            elif mode == "E":
                self.kmc = self.bin = self.clustering = False
        else:
            if mode == "B":
                self.kmc = False
            elif mode == "C":
                self.kmc = self.bin = False
            elif mode == "E":
                self.kmc = self.bin = self.clustering = False
