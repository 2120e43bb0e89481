"""Mode-C jobs: one call of ``engine.cluster_counts`` a job, the entry that
``pipeline._fused_single_batch`` calls, on a count matrix that set-up made
on the card and that stays there (the warm path), with the schedule that
function builds: 0.95, then ``I`` steps annealed to ``N``. The result comes
back to the host as centroids, sizes and ``Groups``. Job j clusters with
the hyperplanes of seed (``--seed`` + j) mod 2^32.

Set-up makes the counts from the seed (``harness.gen.make_counts``, the
distribution of bench.py make_data) and v from them. The check runs the
float32 reference session (``reference.modec``) over the same counts, v,
schedule and seed as one job drawn from the seed, and compares
(``reference.compare``); the control is that session in bfloat16.
"""

from __future__ import annotations

import torch

from harness import gen
from reference import compare, modec

from kmerlsh_tpu_torch.cluster import engine


def job_seed(seed: int, j: int) -> int:
    return (seed + j) % 2**32


class Jobs:
    def __init__(self, cell, seed: int, device):
        cfg = cell.config
        self.S = sum(cfg["groups"])
        self.M = cfg["rows"]
        self.seed = seed
        self.thr = gen.schedule(cfg["cluster_iteration"],
                                cfg["min_similarity"])
        self.counts = gen.make_counts(self.M, self.S, seed, device)
        self.v = gen.coverage_offsets(self.counts)
        self.kept = int(compare.kept_rows(self.counts).sum())
        self.held = None          # (j, result) of the job the check takes

    def run(self, j: int, keep: bool) -> dict:
        cents, sizes, groups = engine.cluster_counts(
            self.counts, self.v, self.thr, seed=job_seed(self.seed, j),
            n=self.M)
        s = engine.LAST_SESSION
        if keep:
            self.held = (j, dict(cents=cents, sizes=sizes, flat=groups.flat,
                                 offsets=groups.offsets))
        return dict(j=j, rows=self.M, clusters=len(sizes),
                    programs=list(s["programs"]),
                    device_seconds=s["device_seconds"],
                    pull_seconds=s["pull_seconds"], S=self.S, kept=self.kept)

    def check(self, control: bool = False) -> dict:
        """{"numbers": the held job's numbers} and, with ``control``, the
        bfloat16 session's under "control"."""
        j, res = self.held
        self.held = None
        if self.counts.is_cuda:
            torch.cuda.empty_cache()
        seed = job_seed(self.seed, j)
        ref = modec.session(self.counts, self.v, self.thr, seed)
        out = dict(job=j, numbers=compare.numbers(
            compare.as_device(res, self.counts.device), ref, self.counts,
            self.v), info=dict(clusters=len(res["sizes"]),
                               reference_clusters=len(ref["sizes"])))
        if control:
            low = modec.session(self.counts, self.v, self.thr, seed,
                                torch.bfloat16)
            out["control"] = compare.numbers(low, ref, self.counts, self.v)
        return out


    def close(self) -> None:
        self.counts = None


def setup(cell, seed: int, device) -> Jobs:
    return Jobs(cell, seed, device)
