"""Mode-E jobs: the CLI's ``--only -M E`` as a function,
``pipeline.kmer_cluster(params)``: the t-test of every cluster of the
clustering file, then each sample's extracted reads, one output file a
sample.

Set-up makes, in a new directory under ``TMPDIR``, what a user's run
reads, from the seed: source sequences of ``read_len`` bases whose
k-mer windows are the matrix's rows (``kmer_set.hex``), one profile a
source with ``shift_share`` of them shifted up in one group
(``harness.gen``), the count matrix on the card, the clustering file the
port's mode C makes of it (``engine.cluster_counts`` at the
configuration's flags, saved by ``clusterio`` as the CLI's ``C_save``
does), and ``fastq_sets`` sets of FASTQs, one of ``reads_per_fastq``
reads a sample, each set drawn from a stream of the seed of its own, with
the two sample lists of each. Job j reads set j mod ``fastq_sets``, so
that no two jobs in a row read the same files. Before each job it sets a
new mtime on the ``.clust`` file, so that every job parses it as a user's
run does (the port caches the parse by the file's mtime). Job j writes
its FASTQs under ``out/`` with prefixes of its own; only the files of the
job the check takes are kept.

The check makes the counts again from the seed, works out each cluster's
centroid from them in float64 (the mean of its members' log-abundances
over v), judges that job's verdicts against the float64 t-test of those
centroids and its FASTQs against the reads those verdicts call for
(``reference.modee``); the control is the t statistic computed in
bfloat16. The clustering (which rows form a cluster) is mode E's input,
as a user hands it over; the mode-C cells check how it is made.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from harness import gen
from reference import modee

from kmerlsh_tpu_torch import cli, pipeline
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.config import HyperParams
from kmerlsh_tpu_torch.io import clusterio

# streams of the seed (harness.gen.generator): sources, counts, FASTQ sets
SOURCES, COUNTS, FASTQS = 2, 3, 16


class Jobs:
    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.device = device
        self.n1, self.n2 = cfg["groups"]
        self.S = self.n1 + self.n2
        self.k = cfg["k"]
        self.pval, self.size_thresh = cfg["pval_thresh"], cfg["size_thresh"]
        self.vote = cfg["kmer_vote"]
        self.tmp = tempfile.TemporaryDirectory(prefix="kmerlsh-bench-")
        work = self.tmp.name
        self.hex = os.path.join(work, "kmer_set.hex")
        self.clust = os.path.join(work, "clustering_result.txt")
        self.out = os.path.join(work, "out")
        os.makedirs(self.out)

        M, L = cfg["rows"], cfg["read_len"]
        self.M, self.seed = M, seed
        n_w = L - self.k + 1
        n_src = -(-M // n_w)
        self.src_shape = (n_src, n_w)
        self.shift = (tr["shift_share"], tr["shift"])
        src = gen.random_codes((n_src, L), gen.generator(seed, device,
                                                         SOURCES), device)
        keys = gen.window_keys(src, self.k).reshape(-1)[:M]
        gen.unflip(keys).astype(">u8").tofile(self.hex)
        del keys
        counts = self._counts()
        cents, _, groups = engine.cluster_counts(
            counts, gen.coverage_offsets(counts),
            gen.schedule(cfg["cluster_iteration"], cfg["min_similarity"]),
            seed=seed % 2**32, n=M)
        del counts
        ignore = HyperParams.ignore_small    # the CLI's C_save drops these
        clusterio.save_result(groups, self.clust + ".clust",
                              ignore_small=ignore)
        clusterio.save_binary(cents, groups, self.clust, ignore_small=ignore)
        del cents, groups

        n = cfg["reads_per_fastq"]
        self.sets, self.params = [], []
        for r in range(tr["fastq_sets"]):
            folder = os.path.join(work, f"set{r:02d}")
            os.makedirs(folder)
            g = gen.generator(seed, device, FASTQS + r)
            codes = gen.fastq_codes(src, self.S * n, g, tr["copy_share"],
                                    tr["substitution"]).cpu().numpy()
            samples = []
            for i in range(self.S):
                path = os.path.join(folder, f"sample{i:03d}.fastq")
                with open(path, "wb") as f:
                    f.write(gen.fastq_records(codes[i * n:(i + 1) * n]))
                samples.append(path)
            del codes
            lists = []
            for name, part in (("l1", samples[:self.n1]),
                               ("l2", samples[self.n1:])):
                lists.append(os.path.join(folder, name))
                with open(lists[-1], "w") as f:
                    for i, path in enumerate(part):
                        f.write(f"{path} {name}db{i}\n")
            self.sets.append(samples)
            self.params.append(cli.params_from_args([
                "-a", lists[0], "-b", lists[1], "--work-dir", work,
                "-F", self.clust, "-K", str(self.k), "--only", "-M", "E",
                "-S", str(self.size_thresh), "-P", str(self.pval),
                "-V", str(self.vote), "--read-scorer", tr["scorer"]])[0])
        del src
        self.reads = self.S * n
        self.scorer = tr["scorer"]
        self.mtime = os.stat(self.clust + ".clust").st_mtime_ns
        self.held = None          # (j, verdicts, output files)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    def _counts(self) -> torch.Tensor:
        """The count matrix, the same from the same seed: each source's
        profile for each of its windows, log-abundance 4 + profile + noise
        (``harness.gen``)."""
        n_src, n_w = self.src_shape
        prof = gen.source_profiles(n_src, self.S, self.n1,
                                   max(64, self.M >> 7), self.seed,
                                   self.device, *self.shift)
        rows = torch.arange(self.M, device=self.device) // n_w
        return gen.counts_of(prof, rows, gen.generator(self.seed, self.device,
                                                       COUNTS))

    def _outputs(self, j: int) -> tuple[str, str, list[str]]:
        a, b = (os.path.join(self.out, f"j{j}_{g}") for g in "AB")
        samples = self.sets[j % len(self.sets)]
        files = [f"{pre}_{os.path.basename(p)}" for pre, part in
                 ((a, samples[:self.n1]), (b, samples[self.n1:]))
                 for p in part]
        return a, b, files

    def run(self, j: int, keep: bool) -> dict:
        stamp = self.mtime + (j + 1) * 10**9
        os.utime(self.clust + ".clust", ns=(stamp, stamp))
        a, b, files = self._outputs(j)
        params = dataclasses.replace(self.params[j % len(self.params)],
                                     output1=a, output2=b)
        stages = pipeline.kmer_cluster(params, self.device)
        if pipeline.LAST_SCORER != self.scorer:
            raise RuntimeError(f"mode E ran the {pipeline.LAST_SCORER} "
                               f"scorer, not {self.scorer}")
        if keep:
            if self.held is not None:
                for f in self.held[2]:
                    os.remove(f)
            self.held = (j, np.array(pipeline.LAST_VERDICTS), files)
        else:
            for f in files:
                os.remove(f)
        return dict(j=j, reads=self.reads, wrs=stages.times["E_wrs"],
                    extract=stages.times["E_extract"])

    def check(self, control: bool = False) -> dict:
        j, got, files = self.held
        dev = self.device
        ids, offs = modee.read_clust(self.clust + ".clust", dev)
        sizes = offs[1:] - offs[:-1]
        counts = self._counts()
        cents = modee.centroids(counts, gen.coverage_offsets(counts), ids,
                                sizes)
        del counts
        left, right = modee.tails(cents, self.n1, self.n2)
        got_t = torch.from_numpy(got).to(dev)
        numbers = dict(verdict_gap=modee.verdict_gap(
            got_t, left, right, sizes, self.pval, self.size_thresh))
        keys = modee.read_hex_keys(self.hex, dev)
        member_verdict = torch.repeat_interleave(got_t, sizes)
        faults = kept = 0
        samples = self.sets[j % len(self.sets)]
        for g, part, outs in ((1, samples[:self.n1], files[:self.n1]),
                              (2, samples[self.n1:], files[self.n1:])):
            diff = torch.sort(keys[ids[member_verdict == g]]).values
            for src, out in zip(part, outs):
                with open(src, "rb") as f:
                    want = modee.expected_fastq(f.read(), diff, self.k,
                                                self.vote)
                with open(out, "rb") as f:
                    faults += modee.record_faults(f.read(), want)
                kept += len(want)
        numbers["read_faults"] = faults
        tested = sizes > self.size_thresh
        out = dict(job=j, numbers=numbers, info=dict(
            clusters=len(sizes), tested=int(tested.sum()),
            differential=int((got_t != 0).sum()), reads_extracted=kept))
        if control:
            lo_l, lo_r = modee.tails(cents, self.n1, self.n2, torch.bfloat16)
            low = modee.verdicts(lo_l, lo_r, sizes, self.pval,
                                 self.size_thresh)
            out["control"] = dict(verdict_gap=modee.verdict_gap(
                low, left, right, sizes, self.pval, self.size_thresh))
        return out

    def close(self) -> None:
        self.tmp.cleanup()


def setup(cell, seed: int, device) -> Jobs:
    return Jobs(cell, seed, device)
