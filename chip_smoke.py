"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the CUDA kernels from kmerlsh_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the same CUDA inputs,
     with both timed (CUDA events around 10 back-to-back calls, median of
     5 such runs after a warm-up), beside its
     bound (the bytes it must move over the card's memory rate, or its
     float32 operations over the card's rate, whichever is larger) and,
     where one PyTorch call computes the same function, that call's time
     (for lsh_keys a torch.matmul of the planes in use: the projections
     alone; for sort_keys torch.sort with int64 indices, as the port
     called it before): the mode-C kernels at 2^20 x 20, the exchange
     kernels on the 2^20 x 20 local-phase result with e = 4096 (the fold
     after a global phase over four ranks' windows, rank 1's local merges
     folded by chain_collapse at its base, which is timed with and without
     that fold), the t-test on 2^20 cluster rows of 10 + 10 samples and of
     50 + 50 (each with the continued fraction's steps: the mean a row and
     the mean of the slowest of 32 consecutive rows), the read
     scorer on one part of 2^16 reads of 150 bp against 2^22 keys (k =
     31), with the key directory it searches timed on its own (its library
     call: torch.searchsorted of each prefix's least key in the keys) and
     torch.searchsorted of the same windows in the same keys as the
     scorer's library call; then the mode-C kernels again at 2^21 x 20
     (the capacity of phase 5's late iterations), at 2^22 x 20 (phase 5b's
     batch and a phase-7 rank's head capacity: the exchange kernels there
     too) and at 2^24 x 20; at each size chain_collapse is also timed
     without the parent fold (as the global phase calls it) beside a copy
     of the bytes it streams, lsh_keys is held exact at h = 1 and 30 too,
     sort_keys exact and timed on that size's lsh_keys output (31 bits),
     each sort's kernel launches (the runtime's launch calls under
     torch.profiler) held to its plan's and logged with its route and its
     passes' floor in bytes a key, and the forest finalize takes is
     measured (depth; a pointer-jumping round by torch indexing); at 2^20
     also lsh_keys at 600 samples, finalize on the forest of 21 iterations
     and sort_keys on its edge cases (no key, one, a tile and one either
     side, the one-launch route's limit and one either side, all keys
     equal, all BIG_KEY, random 1-bit flags); sort_keys also on the
     lsh_keys output at 2^14 (the sharded global phase's 4 x 4,096 keys)
     and 2^16; at 2^24 also
     sort_keys on finalize's row keys (25 bits), on the compaction's dead
     flags (1 bit) and on finalize's cluster keys (25 bits), and the card
     time of a sort by kernel on the 31-bit and the row keys; at
     2^20, 2^22 and 2^24 also pairing_rounds (K10) on the first
     iteration's sorted state, 4 rounds at 0.95 and at 0.5 with a parent
     forest, exact against its plain version, each call timed with the
     state restored outside its CUDA events, its bound the one-pass floor
     (pairing_floor_bytes) with the per-round count beside it (no
     library call), its launches a call (the wrapper's count and the
     runtime's launch calls under torch.profiler, held to its plan's 2)
     and the segments longer than its plan's C logged; at 2^20 also
     K10 on 2^16 columns of 600 samples (C = 32: many segments take its
     cooperative launch), exact and timed; last finalize where the
     benchmark's metahit124.cluster cell runs it, on the inputs the engine
     passes it in a session of 2^24 x 124 annealed over 101 iterations
     (~1.2 M clusters), exact against its plain version, timed, and the
     pulled triple checked to hold the plain outputs' bytes; then
     chain_collapse there too, at the launch plan of the cell's width: a
     session's first iteration at 2^24 x 124, exact against K2's and K3's
     plain versions (centroids within rtol 1e-5) and timed beside their
     functions' bound; then the mode-C kernels where the benchmark's
     kostic18.cluster cell runs them, a session's first iteration at 10^8
     x 18, whose profile-major scratch holds 2.4e9 words, past 2^31:
     sort_keys on its keys, permute_state by its order and the fused
     chain_collapse (P = 256), each held to its plain twin on the 2^15-
     aligned windows of positions at the middle and at the far end of the
     order (ints exact, centroids within rtol 1e-5), and finalize on the
     transformed state as 10^8 one-row clusters (its column scratch 10^8 x
     24 words), bit for bit; each timed beside its bound; then draw_planes, a session's hyperplanes in one launch, bit for bit its
     plain twin at the benchmark cell's 101 x 124 x 31 (seeds 0,
     2100000013, 2^32 - 1) and at 101 x 20 x 31, its device function on
     all 2^23 mantissas the uniform takes, and its time beside the twin's
     and the per-iteration host draws and uploads it replaced;
  4. the CLI on the synthetic FASTQ fixture: --only K, then B, then C, then
     E with the device scorer and with the native scorer, whose extracted
     reads must agree byte for byte and recover the planted markers;
  5. full size: a 2^24 x 20 count matrix with the distribution of
     bench.py make_data, mode C through the CLI (-I 20 -N 0.8) cold and warm,
     with the mode-C kernels' launch counts, the result checked against the
     matrix recomputed on the host, and the depth of the session's forest;
     then one more warm run under torch.profiler: the card's time by kernel
     (the permute's, the chain collapse's and the key sort's kernels, each
     lsh_keys and finalize kernel, the rest; no sort kernel but K9's) and
     its idle share;
  5d. the pairing merge: phase 5's matrix through
     engine.cluster_counts(merge="pairing", rounds=4) at phase 5's
     schedule, checked as phase 5's clustering, K10 launched once a
     pairing iteration (the first iteration, the deep init pass, a chain
     collapse), the count, walls and forest depth logged beside phase
     5's; then the same session on its first 2^22 columns with K10 and
     with pairing_rounds_plain, whose clusterings must be byte-identical;
  5b. out of core: phase 5's matrix through the CLI at --batch-thresh 2^22
     (four batch passes, merge rounds, the final anneal), with the mode-C
     kernels' launch counts, the batch and round counts, the tmp bytes,
     device and pull seconds and the wall, the result checked as phase 5's
     and its count beside phase 5's; each of the first three batches'
     flushes (its deferred pull and its tmp save) must run on the flush
     thread and intersect the next batch's read and session (each
     overlap logged, the appends' own too, and the thread's share of
     save_tmp); then the bytes a row of a session measured on the card
     (hbm.measure_per_row_bytes), which must not lie below the peak of
     phase 5's cold session over its rows, and rows_budget at 20 and 400
     samples;
  5c. the flush thread: a 2^20 x 20 matrix out of core at --batch-thresh
     2^18 through the CLI, as shipped, sequential (pipeline._defers
     patched to False) and as shipped under torch.profiler: the three
     clustering files byte-identical, the tmp rounds and bytes equal, the
     deferred runs' batches flushed as phase 5b's, and in
     the traced run every deferred pull's device-to-pinned copies on a
     stream that no kernel ran on; each run's wall and batch passes'
     span logged;
  5e. the benchmark's kostic18 cohort: a 10^8 x 18 count matrix with the
     distribution of bench.py make_data, mode C through the CLI (-I 100
     -N 0.8, --batch-thresh 1e8), which must cluster it in one engine
     session (kmap_size <= eff_batch: no batch pass, one transform and one
     finalize launch), its kernels' scratch past 2^31 words; the result
     checked as phase 5's, its stage times, programs and peak logged;
  6. mode E at full size: a 2^24 x 20 matrix whose rows are the 31-mers of
     random source sequences (one abundance profile per source, a few per
     cent shifted between the groups), 20 FASTQs of 2^16 reads x 150 bp,
     mode C, then mode E four times, the device and the native scorer
     alternating, and once more with the device scorer under
     torch.profiler: the mode-E kernels' launch counts, sampled verdicts
     against a float64 recomputation, extracted reads equal between all
     runs, E_wrs and reads/s of every run, E_wrs replayed on the
     clustering file and split into the parse, the upload, the t-test
     kernel and the pull, the kernel on these cluster rows against its
     plain version, and the card's idle share in the traced run;
  7. sharded, four ranks on the one card: four kmerlsh-torch processes
     (--coordinator / --num-processes / --process-id, --device cuda, so
     all on cuda:0 over gloo) run phase 5's mode C and then phase 6's mode
     E on phase 6's clustering file. Rank 0's clustering passes phase 5's
     checks, its cluster count lies within the reference's bound for the
     tail the run took (COUNT_BOUND) of phase 5's, every rank
     launched both exchange kernels (and the t-test kernel in mode E), the
     sharded verdicts equal phase 6's bit for bit and the extracted FASTQs
     equal phase 6's byte for byte;
  7b. sharded out of core: phase 5b's run (phase 5's matrix at
     --batch-thresh 2^22) on the same four ranks, so that each batch pass
     shards 2^22 rows into four shards of 2^20 and the merge rounds and
     the final anneal run sharded too. Every rank launched the five mode-C
     kernels and both exchange kernels and counted the same clusters after
     every round (at least one merge round); rank 0 alone wrote, only the
     last round's two files remain, its clustering passes phase 5b's checks
     and its cluster count lies below phase 5b's + 15% (the terminal
     rounds that end each sharded batch pass, COUNT_BOUND). Each rank's
     wall is logged with its split (regroup, save_tmp, read_tmp, device,
     pulls), the count beside phase 5b's and phase 7's;
  8. the kernels line, the card line, and the result line last; each
     phase's wall is logged as it ends.

Any failed check raises, and the script exits non-zero without a result. It
exits non-zero at once where torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    return torch


torch = _require_cuda()

from kmerlsh_tpu_torch import kernels, pipeline, testdata  # noqa: E402
from kmerlsh_tpu_torch.cli import main as cli_main, params_from_args  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.io import clusterio, counts as countsio  # noqa: E402
from kmerlsh_tpu_torch.kernels import build  # noqa: E402
from kmerlsh_tpu_torch.ops import lsh, reads, rng, ttest  # noqa: E402
from kmerlsh_tpu_torch.parallel import dist  # noqa: E402
from kmerlsh_tpu_torch.utils import hbm  # noqa: E402

DEV = torch.device("cuda", 0)
ROOT = os.path.dirname(os.path.abspath(__file__))
S = 20
SMALL = 1 << 20
LATE = 1 << 21           # ~ the capacity of phase 5's iterations 6-20
SORT_SMALL = (1 << 14, 1 << 16)   # phase 3's smaller sorts: the sharded
                                  # global phase's 4 x 4,096 keys, and 2^16
FULL = 1 << 24
NARROW_S, NARROW_M = 18, 10**8   # the benchmark's kostic18 cohort: one
                                 # session of the upstream's batch
CELL_S = 124             # the samples of the benchmark's metahit124 cells
CELL_THR = np.r_[0.95, 0.95 - (0.95 - 0.8) / 100 * np.arange(100)].astype(
    np.float32)          # their anneal: -I 100 -N 0.8
OOC_BATCH = 1 << 22      # phase 5b's --batch-thresh: four batch passes
FLUSH_ROWS = 1 << 20     # phase 5c's matrix
FLUSH_BATCH = 1 << 18    # phase 5c's --batch-thresh: four batch passes
PAIR_ROUNDS = 4          # phase 3's and 5d's pairing rounds an iteration
PAIR_LOW = 0.5           # phase 3's threshold at which most pairs merge
PAIR_SAME = 1 << 22      # phase 5d's columns run with K10 and its plain version
RANKS = 4                # phase 7's processes, all on the one card
WIDE_S = 600             # many samples: lsh_keys' planes fill shared memory
WIDE_E = 100             # the t-test's wider rows: 50 + 50 samples
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

# kernel → (source, the reference device program it replaces)
KERNELS = {
    "abundance_transform": ("kmerlsh_tpu_torch/csrc/lsh_keys.cu",
                            "kmerlsh_tpu/ops/transform.py:33"),
    "lsh_keys": ("kmerlsh_tpu_torch/csrc/lsh_keys.cu",
                 "kmerlsh_tpu/ops/lsh.py:67"),
    "sort_keys": ("kmerlsh_tpu_torch/csrc/sort_keys.cu",
                  "kmerlsh_tpu/cluster/engine.py:117"),
    "permute_state": ("kmerlsh_tpu_torch/csrc/permute_state.cu",
                      "kmerlsh_tpu/cluster/engine.py:117"),
    "chain_collapse": ("kmerlsh_tpu_torch/csrc/chain_collapse.cu",
                       "kmerlsh_tpu/cluster/engine.py:335"),
    "finalize": ("kmerlsh_tpu_torch/csrc/finalize.cu",
                 "kmerlsh_tpu/cluster/engine.py:651"),
    "wrs_verdicts": ("kmerlsh_tpu_torch/csrc/ttest.cu",
                     "kmerlsh_tpu/ops/ttest.py:57"),
    "key_directory": ("kmerlsh_tpu_torch/csrc/reads.cu",
                      "kmerlsh_tpu/ops/reads.py:145"),
    "score_reads": ("kmerlsh_tpu_torch/csrc/reads.cu",
                    "kmerlsh_tpu/ops/reads.py:145"),
    "exchange_window": ("kmerlsh_tpu_torch/csrc/exchange.cu",
                        "kmerlsh_tpu/parallel/dist.py:66"),
    "exchange_fold": ("kmerlsh_tpu_torch/csrc/exchange.cu",
                      "kmerlsh_tpu/parallel/dist.py:85"),
    "pairing_rounds": ("kmerlsh_tpu_torch/csrc/pairing.cu",
                       "kmerlsh_tpu/cluster/engine.py:168"),
    "draw_planes": ("kmerlsh_tpu_torch/csrc/planes.cu",
                    "kmerlsh_tpu/ops/lsh.py:27"),
}
# a chain session's launches: from PR 25 its state moves into rows once
# (to_rows) and back in its compaction (permute_rows); the sharded
# iterations keep K2 (permute_state) in their capacity shrink
MODE_C = ("abundance_transform", "lsh_keys", "sort_keys", "to_rows",
          "chain_collapse", "permute_rows", "finalize", "draw_planes")
SHARDED_C = MODE_C + ("permute_state",)
MODE_E = ("wrs_verdicts", "key_directory", "score_reads")
EXCHANGE = ("exchange_window", "exchange_fold")
# Phase 7's bound on the sharded cluster count against one process's, by the
# tail the reference's decisions chose. The handoff tail replays the end of
# the anneal with one device's semantics: within 10% (the reference's
# tests/test_dist.py:205). The terminal rounds, run when the survivors never
# fit dist.HANDOFF_CAP, may depart further by design (tests/test_torch_dist.py
# measures the port's and the reference's terminal counts equal on the CPU):
# the reference bounds their rise at 15% (tests/test_dist.py:264).
COUNT_BOUND = {"handoff": (-0.10, 0.10), "terminal": (None, 0.15)}
E_ORDER = ("device", "native", "native", "device")   # phase 6's scorer runs
K_E = 31                 # k of the full-size mode-E phase
READ_LEN = 150
N_FASTQ = S              # one FASTQ per sample
FASTQ_READS = reads.READS_CAP


def log(msg: str) -> None:
    print(msg, flush=True)


def counts_of(profiles: torch.Tensor, rows: torch.Tensor,
              g: torch.Generator) -> np.ndarray:
    """uint16 [S, len(rows)]: log-abundance 4 + profile of each row + 0.01
    noise, made on the card (profiles f32 [S, P] there)."""
    vals = 4.0 + profiles[:, rows]
    vals += 0.01 * torch.randn(vals.shape, device=DEV, generator=g)
    counts = torch.clamp(torch.round(torch.expm1(vals)), 1, 65535)
    return counts.to(torch.int32).cpu().numpy().astype(np.uint16)


def make_counts(n_rows: int, seed: int = 0) -> np.ndarray:
    """uint16 [S, n_rows] with the distribution of bench.py make_data: rows
    drawn from the profile pool, log-abundance 4 + profile + 0.01 noise.
    The row draw and the noise run on the card."""
    r = np.random.default_rng(seed)
    pool = testdata.profile_pool(r, max(64, n_rows >> 7), S)
    pool = torch.from_numpy(pool.T.copy()).to(DEV)              # [S, P]
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = torch.randint(0, pool.shape[1], (n_rows,), device=DEV, generator=g)
    return counts_of(pool, rows, g)


def write_matrix(work: str, counts: np.ndarray) -> list[float]:
    """kmer_count.bin/.log and the sample lists l1/l2 of a mode-C run."""
    s, n = counts.shape
    counts.astype("<u2").tofile(os.path.join(work, countsio.BIN_NAME))
    cov = np.log(np.maximum(counts, 1).astype(np.float64)).sum(axis=1)
    with open(os.path.join(work, countsio.LOG_NAME), "w") as f:
        f.write(str(n))
        for c in cov:
            f.write("\t%f" % c)
    for name, idx in (("l1", range(s // 2)), ("l2", range(s // 2, s))):
        with open(os.path.join(work, name), "w") as f:
            for i in idx:
                f.write(f"s{i}.fastq db{i}\n")
    _, covs = countsio.read_log(os.path.join(work, countsio.LOG_NAME))
    return [c / n for c in covs]


def cuda_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Milliseconds of one fn() on the card, after one warm-up call: the
    median over ``reps`` runs of ``calls`` back-to-back calls, each run
    between two CUDA events, over ``calls`` (the host's work of one call
    then overlaps the card's work of the one before)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def cuda_ms_restored(fn, restore, reps: int = 5, calls: int = 10) -> float:
    """Milliseconds of one fn() on the card for a function that updates
    its inputs in place: ``restore()`` puts them back before each call,
    outside the CUDA events around the call; the median over ``reps`` runs
    of the sum over ``calls`` calls, over ``calls``, after a warm-up."""
    restore()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        events = []
        for _ in range(calls):
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in events) / calls)
    return float(np.median(times))


def _max_err(pairs) -> float:
    return max((float((x.double() - y.double()).abs().max()) if x.numel()
                else 0.0) for x, y in pairs)


def _exact(name: str, pairs) -> float:
    pairs = list(pairs)
    for i, (x, y) in enumerate(pairs):
        if not torch.equal(x, y):
            bad = int((x != y).sum())
            raise AssertionError(f"{name}: output {i} differs in {bad} places")
    return _max_err(pairs)


def step_stats(steps: torch.Tensor) -> str:
    """The continued fraction's steps on a row set (ttest.fraction_steps):
    the mean over the rows that run it, and the mean over each 32
    consecutive rows of the slowest one (a warp of one thread a row runs
    that long)."""
    run = steps[steps > 0].double()
    warps = torch.nn.functional.pad(steps, (0, -len(steps) % 32))
    slowest = warps.view(-1, 32).max(1).values.double()
    return (f"{len(run)} of {len(steps)} rows run the continued fraction, "
            f"{float(run.mean()) if len(run) else 0.0:.3f} steps a row on "
            f"average ({int(run.max()) if len(run) else 0} at most); the "
            f"slowest of 32 consecutive rows {float(slowest.mean()):.3f} on "
            f"average")


def bound(n_bytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take for a call (ms): the larger of
    the bytes it must move (each input read once, each output written
    once) over the memory rate and its float32 operations over the float32
    rate."""
    b, f = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return dict(bound_ms=1e3 * max(b, f),
                bound_by="bytes" if b >= f else "operations")


def timings(kernel, plain, n_bytes: float, flops: float = 0.0,
            library=None) -> dict:
    """ms of the kernel, of its plain version and of the one PyTorch call
    computing the same function (None where there is none), and the
    bound."""
    return dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library) if library else None,
                **bound(n_bytes, flops))


def log_kernels(res: dict, n: int) -> None:
    for name, r in res.items():
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "none")
        plain = (f"{r['plain_ms']:.4f} ms" if r["plain_ms"] is not None
                 else "not timed")
        log(f"kernel {name} at {n}: max_abs_err {r['max_abs_err']:.3g}  "
            f"kernel {r['ms']:.4f} ms  plain {plain}  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  library {lib}")


def sort_floor(plan: dict) -> int:
    """Bytes a key the sort's passes must move: the first scatter reads
    keys and writes keys and indices, each later one reads both and writes
    both; the histograms read the keys once more for every pass on the
    one-sweep route, once a pass on the three-launch route, never on the
    one-launch route (its tiles count their digits as they rank them)."""
    hist = dict(zip(kernels.SORT_ROUTES, (0, 4, 4 * plan["passes"])))[
        plan["route"]]
    return hist + 12 + 16 * (plan["passes"] - 1)


def sort_case(key: torch.Tensor, bits: int, what: str) -> dict:
    """sort_keys on ``key`` exact against its plain version, both timed
    beside torch.sort with int64 indices (the port's call before K9) and
    the bound; the launches of one sort counted. Returns the kernel's
    entry."""
    M = key.numel()
    k = kernels.sort_keys(key, bits)
    p = kernels.sort_keys_plain(key, bits)
    # the keys in; the sorted keys and the int32 order out
    entry = dict(max_abs_err=_exact(f"sort_keys on {what}", zip(k, p)),
                 **timings(lambda: kernels.sort_keys(key, bits),
                           lambda: kernels.sort_keys_plain(key, bits),
                           12 * M,
                           library=lambda: torch.sort(key, stable=True)))
    plan = kernels.sort_plan(M, bits)
    launched = sort_launches(key, bits)
    if launched != plan["launches"]:
        raise AssertionError(f"sort_keys on {what}: {launched} kernel "
                             f"launches, the plan says {plan['launches']}")
    floor = sort_floor(plan)
    log(f"sort_keys on {what}: {M} keys of {bits} bits in "
        f"{plan['passes']} passes of {plan['digit']}-bit digits on the "
        f"{plan['route']} route, {launched} launches, exact; kernel "
        f"{entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  bound "
        f"{entry['bound_ms']:.4f} ms  torch.sort {entry['library_ms']:.4f} "
        f"ms  ratio {entry['ms'] / entry['library_ms']:.3f}; the passes' "
        f"floor {floor} bytes a key, {bound(floor * M)['bound_ms']:.4f} ms")
    return entry


def traced_launches(fn, n: int = 1):
    """n calls of fn() under torch.profiler, after one untraced: ({kernel
    name: (card ms, launches)}, the CUDA runtime's kernel launch calls);
    memsets are not kernels."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as trace:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by, calls = {}, 0
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").split("(")[0]
            if name.startswith("Memset"):
                continue
            ms, c = by.get(name, (0.0, 0))
            by[name] = (ms + (e.time_range.end - e.time_range.start) * 1e-3,
                        c + 1)
        elif e.name.startswith("cudaLaunch"):
            calls += 1
    return by, calls


def sort_events(key: torch.Tensor, bits: int, n: int = 1):
    """n sorts of ``key`` under torch.profiler (traced_launches)."""
    return traced_launches(lambda: kernels.sort_keys(key, bits), n)


def sort_launches(key: torch.Tensor, bits: int) -> int:
    """The kernel launches of one sort: the runtime's launch calls (the
    cooperative one included). The trace may miss a kernel of so short a
    window, never a launch call; every kernel it holds is K9's."""
    by, calls = sort_events(key, bits)
    ran = sum(c for _, c in by.values())
    if ran > calls or any(not k.startswith("kl_sort") for k in by):
        raise AssertionError(f"sort_keys: {calls} launch calls, kernels "
                             f"{by}")
    return calls


def sort_split(key: torch.Tensor, bits: int, what: str) -> None:
    """Log the card time of a sort by kernel (10 sorts traced)."""
    by, _ = sort_events(key, bits, 10)
    for name, (ms, c) in sorted(by.items()):
        log(f"sort_keys on {what}, card time by kernel: {name} "
            f"{ms / 10:.4f} ms in {c / 10:g} launches a sort")
    log(f"sort_keys on {what}, card time: "
        f"{sum(ms for ms, _ in by.values()) / 10:.4f} ms a sort")


def sort_edge_cases() -> None:
    """sort_keys exact against its plain version on no key, one key, a
    tile of keys and one either side, the one-launch route's limit and one
    either side (31 and 25 bits), all keys equal, all BIG_KEY and random
    1-bit flags (at 2^20 and at the limit)."""
    tile = kernels.sort_plan(1, lsh.KEY_BITS)["tile"]
    limit = kernels.SORT_ONE_MAX
    r = np.random.default_rng(10)
    ties = r.integers(0, 1000, size=limit + 1) << 20   # every digit in use
    cases = [("no key", [], lsh.KEY_BITS), ("one key", [5], lsh.KEY_BITS),
             ("a tile less one", ties[:tile - 1], lsh.KEY_BITS),
             ("a tile", ties[:tile], lsh.KEY_BITS),
             ("a tile and one", ties[:tile + 1], lsh.KEY_BITS),
             ("the one-launch limit less one", ties[:limit - 1],
              lsh.KEY_BITS),
             ("the one-launch limit", ties[:limit], lsh.KEY_BITS),
             ("the one-launch limit and one", ties, lsh.KEY_BITS),
             ("the one-launch limit, 25 bits", ties[:limit] >> 6, 25),
             ("the one-launch limit and one, 25 bits", ties >> 6, 25),
             ("all keys equal", np.full(SMALL, 777), lsh.KEY_BITS),
             ("all BIG_KEY", np.full(SMALL, lsh.BIG_KEY), lsh.KEY_BITS),
             ("random flags", r.integers(0, 2, size=SMALL), 1),
             ("random flags at the limit", r.integers(0, 2, size=limit), 1)]
    for what, key, bits in cases:
        key = torch.from_numpy(np.asarray(key, np.int32)).to(DEV)
        _exact(f"sort_keys on {what}",
               zip(kernels.sort_keys(key, bits),
                   kernels.sort_keys_plain(key, bits)))
    log("sort_keys: exact on " + ", ".join(c[0] for c in cases))


def phase_sort_small() -> None:
    """sort_keys on the lsh_keys output at 2^14 (the sharded global
    phase's 4 x 4,096 keys) and 2^16 keys, both on the one-launch
    route."""
    for M in SORT_SMALL:
        counts = torch.from_numpy(make_counts(M, seed=1)).to(DEV)
        cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
        values, sizes = kernels.abundance_transform(counts, (cov / M).float())
        h = engine._active_h_of(int((sizes > 0).sum()))
        key, _ = kernels.lsh_keys(values, sizes,
                                  rng.draw_hyperplanes(0, 0, S).to(DEV), h)
        sort_case(key, lsh.KEY_BITS, f"lsh_keys at {M}")


def cluster_keys(sizes, slots, parent) -> torch.Tensor:
    """finalize's second sort's keys on a compacted state: each alive
    root's least member row, cap0 for a column that is no root."""
    cap0 = parent.shape[0]
    roots = parent.long()
    while not torch.equal(nxt := roots[roots], roots):
        roots = nxt
    least = torch.full((cap0,), cap0, dtype=torch.int64, device=DEV)
    least.scatter_reduce_(0, roots, torch.arange(cap0, device=DEV), "amin")
    s = slots[sizes > 0].long()
    return torch.where(roots[s] == s, least[s], cap0).to(torch.int32)


def root_keys(sizes, slots, parent) -> torch.Tensor:
    """finalize's row keys on a session's state: each row's root where the
    root is an alive slot, else cap0 (finalize_plain's first sort key)."""
    cap0 = parent.shape[0]
    roots = parent.long()
    while not torch.equal(nxt := roots[roots], roots):
        roots = nxt
    alive = torch.zeros(cap0 + 1, dtype=torch.bool, device=DEV)
    alive[slots[sizes > 0].long()] = True
    return torch.where(alive[roots], roots, cap0).to(torch.int32)


def finalize_timed(vt, sz, sl, parent) -> tuple[dict, int]:
    """Compact a session's final state, hold finalize on it against its
    plain version and time both. Returns (the kernel's entry, clusters)."""
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    vt, sz, sl = vt[:, :na].contiguous(), sz[:na], sl[:na]
    cap0 = parent.shape[0]
    deepest, mean = testdata.forest_depth(parent)
    up = parent.long()
    rounds = max(deepest - 1, 1).bit_length() + 1
    log(f"finalize at {cap0}: forest depth {deepest} at most, {mean:.3f} on "
        f"average; pointer jumping would take {rounds} rounds of "
        f"{cuda_ms(lambda: up[up]):.4f} ms (one round by torch indexing)")
    return finalize_checked(vt, sz, sl, parent)[0], na


def finalize_checked(vt, sz, sl, parent) -> tuple[dict, tuple]:
    """finalize on a compacted state held to its plain version bit for bit
    and both timed. Returns (the kernel's entry, the plain outputs)."""
    k = kernels.finalize(vt, sz, sl, parent)
    p = kernels.finalize_plain(vt, sz, sl, parent)
    s, fc = vt.shape
    # state and parent in; members (int64), lens, sizes (int64) and
    # centroids out
    return dict(max_abs_err=_exact("finalize", zip(k, p)),
                **timings(lambda: kernels.finalize(vt, sz, sl, parent),
                          lambda: kernels.finalize_plain(vt, sz, sl, parent),
                          8 * s * fc + 20 * fc + 12 * parent.shape[0])), p


def phase_finalize_cell() -> None:
    """finalize where the benchmark's metahit124.cluster cell runs it: a
    session of 2^24 rows x 124 samples annealed over 101 iterations to 0.8
    (~1.2 M clusters), finalize's inputs taken as the engine passes them.
    The kernel is held to its plain version bit for bit and both timed; the
    pulled triple must hold the plain outputs' bytes in the pull's types
    ([K, 124] float32 C-contiguous, int64 sizes and members)."""
    counts, v = testdata.session_input(FULL, CELL_S, 11, DEV)
    seen, real = [], kernels.finalize

    def capture(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    kernels.finalize = capture
    try:
        cents, sizes, groups = engine.cluster_counts(counts, v, CELL_THR,
                                                     seed=11, n=FULL)
    finally:
        kernels.finalize = real
    del counts
    (args, _), = seen
    fc = args[0].shape[1]
    res, p = finalize_checked(*args)
    want = (p[3].cpu().numpy(), p[2].cpu().numpy(),
            p[0].cpu().numpy()[:len(groups.flat)], p[1].cpu().numpy())
    got = (cents, sizes, groups.flat, np.diff(groups.offsets))
    if not (cents.dtype == np.float32 and cents.flags.c_contiguous
            and sizes.dtype == groups.flat.dtype == np.int64
            and all(np.array_equal(a, b) for a, b in zip(got, want))):
        raise AssertionError("finalize at the cell: the pulled triple is not "
                             "the plain outputs")
    log(f"finalize at the cell ({FULL} x {CELL_S}, {fc} clusters, "
        f"{engine.LAST_SESSION['pull_host_allocs']} pinned blocks "
        f"allocated by the pull): exact against its plain version, kernel "
        f"{res['ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")


def lsh_keys_rows_plain_blocks(rows, sz, planes, h: int,
                               block: int = 1 << 24):
    """``kernels.lsh_keys_rows_plain`` on a row state whose [H_MAX + 1, M]
    projections do not fit beside it at once: a column's projection is its
    own sum, so the bucket keys and projections are made a block of
    columns at a time, and the sort key's range is taken over all of them
    (the same bits as the one call, which it is up to ``block`` rows)."""
    M = rows.shape[0]
    if M <= block:
        return kernels.lsh_keys_rows_plain(rows, sz, planes, h)
    S = planes.shape[0]
    keys = torch.empty(M, dtype=torch.int32, device=rows.device)
    proj = torch.empty(M, dtype=torch.float32, device=rows.device)
    for b in range(0, M, block):
        keys[b:b + block], proj[b:b + block] = lsh.signatures_t(
            kernels.rows_values(rows[b:b + block], S), planes, h)
    keys = torch.where(sz > 0, keys, lsh.BIG_KEY)
    return lsh.combined_sort_key(keys, proj, sz, h), proj


def rows_checked(at: str, vt, sz, sl, planes, h: int, order, skey,
                 thr: float, col, plain, windows, atol: float) -> tuple:
    """The kernels of a chain session's row state where a benchmark cell
    runs them, a session's first iteration: K2's transpose into the rows
    (``to_rows``), exact on ``windows`` of columns; K1b on the rows, bit
    for bit its plain twin (:func:`lsh_keys_rows_plain_blocks`, on every
    column) and K1b on the columns; K3 on the rows, bit for bit the column
    K3's outputs ``col`` (the kernels share their arithmetic: sizes, slots,
    values; where the two plans cut the positions otherwise, the values
    within rounding) and held to its plain twin on ``windows`` of positions
    (``plain(w)``: the plain collapse's outputs there, its parent and the
    window's source slots; ints and parent entries exact, values within
    rtol 1e-5 and ``atol``); K2's gather alone back to columns, exact
    there. Returns (rows, the parent K3 folded into, the values' largest
    error against the plain twin, the dying slots, the largest error of
    ``to_rows`` and ``lsh_keys_rows`` against their plain twins) for
    :func:`rows_timed`."""
    S_, M = vt.shape
    rows = kernels.to_rows(vt, sz, sl)
    exact = dict(to_rows=max(
        _exact(f"to_rows at {at}, columns {w}",
               [(rows[w], kernels.to_rows_plain(vt[:, w], sz[w], sl[w]))])
        for w in (slice(0, NARROW_WINDOW), slice(M - NARROW_WINDOW, M))))
    kr = kernels.lsh_keys_rows(rows, sz, planes, h)
    kp = lsh_keys_rows_plain_blocks(rows, sz, planes, h)
    exact["lsh_keys_rows"] = _exact(
        f"lsh_keys_rows at {at} against its plain twin", zip(kr, kp))
    del kp
    kc = kernels.lsh_keys(vt, sz, planes, h)
    _exact(f"lsh_keys_rows at {at} against lsh_keys", zip(kr, kc))
    del kr, kc
    pr = sl.clone()
    out, osz = kernels.chain_collapse_rows(rows, S_, order, skey, thr, h, pr)
    _exact(f"chain_collapse_rows at {at} against chain_collapse",
           [(osz, col[1]), (out[:, S_ + 1], col[2])])
    # bit for bit where the two plans cut the positions alike (a chain's
    # sums follow the sub-ranges), else within rounding
    alike = (kernels.chain_plan(S_, M, rows=True)["P"]
             == kernels.chain_plan(S_, M)["P"])
    for i, a in enumerate(kernels.rows_values(out, S_)):
        if alike:
            _exact(f"chain_collapse_rows at {at}, value row {i}",
                   [(a, col[0][i])])
        else:
            torch.testing.assert_close(a, col[0][i], rtol=1e-5, atol=atol)
    dying = int((col[1] == 0).sum() - (sz == 0).sum())
    errs = []
    for w in windows:
        p, pp, wsl = plain(w)
        wsl = wsl.long()
        where = f"chain_collapse_rows at {at}, positions {w}"
        _exact(where, [(osz[w], p[1]), (out[w, S_ + 1], p[2]),
                       (pr[wsl], pp[wsl])])
        for a, b in zip(kernels.rows_values(out[w], S_), p[0]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
        errs.append(_max_err(zip(kernels.rows_values(out[w], S_), p[0])))
        del p, pp
    del out, osz
    for w in windows:   # K2's gather back, on a window's first positions
        o = order[w][:NARROW_WINDOW]
        _exact(f"permute_rows at {at}, positions {w}",
               zip(kernels.permute_rows(rows, S_, o),
                   kernels.permute_rows_plain(rows, S_, o)))
    return rows, pr, max(errs), dying, exact


def rows_timed(at: str, vt, sz, sl, planes, h: int, order, skey, thr: float,
               rows, pr, err: float, dying: int, exact: dict) -> dict:
    """The row state's kernels of :func:`rows_checked` timed beside the
    bound of each one's function (the row state's own bytes and the column
    kernels' times logged beside them), and the plain twins of ``to_rows``
    and ``lsh_keys_rows`` as :func:`rows_checked` ran them; K3's on rows,
    the column pair's plain with a layout change, is not timed here (the
    memory holds no second state beside the plain pair's temporaries)."""
    S_, M = vt.shape
    W = kernels.row_words(S_)
    res = {}
    res["to_rows"] = dict(
        max_abs_err=exact["to_rows"],
        ms=cuda_ms(lambda: kernels.to_rows(vt, sz, sl), 5, 4),
        plain_ms=cuda_ms(lambda: kernels.to_rows_plain(vt, sz, sl), 3, 1),
        library_ms=None, **bound(4 * S_ * M + 8 * M + 4 * W * M))
    res["lsh_keys_rows"] = dict(
        max_abs_err=exact["lsh_keys_rows"],
        ms=cuda_ms(lambda: kernels.lsh_keys_rows(rows, sz, planes, h), 5, 4),
        plain_ms=cuda_ms(lambda: lsh_keys_rows_plain_blocks(
            rows, sz, planes, h), 3, 1),
        library_ms=None,
        **bound(4 * S_ * M + 4 * M + 4 * S_ * (h + 1) + 8 * M,
                2 * S_ * (h + 1) * M))
    # the fold writes the same parent entries again: timed in place
    res["chain_collapse_rows"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.chain_collapse_rows(
            rows, S_, order, skey, thr, h, pr), 5, 4),
        plain_ms=None, library_ms=None,
        **bound(8 * S_ * M + 24 * M + 4 * dying, 8 * S_ * M))
    col_ms = {
        "lsh_keys": cuda_ms(lambda: kernels.lsh_keys(vt, sz, planes, h), 5, 4),
        "chain_collapse": cuda_ms(lambda: kernels.chain_collapse(
            vt, sz, sl, order, skey, thr, h, None, sl.clone(),
            merged=False), 5, 4)}
    log(f"the row state at {at} (W = {W}, {4 * W * M} bytes of rows; K3 on "
        f"rows moves {8 * W * M + 12 * M + 8 * dying} bytes, its function "
        f"{8 * S_ * M + 24 * M + 4 * dying}): to_rows, lsh_keys_rows (on "
        f"every column) and chain_collapse_rows exact against their plain "
        f"twins and the column kernels; on columns lsh_keys {col_ms['lsh_keys']:.4f} ms, "
        f"chain_collapse (its transpose too) {col_ms['chain_collapse']:.4f} "
        f"ms")
    return res


def phase_chain_cell() -> None:
    """chain_collapse where the benchmark's metahit124.cluster cell runs it,
    at the launch plan of the cell's width: a session's first iteration at
    2^24 x 124 (testdata.session_input, seed 11; the alive count's h,
    iteration 0's planes, the cell's first threshold, the parent fold).
    Held to K2's plain version followed by the plain collapse: sizes,
    slots, merged_into and parent exact, centroids within rtol 1e-5; both
    timed, beside the bound of K2's and K3's functions (8 S M + 20 M and
    8 S M + 24 M + 4 a dying slot bytes). Then the row state's kernels of
    :func:`rows_checked`, held to the same plain outputs, and timed."""
    counts, v = testdata.session_input(FULL, CELL_S, 11, DEV)
    vt, sz = kernels.abundance_transform(counts, torch.from_numpy(v).to(DEV))
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    planes = rng.draw_hyperplanes(11, 0, CELL_S).to(DEV)
    key, _ = kernels.lsh_keys(vt, sz, planes, h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    del key
    sl = torch.arange(FULL, dtype=torch.int32, device=DEV)
    thr = float(CELL_THR[0])
    pk, pp = sl.clone(), sl.clone()
    # the plain pair first, its temporaries gone before the kernel's
    # outputs are made; the centroids compared a sample at a time (the
    # device's memory holds ~63 GiB at the plain pair's peak)
    p = kernels.chain_collapse_plain(
        *kernels.permute_state_plain(vt, sz, sl, order), skey, thr, h, None,
        pp)
    k = kernels.chain_collapse(vt, sz, sl, order, skey, thr, h, None, pk)
    _exact(f"chain_collapse at {FULL} x {CELL_S}",
           [(k[1], p[1]), (k[2], p[2]), (k[3], p[3]), (pk, pp)])
    dying = int((k[3] >= 0).sum())
    if dying == 0:
        raise AssertionError(f"chain_collapse at {FULL} x {CELL_S}: no chain "
                             f"merged at {thr}")
    for a, b in zip(k[0], p[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    err = _max_err(zip(k[0], p[0]))
    del k
    col = kernels.chain_collapse(vt, sz, sl, order, skey, thr, h, None, None,
                                 merged=False)
    at = f"{FULL} x {CELL_S}"
    checked = rows_checked(at, vt, sz, sl, planes, h, order, skey, thr, col,
                           lambda w: (p, pp, sl), [slice(None)], 0.0)
    del p, col
    torch.cuda.empty_cache()
    row_res = rows_timed(at, vt, sz, sl, planes, h, order, skey, thr,
                         *checked)
    del checked
    torch.cuda.empty_cache()
    # the fold writes the same parent entries again: timed in place
    res = dict(max_abs_err=err,
               ms=cuda_ms(lambda: kernels.chain_collapse(
                   vt, sz, sl, order, skey, thr, h, None, pk), 5, 4),
               plain_ms=cuda_ms(lambda: kernels.chain_collapse_plain(
                   *kernels.permute_state_plain(vt, sz, sl, order), skey,
                   thr, h, None, pp), 3, 1),
               library_ms=None,
               **bound(16 * CELL_S * FULL + 44 * FULL + 4 * dying,
                       6 * CELL_S * FULL))
    log(f"chain_collapse at the cell ({FULL} x {CELL_S}, h = {h}, {dying} "
        f"slots die at {thr}): exact against K2's and K3's plain versions")
    log_kernels({"chain_collapse": res, **row_res}, f"{FULL} x {CELL_S}")


NARROW_WINDOW = 1 << 18   # positions of a compared window, a multiple of
                          # 2^15: no chain crosses its ends


def _narrow_windows() -> list[slice]:
    """The compared windows of positions at 10^8: from the last multiple of
    2^15 at least NARROW_WINDOW before the end to the end, and NARROW_WINDOW
    from one in the middle."""
    far = (NARROW_M - NARROW_WINDOW) >> 15 << 15
    mid = (NARROW_M // 2) >> 15 << 15
    return [slice(far, NARROW_M), slice(mid, mid + NARROW_WINDOW)]


def phase_narrow_cell() -> None:
    """The mode-C kernels where the benchmark's kostic18.cluster cell runs
    them, past 2^31 words of K2's profile-major scratch (10^8 x 24): a
    session's first iteration at 10^8 x 18 (testdata.session_input, seed
    11; the alive count's h, iteration 0's planes, the first threshold,
    the parent fold). sort_keys on the iteration's keys, exact on all of
    them; permute_state by their order and the fused chain_collapse (P =
    256), each held to its plain twin on the windows of _narrow_windows,
    whose source rows lie past word 2^31 (ints and the parent entries of
    the window's slots exact, centroids within rtol 1e-5 and atol 1e-6, as
    tests/test_torch_narrow_cohort.py holds them); the row state's kernels
    of :func:`rows_checked` (rows of 20 words, past byte 2^32 on the
    windows), held so too; finalize on the
    transformed state as 10^8 clusters of one row, its columns through a
    scratch of 10^8 x 24 words, exact. Each timed beside its bound, its
    plain version at full size."""
    M, S_ = NARROW_M, NARROW_S
    at = f"{M} x {S_}"
    counts, v = testdata.session_input(M, S_, 11, DEV)
    vt, sz = kernels.abundance_transform(counts, torch.from_numpy(v).to(DEV))
    del counts
    if int((sz > 0).sum()) != M:
        raise AssertionError(f"narrow cell: not every row of {at} kept")
    h = engine._active_h_of(M)
    planes = rng.draw_hyperplanes(11, 0, S_).to(DEV)
    key, _ = kernels.lsh_keys(vt, sz, planes, h)
    res = {"sort_keys": sort_case(key, lsh.KEY_BITS, f"lsh_keys at {at}")}
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    del key
    sl = torch.arange(M, dtype=torch.int32, device=DEV)
    W = kernels.permute_plan(S_, M)["W"]
    windows = _narrow_windows()
    for w in windows:
        if int(order[w].max()) * W < 2**31:
            raise AssertionError(f"narrow cell: window {w} reads no scratch "
                                 f"row past word 2^31")

    k = kernels.permute_state(vt, sz, sl, order)
    errs = []
    for w in windows:
        p = kernels.permute_state_plain(vt, sz, sl, order[w])
        errs.append(_exact(f"permute_state at {at}, positions {w}",
                           zip((k[0][:, w], k[1][w], k[2][w]), p)))
    del k, p
    res["permute_state"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: kernels.permute_state(vt, sz, sl, order), 5, 4),
        plain_ms=cuda_ms(lambda: kernels.permute_state_plain(
            vt, sz, sl, order), 3, 1),
        library_ms=cuda_ms(lambda: torch.index_select(vt, 1, order), 3, 1),
        **bound(8 * S_ * M + 20 * M))

    thr = float(CELL_THR[0])
    pk = sl.clone()
    k = kernels.chain_collapse(vt, sz, sl, order, skey, thr, h, None, pk)
    dying = int((k[3] >= 0).sum())
    errs = []
    for w in windows:
        pp = sl.clone()
        sv, ss, sls = kernels.permute_state_plain(vt, sz, sl, order[w])
        p = kernels.chain_collapse_plain(sv, ss, sls, skey[w], thr, h, None,
                                         pp)
        del sv, ss
        where = f"chain_collapse at {at}, positions {w}"
        _exact(where, [(k[1][w], p[1]), (k[2][w], p[2]), (k[3][w], p[3]),
                       (pk[sls.long()], pp[sls.long()])])
        if int((p[3] >= 0).sum()) == 0:
            raise AssertionError(f"{where}: no chain merged at {thr}")
        torch.testing.assert_close(k[0][:, w], p[0], rtol=1e-5, atol=1e-6)
        errs.append(_max_err([(k[0][:, w], p[0])]))
        del p, pp, sls
    del k
    torch.cuda.empty_cache()
    # the fold writes the same parent entries again: timed in place
    res["chain_collapse"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: kernels.chain_collapse(
            vt, sz, sl, order, skey, thr, h, None, pk), 5, 4),
        plain_ms=cuda_ms(lambda: kernels.chain_collapse_plain(
            *kernels.permute_state_plain(vt, sz, sl, order), skey, thr, h,
            None, sl.clone()), 2, 1),
        library_ms=None,
        **bound(16 * S_ * M + 44 * M + 4 * dying, 6 * S_ * M))

    def plain(w):
        pp = sl.clone()
        sv, ss, sls = kernels.permute_state_plain(vt, sz, sl, order[w])
        return (kernels.chain_collapse_plain(sv, ss, sls, skey[w], thr, h,
                                             None, pp), pp, sls)
    col = kernels.chain_collapse(vt, sz, sl, order, skey, thr, h, None, None,
                                 merged=False)
    checked = rows_checked(at, vt, sz, sl, planes, h, order, skey, thr, col,
                           plain, windows, 1e-6)
    del col
    torch.cuda.empty_cache()
    res.update(rows_timed(at, vt, sz, sl, planes, h, order, skey, thr,
                          *checked))
    del checked, skey, order, pk
    torch.cuda.empty_cache()

    args = (vt, sz, sl, sl.clone())
    k = kernels.finalize(*args)
    p = kernels.finalize_plain(*args)
    _exact(f"finalize at {at}", zip(k[:3], p[:3]))
    for i, (a, b) in enumerate(zip(k[3].split(1 << 24), p[3].split(1 << 24))):
        _exact(f"finalize at {at}, centroids of block {i}", [(a, b)])
    del k, p
    torch.cuda.empty_cache()
    res["finalize"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.finalize(*args), 3, 2),
        plain_ms=cuda_ms(lambda: kernels.finalize_plain(*args), 2, 1),
        library_ms=None, **bound(8 * S_ * M + 20 * M + 12 * M))
    log(f"the mode-C kernels at the kostic18 cell ({at}, W = {W}, h = {h}, "
        f"{dying} slots die at {thr}; windows {windows}): exact against "
        f"their plain versions, chain_collapse's centroids within "
        f"{res['chain_collapse']['max_abs_err']:.3g}")
    log_kernels(res, at)


def _same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    same = got.cpu().contiguous().view(torch.int32) == \
        want.contiguous().view(torch.int32)
    if got.shape != want.shape or not bool(same.all()):
        raise AssertionError(f"{name}: {int((~same).sum())} values differ "
                             f"from the plain twin's bits")


def phase_planes() -> dict:
    """draw_planes against its plain twin, bit for bit, and timed (its
    bound: the bytes it writes; its plain time and the per-iteration draws
    and uploads it replaced on the host clock)."""
    its = len(CELL_THR)
    t0 = time.perf_counter()
    for seed, s in ((0, CELL_S), (2100000013, CELL_S), (2**32 - 1, CELL_S),
                    (0, S)):
        _same_bits(f"draw_planes({seed}, {its}, {s})",
                   kernels.draw_planes(seed, its, s, DEV),
                   rng.draw_planes(seed, its, s))
    m = torch.arange(1 << 23, dtype=torch.int64) << 9
    _same_bits("normal_of_bits on every mantissa",
               kernels.normal_of_bits(
                   (m - ((m >> 31) << 32)).to(torch.int32).to(DEV)),
               rng.normal_of_bits(m))
    checked = time.perf_counter() - t0

    def host_ms(fn, reps: int = 5) -> float:
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return float(np.median(times))

    seed = 2100000013
    for s in (S, CELL_S):     # the result line keeps the cell's shape
        res = dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: kernels.draw_planes(seed, its, s, DEV)),
            plain_ms=host_ms(lambda: rng.draw_planes(seed, its, s)),
            library_ms=None, **bound(4 * its * s * (lsh.H_MAX + 1)))
        one_call = host_ms(lambda: kernels.draw_planes(seed, its, s, DEV))
        per_it = host_ms(lambda: [rng.draw_hyperplanes(seed, it, s).to(DEV)
                                  for it in range(its)], reps=3)
        by, calls = traced_launches(
            lambda: kernels.draw_planes(seed, its, s, DEV), 10)
        card_ms, traced = by.pop("kl_draw_planes_kernel")
        if by or calls != 10:
            raise AssertionError(f"draw_planes: {calls} launch calls and "
                                 f"{by} for 10 calls")
        log(f"kernel draw_planes at {its} x {s} x {lsh.H_MAX + 1}: exact "
            f"(4 draws and 2^23 mantissas checked in {checked:.1f} s)  "
            f"kernel {res['ms']:.4f} ms (card {card_ms / traced:.4f} ms over "
            f"{traced} traced kernels, one launch a call)  plain "
            f"{res['plain_ms']:.1f} ms  bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']})  one call on the "
            f"host clock {one_call:.3f} ms  per-iteration host draws and "
            f"uploads {per_it:.1f} ms")
    return {"draw_planes": res}


def phase_kernels_exchange(state, local, merged: int, h: int) -> dict:
    """The exchange kernels on an M x 20 local-phase result (``local``:
    values, sizes, slots, merged_into of ``state``, the input state with its
    order and sorted keys, collapsed at 0.95): the rotating window of e = 4096
    survivors, then rank 1's fold after a global phase over four ranks'
    windows (testdata.exchange_inputs), its local merges folded by
    chain_collapse with its parent shard and base as the sharded iteration
    does, each exact against its plain version; and chain_collapse at that
    base with and without the fold, beside the sum of one exchange's K3 and
    K8b (a parent tree's: tools/kernel_split.py exchange)."""
    res = {}
    values, sizes, slots, mi = local
    iv, isz, isl, order, skey = state
    c, e = values.shape[1], dist.EXCHANGE_CAP
    k = kernels.exchange_window(values, sizes, slots, e, 1)
    p = kernels.exchange_window_plain(values, sizes, slots, e, 1)
    # sizes in, and the window's columns; the window out
    res["exchange_window"] = dict(
        max_abs_err=_exact("exchange_window", zip(k, p)),
        **timings(lambda: kernels.exchange_window(values, sizes, slots, e, 1),
                  lambda: kernels.exchange_window_plain(values, sizes, slots,
                                                        e, 1),
                  4 * c + e * (4 * S + 8) + e * (4 * S + 12)))
    n_valid = int((k[0] < c).sum())
    if n_valid != e:
        raise AssertionError(f"exchange_window: {n_valid} of {e} entries")

    (*glob, w_slots, pos, lv, ls, lsl, lmi, parent0,
     base) = testdata.exchange_inputs(values, sizes, slots, mi, RANKS, 1, e)
    g_merged = int((glob[2] >= 0).sum())
    if g_merged == 0:
        raise AssertionError("exchange_fold: the global phase merged nothing")
    # rank 1's local phase: its merges folded into its parent shard
    slb = isl + base
    kp, pp = parent0.clone(), parent0.clone()
    k = kernels.chain_collapse(iv, isz, slb, order, skey, 0.95, h, None, kp,
                               base)
    p = kernels.chain_collapse_plain(
        *kernels.permute_state_plain(iv, isz, slb, order), skey, 0.95, h,
        None, pp, base)
    _exact("chain_collapse at a base", [(k[1], p[1]), (k[2], p[2]),
                                        (k[3], p[3]), (kp, pp)])
    _exact("chain_collapse at a base against the exchange's local state",
           [(k[1], ls), (k[2], lsl), (k[3], lmi)])
    local_folds = int((kp != parent0).sum())
    folded = kp.clone()
    kv, ks, pv, ps = lv.clone(), ls.clone(), lv.clone(), ls.clone()
    kernels.exchange_fold(*glob, w_slots, pos, kv, ks, kp, base)
    kernels.exchange_fold_plain(*glob, w_slots, pos, pv, ps, pp, base)
    err = _exact("exchange_fold", [(kv, pv), (ks, ps), (kp, pp)])
    folds = int((kp != folded).sum())
    n = glob[0].shape[1]
    # the gathered slots, the window in; the window's merged columns read
    # and written, one parent entry per global merge of this rank's slots
    # (the fold writes the same values again: timed in place)
    res["exchange_fold"] = dict(
        max_abs_err=err,
        **timings(lambda: kernels.exchange_fold(*glob, w_slots, pos, kv, ks,
                                                kp, base),
                  lambda: kernels.exchange_fold_plain(*glob, w_slots, pos, pv,
                                                      ps, pp, base),
                  4 * n + 8 * e + n_valid * (8 * S + 12) + 4 * folds))
    # K3 at the rank's base, the fold timed in place (it writes the same
    # entries again), and without it; its bytes as phase 3's chain_collapse
    streamed = 16 * S * c + 48 * c
    with_fold = cuda_ms(lambda: kernels.chain_collapse(
        iv, isz, slb, order, skey, 0.95, h, None, folded, base))
    bare = cuda_ms(lambda: kernels.chain_collapse(iv, isz, slb, order, skey,
                                                  0.95, h))
    fold_ms = res["exchange_fold"]["ms"]
    log(f"exchange at {c}: window of {e} of {int((sizes > 0).sum())} alive "
        f"columns; the global phase over {n} gathered columns merged "
        f"{g_merged}; rank 1's chain_collapse folded {local_folds} local "
        f"merges ({merged} merged), exchange_fold {folds} global ones")
    log(f"exchange at {c}: chain_collapse with the local fold (base {base}) "
        f"{with_fold:.4f} ms, bound "
        f"{bound(streamed + 4 * local_folds)['bound_ms']:.4f}; without "
        f"{bare:.4f} ms, bound {bound(streamed)['bound_ms']:.4f}; "
        f"exchange_fold {fold_ms:.4f} ms; K3 + K8b of one exchange "
        f"{with_fold + fold_ms:.4f} ms")
    return res


def phase_kernels(M: int = SMALL, exchange: bool = True,
                  pairing: bool = True) -> dict:
    """Each mode-C kernel against its plain version on the same CUDA
    inputs at M x 20, the shapes of a session's first iteration, the
    pairing rounds on that iteration's sorted state, and the exchange
    kernels on that iteration's result."""
    res = {}
    counts = torch.from_numpy(make_counts(M, seed=1)).to(DEV)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    v = (cov / M).to(torch.float32)

    k = kernels.abundance_transform(counts, v)
    p = kernels.abundance_transform_plain(counts, v)
    # uint16 in, f32 values and int32 sizes out; a sum and a subtraction
    # per count at the least
    res["abundance_transform"] = dict(
        max_abs_err=_exact("abundance_transform", zip(k, p)),
        **timings(lambda: kernels.abundance_transform(counts, v),
                  lambda: kernels.abundance_transform_plain(counts, v),
                  6 * S * M + 4 * S + 4 * M, 2 * S * M))
    values, sizes = k
    n_alive = int((sizes > 0).sum())
    h = engine._active_h_of(n_alive)
    planes = rng.draw_hyperplanes(0, 0, S).to(DEV)

    k = kernels.lsh_keys(values, sizes, planes, h)
    p = kernels.lsh_keys_plain(values, sizes, planes, h)
    # the library call: one float32 product of the h + 1 planes in use with
    # the values, the projections alone (no keys, no quantization)
    used = torch.cat([planes[:, :h], planes[:, lsh.H_MAX:]], dim=1)
    # values and sizes in, keys and projections out; h + 1 projections of
    # S multiply-adds per column
    res["lsh_keys"] = dict(
        max_abs_err=_exact("lsh_keys", zip(k, p)),
        **timings(lambda: kernels.lsh_keys(values, sizes, planes, h),
                  lambda: kernels.lsh_keys_plain(values, sizes, planes, h),
                  4 * S * M + 12 * M + 4 * S * planes.shape[1],
                  2 * S * M * (h + 1),
                  library=lambda: torch.matmul(used.T, values)))
    key = k[0]
    lsh_keys_cases(values, sizes, planes, h)
    res["sort_keys"] = sort_case(key, lsh.KEY_BITS, f"lsh_keys at {M}")
    if M == SMALL:
        sort_edge_cases()
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    slots = torch.arange(M, dtype=torch.int32, device=DEV)

    k = kernels.permute_state(values, sizes, slots, order)
    p = kernels.permute_state_plain(values, sizes, slots, order)
    # state and int32 order in, state out; the library call moves the
    # values alone
    res["permute_state"] = dict(
        max_abs_err=_exact("permute_state", zip(k, p)),
        **timings(lambda: kernels.permute_state(values, sizes, slots, order),
                  lambda: kernels.permute_state_plain(values, sizes, slots,
                                                      order),
                  8 * S * M + 20 * M,
                  library=lambda: torch.index_select(values, 1, order)))
    svals, ssizes, sslots = k
    if pairing:
        res["pairing_rounds"] = pairing_case((svals, ssizes, sslots, skey), h)
        if M == SMALL:
            pairing_wide()

    # K3 moves the state into sort order itself (K2's transpose, rows
    # staged by the order): held to the plain collapse of K2's sorted copy
    parent0 = torch.arange(M, dtype=torch.int32, device=DEV)
    pk, pp = parent0.clone(), parent0.clone()
    k = kernels.chain_collapse(values, sizes, slots, order, skey, 0.95, h,
                               None, pk)
    p = kernels.chain_collapse_plain(svals, ssizes, sslots, skey, 0.95, h,
                                     None, pp)
    _exact("chain_collapse", [(k[1], p[1]), (k[2], p[2]), (k[3], p[3]),
                              (pk, pp)])
    merged = int((k[3] >= 0).sum())
    if merged == 0:
        raise AssertionError("chain_collapse: no chain merged at 0.95")
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=0)
    # the functions of K2 and K3 together: state, order and keys in, the
    # moved state out and in again; state, merged_into and one parent entry
    # per merge out; three products (dot and two norms) per value at the
    # least
    res["chain_collapse"] = dict(
        max_abs_err=_max_err([(k[0], p[0])]),
        **timings(lambda: kernels.chain_collapse(
                      values, sizes, slots, order, skey, 0.95, h, None,
                      parent0.clone()),
                  lambda: kernels.chain_collapse_plain(
                      *kernels.permute_state_plain(values, sizes, slots,
                                                   order),
                      skey, 0.95, h, None, parent0.clone()),
                  16 * S * M + 48 * M + 4 * merged, 6 * S * M))
    log(f"chain_collapse: {merged} of {n_alive} columns merged at 0.95")
    # as the global phase calls it, without the parent fold; and a copy of
    # the bytes it streams (values and three int columns in and out)
    bare = cuda_ms(lambda: kernels.chain_collapse(values, sizes, slots, order,
                                                  skey, 0.95, h))
    copy = cuda_ms(lambda: [t.clone() for t in (svals, ssizes, sslots, skey)])
    log(f"chain_collapse at {M}: without the parent fold {bare:.4f} ms; a "
        f"copy of its values and int columns {copy:.4f} ms")
    if exchange:
        res.update(phase_kernels_exchange((values, sizes, slots, order, skey),
                                          k, merged, h))

    # a session's final state: a few more iterations through the kernels
    vt, sz, sl, parent = k[0], k[1], k[2], pk
    for it in range(1, 6):
        na = int((sz > 0).sum())
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(DEV),
            0.95 - 0.01 * it, engine._active_h_of(na))[:3]
    if M == FULL:   # logged only
        sort_split(key, lsh.KEY_BITS, f"lsh_keys at {M}")
        rows = root_keys(sz, sl, parent)
        sort_case(rows, M.bit_length(), f"finalize's row keys at {M}")
        sort_split(rows, M.bit_length(), f"finalize's row keys at {M}")
        sort_case((sz == 0).to(torch.int32), 1, f"the dead flags at {M}")
        vc, szc, slc = engine.compact_sort(vt, sz, sl)
        sort_case(cluster_keys(szc, slc, parent), M.bit_length(),
                  f"finalize's cluster keys at {M}")
        del vc, szc, slc
    res["finalize"], na = finalize_timed(vt, sz, sl, parent)
    log(f"finalize: {na} clusters over {M} rows")
    if M == SMALL:
        finalize_deep()
    log_kernels(res, M)
    return res


def first_sorted_state(M: int, seed: int = 1) -> tuple:
    """The sorted state of a session's first iteration at M x 20 as phase
    3 makes it (make_counts(M, seed), the abundance transform, lsh_keys at
    the data's h, sort_keys, permute_state): (values, sizes, slots, keys,
    h)."""
    counts = torch.from_numpy(make_counts(M, seed=seed)).to(DEV)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    values, sizes = kernels.abundance_transform(
        counts, (cov / M).to(torch.float32))
    del counts
    h = engine._active_h_of(int((sizes > 0).sum()))
    key, _ = kernels.lsh_keys(values, sizes,
                              rng.draw_hyperplanes(0, 0, S).to(DEV), h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    slots = torch.arange(M, dtype=torch.int32, device=DEV)
    return (*kernels.permute_state(values, sizes, slots, order), skey, h)


def pairing_bytes(M: int, stats, s: int = S) -> float:
    """The bytes pairing_rounds would move at M positions if every round
    read each pair's columns (the earlier three-launch design's count,
    kept beside the floor), from its rounds' (pairs formed, pairs
    merged): the keys read and merged_into written once; each round every
    size read, both columns of each pair formed, and for each merge both
    slots read and the left's values, both sizes, merged_into and a
    parent entry written."""
    return 8 * M + sum(4 * M + 8 * s * formed + (4 * s + 24) * merged
                       for formed, merged in stats)


def pairing_floor_bytes(skey, vals_in, vals_out, sizes_in, sizes_out,
                        mi) -> float:
    """The least bytes pairing_rounds moves on these inputs, whatever the
    rounds: each alive column (S floats), every size and key read once;
    the changed columns' values written as the 32-byte sectors that hold
    them (their values lie M apart: S sectors for each 8 aligned positions
    holding a changed column, each sector once), each size that changed
    written, and for each death (mi: merged_into from -1) both slots read
    and its merged_into and parent entry written."""
    s = vals_in.shape[0]
    alive = int(((sizes_in > 0) & (skey != lsh.BIG_KEY)).sum())
    cols = torch.nonzero((vals_out != vals_in).any(dim=0)).squeeze(1)
    sectors = s * int(torch.unique(cols // 8).numel())
    changed = int((sizes_out != sizes_in).sum())
    return (4 * s * alive + 8 * skey.numel() + 32 * sectors + 4 * changed
            + 16 * int((mi >= 0).sum()))


def segment_stats(skey, shift: int, C: int) -> tuple[int, int, int]:
    """(segments, segments longer than C, positions in them) of the sorted
    keys (runs of equal key >> shift)."""
    g = skey >> shift
    starts = torch.ones_like(g, dtype=torch.bool)
    starts[1:] = g[1:] != g[:-1]
    first = torch.nonzero(starts).squeeze(1)
    lens = torch.diff(torch.cat([first, first.new_tensor([g.numel()])]))
    long = lens > C
    return int(lens.numel()), int(long.sum()), int(lens[long].sum())


def pairing_case(sorted_state, h: int) -> dict:
    """pairing_rounds against its plain version on the first iteration's
    sorted state, PAIR_ROUNDS rounds at 0.95 and at PAIR_LOW, with a parent
    forest: every output exact. The kernel timed at both, the plain version
    at 0.95, with the state restored before each call, beside its bound
    (pairing_floor_bytes) and the per-round count; its launches a call
    (the wrapper's count and the runtime's launch calls under
    torch.profiler) and the segments longer than its plan's C logged; no
    single PyTorch call computes the rounds. Returns the entry at 0.95."""
    svals, ssizes, sslots, skey = sorted_state
    s, M = svals.shape
    shift = kernels.free_bits(h)
    plan = kernels.pairing_plan(s, M)
    segs, n_long, in_long = segment_stats(skey, shift, plan["C"])
    log(f"pairing_rounds at {M} x {s}: h = {h}, shift {shift}, C = "
        f"{plan['C']}: {segs} segments, {n_long} longer than C holding "
        f"{in_long} positions ({in_long / M:.4%})")
    ident = torch.arange(M, dtype=torch.int32, device=DEV)
    out = {}
    for thr in (0.95, PAIR_LOW):
        state = [svals.clone(), ssizes.clone(), ident.clone()]

        def restore():
            state[0].copy_(svals)
            state[1].copy_(ssizes)
            state[2].copy_(ident)

        def run(fn, **kw):
            return fn(state[0], state[1], sslots, skey, shift, thr,
                      PAIR_ROUNDS, None, state[2], **kw)

        restore()
        on_card = kernels.card_launches["pairing_rounds"]
        k = [x.clone() for x in run(kernels.pairing_rounds)] + [
            state[2].clone()]
        calls = kernels.card_launches["pairing_rounds"] - on_card
        restore()
        stats = []
        p = list(run(kernels.pairing_rounds_plain, stats=stats)) + [state[2]]
        err = _exact(f"pairing_rounds at {thr}", zip(k, p))
        formed = sum(f for f, _ in stats)
        merged = sum(m for _, m in stats)
        if not merged:
            raise AssertionError(f"pairing_rounds: no pair merged at {thr}")
        # merged_into given, so that the wrapper fills nothing in the window
        mi = torch.full((M,), -1, dtype=torch.int32, device=DEV)
        restore()
        by, traced = traced_launches(lambda: kernels.pairing_rounds(
            state[0], state[1], sslots, skey, shift, thr, PAIR_ROUNDS, mi,
            state[2]))
        if calls != plan["launches"] or traced != calls or any(
                not name.startswith("kl_pair") for name in by):
            raise AssertionError(f"pairing_rounds: {calls} launches counted, "
                                 f"{traced} launch calls traced, kernels "
                                 f"{by}; the plan says {plan['launches']}")
        floor = pairing_floor_bytes(skey, svals, k[0], ssizes, k[1], k[2])
        per_round = bound(pairing_bytes(M, stats, s))["bound_ms"]
        # the dot product and two norms of each pair formed, the mean of
        # each merge: float32 operations
        r = dict(max_abs_err=err,
                 ms=cuda_ms_restored(lambda: run(kernels.pairing_rounds),
                                     restore),
                 # 0.4 s a call at 2^24: timed at 0.95 alone
                 plain_ms=cuda_ms_restored(
                     lambda: run(kernels.pairing_rounds_plain), restore,
                     reps=3, calls=2) if thr == 0.95 else None,
                 library_ms=None,
                 **bound(floor, 6 * s * formed + 3 * s * merged))
        log(f"pairing_rounds at {M} x {s}, {thr}: {PAIR_ROUNDS} rounds "
            f"formed {[f for f, _ in stats]} pairs and merged "
            f"{[m for _, m in stats]} ({merged / max(formed, 1):.1%}); "
            f"max_abs_err {err:.3g}  kernel {r['ms']:.4f} ms  plain "
            + (f"{r['plain_ms']:.4f} ms" if r["plain_ms"] else "not timed")
            + f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; one pass, "
            f"{floor / 1e6:.1f} MB) [per round {per_round:.4f} ms]  library "
            f"none; {calls} launches a call")
        out[thr] = r
    return out[0.95]


def pairing_wide() -> None:
    """pairing_rounds at WIDE_S samples on 2^16 columns (C = 32, so that
    many segments take the cooperative launch): 2^12 profiles with noise
    0.1 through lsh_keys, sort_keys and permute_state at h = 16, then
    pairing_case (exact, timed; logged only)."""
    n = 1 << 16
    r = np.random.default_rng(WIDE_S)
    prof = r.normal(size=(WIDE_S, n >> 4)).astype(np.float32)
    wide = prof[:, r.integers(0, n >> 4, n)] + 0.1 * r.normal(
        size=(WIDE_S, n)).astype(np.float32)
    wide = torch.from_numpy(wide).to(DEV)
    wsz = torch.ones(n, dtype=torch.int32, device=DEV)
    h = engine._active_h_of(n)
    key, _ = kernels.lsh_keys(wide, wsz, rng.draw_hyperplanes(0, 0, WIDE_S)
                              .to(DEV), h)
    skey, order = kernels.sort_keys(key, lsh.KEY_BITS)
    slots = torch.arange(n, dtype=torch.int32, device=DEV)
    sv, ss, sl = kernels.permute_state(wide, wsz, slots, order)
    pairing_case((sv, ss, sl, skey), h)


def lsh_keys_cases(values, sizes, planes, h: int) -> None:
    """lsh_keys exact at h = 1 and 30 beside the data's h and, at SMALL, at
    WIDE_S samples on 2^16 columns (timed, logged only)."""
    M = values.shape[1]
    for hh in (1, lsh.H_MAX):
        _exact(f"lsh_keys at h = {hh}",
               zip(kernels.lsh_keys(values, sizes, planes, hh),
                   kernels.lsh_keys_plain(values, sizes, planes, hh)))
    log(f"lsh_keys at {M}: h = {h}, {kernels.lsh_plan(S, h)['planes']} sign "
        f"planes computed; exact at h = 1 and 30 too")
    if M != SMALL:
        return
    n = 1 << 16
    r = np.random.default_rng(WIDE_S)
    wide = torch.from_numpy(r.normal(size=(WIDE_S, n)).astype(np.float32))
    wide = wide.to(DEV)
    wsz = torch.from_numpy(r.integers(0, 3, n, dtype=np.int32)).to(DEV)
    wpl = rng.draw_hyperplanes(1, 0, WIDE_S).to(DEV)
    for hh in (1, h, lsh.H_MAX):
        _exact(f"lsh_keys at S = {WIDE_S}, h = {hh}",
               zip(kernels.lsh_keys(wide, wsz, wpl, hh),
                   kernels.lsh_keys_plain(wide, wsz, wpl, hh)))
    t = timings(lambda: kernels.lsh_keys(wide, wsz, wpl, h),
                lambda: kernels.lsh_keys_plain(wide, wsz, wpl, h),
                4 * WIDE_S * n + 12 * n + 4 * WIDE_S * wpl.shape[1],
                2 * WIDE_S * n * (h + 1))
    log(f"lsh_keys at S = {WIDE_S}, {n} columns: exact at h = 1, {h} and "
        f"30; kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")


def finalize_deep() -> None:
    """finalize on the forest of a session as deep as phase 5's: SMALL x 20
    through testdata.FOREST_ROUNDS iterations annealed as -I 20 -N 0.8,
    exact against its plain version, timed (logged only)."""
    counts = torch.from_numpy(make_counts(SMALL, seed=2)).to(DEV)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / SMALL).float())
    sl = torch.arange(SMALL, dtype=torch.int32, device=DEV)
    parent = sl.clone()
    for it in range(testdata.FOREST_ROUNDS):
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(DEV),
            0.95 - 0.0075 * it, engine._active_h_of(int((sz > 0).sum())))[:3]
    entry, na = finalize_timed(vt, sz, sl, parent)
    log(f"finalize after {testdata.FOREST_ROUNDS} iterations: {na} clusters "
        f"over {SMALL} rows, exact; kernel {entry['ms']:.4f} ms  plain "
        f"{entry['plain_ms']:.4f} ms")


def wrs_case(values: np.ndarray, sizes: np.ndarray, n: int,
             what: str) -> dict:
    """The t-test kernel on rows of n + n samples against its plain version
    (verdicts exact, tails within rtol 1e-5 / atol 1e-6), both timed, with
    its bound and the fraction's steps. Returns the kernel's entry."""
    v = torch.from_numpy(values).to(DEV)
    sz = torch.from_numpy(sizes).to(DEV)
    args = (v, sz, n, n, 0.01, 5)
    k = kernels.wrs_verdicts(*args)
    p = kernels.wrs_verdicts_plain(*args)
    _exact("wrs_verdicts", [(k[0], p[0])])
    # the same float32 operations in the same order, and the same CUDA
    # lgammaf / logf / log1pf / expf: a few ulps at most
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    n1, n2 = int((k[0] == 1).sum()), int((k[0] == 2).sum())
    if n1 == 0 or n2 == 0:
        raise AssertionError(f"wrs_verdicts: {n1} / {n2} rows in groups 1 / 2")
    N = len(values)
    steps = ttest.fraction_steps(v, n, n)
    # rows and sizes in, verdicts and both tails out; four operations a
    # value (the group sums and squared deviations), 24 a row (the
    # statistic, the swap and the tail) and 12 a step of the continued
    # fraction these rows take
    entry = dict(max_abs_err=_max_err(zip(k[1:], p[1:])),
                 **timings(lambda: kernels.wrs_verdicts(*args),
                           lambda: kernels.wrs_verdicts_plain(*args),
                           (8 * n + 13) * N,
                           (8 * n + 24) * N + 12 * float(steps.sum())))
    log(f"wrs_verdicts on {what}: {n1} in group 1, {n2} in group 2; "
        f"kernel {entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); "
        + step_stats(steps))
    return entry


def phase_kernels_mode_e() -> dict:
    """The t-test on 2^20 cluster rows of 10 + 10 samples (and of 50 + 50,
    logged only) and the read scorer on one full part (2^16 reads of 150
    bp, k = 31, 2^22 keys), each against its plain version on the same
    CUDA inputs."""
    res = {}
    for n in (S // 2, WIDE_E // 2):
        entry = wrs_case(*testdata.wrs_rows(SMALL, n, n, seed=3), n,
                         f"{SMALL} rows of {n} + {n}")
        res.setdefault("wrs_verdicts", entry)   # the line's: 10 + 10

    t0 = time.perf_counter()
    seqs, keys, tie = testdata.read_part(reads.READS_CAP, 1 << 22, k=K_E,
                                         read_len=READ_LEN, seed=4)
    log(f"score_reads: part of {len(seqs)} reads and {len(keys)} keys made "
        f"in {time.perf_counter() - t0:.1f} s")
    part = [torch.from_numpy(a).to(DEV) for a in reads.pack_part(seqs, K_E)]
    dkeys = torch.from_numpy(keys.view(np.int64)).to(DEV)
    directory = kernels.key_directory(dkeys)
    bits = directory.numel().bit_length() - 1
    # the library call: torch.searchsorted of each prefix's least key in
    # the keys in signed order; the last entry, D, needs no search
    flipped = dkeys ^ kernels._SIGN
    least = ((torch.arange(1 << bits, dtype=torch.int64, device=DEV)
              << (64 - bits)) ^ kernels._SIGN)

    def library():
        return torch.searchsorted(flipped, least, out_int32=True)

    _exact("key_directory against torch.searchsorted",
           [(directory[:-1], library())])
    # keys in, the directory out; one search of the keys a directory entry
    # is the kernel's own choice, not counted
    res["key_directory"] = dict(
        max_abs_err=_exact("key_directory", [
            (directory, kernels.key_directory_plain(dkeys))]),
        **timings(lambda: kernels.key_directory(dkeys),
                  lambda: kernels.key_directory_plain(dkeys),
                  8 * len(keys) + 4 * directory.numel(), library=library))
    args = (*part, dkeys, K_E, 0.5)
    k = kernels.score_reads(*args, directory)
    p = kernels.score_reads_plain(*args)
    _exact("score_reads", [(k, p)])
    mask = k.cpu().numpy()
    native = reads.score_part_native(seqs, keys, K_E, 0.5)
    if not np.array_equal(mask, native):
        raise AssertionError(f"score_reads: {int((mask != native).sum())} "
                             "reads differ from the native scorer")
    if mask[tie] or not 0 < mask.sum() < len(mask):
        raise AssertionError(f"score_reads: tie read selected or "
                             f"{int(mask.sum())} of {len(mask)} selected")
    # the library call: torch.searchsorted of the queries the kernel looks
    # up (every window of every eligible read) in the same keys
    codes, ws, nw, lens = part
    nw = torch.where(lens >= K_E + 10, nw, 0).long()
    first = torch.repeat_interleave(ws.long() - torch.cumsum(nw, 0) + nw, nw)
    windows = first + torch.arange(int(nw.sum()), device=DEV)
    queries = kernels.score_queries_plain(codes, K_E)[windows]
    # codes, per-read windows and lengths, and the keys in; the mask out
    res["score_reads"] = dict(
        max_abs_err=_max_err([(k, p)]),
        **timings(lambda: kernels.score_reads(*args, directory),
                  lambda: kernels.score_reads_plain(*args),
                  part[0].numel() + 13 * len(seqs) + 8 * len(keys),
                  library=lambda: torch.searchsorted(flipped, queries)))
    bucket = torch.diff(directory)
    log(f"score_reads: {len(queries)} windows; directory of "
        f"{directory.numel()} entries, {int((bucket > 0).sum())} buckets "
        f"in use, {float(bucket.float().mean()):.2f} keys a bucket on "
        f"average, {int(bucket.max())} at most")
    log(f"score_reads: {int(mask.sum())} of {len(mask)} reads selected, "
        f"equal to the plain and the native scorer")
    log_kernels(res, SMALL)
    return res


def _same_files(name: str, a: list[str], b: list[str]) -> int:
    """Byte-compare pairs of files; the number of FASTQ records in a."""
    records = 0
    for x, y in zip(a, b, strict=True):
        bx = open(x, "rb").read()
        if bx != open(y, "rb").read():
            raise AssertionError(f"{name}: {x} and {y} differ")
        records += bx.count(b"\n+\n")
    return records


def run_mode_e(argv: list[str], scorer: str,
               samples: tuple[list[str], list[str]], out_dir: str,
               tag: str) -> dict:
    """Mode E once, ``argv`` being the CLI's flags without --only, -M, -o,
    -p and --read-scorer. The cluster file's parse is dropped first, so
    that every run's E_wrs reads it. Returns the mode-E kernels' launches,
    the stages, the verdicts and the extracted files (group A's first)."""
    pa, pb = (os.path.join(out_dir, f"{tag}_{g}") for g in "AB")
    params, device = params_from_args(argv + [
        "--only", "-M", "E", "-o", pa, "-p", pb, "--read-scorer", scorer])
    clusterio._CLUST_CACHE.clear()
    kernels.reset_launches()
    stages = pipeline.kmer_cluster(params, device)
    if pipeline.LAST_SCORER != scorer:
        raise AssertionError(f"mode E ran scorer {pipeline.LAST_SCORER}, "
                             f"not {scorer}")
    return dict(launches={k: kernels.launches[k] for k in MODE_E},
                stages=stages, verdicts=pipeline.LAST_VERDICTS,
                outs=[f"{pre}_{os.path.basename(f)}"
                      for pre, part in zip((pa, pb), samples) for f in part])


def phase_fixture(tmp: str) -> None:
    """Modes K, B and C through the CLI on the synthetic FASTQ fixture, then
    mode E with the device and with the native scorer."""
    m = testdata.generate(os.path.join(tmp, "data"), seed=99)
    base = ["-a", m["lists"]["A"], "-b", m["lists"]["B"], "-K", "15",
            "--work-dir", tmp, "-F", os.path.join(tmp, "clustering_result.txt"),
            "-D", os.path.join(tmp, "tmp"), "--seed", "5", "-I", "15",
            "-N", "0.85"]
    for mode in ("K", "B", "C"):
        cli_main(base + ["--only", "-M", mode])
    for name in ("kmer_set.hex", "kmer_count.bin", "kmer_count.log",
                 "clustering_result.txt", "clustering_result.txt.clust"):
        if not os.path.exists(os.path.join(tmp, name)):
            raise AssertionError(f"fixture: {name} missing")
    kmap, _ = countsio.read_log(os.path.join(tmp, "kmer_count.log"))
    values, ids = clusterio.read_cluster_all(
        os.path.join(tmp, "clustering_result.txt"), 4)
    flat = ids.flat.astype(np.int64)
    if len(np.unique(flat)) != len(flat) or (flat >= kmap).any():
        raise AssertionError("fixture: a row id twice or out of range")
    if not np.isfinite(values).all():
        raise AssertionError("fixture: non-finite centroids")
    log(f"fixture: {kmap} k-mers, {len(ids)} saved clusters")

    e_argv = base + ["-S", "20", "-P", "0.01", "-V", "0.5"]
    samples = (m["samples"]["A"], m["samples"]["B"])
    dev = run_mode_e(e_argv, "device", samples, tmp, "device")
    native = run_mode_e(e_argv, "native", samples, tmp, "native")
    n = _same_files("fixture", dev["outs"], native["outs"])
    if n == 0:
        raise AssertionError("fixture: no read extracted")
    keys = countsio.read_hex(os.path.join(tmp, countsio.HEX_NAME))
    got = pipeline.diff_key_sets(keys, ids, dev["verdicts"])
    for g, diff in zip("AB", got):
        mk = testdata.marker_keys(m["markers"][g], 15)
        frac = np.isin(mk[np.isin(mk, keys)], diff).mean()
        if not frac > 0.8:
            raise AssertionError(f"fixture: {frac:.0%} of group {g} markers")
        log(f"fixture: mode E recovers {frac:.0%} of group {g}'s markers")
    log(f"fixture: mode E extracted {n} reads, device and native scorers "
        f"byte-identical")


def check_clustering(tag: str, clust: str, counts: np.ndarray,
                     v_kmers: list[float],
                     f16_rounds: int = 0) -> tuple[int, float]:
    """A mode-C clustering file of ``counts``: every row id once and in
    range, finite centroids, and the centroids of 1000 sampled clusters
    equal to their members' mean recomputed on the host. ``f16_rounds``
    counts the tmp round files (float16) that the centroids passed
    through, each of which may move a value by half a float16 ulp. Returns
    (saved clusters, the largest centroid error)."""
    values, ids = clusterio.read_cluster_all(clust, counts.shape[0])
    return len(ids), check_groups(tag, values, ids, counts, v_kmers,
                                  f16_rounds)


def check_groups(tag: str, values: np.ndarray, ids, counts: np.ndarray,
                 v_kmers: list[float], f16_rounds: int = 0) -> float:
    """check_clustering's checks on centroids [K, S] and their member
    groups; returns the largest centroid error."""
    flat = ids.flat.astype(np.int64)
    if len(np.unique(flat)) != len(flat) or (flat >= counts.shape[1]).any():
        raise AssertionError(f"{tag}: a row id twice or out of range")
    if (not np.isfinite(values).all()
            or values.shape != (len(ids), counts.shape[0])):
        raise AssertionError(f"{tag}: centroids malformed")
    r = np.random.default_rng(0)
    pick = r.choice(len(ids), size=min(1000, len(ids)), replace=False)
    v = np.asarray(v_kmers, np.float32)
    worst = 0.0
    for c in pick:
        members = ids[int(c)].astype(np.int64)
        rows = np.log1p(counts[:, members].astype(np.float64)) - v[:, None]
        want = rows.mean(axis=1)
        # rtol 1e-4 of the member values' magnitude (~1): the engine sums in
        # float32, in chain order
        err = np.abs(values[c] - want).max()
        worst = max(worst, float(err))
        # a tmp round stores each value to within half a float16 ulp,
        # 2^-11 of its magnitude; a weighted mean keeps that bound
        if err > (1e-4 * max(1.0, np.abs(want).max())
                  + f16_rounds * 2**-11 * max(1.0, np.abs(rows).max())):
            raise AssertionError(f"{tag}: cluster {c} centroid off by {err}")
    return worst


def phase_full(tmp: str) -> dict:
    """Mode C at 2^24 x 20 through the CLI, cold then warm."""
    t0 = time.perf_counter()
    counts = make_counts(FULL, seed=0)
    v_kmers = write_matrix(tmp, counts)
    log(f"full: data {FULL} x {S} written in "
        f"{time.perf_counter() - t0:.1f} s")
    clust = os.path.join(tmp, "result.txt")
    argv = ["-a", os.path.join(tmp, "l1"), "-b", os.path.join(tmp, "l2"),
            "--only", "-M", "C", "-I", "20", "-N", "0.8", "--seed", "0",
            "--work-dir", tmp, "-F", clust, "-D", os.path.join(tmp, "tmp")]
    base = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    forest = {}
    real_finalize = kernels.finalize

    def keep_forest(vt, sz, sl, parent):   # the session's forest, kept
        forest["parent"] = parent.clone()
        return real_finalize(vt, sz, sl, parent)

    kernels.finalize = keep_forest
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        cli_main(argv)
    finally:
        kernels.finalize = real_finalize
    cold = time.perf_counter() - t0
    # the cold run's own peak: above what was allocated before it (and
    # before this script's copy of its forest, made at its end)
    session_peak = torch.cuda.max_memory_allocated(DEV) - base
    launches = dict(kernels.launches)   # permute_state's too, 0 here
    missing = [k for k in MODE_C if launches[k] == 0]
    if missing:
        raise AssertionError(f"mode C never launched {missing}")
    cold_device = engine.LAST_SESSION["device_seconds"]
    t0 = time.perf_counter()
    cli_main(argv)
    warm = time.perf_counter() - t0
    warm_device = engine.LAST_SESSION["device_seconds"]
    peak = torch.cuda.max_memory_allocated(DEV)
    trace_mode_c(argv)

    saved, worst = check_clustering("full", clust, counts, v_kmers)
    n_clusters = engine.LAST_SESSION["clusters"]
    log(f"full: {n_clusters} clusters, {saved} saved (size > 5); centroids "
        f"of 1000 sampled clusters within {worst:.3g} of the host means")
    log(f"full: cold {cold:.3f} s (device {cold_device:.3f} s), warm "
        f"{warm:.3f} s (device {warm_device:.3f} s), peak device memory "
        f"{peak / 2**30:.2f} GiB; the cold session's own {session_peak} "
        f"bytes = {session_peak / FULL:.3f} a row, above the {base} held "
        f"before it")
    log(f"full: programs {engine.LAST_SESSION['programs']}")
    deepest, mean = testdata.forest_depth(forest.pop("parent"))
    log(f"full: the session's forest is {deepest} deep at most, {mean:.3f} "
        f"on average")
    return dict(launches=launches, clusters=n_clusters, saved=saved,
                cold=cold, warm=warm, counts=counts, v_kmers=v_kmers,
                argv=argv, session_peak=session_peak)


def phase_narrow(tmp: str) -> None:
    """Mode C of the benchmark's kostic18 cohort through the CLI: a 10^8 x
    18 kmer_count.bin (make_data's distribution, seed 11), -I 100 -N 0.8
    at the upstream's --batch-thresh 1e8, which the port's batch does not
    lower at 18 samples, so one engine session clusters the matrix
    (kmap_size <= eff_batch: no batch pass); the profile-major scratch of
    its kernels holds 2.4e9 words. The clustering checked as phase 5's;
    the stage times, the session's programs and the card's peak logged."""
    t0 = time.perf_counter()
    counts, v = testdata.session_input(NARROW_M, NARROW_S, 11, DEV)
    counts = counts.cpu().numpy()
    v_kmers = write_matrix(tmp, counts)
    log(f"narrow: data {NARROW_M} x {NARROW_S} written in "
        f"{time.perf_counter() - t0:.1f} s")
    clust = os.path.join(tmp, "result.txt")
    argv = ["-a", os.path.join(tmp, "l1"), "-b", os.path.join(tmp, "l2"),
            "--only", "-M", "C", "-I", "100", "-N", "0.8", "--seed", "0",
            "--batch-thresh", str(NARROW_M), "--work-dir", tmp, "-F", clust,
            "-D", os.path.join(tmp, "tmp")]
    pipeline._DEVICE_COUNTS_CACHE.clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    kernels.reset_launches()
    t0 = time.perf_counter()
    cli_main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV) - base
    times = dict(pipeline.LAST_STAGES.times)
    programs = engine.LAST_SESSION["programs"]
    if ("C_init_clustering" in times or "C_cluster" not in times
            or programs[0][0] != f"transform@{NARROW_M}"
            or kernels.launches["abundance_transform"] != 1
            or kernels.launches["finalize"] != 1):
        raise AssertionError(f"narrow: not one session ({times}, "
                             f"{programs[:2]}, {kernels.launches})")
    pipeline._DEVICE_COUNTS_CACHE.clear()
    saved, worst = check_clustering("narrow", clust, counts, v_kmers)
    n_clusters = engine.LAST_SESSION["clusters"]
    log(f"narrow: one session, {n_clusters} clusters, {saved} saved; "
        f"centroids of 1000 sampled clusters within {worst:.3g} of the host "
        f"means; wall {wall:.3f} s, device "
        f"{engine.LAST_SESSION['device_seconds']:.3f} s, pull "
        f"{engine.LAST_SESSION['pull_seconds']:.3f} s, "
        f"{engine.LAST_SESSION['sorted_keys']} keys sorted; the card's peak "
        f"{peak} B above the {base} held before = {peak / NARROW_M:.3f} a "
        f"row")
    log("narrow: stages " + ", ".join(f"{k} {t:.3f} s"
                                      for k, t in times.items()))
    log(f"narrow: programs {programs[:4]} ... {programs[-2:]}")


def pairing_session(counts, v_kmers, thr) -> tuple:
    """engine.cluster_counts with merge="pairing" (PAIR_ROUNDS rounds, the
    deep init pass a chain collapse) on a numpy count matrix: (result,
    launches, LAST_SESSION, forest, wall seconds)."""
    forest = {}
    real_finalize = kernels.finalize

    def keep_forest(vt, sz, sl, parent):
        forest["parent"] = parent.clone()
        return real_finalize(vt, sz, sl, parent)

    kernels.finalize = keep_forest
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = engine.cluster_counts(counts, v_kmers, thr, seed=0,
                                    rounds=PAIR_ROUNDS, deep_init=True,
                                    merge="pairing", device=DEV)
    finally:
        kernels.finalize = real_finalize
    wall = time.perf_counter() - t0
    return (out, dict(kernels.launches), dict(engine.LAST_SESSION),
            forest["parent"], wall)


def phase_pairing(full: dict) -> dict:
    """Phase 5d: phase 5's matrix through engine.cluster_counts with
    merge="pairing" at phase 5's schedule (-I 20 -N 0.8, seed 0), checked
    as phase 5's clustering; K10 launched once a pairing iteration; then
    the same session on the first PAIR_SAME columns with K10 and with its
    plain version substituted, whose members, sizes and centroids must be
    byte-identical."""
    i, floor = 20, 0.8
    thr = np.concatenate([[0.95], 0.95 - (0.95 - floor) / i * np.arange(i)]
                         ).astype(np.float32)
    counts, v = full["counts"], full["v_kmers"]
    (cents, sizes, groups), launches, st, parent, wall = pairing_session(
        counts, v, thr)
    iters = sum(name.startswith("iter[") for name, _ in st["programs"])
    if launches["pairing_rounds"] != iters - 1 or launches[
            "chain_collapse"] != 1:
        raise AssertionError(f"pairing: {iters} iterations launched K10 "
                             f"{launches['pairing_rounds']} and K3 "
                             f"{launches['chain_collapse']} times")
    worst = check_groups("pairing", cents, groups, counts, v)
    deepest, mean = testdata.forest_depth(parent)
    log(f"pairing: {len(groups)} clusters over {counts.shape[1]} rows at "
        f"{PAIR_ROUNDS} rounds (phase 5's chain merge: {full['clusters']}, "
        f"{len(groups) / full['clusters'] - 1:+.2%}); wall {wall:.3f} s, "
        f"device {st['device_seconds']:.3f} s, pull "
        f"{st['pull_seconds']:.3f} s; {iters} iterations, K10 launched "
        f"{launches['pairing_rounds']} times; centroids of 1000 sampled "
        f"clusters within {worst:.3g} of the host means; forest "
        f"{deepest} deep at most, {mean:.3f} on average")
    log(f"pairing: programs {st['programs']}")
    part = np.ascontiguousarray(counts[:, :PAIR_SAME])
    got = pairing_session(part, v, thr)[0]
    real = kernels.pairing_rounds
    kernels.pairing_rounds = kernels.pairing_rounds_plain
    try:
        want = pairing_session(part, v, thr)[0]
    finally:
        kernels.pairing_rounds = real
    same = (np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
            and np.array_equal(got[1], want[1])
            and np.array_equal(got[2].flat, want[2].flat)
            and np.array_equal(got[2].offsets, want[2].offsets))
    if not same:
        raise AssertionError(f"pairing at {PAIR_SAME}: K10's session "
                             "differs from its plain version's")
    log(f"pairing at {PAIR_SAME}: {len(got[2])} clusters, byte-identical "
        "with K10 and with pairing_rounds_plain")
    return dict(launches={"pairing_rounds": launches["pairing_rounds"]},
                clusters=len(groups))


def phase_out_of_core(full: dict, tmp: str) -> dict:
    """Phase 5's matrix out of core through the CLI: --batch-thresh
    OOC_BATCH gives four batch passes, then merge rounds and the final
    anneal; the result checked as phase 5's, its count beside phase 5's.
    Then the bytes a row of a session, measured on the card, held against
    the peak of phase 5's cold session over its rows, and the batch budget
    at S and 400 samples. Returns the run's cluster counts (all, saved)."""
    argv = list(full["argv"])
    clust = os.path.join(tmp, "ooc_result.txt")
    argv[argv.index("-F") + 1] = clust
    argv[argv.index("-D") + 1] = os.path.join(tmp, "ooc_tmp")
    argv += ["--batch-thresh", str(OOC_BATCH)]
    torch.cuda.reset_peak_memory_stats(DEV)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with recording() as calls:
        cli_main(argv)
    wall = time.perf_counter() - t0
    flush_overlap("out of core", calls, pipeline.LAST_STAGES, wall,
                  -(-FULL // OOC_BATCH))
    launches = {k: kernels.launches[k] for k in MODE_C}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"out of core never launched {missing}")
    st = pipeline.LAST_STAGES
    rounds = st.metrics.get("tmp_rounds", [])
    if "C_init_clustering" not in st.times or len(rounds) < 2:
        raise AssertionError(f"out of core: no merge round ({rounds})")
    saved, worst = check_clustering("out of core", clust, full["counts"],
                                    full["v_kmers"], f16_rounds=len(rounds))
    clusters = engine.LAST_SESSION["clusters"]
    log(f"out of core: {-(-FULL // OOC_BATCH)} batch passes of {OOC_BATCH} "
        f"rows, then {len(rounds) - 1} merge rounds; clusters after each "
        f"{rounds}; tmp files written {st.metrics['tmp_bytes']} bytes")
    log(f"out of core: {clusters} clusters, {saved} saved (one batch, phase "
        f"5: {full['clusters']}, {full['saved']}); centroids of 1000 "
        f"sampled clusters within {worst:.3g} of the host means")
    log(f"out of core: wall {wall:.3f} s, device {st.times['device_seconds']:.3f}"
        f" s, pull {st.times['pull_seconds']:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(DEV) / 2**30:.2f} GiB; launches "
        f"{launches}; stages " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.times.items()))

    per_row = hbm.measure_per_row_bytes(S, DEV)
    floor = full["session_peak"] / FULL
    if per_row is None or per_row < floor:
        raise AssertionError(f"bytes a row measured {per_row}, below phase "
                             f"5's session peak over its rows {floor:.3f}")
    log(f"memory: {per_row} bytes a row measured at S = {S} (phase 5's "
        f"session peak over its rows: {floor:.3f}; the static model "
        f"{14 * S + 64})")
    mem = hbm.device_memory_bytes(DEV)
    for s, n in ((S, 1 << 28), (400, 50_000_000)):
        log(f"memory: rows_budget at S = {s}: {hbm.rows_budget(s, device=DEV)}"
            f" (static), {hbm.rows_budget(s, kmap_size=n, device=DEV)} for "
            f"{n} rows (measured: {hbm.cached_per_row_bytes(s, DEV)} bytes a "
            f"row) of the card's {mem} bytes")
    return dict(clusters=clusters, saved=saved)


@contextlib.contextmanager
def recording():
    """Record every call of the port's clusterio.save_result and
    save_binary, counts.read_count_batch, engine.cluster_counts and the
    engine's finalize pull (engine._pull) made inside the block: its
    function, thread, file name (the saves), whether it was given
    defer_pull (the pipeline's batch sessions), and its start and end on
    the host's clock."""
    calls = []
    wrapped = ((clusterio, "save_result", 1), (clusterio, "save_binary", 2),
               (countsio, "read_count_batch", None),
               (engine, "cluster_counts", None), (engine, "_pull", None))
    reals = [getattr(mod, name) for mod, name, _ in wrapped]

    def wrap(name, fn, at):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls.append(dict(
                    name=name, thread=threading.get_ident(), t0=t0,
                    t1=time.perf_counter(), batch="defer_pull" in kw,
                    file=None if at is None else os.path.basename(a[at])))
        return call

    for (mod, name, at), fn in zip(wrapped, reals):
        setattr(mod, name, wrap(name, fn, at))
    try:
        yield calls
    finally:
        for (mod, name, _), fn in zip(wrapped, reals):
            setattr(mod, name, fn)


def flush_overlap(tag: str, calls: list[dict], st, wall: float,
                  batches: int) -> float:
    """From an out-of-core run's recorded calls. Every batch but the last
    must be flushed on another thread than the main one (its deferred
    pull, and its .clust and binary appends to round 0), and its flush
    (from the pull's start to the binary's end) must intersect the next
    batch's read and session: the pull starts as that read does, so
    its copies run while the main thread reads and launches. Logs, for
    each batch, how long the flush, the pull, and the appends alone
    (negative: the gap after the session) overlap the next batch's read
    and session; the thread's share of save_tmp; the batch passes' span.
    Returns that span (s)."""
    main = threading.main_thread().ident
    calls = sorted(calls, key=lambda c: c["t0"])
    of = {name: [c for c in calls if c["name"] == name and (
        c["file"] in (None, "0.bin", "0.bin.clust"))] for name in (
        "read_count_batch", "save_result", "save_binary")}
    sessions = [c for c in calls if c["name"] == "cluster_counts"
                and c["batch"]]
    pulls = [c for c in calls if c["name"] == "_pull" and c["thread"] != main]
    reads, results, binaries = (of[n] for n in (
        "read_count_batch", "save_result", "save_binary"))
    if not len(reads) == len(sessions) == len(results) == len(binaries) \
            == batches or len(pulls) != batches - 1:
        raise AssertionError(
            f"{tag}: {len(reads)} reads, {len(sessions)} sessions, "
            f"{len(results)} + {len(binaries)} saves for {batches} batches, "
            f"{len(pulls)} pulls on a flush thread")

    def overlap(a: tuple, b: tuple) -> float:
        return min(a[1], b[1]) - max(a[0], b[0])

    rows = []
    for i in range(batches - 1):
        nxt = (reads[i + 1]["t0"], sessions[i + 1]["t1"])
        flush = (pulls[i]["t0"], binaries[i]["t1"])
        if {results[i]["thread"], binaries[i]["thread"]} & {main}:
            raise AssertionError(f"{tag}: batch {i}'s save ran on the main "
                                 f"thread")
        if not pulls[i]["t1"] <= results[i]["t0"]:
            raise AssertionError(f"{tag}: batch {i}'s pull is not its own")
        rows.append((overlap(flush, nxt),
                     overlap((pulls[i]["t0"], pulls[i]["t1"]), nxt),
                     overlap((results[i]["t0"], binaries[i]["t1"]), nxt)))
        if rows[-1][0] <= 0:
            raise AssertionError(
                f"{tag}: batch {i}'s flush ({flush[0]:.4f}-{flush[1]:.4f} s)"
                f" missed batch {i + 1}'s read and session ({nxt[0]:.4f}-"
                f"{nxt[1]:.4f} s)")
    thread_save = sum(c["t1"] - c["t0"] for c in results + binaries
                      if c["thread"] != main)
    span = binaries[-1]["t1"] - reads[0]["t0"]
    log(f"{tag}: flush thread: each batch's flush / pull / appends "
        f"overlapping the next batch's read and session by " + "; ".join(
            " / ".join(f"{x:.4f}" for x in r) for r in rows) + " s; "
        f"appends on the thread {thread_save:.4f} s of save_tmp "
        f"{st.times['save_tmp']:.4f} s ({thread_save / st.times['save_tmp']:.2%}"
        f"); batch passes {span:.4f} s of the {wall:.4f} s wall "
        f"({span / wall:.2%}); reads " + ", ".join(
            f"{c['t1'] - c['t0']:.4f}" for c in reads) + " s, sessions "
        + ", ".join(f"{c['t1'] - c['t0']:.4f}" for c in sessions) + " s, "
        "flushes " + ", ".join(f"{b['t1'] - p['t0']:.4f}" for p, b in zip(
            pulls, binaries)) + " s (pull with its host copies / regroup / "
        ".clust append / binary append: " + "; ".join(
            f"{p['t1'] - p['t0']:.4f} / {r['t0'] - p['t1']:.4f} / "
            f"{r['t1'] - r['t0']:.4f} / {b['t1'] - b['t0']:.4f}"
            for p, r, b in zip(pulls, results, binaries)) + " s)")
    return span


def pinned_copies(trace, path: str) -> tuple[set, list]:
    """From a torch.profiler trace exported to ``path``: (the streams of
    every kernel, the (stream, bytes) of every device-to-pinned copy)."""
    trace.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def stream(e):
        return e.get("args", {}).get("stream", e.get("tid"))

    kern = {stream(e) for e in events if e.get("cat") == "kernel"}
    pinned = [(stream(e), e["args"]["bytes"]) for e in events
              if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "") and "Pinned" in e["name"]]
    return kern, pinned


def phase_flush(tmp: str) -> None:
    """Phase 5c: a FLUSH_ROWS x 20 matrix out of core at --batch-thresh
    FLUSH_BATCH through the CLI, as shipped (deferred) and sequential
    (pipeline._defers patched to False) in turns, deferred, sequential,
    sequential, deferred, then as shipped under torch.profiler. Every
    run's clustering files must be byte-identical to the first
    sequential run's and its tmp_rounds and tmp_bytes equal; in the
    traced run every deferred pull's copies (device to pinned host
    memory) must run on a stream that no kernel ran on."""
    counts = make_counts(FLUSH_ROWS, seed=1)
    write_matrix(tmp, counts)
    base = ["-a", os.path.join(tmp, "l1"), "-b", os.path.join(tmp, "l2"),
            "--only", "-M", "C", "-I", "20", "-N", "0.8", "--seed", "0",
            "--work-dir", tmp, "--batch-thresh", str(FLUSH_BATCH)]
    batches = -(-FLUSH_ROWS // FLUSH_BATCH)
    real_defers = pipeline._defers
    out = {}
    for run in ("deferred", "sequential", "sequential 2", "deferred 2",
                "traced"):
        clust = os.path.join(tmp, f"{run.replace(' ', '')}.txt")
        argv = base + ["-F", clust, "-D", clust + ".tmp"]
        if run.startswith("sequential"):
            pipeline._defers = lambda bs, S, device: False
        kernels.reset_launches()
        try:
            with contextlib.ExitStack() as stack:
                calls = stack.enter_context(recording())
                if run == "traced":
                    trace = stack.enter_context(torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA]))
                t0 = time.perf_counter()
                cli_main(argv)
                wall = time.perf_counter() - t0
        finally:
            pipeline._defers = real_defers
        missing = [k for k in MODE_C if kernels.launches[k] == 0]
        if missing:
            raise AssertionError(f"flush {run}: never launched {missing}")
        st = pipeline.LAST_STAGES
        tag = f"flush {run}"
        if run.startswith("sequential"):
            main = threading.main_thread().ident
            if {c["thread"] for c in calls} != {main}:
                raise AssertionError(f"{tag}: a call off the main thread")
            span = (max(c["t1"] for c in calls if c["file"] == "0.bin")
                    - min(c["t0"] for c in calls
                          if c["name"] == "read_count_batch"))
            log(f"{tag}: batch passes {span:.4f} s of the {wall:.4f} s wall "
                f"({span / wall:.2%})")
        else:
            span = flush_overlap(tag, calls, st, wall, batches)
        files = [open(clust + ext, "rb").read() for ext in ("", ".clust")]
        out[run] = dict(files=files, rounds=list(st.metrics["tmp_rounds"]),
                        tmp_bytes=st.metrics["tmp_bytes"], wall=wall,
                        span=span)
        log(f"{tag}: wall {wall:.4f} s, rounds {out[run]['rounds']}, tmp "
            f"bytes {out[run]['tmp_bytes']}, device "
            f"{st.times['device_seconds']:.4f} s, pull "
            f"{st.times['pull_seconds']:.4f} s; stages " + ", ".join(
                f"{k} {v:.4f}" for k, v in st.times.items()))
    ref = out["sequential"]
    for run, got in out.items():
        if got["files"] != ref["files"]:
            raise AssertionError(f"flush {run}: the clustering files differ "
                                 f"from the sequential run's")
        if (got["rounds"], got["tmp_bytes"]) != (ref["rounds"],
                                                 ref["tmp_bytes"]):
            raise AssertionError(f"flush {run}: rounds {got['rounds']} / "
                                 f"{got['tmp_bytes']} bytes, sequential "
                                 f"{ref['rounds']} / {ref['tmp_bytes']}")
    # a deferred pull copies four arrays into pinned memory on a side
    # stream; the other device-to-pinned copies, the immediate pulls (the
    # merge rounds') and the scalars .item() reads (the alive counts), run
    # on the kernels' stream: every batch's four must be off it
    kern, pinned = pinned_copies(trace, os.path.join(tmp, "trace.json"))
    pulls = [c for c in pinned if c[1] > 8 and c[0] not in kern]
    scalars = [c for c in pinned if c[1] <= 8]
    side = {c[0] for c in pulls}
    if len(pulls) < 4 * batches:
        raise AssertionError(
            f"flush traced: {len(pulls)} device-to-pinned copies of more "
            f"than 8 bytes on streams {sorted(side)} where no kernel ran "
            f"(kernels on {sorted(kern)}), fewer than {4 * batches}")
    log(f"flush: the three runs' files byte-identical "
        f"({len(ref['files'][0])} + {len(ref['files'][1])} bytes, "
        f"{len(ref['rounds']) - 1} merge rounds); the traced run's "
        f"{len(pulls)} deferred-pull copies ({sum(c[1] for c in pulls)} "
        f"bytes) on streams {sorted(side)}, its kernels on {sorted(kern)} "
        f"(with {len(scalars)} scalar reads on streams "
        f"{sorted({c[0] for c in scalars})})")
    log("flush: batch passes (s) " + ", ".join(
        f"{run} {r['span']:.4f}" for run, r in out.items()) + "; walls (s) "
        + ", ".join(f"{run} {r['wall']:.4f}" for run, r in out.items()))


def kernel_group(name: str) -> str:
    """The row of phase 5's device-time split a device event belongs to:
    a group, or the kernel's own name (the template arguments kept)."""
    name = name.removeprefix("void ").split("(")[0]
    if name.startswith("kl_permute"):
        return "permute_state (kl_permute*)"
    if name.startswith("kl_chain"):
        return "chain_collapse (kl_chain*)"
    if name.startswith("kl_sort"):
        return "sort_keys (kl_sort*)"
    if name.startswith("kl_") or "sort" in name.lower():
        return name
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and fills"
    return "other PyTorch kernels"


def trace_mode_c(argv: list[str]) -> None:
    """One more warm mode-C run under torch.profiler: the card's time by
    kernel group, its busy time and idle share of the run's wall."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        cli_main(argv)
        wall = time.perf_counter() - t0
    by = {}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            g = kernel_group(e.name)
            ms, n = by.get(g, (0.0, 0))
            by[g] = (ms + (e.time_range.end - e.time_range.start) * 1e-3, n + 1)
    busy = device_busy_seconds(trace)
    if busy <= 0:
        raise AssertionError("full: the profiler saw no device time")
    for name in ("permute_state (kl_permute*)", "chain_collapse (kl_chain*)",
                 "sort_keys (kl_sort*)"):
        if name not in by:
            raise AssertionError(f"full: no {name} kernel in the trace")
    others = [g for g in by if "sort" in g.lower()
              and g != "sort_keys (kl_sort*)"]
    if others:
        raise AssertionError(f"full: sort kernels other than K9's in the "
                             f"trace: {others}")
    for kernel, names in (("lsh_keys", ("kl_project", "kl_quantize")),
                          ("finalize", ("kl_fin_",))):
        if not any(g.startswith(names[0]) for g in by):
            raise AssertionError(f"full: no {names[0]}* kernel in the trace")
        ms = sum(t for g, (t, _) in by.items() if g.startswith(names))
        log(f"full traced run: {kernel} ({'*, '.join(names)}*) {ms:.3f} ms")
    log(f"full traced run (warm, under torch.profiler): wall {wall:.4f} s, "
        f"device session {engine.LAST_SESSION['device_seconds']:.4f} s, "
        f"card busy {busy:.4f} s = idle {1 - busy / wall:.2%}")
    for g, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        log(f"full traced run: {g}: {ms:.3f} ms in {n} device events")


def host_verdicts(values: np.ndarray, sizes: np.ndarray, pval: float,
                  size_thresh: int):
    """float64 AB::WRS with scipy's t distribution → (verdicts, left,
    right)."""
    from scipy import stats

    x = values[:, :S // 2].astype(np.float64)
    y = values[:, S // 2:].astype(np.float64)
    n1, n2 = x.shape[1], y.shape[1]
    xm, ym = x.mean(1), y.mean(1)
    ss = ((x - xm[:, None]) ** 2).sum(1) + ((y - ym[:, None]) ** 2).sum(1)
    df = n1 + n2 - 2
    s = np.sqrt(ss * (1 / n1 + 1 / n2) / df)
    ok = s > 0
    t = (xm - ym) / np.where(ok, s, 1.0)
    left = np.where(ok, stats.t.cdf(t, df), (xm >= ym).astype(float))
    right = np.where(ok, stats.t.sf(t, df), (xm <= ym).astype(float))
    v = np.where(left <= pval, 2, np.where(right <= pval, 1, 0))
    return np.where(sizes > size_thresh, v, 0), left, right


def phase_mode_e(tmp: str) -> dict:
    """Mode E at full size: 2^24 k-mer rows from source sequences, 20
    FASTQs of 2^16 reads, mode C, then mode E with each scorer in turn
    (E_ORDER) and one traced device-scorer run."""
    t0 = time.perf_counter()
    r = np.random.default_rng(7)
    n_w = READ_LEN - K_E + 1
    src = r.integers(0, 4, size=(-(-FULL // n_w), READ_LEN), dtype=np.uint8)
    keys = testdata.window_keys(src, K_E)[:FULL]
    testdata.write_hex(os.path.join(tmp, countsio.HEX_NAME), keys)
    # one profile per source; 3% shifted up in group A, 3% in group B
    pool = testdata.profile_pool(r, max(64, FULL >> 7), S)
    prof = pool[r.integers(0, len(pool), size=len(src))]
    kind = r.random(len(src))
    prof[kind < 0.03, :S // 2] += 0.6
    prof[(kind >= 0.03) & (kind < 0.06), S // 2:] += 0.6
    g = torch.Generator(device=DEV).manual_seed(7)
    rows = torch.arange(FULL, device=DEV) // n_w
    counts = counts_of(torch.from_numpy(prof.T.copy()).to(DEV), rows, g)
    write_matrix(tmp, counts)
    del counts
    fastqs = testdata.write_source_fastqs(tmp, src, N_FASTQ, FASTQ_READS,
                                          seed=8)
    for name, part in (("l1", fastqs[:S // 2]), ("l2", fastqs[S // 2:])):
        with open(os.path.join(tmp, name), "w") as f:
            for i, path in enumerate(part):
                f.write(f"{os.path.abspath(path)} {name}db{i}\n")
    log(f"mode E: {FULL} k-mers of {len(src)} sources, {N_FASTQ} FASTQs of "
        f"{FASTQ_READS} x {READ_LEN} bp written in "
        f"{time.perf_counter() - t0:.1f} s")

    clust = os.path.join(tmp, "result.txt")
    common = ["-a", os.path.join(tmp, "l1"), "-b", os.path.join(tmp, "l2"),
              "--work-dir", tmp, "-F", clust, "-D", os.path.join(tmp, "tmp"),
              "-K", str(K_E), "--seed", "0"]
    t0 = time.perf_counter()
    cli_main(common + ["--only", "-M", "C", "-I", "20", "-N", "0.8"])
    log(f"mode E: mode C in {time.perf_counter() - t0:.1f} s")

    # alternate the scorers, so that neither always runs first; the last
    # device run goes under torch.profiler for the card's busy time
    e_argv = common + ["-S", "5", "-P", "0.01", "-V", "0.5"]
    samples = (fastqs[:S // 2], fastqs[S // 2:])
    runs = [(scorer, run_mode_e(e_argv, scorer, samples, tmp, f"{scorer}{i}"))
            for i, scorer in enumerate(E_ORDER)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        traced = run_mode_e(e_argv, "device", samples, tmp, "traced")
        traced_wall = time.perf_counter() - t0
    busy = device_busy_seconds(trace)
    if busy <= 0:
        raise AssertionError("mode E: the profiler saw no device time")
    dev = runs[0][1]
    for scorer, run in runs + [("device", traced)]:
        if scorer == "device":
            missing = [k for k, n in run["launches"].items() if n == 0]
            if missing:
                raise AssertionError(f"mode E never launched {missing}")
        if not np.array_equal(dev["verdicts"], run["verdicts"]):
            raise AssertionError("mode E: verdicts differ between runs")
        selected = _same_files("mode E", dev["outs"], run["outs"])
    total = N_FASTQ * FASTQ_READS
    if not 0 < selected < total:
        raise AssertionError(f"mode E: {selected} of {total} reads selected")

    values, ids = clusterio.read_cluster_all(clust, S)
    sizes = ids.sizes
    verdicts = dev["verdicts"]
    tested = np.flatnonzero(sizes > 5)
    pr = np.random.default_rng(9)
    pick = pr.choice(tested, size=min(1000, len(tested)), replace=False)
    flagged = np.flatnonzero(verdicts)
    pick = np.union1d(pick, pr.choice(flagged, size=min(1000, len(flagged)),
                                      replace=False))
    want, left, right = host_verdicts(values[pick], sizes[pick], 0.01, 5)
    # where a tail lies within 1e-4 relative of -P, float32 may fall on
    # either side
    near = ((np.abs(left - 0.01) <= 1e-4 * 0.01)
            | (np.abs(right - 0.01) <= 1e-4 * 0.01))
    bad = (want != verdicts[pick]) & ~near
    if bad.any():
        raise AssertionError(f"mode E: {int(bad.sum())} of {len(pick)} "
                             "sampled verdicts differ from float64")
    counts = np.bincount(verdicts[tested], minlength=3)
    log(f"mode E: {len(ids)} clusters, {len(tested)} tested (size > 5): "
        f"{counts[0]} not significant, {counts[1]} group 1, {counts[2]} "
        f"group 2; {len(pick)} sampled verdicts equal float64 "
        f"({int(near.sum())} within 1e-4 of -P skipped)")
    m = dev["stages"].metrics
    log(f"mode E: differential k-mers {m['diff_kmers_group1']} (group A), "
        f"{m['diff_kmers_group2']} (group B); {selected} of {total} reads "
        f"selected, byte-identical between the scorers")
    out = dict(launches=dev["launches"], clusters=len(ids),
               tested=len(tested), verdicts=verdicts, outs=dev["outs"],
               argv=e_argv, samples=samples)
    for i, (scorer, run) in enumerate(runs):
        t = run["stages"].times
        log(f"mode E run {i} ({scorer} scorer): E_wrs {t['E_wrs']:.4f} s, "
            f"E_extract {t['E_extract']:.4f} s = "
            f"{total / t['E_extract']:.0f} reads/s")
    e_wrs_split(clust, verdicts)
    t = traced["stages"].times
    log(f"mode E traced run (device scorer, under torch.profiler): E_wrs "
        f"{t['E_wrs']:.4f} s, E_extract {t['E_extract']:.4f} s, wall "
        f"{traced_wall:.4f} s, card busy {busy:.4f} s = idle "
        f"{1 - busy / traced_wall:.2%}")
    return out


def e_wrs_split(clust: str, verdicts: np.ndarray) -> None:
    """E_wrs replayed on a clustering file, split by function as the stage
    runs it: the parse (clusterio.read_cluster_all, its cache cleared), the
    upload of values and sizes, the kernel (one call between CUDA events)
    and the pull of the verdicts, which must equal the runs'; then the
    kernel on these rows against its plain version (wrs_case)."""
    clusterio._CLUST_CACHE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values, ids = clusterio.read_cluster_all(clust, S)
    sizes = np.ascontiguousarray(ids.sizes, np.int32)
    t1 = time.perf_counter()
    v = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(DEV)
    sz = torch.from_numpy(sizes).to(DEV)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    verdict, _, _ = kernels.wrs_verdicts(v, sz, S // 2, S // 2, 0.01, 5)
    b.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    pulled = verdict.cpu().numpy()
    t4 = time.perf_counter()
    if not np.array_equal(pulled, verdicts):
        raise AssertionError("mode E: the replayed verdicts differ")
    log(f"mode E: E_wrs by function on this clustering file: parse "
        f"{t1 - t0:.4f} s, upload {t2 - t1:.4f} s, kernel "
        f"{a.elapsed_time(b):.4f} ms of card time ({1e3 * (t3 - t2):.4f} ms "
        f"with its launch and a synchronize), pull {1e3 * (t4 - t3):.4f} ms;"
        f" {t4 - t0:.4f} s in all")
    wrs_case(values, sizes, S // 2, f"phase 6's {len(values)} cluster rows")


def device_busy_seconds(trace) -> float:
    """Seconds in which the card ran at least one kernel or copy: the union
    of the device events' intervals in a torch.profiler trace."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in trace.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


# One rank of phases 7 and 7b: the CLI as a user runs it, then this rank's
# kernel launches, session split, stages, tmp rounds, the files it wrote
# through clusterio, wall and peak device memory to <out>.json and its
# mode-E verdicts to <out>.npy.
RANK_MAIN = r"""
import json, sys, time
import numpy as np
import torch
from kmerlsh_tpu_torch import kernels, pipeline
from kmerlsh_tpu_torch.cli import main
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.io import clusterio
from kmerlsh_tpu_torch.parallel import dist

out, argv = sys.argv[1], sys.argv[2:]
writes = []


def recorded(name):
    fn = getattr(clusterio, name)

    def wrapper(*a, **kw):
        writes.append(name)
        return fn(*a, **kw)
    setattr(clusterio, name, wrapper)


recorded("save_result")
recorded("save_binary")
kernels.reset_launches()
t0 = time.perf_counter()
main(argv)
wall = time.perf_counter() - t0
sess = dist.LAST_SESSION
rec = dict(wall=wall, launches=dict(kernels.launches),
           peak_bytes=torch.cuda.max_memory_allocated(),
           device_seconds=sess.get("device_seconds"),
           pull_seconds=sess.get("pull_seconds"),
           sharded_iterations=sess.get("sharded_iterations"),
           alive=sess.get("alive"), programs=sess.get("programs"),
           stages={k: round(v, 4)
                   for k, v in pipeline.LAST_STAGES.times.items()},
           tail=sess.get("tail"), clusters=engine.LAST_SESSION.get("clusters"),
           tmp_rounds=pipeline.LAST_STAGES.metrics.get("tmp_rounds"),
           tmp_bytes=pipeline.LAST_STAGES.metrics.get("tmp_bytes"),
           writes=len(writes),
           foreign=sorted(n for n in sys.modules if n.split(".")[0]
                          in ("jax", "jaxlib", "kmerlsh_tpu")))
if pipeline.LAST_VERDICTS is not None:
    np.save(out + ".npy", pipeline.LAST_VERDICTS)
with open(out + ".json", "w") as f:
    json.dump(rec, f)
"""
RANK_TIMEOUT = 600       # seconds for one run of the four ranks


def run_ranks(tag: str, argv: list[str], work: str) -> list[dict]:
    """RANKS processes of the CLI with ``argv`` in one process group, each
    on the card (--device cuda). Every one must exit 0; the rest are killed
    once one fails. Returns the ranks' records."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(work, f"{tag}_rank{r}") for r in range(RANKS)]
    logs = [open(o + ".log", "w") for o in outs]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, outs[r], *argv, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(RANKS), "--process-id",
         str(r), "--device", "cuda"], cwd=ROOT, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(RANKS)]
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < RANK_TIMEOUT:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = open(outs[r] + ".log").read()[-3000:]
            raise AssertionError(f"sharded {tag}: rank {r} exited "
                                 f"{p.returncode}:\n{tail}")
    recs = [json.load(open(o + ".json")) for o in outs]
    for r, rec in enumerate(recs):
        if rec["foreign"]:
            raise AssertionError(f"sharded {tag}: rank {r} imported "
                                 f"{rec['foreign']}")
        split = (f"device {rec['device_seconds']:.3f} s, pull "
                 f"{rec['pull_seconds']:.3f} s, sharded to iteration "
                 f"{rec['sharded_iterations']} with {rec['alive']} alive, "
                 f"then the {rec['tail']} tail, "
                 if rec["device_seconds"] is not None else "")
        log(f"sharded {tag}: rank {r}: wall {rec['wall']:.3f} s, {split}"
            f"peak device memory {rec['peak_bytes'] / 2**20:.1f} MiB; "
            f"stages {rec['stages']}")
    return recs


def phase_sharded(full: dict, full_dir: str, mode_e: dict,
                  e_dir: str) -> dict:
    """Phase 5's mode C, then phase 6's mode E on phase 6's clustering
    file, each on RANKS processes that share the one card."""
    argv = list(full["argv"])
    clust = os.path.join(full_dir, "sharded_result.txt")
    argv[argv.index("-F") + 1] = clust
    recs = run_ranks("C", argv, full_dir)
    log(f"sharded C: rank 0's programs {recs[0]['programs']}")
    for r, rec in enumerate(recs):
        missing = [k for k in SHARDED_C + EXCHANGE if rec["launches"][k] == 0]
        if missing:
            raise AssertionError(f"sharded C: rank {r} never launched "
                                 f"{missing}")
    tails = {(rec["tail"], rec["sharded_iterations"]) for rec in recs}
    if len(tails) != 1 or recs[0]["tail"] not in COUNT_BOUND:
        raise AssertionError(f"sharded C: the ranks' tails {sorted(tails)}")
    saved, worst = check_clustering("sharded C", clust, full["counts"],
                                    full["v_kmers"])
    total = recs[0]["clusters"]
    lo, hi = COUNT_BOUND[recs[0]["tail"]]
    for name, got, want in (("clusters", total, full["clusters"]),
                            ("saved clusters", saved, full["saved"])):
        rise = got / want - 1
        if not (rise < hi and (lo is None or rise > lo)):
            raise AssertionError(f"sharded C: {got} {name} against {want} "
                                 f"on one process ({rise:+.2%}, "
                                 f"{recs[0]['tail']} tail)")
    log(f"sharded C: {total} clusters, {saved} saved (one process: "
        f"{full['clusters']}, {full['saved']}: "
        f"{total / full['clusters'] - 1:+.2%}, "
        f"{saved / full['saved'] - 1:+.2%}, {recs[0]['tail']} tail); "
        f"centroids of 1000 sampled "
        f"clusters within {worst:.3g} of the host means; launches per rank "
        f"{[[rec['launches'][k] for k in SHARDED_C + EXCHANGE] for rec in recs]}"
        f" ({', '.join(SHARDED_C + EXCHANGE)}; four ranks share one card: not "
        f"a four-card speed)")

    pa, pb = (os.path.join(e_dir, f"sharded_{g}") for g in "AB")
    recs_e = run_ranks("E", mode_e["argv"] + ["--only", "-M", "E", "-o", pa,
                                              "-p", pb], e_dir)
    want = mode_e["verdicts"]
    for r, rec in enumerate(recs_e):
        if rec["launches"]["wrs_verdicts"] == 0:
            raise AssertionError(f"sharded E: rank {r} never launched "
                                 "wrs_verdicts")
        got = np.load(os.path.join(e_dir, f"E_rank{r}.npy"))
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"sharded E: rank {r}'s verdicts differ "
                                 "from one process's")
    outs = [f"{pre}_{os.path.basename(f)}"
            for pre, part in zip((pa, pb), mode_e["samples"]) for f in part]
    n = _same_files("sharded E", outs, mode_e["outs"])
    log(f"sharded E: {len(want)} verdicts of every rank equal one "
        f"process's; {n} extracted reads byte-identical")
    return dict(launches={k: sum(rec["launches"][k] for rec in recs)
                          for k in EXCHANGE}, clusters=total)


def phase_sharded_out_of_core(full: dict, ooc: dict, sharded: dict,
                              full_dir: str) -> None:
    """Phase 5b's out-of-core run on RANKS processes that share the one
    card: every batch pass shards OOC_BATCH rows over the ranks, and the
    merge rounds and the final anneal run sharded. Checked against phase
    5b: the same kernels launched on every rank, the ranks' round counts
    equal, rank 0 the only writer with the last round's files alone left,
    the clustering as phase 5b's, the count below phase 5b's + 15%."""
    argv = list(full["argv"])
    clust = os.path.join(full_dir, "sharded_ooc_result.txt")
    tmp_dir = os.path.join(full_dir, "sharded_ooc_tmp")
    argv[argv.index("-F") + 1] = clust
    argv[argv.index("-D") + 1] = tmp_dir
    argv += ["--batch-thresh", str(OOC_BATCH)]
    recs = run_ranks("C_ooc", argv, full_dir)
    for r, rec in enumerate(recs):
        missing = [k for k in SHARDED_C + EXCHANGE if rec["launches"][k] == 0]
        if missing:
            raise AssertionError(f"sharded out of core: rank {r} never "
                                 f"launched {missing}")
        st = rec["stages"]
        log(f"sharded out of core: rank {r}: wall {rec['wall']:.3f} s: "
            + ", ".join(f"{k} {st.get(k, 0.0):.3f} s" for k in (
                "regroup", "save_tmp", "read_tmp", "device_seconds",
                "pull_seconds"))
            + f"; tmp bytes counted {rec['tmp_bytes']}, files written "
            f"{rec['writes']}")
    rounds = recs[0]["tmp_rounds"]
    if not rounds or len(rounds) < 2 or any(
            rec["tmp_rounds"] != rounds for rec in recs):
        raise AssertionError("sharded out of core: the ranks' rounds "
                             f"{[rec['tmp_rounds'] for rec in recs]}")
    writers = [r for r, rec in enumerate(recs) if rec["writes"]]
    if writers != [0]:
        raise AssertionError(f"sharded out of core: ranks {writers} wrote")
    last = f"{len(rounds) - 1}.bin"
    left = sorted(os.listdir(tmp_dir))
    if left != [last, last + ".clust"]:
        raise AssertionError(f"sharded out of core: {left} left in the tmp "
                             "directory")
    saved, worst = check_clustering("sharded out of core", clust,
                                    full["counts"], full["v_kmers"],
                                    f16_rounds=len(rounds))
    total = recs[0]["clusters"]
    rise = total / ooc["clusters"] - 1
    if not rise < COUNT_BOUND["terminal"][1]:
        raise AssertionError(f"sharded out of core: {total} clusters "
                             f"against phase 5b's {ooc['clusters']} "
                             f"({rise:+.2%})")
    log(f"sharded out of core: {-(-FULL // OOC_BATCH)} batch passes of "
        f"{OOC_BATCH} rows in {RANKS} shards, then {len(rounds) - 1} merge "
        f"rounds; clusters after each {rounds}; tmp files written "
        f"{recs[0]['tmp_bytes']} bytes")
    log(f"sharded out of core: {total} clusters, {saved} saved (phase 5b: "
        f"{ooc['clusters']}, {ooc['saved']}: {rise:+.2%}, "
        f"{saved / ooc['saved'] - 1:+.2%}; phase 7: {sharded['clusters']}; "
        f"phase 5: {full['clusters']}); centroids of 1000 sampled clusters "
        f"within {worst:.3g} of the host means; launches per rank "
        f"{[[rec['launches'][k] for k in SHARDED_C + EXCHANGE] for rec in recs]}"
        f" (four ranks share one card: not a four-card speed)")


def main() -> None:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0:.1f} s)")

    t_start = time.perf_counter()

    def ended(phase: str) -> None:
        log(f"phase {phase} ended at {time.perf_counter() - t_start:.1f} s")

    res = phase_kernels()
    res.update(phase_kernels_mode_e())
    phase_sort_small()
    phase_kernels(LATE, exchange=False, pairing=False)   # logged only
    phase_kernels(OOC_BATCH)   # phase 5b's batch, a phase-7 rank's head
                               # capacity; logged only
    phase_kernels(FULL, exchange=False)        # logged only
    phase_finalize_cell()                      # logged only
    phase_chain_cell()                         # logged only
    phase_narrow_cell()                        # logged only
    res.update(phase_planes())
    ended("3")
    with tempfile.TemporaryDirectory() as tmp:
        phase_fixture(tmp)
    ended("4")
    with tempfile.TemporaryDirectory() as t5, \
            tempfile.TemporaryDirectory() as t6:
        full = phase_full(t5)
        ended("5")
        pairing = phase_pairing(full)
        ended("5d")
        ooc = phase_out_of_core(full, t5)
        ended("5b")
        with tempfile.TemporaryDirectory() as t5c:
            phase_flush(t5c)
        ended("5c")
        with tempfile.TemporaryDirectory() as t5e:
            phase_narrow(t5e)
        ended("5e")
        mode_e = phase_mode_e(t6)
        ended("6")
        pipeline._DEVICE_COUNTS_CACHE.clear()
        torch.cuda.empty_cache()
        sharded = phase_sharded(full, t5, mode_e, t6)
        ended("7")
        phase_sharded_out_of_core(full, ooc, sharded, t5)
        ended("7b")
    for name in ("jax", "kmerlsh_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")

    launches = {**full["launches"], **mode_e["launches"],
                **sharded["launches"], **pairing["launches"]}
    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **res[name])
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
