"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the CUDA kernels from kmerlsh_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the same CUDA inputs,
     with both timed (CUDA events, median of 5 after a warm-up): the mode-C
     kernels at 2^20 x 20, the t-test on 2^20 cluster rows of 10 + 10
     samples, the read scorer on one part of 2^16 reads of 150 bp against
     2^22 keys (k = 31);
  4. the CLI on the synthetic FASTQ fixture: --only K, then B, then C, then
     E with the device scorer and with the native scorer, whose extracted
     reads must agree byte for byte and recover the planted markers;
  5. full size: a 2^24 x 20 count matrix with the distribution of
     bench.py make_data, mode C through the CLI (-I 20 -N 0.8) cold and warm,
     with the mode-C kernels' launch counts, the result checked against the
     matrix recomputed on the host;
  6. mode E at full size: a 2^24 x 20 matrix whose rows are the 31-mers of
     random source sequences (one abundance profile per source, a few per
     cent shifted between the groups), 20 FASTQs of 2^16 reads x 150 bp,
     mode C, then mode E four times, the device and the native scorer
     alternating, and once more with the device scorer under
     torch.profiler: the mode-E kernels' launch counts, sampled verdicts
     against a float64 recomputation, extracted reads equal between all
     runs, E_wrs and reads/s of every run, and the card's idle share in
     the traced run;
  7. the kernels line, the card line, and the result line last.

Any failed check raises, and the script exits non-zero without a result. It
exits non-zero at once where torch sees no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
from kmerlsh_tpu_torch.ops import reads, rng, ttest  # noqa: E402

DEV = torch.device("cuda", 0)
S = 20
SMALL = 1 << 20
FULL = 1 << 24

# kernel → (source, the reference device program it replaces)
KERNELS = {
    "abundance_transform": ("kmerlsh_tpu_torch/csrc/lsh_keys.cu",
                            "kmerlsh_tpu/ops/transform.py:33"),
    "lsh_keys": ("kmerlsh_tpu_torch/csrc/lsh_keys.cu",
                 "kmerlsh_tpu/ops/lsh.py:67"),
    "permute_state": ("kmerlsh_tpu_torch/csrc/permute_state.cu",
                      "kmerlsh_tpu/cluster/engine.py:117"),
    "chain_collapse": ("kmerlsh_tpu_torch/csrc/chain_collapse.cu",
                       "kmerlsh_tpu/cluster/engine.py:335"),
    "finalize": ("kmerlsh_tpu_torch/csrc/finalize.cu",
                 "kmerlsh_tpu/cluster/engine.py:651"),
    "wrs_verdicts": ("kmerlsh_tpu_torch/csrc/ttest.cu",
                     "kmerlsh_tpu/ops/ttest.py:57"),
    "score_reads": ("kmerlsh_tpu_torch/csrc/reads.cu",
                    "kmerlsh_tpu/ops/reads.py:145"),
}
MODE_C = ("abundance_transform", "lsh_keys", "permute_state",
          "chain_collapse", "finalize")
MODE_E = ("wrs_verdicts", "score_reads")
E_ORDER = ("device", "native", "native", "device")   # phase 6's scorer runs
K_E = 31                 # k of the full-size mode-E phase
READ_LEN = 150
N_FASTQ = S              # one FASTQ per sample
FASTQ_READS = reads.READS_CAP


def log(msg: str) -> None:
    print(msg, flush=True)


def profile_pool(r: np.random.Generator, n_base: int) -> np.ndarray:
    """f32 [P, S] unit profiles of bench.py make_data: n_base roots and a
    3-level similarity hierarchy below them (cosine 0.93, 0.89, 0.85
    between levels)."""
    cur = r.normal(size=(n_base, S)).astype(np.float32)
    cur /= np.linalg.norm(cur, axis=1, keepdims=True)
    nodes = [cur]
    for lev in range(3):
        cos = 0.93 - 0.04 * lev
        sin = np.sqrt(1 - cos * cos)
        kids = []
        for sgn in (1.0, -1.0):
            orth = r.normal(size=cur.shape).astype(np.float32)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
        cur = np.concatenate(kids)
        nodes.append(cur)
    return np.concatenate(nodes)


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
    pool = torch.from_numpy(
        profile_pool(r, max(64, n_rows >> 7)).T.copy()).to(DEV)  # [S, P]
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = torch.randint(0, pool.shape[1], (n_rows,), device=DEV, generator=g)
    return counts_of(pool, rows, g)


def write_matrix(work: str, counts: np.ndarray) -> list[float]:
    """kmer_count.bin/.log and the sample lists l1/l2 of a mode-C run."""
    n = counts.shape[1]
    counts.astype("<u2").tofile(os.path.join(work, countsio.BIN_NAME))
    cov = np.log(np.maximum(counts, 1).astype(np.float64)).sum(axis=1)
    with open(os.path.join(work, countsio.LOG_NAME), "w") as f:
        f.write(str(n))
        for c in cov:
            f.write("\t%f" % c)
    for name, idx in (("l1", range(S // 2)), ("l2", range(S // 2, S))):
        with open(os.path.join(work, name), "w") as f:
            for i in idx:
                f.write(f"s{i}.fastq db{i}\n")
    _, covs = countsio.read_log(os.path.join(work, countsio.LOG_NAME))
    return [c / n for c in covs]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same CUDA inputs at
    2^20 x 20, the shapes of a session's first iteration."""
    res = {}
    counts = torch.from_numpy(make_counts(SMALL, seed=1)).to(DEV)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    v = (cov / SMALL).to(torch.float32)

    k = kernels.abundance_transform(counts, v)
    p = kernels.abundance_transform_plain(counts, v)
    res["abundance_transform"] = dict(
        max_abs_err=_exact("abundance_transform", zip(k, p)),
        ms=cuda_ms(lambda: kernels.abundance_transform(counts, v)),
        plain_ms=cuda_ms(lambda: kernels.abundance_transform_plain(counts, v)))
    values, sizes = k
    n_alive = int((sizes > 0).sum())
    h = engine._active_h_of(n_alive)
    planes = rng.draw_hyperplanes(0, 0, S).to(DEV)

    k = kernels.lsh_keys(values, sizes, planes, h)
    p = kernels.lsh_keys_plain(values, sizes, planes, h)
    res["lsh_keys"] = dict(
        max_abs_err=_exact("lsh_keys", zip(k, p)),
        ms=cuda_ms(lambda: kernels.lsh_keys(values, sizes, planes, h)),
        plain_ms=cuda_ms(lambda: kernels.lsh_keys_plain(values, sizes, planes,
                                                        h)))
    key = k[0]
    skey, order = torch.sort(key, stable=True)
    slots = torch.arange(SMALL, dtype=torch.int32, device=DEV)

    k = kernels.permute_state(values, sizes, slots, order)
    p = kernels.permute_state_plain(values, sizes, slots, order)
    res["permute_state"] = dict(
        max_abs_err=_exact("permute_state", zip(k, p)),
        ms=cuda_ms(lambda: kernels.permute_state(values, sizes, slots, order)),
        plain_ms=cuda_ms(lambda: kernels.permute_state_plain(
            values, sizes, slots, order)))
    svals, ssizes, sslots = k

    parent0 = torch.arange(SMALL, dtype=torch.int32, device=DEV)
    pk, pp = parent0.clone(), parent0.clone()
    k = kernels.chain_collapse(svals, ssizes, sslots, skey, 0.95, h, None, pk)
    p = kernels.chain_collapse_plain(svals, ssizes, sslots, skey, 0.95, h,
                                     None, pp)
    _exact("chain_collapse", [(k[1], p[1]), (k[2], p[2]), (k[3], p[3]),
                              (pk, pp)])
    merged = int((k[3] >= 0).sum())
    if merged == 0:
        raise AssertionError("chain_collapse: no chain merged at 0.95")
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=0)
    res["chain_collapse"] = dict(
        max_abs_err=_max_err([(k[0], p[0])]),
        ms=cuda_ms(lambda: kernels.chain_collapse(
            svals, ssizes, sslots, skey, 0.95, h, None, parent0.clone())),
        plain_ms=cuda_ms(lambda: kernels.chain_collapse_plain(
            svals, ssizes, sslots, skey, 0.95, h, None, parent0.clone())))
    log(f"chain_collapse: {merged} of {n_alive} columns merged at 0.95")

    # a session's final state: a few more iterations through the kernels
    vt, sz, sl, parent = k[0], k[1], k[2], pk
    for it in range(1, 6):
        na = int((sz > 0).sum())
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(DEV),
            0.95 - 0.01 * it, engine._active_h_of(na))
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    vt, sz, sl = vt[:, :na].contiguous(), sz[:na], sl[:na]
    k = kernels.finalize(vt, sz, sl, parent)
    p = kernels.finalize_plain(vt, sz, sl, parent)
    res["finalize"] = dict(
        max_abs_err=_exact("finalize", zip(k, p)),
        ms=cuda_ms(lambda: kernels.finalize(vt, sz, sl, parent)),
        plain_ms=cuda_ms(lambda: kernels.finalize_plain(vt, sz, sl, parent)))
    log(f"finalize: {na} clusters over {SMALL} rows")
    for name, r in res.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")
    return res


def phase_kernels_mode_e() -> dict:
    """The t-test on 2^20 cluster rows of 10 + 10 samples and the read
    scorer on one full part (2^16 reads of 150 bp, k = 31, 2^22 keys), each
    against its plain version on the same CUDA inputs."""
    res = {}
    values, sizes = testdata.wrs_rows(SMALL, S // 2, S // 2, seed=3)
    v = torch.from_numpy(values).to(DEV)
    sz = torch.from_numpy(sizes).to(DEV)
    args = (v, sz, S // 2, S // 2, 0.01, 5)
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
    res["wrs_verdicts"] = dict(
        max_abs_err=_max_err(zip(k[1:], p[1:])),
        ms=cuda_ms(lambda: kernels.wrs_verdicts(*args)),
        plain_ms=cuda_ms(lambda: kernels.wrs_verdicts_plain(*args)))
    log(f"wrs_verdicts: {SMALL} rows, {n1} in group 1, {n2} in group 2")

    t0 = time.perf_counter()
    seqs, keys, tie = testdata.read_part(reads.READS_CAP, 1 << 22, k=K_E,
                                         read_len=READ_LEN, seed=4)
    log(f"score_reads: part of {len(seqs)} reads and {len(keys)} keys made "
        f"in {time.perf_counter() - t0:.1f} s")
    part = [torch.from_numpy(a).to(DEV) for a in reads.pack_part(seqs, K_E)]
    dkeys = torch.from_numpy(keys.view(np.int64)).to(DEV)
    args = (*part, dkeys, K_E, 0.5)
    k = kernels.score_reads(*args)
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
    res["score_reads"] = dict(
        max_abs_err=_max_err([(k, p)]),
        ms=cuda_ms(lambda: kernels.score_reads(*args)),
        plain_ms=cuda_ms(lambda: kernels.score_reads_plain(*args)))
    log(f"score_reads: {int(mask.sum())} of {len(mask)} reads selected, "
        f"equal to the plain and the native scorer")
    for name, r in res.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")
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
    torch.cuda.reset_peak_memory_stats(DEV)
    kernels.reset_launches()
    t0 = time.perf_counter()
    cli_main(argv)
    cold = time.perf_counter() - t0
    launches = {k: kernels.launches[k] for k in MODE_C}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"mode C never launched {missing}")
    cold_device = engine.LAST_SESSION["device_seconds"]
    t0 = time.perf_counter()
    cli_main(argv)
    warm = time.perf_counter() - t0
    warm_device = engine.LAST_SESSION["device_seconds"]
    peak = torch.cuda.max_memory_allocated(DEV)

    values, ids = clusterio.read_cluster_all(clust, S)
    flat = ids.flat.astype(np.int64)
    if len(np.unique(flat)) != len(flat) or (flat >= FULL).any():
        raise AssertionError("full: a row id twice or out of range")
    if not np.isfinite(values).all() or values.shape != (len(ids), S):
        raise AssertionError("full: centroids malformed")
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
        if err > 1e-4 * max(1.0, np.abs(want).max()):
            raise AssertionError(f"full: cluster {c} centroid off by {err}")
    n_clusters = engine.LAST_SESSION["clusters"]
    log(f"full: {n_clusters} clusters, {len(ids)} saved (size > 5); centroids of "
        f"{len(pick)} sampled clusters within {worst:.3g} of the host means")
    log(f"full: cold {cold:.3f} s (device {cold_device:.3f} s), warm "
        f"{warm:.3f} s (device {warm_device:.3f} s), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"full: programs {engine.LAST_SESSION['programs']}")
    return dict(launches=launches, clusters=n_clusters, cold=cold, warm=warm)


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
    pool = profile_pool(r, max(64, FULL >> 7))
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
               tested=len(tested))
    for i, (scorer, run) in enumerate(runs):
        t = run["stages"].times
        log(f"mode E run {i} ({scorer} scorer): E_wrs {t['E_wrs']:.4f} s, "
            f"E_extract {t['E_extract']:.4f} s = "
            f"{total / t['E_extract']:.0f} reads/s")
    t = traced["stages"].times
    log(f"mode E traced run (device scorer, under torch.profiler): E_wrs "
        f"{t['E_wrs']:.4f} s, E_extract {t['E_extract']:.4f} s, wall "
        f"{traced_wall:.4f} s, card busy {busy:.4f} s = idle "
        f"{1 - busy / traced_wall:.2%}")
    return out


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

    res = phase_kernels()
    res.update(phase_kernels_mode_e())
    with tempfile.TemporaryDirectory() as tmp:
        phase_fixture(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        full = phase_full(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mode_e = phase_mode_e(tmp)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    launches = {**full["launches"], **mode_e["launches"]}
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
