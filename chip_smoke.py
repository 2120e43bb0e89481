"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the CUDA kernels from kmerlsh_tpu_torch/csrc;
  3. at 2^20 x 20, each kernel against its plain PyTorch version on the same
     CUDA inputs, with both timed (CUDA events, median of 5 after a warm-up);
  4. the CLI on the synthetic FASTQ fixture: --only K, then B, then C;
  5. full size: a 2^24 x 20 count matrix with the distribution of
     bench.py make_data, mode C through the CLI (-I 20 -N 0.8) cold and warm,
     with the kernels' launch counts, the result checked against the
     matrix recomputed on the host;
  6. the kernels line, the card line, and the result line last.

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

from kmerlsh_tpu_torch import kernels, testdata  # noqa: E402
from kmerlsh_tpu_torch.cli import main as cli_main  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.io import clusterio, counts as countsio  # noqa: E402
from kmerlsh_tpu_torch.kernels import build  # noqa: E402
from kmerlsh_tpu_torch.ops import rng  # noqa: E402

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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_counts(n_rows: int, seed: int = 0) -> np.ndarray:
    """uint16 [S, n_rows] with the distribution of bench.py make_data: rows
    drawn from a 3-level similarity hierarchy of unit profiles (cosine
    0.93, 0.89, 0.85 between levels), log-abundance 4 + profile + 0.01
    noise. The row draw and the noise run on the card."""
    r = np.random.default_rng(seed)
    n_base = max(64, n_rows >> 7)
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
    pool = torch.from_numpy(np.concatenate(nodes).T.copy()).to(DEV)  # [S, P]
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = torch.randint(0, pool.shape[1], (n_rows,), device=DEV, generator=g)
    vals = 4.0 + pool[:, rows]
    vals += 0.01 * torch.randn(vals.shape, device=DEV, generator=g)
    counts = torch.clamp(torch.round(torch.expm1(vals)), 1, 65535)
    return counts.to(torch.int32).cpu().numpy().astype(np.uint16)


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


def phase_fixture(tmp: str) -> None:
    """Modes K, B and C through the CLI on the synthetic FASTQ fixture."""
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
    launches = dict(kernels.launches)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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
    with tempfile.TemporaryDirectory() as tmp:
        phase_fixture(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        full = phase_full(tmp)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=full["launches"][name], **res[name])
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
