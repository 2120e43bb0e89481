"""Synthetic fixtures.

``generate`` (a copy of kmerlsh_tpu.testdata's, the same files from the same
seed): two-group FASTQs with planted differential markers. ``python -m
kmerlsh_tpu_torch.testdata <dir>`` writes the FASTQs plus the two-column
sample lists (``groupA.txt`` / ``groupB.txt``).

``profile_pool`` draws the abundance profiles of bench.py make_data, from
which chip_smoke.py and tools/out_of_core_rounds.py make count matrices;
``session_input`` makes such a matrix and its coverage offsets on a device.
``wrs_rows``, ``read_part`` and ``score_case`` make the inputs of the
mode-E kernels from a seed, with their edge cases planted, for the kernel
tests and chip_smoke.py.
``window_keys``, ``marker_keys``, ``write_hex`` and ``write_source_fastqs``
build mode-E inputs from source sequences, so that chip_smoke.py needs no
codec of its own. ``exchange_inputs`` and ``finalize_case`` make the inputs
of the exchange fold and of finalize. ``column_session`` runs a chain
session with its state kept as [S, M] columns, the loop a chain session ran
before it carried rows, for the tests that hold the row state to it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from kmerlsh_tpu_torch.kmer import codec

__all__ = ["generate", "profile_pool", "session_input", "wrs_rows", "read_part", "score_case",
           "window_keys", "marker_keys", "write_hex", "write_source_fastqs",
           "exchange_inputs", "finalize_case", "forest_depth",
           "column_session"]


BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n: int) -> str:
    return bytes(BASES[rng.integers(0, 4, size=n)]).decode()


def _reads_from(rng, seq: str, n_reads: int, read_len: int) -> list[str]:
    out = []
    for _ in range(n_reads):
        start = int(rng.integers(0, max(len(seq) - read_len, 1)))
        out.append(seq[start : start + read_len])
    return out


def generate(
    out_dir: str,
    samples_per_group: int = 2,
    n_background: int = 20,
    n_markers: int = 3,
    background_len: int = 400,
    marker_len: int = 300,
    read_len: int = 100,
    background_reads: int = 400,
    marker_reads: int = 300,
    seed: int = 1234,
) -> dict:
    """Returns a manifest dict with file paths and the planted marker
    sequences per group."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    background = [_rand_seq(rng, background_len) for _ in range(n_background)]
    markers = {
        "A": [_rand_seq(rng, marker_len) for _ in range(n_markers)],
        "B": [_rand_seq(rng, marker_len) for _ in range(n_markers)],
    }

    manifest = {"markers": markers, "samples": {"A": [], "B": []},
                "lists": {}}
    for group in ("A", "B"):
        list_path = os.path.join(out_dir, f"group{group}.txt")
        with open(list_path, "w") as lf:
            for s in range(samples_per_group):
                fq = os.path.join(out_dir, f"g{group}_s{s}.fastq")
                db = os.path.join(out_dir, f"db{group}{s}")
                reads: list[str] = []
                for _ in range(background_reads):
                    src = background[int(rng.integers(0, n_background))]
                    reads += _reads_from(rng, src, 1, read_len)
                for m in markers[group]:
                    reads += _reads_from(rng, m, marker_reads // n_markers,
                                         read_len)
                rng.shuffle(reads)
                with open(fq, "w") as f:
                    for i, r in enumerate(reads):
                        f.write(f"@g{group}s{s}r{i}\n{r}\n+\n{'I' * len(r)}\n")
                lf.write(f"{fq} {db}\n")
                manifest["samples"][group].append(fq)
        manifest["lists"][group] = list_path
    return manifest


def wrs_rows(n: int, n1: int, n2: int, seed: int = 0):
    """Cluster rows for the t-test: values f32 [n, n1+n2] around 4 with
    spread 0.3, sizes int32 [n] in [0, 100). A tenth of the rows are
    shifted up in group A, a tenth in group B, by 0–1.5; one row in a
    hundred is constant (s = 0, equal means) and one in a hundred has
    constant groups of different values (s = 0, unequal means)."""
    r = np.random.default_rng(seed)
    v = (4.0 + 0.3 * r.normal(size=(n, n1 + n2))).astype(np.float32)
    shift = r.uniform(0, 1.5, size=n).astype(np.float32)
    kind = r.integers(0, 100, size=n)
    v[kind < 10, :n1] += shift[kind < 10, None]
    v[(kind >= 10) & (kind < 20), n1:] += shift[(kind >= 10) & (kind < 20),
                                               None]
    v[kind == 20] = 4.0
    v[kind == 21, :n1] = 4.5
    v[kind == 21, n1:] = 4.0
    sizes = r.integers(0, 100, size=n).astype(np.int32)
    return v, sizes


def read_part(n_reads: int, n_keys: int, k: int = 31, read_len: int = 150,
              vote: float = 0.5, seed: int = 0):
    """One part of reads and a sorted uint64 differential set of exactly
    ``n_keys`` keys: every window of a pool of source sequences of
    ``read_len`` bases, topped up with random 64-bit keys. A third of the
    reads are copies of sources with 1% substitutions (some with N bases),
    the rest random; a few have N, a few are 1–9 bases shorter than k+10,
    one is the first k+10 bases of a source, one is empty, and one has a
    hit ratio of exactly ``vote`` (returned as its index)."""
    r = np.random.default_rng(seed)
    n_w = read_len - k + 1
    n_src = max(1, min(n_keys // n_w, n_reads))
    src = r.integers(0, 4, size=(n_src, read_len)).astype(np.uint8)
    keys = np.unique(window_keys(src, k))
    while len(keys) < n_keys:
        extra = r.integers(0, 2**64, size=n_keys - len(keys), dtype=np.uint64)
        keys = np.union1d(keys, extra)
    keys = keys[:n_keys]

    base = np.frombuffer(b"ACGT", np.uint8)
    codes = r.integers(0, 4, size=(n_reads, read_len)).astype(np.uint8)
    copy = r.random(n_reads) < 1 / 3
    pick = r.integers(0, n_src, size=n_reads)
    codes[copy] = src[pick[copy]]
    sub = (r.random((n_reads, read_len)) < 0.01) & copy[:, None]
    codes[sub] = r.integers(0, 4, size=int(sub.sum()))
    seqs = base[codes]
    with_n = r.random(n_reads) < 0.05
    seqs[with_n, r.integers(0, read_len, size=int(with_n.sum()))] = ord("N")
    reads = [bytes(s) for s in seqs]

    n_short = min(9, n_reads // 8)
    for i in range(n_short):       # lengths k+1 … k+9: never eligible
        reads[i] = bytes(base[src[i % n_src, : k + 1 + i]])
    reads[n_short] = bytes(base[src[0, : k + 10]])     # eligible, all hits
    reads[n_short + 1] = b""
    # exactly vote · n_w hits: the source's first windows, then a base that
    # differs from the source's, so that no later window is the source's
    tie = n_short + 2
    hits = int(round(vote * n_w))
    if abs(hits - vote * n_w) > 1e-9 or hits + k > read_len:
        raise ValueError(f"vote {vote} × {n_w} windows is not a whole count")
    t = r.integers(0, 4, size=read_len).astype(np.uint8)
    t[: hits + k - 1] = src[0, : hits + k - 1]
    t[hits + k - 1] = (src[0, hits + k - 1] + 1) % 4
    reads[tie] = bytes(base[t])
    got = int(np.isin(window_keys(t[None], k), keys).sum())
    if got != hits:
        raise ValueError(f"tie read has {got} hits, not {hits}")
    return reads, keys, tie


def profile_pool(r: np.random.Generator, n_base: int, s: int) -> np.ndarray:
    """f32 [P, s] unit profiles of bench.py make_data: n_base roots and a
    3-level similarity hierarchy below them (cosine 0.93, 0.89, 0.85
    between levels)."""
    cur = r.normal(size=(n_base, s)).astype(np.float32)
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


def session_input(n_rows: int, s: int, seed: int, device):
    """(uint16 [s, n_rows] counts on ``device``, f32 [s] v): bench.py
    make_data's distribution (rows drawn from the :func:`profile_pool` of
    max(64, n_rows >> 7) roots, log-abundance 4 + profile + 0.01 noise,
    counts clamped to [1, 65535]) made there eight samples at a time, and
    each sample's mean log count (the coverage offsets of the abundance
    transform)."""
    import torch

    r = np.random.default_rng(seed)
    pool = torch.from_numpy(
        profile_pool(r, max(64, n_rows >> 7), s).T.copy()).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randint(0, pool.shape[1], (n_rows,), device=device,
                         generator=g)
    counts = torch.empty((s, n_rows), dtype=torch.int16, device=device)
    v = np.empty(s, np.float32)
    for a in range(0, s, 8):
        vals = 4.0 + pool[a:a + 8][:, rows]
        vals += 0.01 * torch.randn(vals.shape, device=device, generator=g)
        c = torch.clamp(torch.round(torch.expm1(vals)), 1, 65535).to(
            torch.int32)
        v[a:a + 8] = torch.log(c.double()).mean(1).cpu().numpy()
        # uint16 through int16 bits, which every PyTorch build converts to
        counts[a:a + 8] = c - ((c > 32767).to(torch.int32) << 16)
    return counts.view(torch.uint16), v


SCORE_CASES = ("empty", "one", "crowded", "edges")


def score_case(kind: str, k: int, seed: int = 0):
    """A part of reads and a sorted uint64 key set that strain the prefix
    directory of the read scorer (16 top key bits: the directory of fewer
    than 2^16 keys), for ``kind``:
    ``empty`` no key; ``one`` a single key of a read's window;
    ``crowded`` every key in one bucket, the smallest prefix (windows of
    poly-A runs and random keys of that prefix); ``edges`` keys in the
    smallest and the largest bucket only (for k >= 24 with windows there:
    T^12 … A^12 reads). Reads are 0–200 bases, some shorter than k + 10,
    some with N; the last read is eligible. Returns (reads, keys)."""
    r = np.random.default_rng(seed)
    lens = r.integers(0, 201, size=400)
    lens[-1] = max(int(lens[-1]), k + 10)
    seqs = [BASES[r.integers(0, 4, size=n)] for n in lens]
    for i in range(0, 400, 7):        # poly-A runs: windows of prefix 0
        run = min(len(seqs[i]), k + 20)
        seqs[i][:run] = ord("A")
    if k >= 24:                       # windows of the largest prefix
        for i in range(3, 400, 11):
            n = max(len(seqs[i]), k + 10)
            t = BASES[r.integers(0, 4, size=n)]
            t[:12], t[k - 12:k] = ord("T"), ord("A")
            seqs[i] = t
    for i in range(5, 400, 13):
        if len(seqs[i]):
            seqs[i][r.integers(0, len(seqs[i]))] = ord("N")
    reads = [bytes(x) for x in seqs]
    flat = np.concatenate([codec.seq_to_codes(x)[0] for x in reads if x]
                          or [np.zeros(0, np.uint8)])
    wins = np.unique(codec.canonical_key(codec.sliding_kmers(flat, k), k))
    bits = 16
    top = np.uint64((1 << bits) - 1)
    shift = np.uint64(64 - bits)
    prefix = wins >> shift
    low = r.integers(0, 2**63, size=2000, dtype=np.uint64) >> np.uint64(bits)
    if kind == "empty":
        keys = np.empty(0, np.uint64)
    elif kind == "one":
        keys = wins[len(wins) // 2:len(wins) // 2 + 1]
    elif kind == "crowded":
        keys = np.union1d(wins[prefix == 0], low)
    elif kind == "edges":
        keys = np.union1d(wins[(prefix == 0) | (prefix == top)],
                          np.concatenate([low[:500], (top << shift) | low]))
    else:
        raise ValueError(f"no score case {kind!r}")
    return reads, keys


def window_keys(src: np.ndarray, k: int) -> np.ndarray:
    """Canonical keys of every window of every row of ``src`` [n, L]."""
    n, L = src.shape
    packed = codec.sliding_kmers(src.reshape(-1), k)
    idx = (np.arange(n)[:, None] * L + np.arange(L - k + 1)).reshape(-1)
    return codec.canonical_key(packed[idx], k)


def marker_keys(markers: list[str], k: int) -> np.ndarray:
    """Sorted unique canonical keys of every k-mer of the marker strings."""
    return np.unique(np.concatenate([
        codec.canonical_key(codec.sliding_kmers(
            codec.seq_to_codes(m.encode())[0], k), k) for m in markers]))


def write_hex(path: str, keys: np.ndarray) -> None:
    """``kmer_set.hex`` of canonical uint64 keys, row r = keys[r]."""
    codec.packed_of_key(keys).astype("<u8").tofile(path)


def write_source_fastqs(work: str, src: np.ndarray, n_files: int,
                        n_reads: int, seed: int) -> list[str]:
    """``n_files`` FASTQs ``sample{i:02d}.fastq`` of ``n_reads`` reads of
    L bases, src being codes uint8 [n, L]: half of the reads are copies of
    random sources with 0.5% substitutions, half random sequence."""
    r = np.random.default_rng(seed)
    L = src.shape[1]
    width = 1 + 9 + 1 + L + 3 + L + 1          # @r%08d\n seq \n+\n qual \n
    digits = (np.arange(n_reads)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    paths = []
    for i in range(n_files):
        codes = r.integers(0, 4, size=(n_reads, L), dtype=np.uint8)
        copy = r.random(n_reads) < 0.5
        codes[copy] = src[r.integers(0, len(src), size=int(copy.sum()))]
        sub = (r.random((n_reads, L)) < 0.005) & copy[:, None]
        codes[sub] = r.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
        rec = np.empty((n_reads, width), np.uint8)
        rec[:, 0], rec[:, 1] = ord("@"), ord("r")
        rec[:, 2:10] = ord("0") + digits
        rec[:, 10] = ord("\n")
        rec[:, 11:11 + L] = codec.CODE_TO_BASE[codes]
        rec[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 14 + L:14 + 2 * L] = ord("I")
        rec[:, -1] = ord("\n")
        path = os.path.join(work, f"sample{i:02d}.fastq")
        rec.tofile(path)
        paths.append(path)
    return paths


def exchange_inputs(values_t, sizes, slots, merged_into, world: int,
                    rank: int, e: int, seed: int = 0):
    """One exchange of ``rank`` of ``world`` ranks that all hold one
    local-phase result (values f32 [S, c]; sizes, slots in [0, c) and
    merged_into int32 [c], tensors on one device), rank d's slots and
    merges offset by d·c: every rank's window (rotation d), gathered in
    rank order and collapsed by the global phase (``engine._one_iteration``
    with no parent, at 0.9). Returns the global result (values, sizes,
    merged_into, slots), this rank's window (slots, pos), a copy of its
    local state (values, sizes, slots, merged_into), an identity parent
    shard and its base:
    ``kernels.exchange_fold`` takes all but the local slots and
    merged_into, which ``chain_collapse`` folds at that base. Runs through
    the kernel wrappers where the tensors lie."""
    import torch

    from kmerlsh_tpu_torch import kernels
    from kmerlsh_tpu_torch.cluster import engine
    from kmerlsh_tpu_torch.ops import rng

    s, c = values_t.shape
    wins, local = [], None
    for d in range(world):
        st = (values_t.clone(), sizes.clone(), slots + d * c,
              torch.where(merged_into >= 0, merged_into + d * c, merged_into))
        wins.append(kernels.exchange_window(st[0], st[1], st[2], e, d))
        if d == rank:
            local = st
    g_vals = torch.cat([w[1] for w in wins], dim=1)
    g_sizes = torch.cat([w[2] for w in wins])
    g_slots = torch.cat([w[3] for w in wins])
    h = engine._active_h_of(int((g_sizes > 0).sum()))
    planes = rng.draw_hyperplanes(seed, 0, s).to(values_t.device)
    m_vals, m_sizes, m_scs, m_mi = engine._one_iteration(
        g_vals, g_sizes, g_slots, None, planes, 0.9, h)
    parent = torch.arange(rank * c, (rank + 1) * c, dtype=torch.int32,
                          device=values_t.device)
    pos, w_slots = wins[rank][0], wins[rank][3]
    return (m_vals, m_sizes, m_mi, m_scs, w_slots, pos, *local, parent,
            rank * c)


FOREST_ROUNDS = 21   # the iterations of a mode-C session at -I 20


def finalize_case(cap0: int, kind: str, s: int = 5, seed: int = 0):
    """A finalize input: numpy (values_t f32 [s, fc], sizes and slots int32
    [fc], parent int32 [cap0]).

    ``merges``: FOREST_ROUNDS rounds in each of which a tenth of the roots
    merge into other roots, as a session's iterations fold chains, the
    tallest tree among them (so 21 deep); the state holds the survivors in
    random order, one in 20 of them with size 0 (a dead root) and one in 10
    left out (its rows' root is then dead too, as when fc is below a
    session's alive count), and last one column whose slot is a merged row
    (no root: it gets no cluster).
    ``chain``: row r points at row r - 1, one chain cap0 - 1 deep, its root
    the one state column. ``empty``: the same chain and no state column."""
    r = np.random.default_rng(seed)
    parent = np.arange(cap0)
    if kind == "merges":
        roots, height = parent.copy(), np.zeros(cap0, np.int64)
        for _ in range(FOREST_ROUNDS):
            die = r.random(len(roots)) < 0.1
            die[0] = False
            if len(roots) > 1:   # the tallest other tree grows
                die[1 + np.argmax(height[roots[1:]])] = True
            keep = roots[~die]
            into = r.choice(keep, size=int(die.sum()))
            parent[roots[die]] = into
            np.maximum.at(height, into, height[roots[die]] + 1)
            roots = keep
        merged = np.flatnonzero(parent != np.arange(cap0))
        slots = np.r_[r.permutation(roots)[:len(roots) * 9 // 10],
                      r.choice(merged, 1)]
    elif kind in ("chain", "empty"):
        parent[1:] = parent[:-1]
        slots = parent[:1] if kind == "chain" else parent[:0]
    else:
        raise ValueError(f"no finalize case {kind!r}")
    fc = len(slots)
    sizes = r.integers(1, 50, fc).astype(np.int32)
    if kind == "merges":
        sizes[:-1][r.random(fc - 1) < 0.05] = 0
    values = r.normal(size=(s, fc)).astype(np.float32)
    return values, sizes, slots.astype(np.int32), parent.astype(np.int32)


def forest_depth(parent) -> tuple[int, float]:
    """(largest, mean) number of parent links from a row to its root, for
    a parent forest given as a 1-d integer tensor."""
    import torch

    up = parent.long()
    x = torch.arange(len(up), device=up.device)
    depth = torch.zeros_like(x)
    while len(x):
        nxt = up[x]
        moved = nxt != x
        if not bool(moved.any()):
            break
        depth += moved.long()
        x = nxt
    return (int(depth.max()) if len(x) else 0,
            float(depth.double().mean()) if len(x) else 0.0)


def column_session(counts, v, thresholds, seed: int):
    """``engine.cluster_counts(counts, v, thresholds, seed=seed)`` (a chain
    session) with its state kept as [S, M] columns: the transform, each
    iteration through ``engine._one_iteration``, ``engine.compact_sort``,
    finalize and the pull. Returns the (centroids, sizes, members) triple
    and the parent forest."""
    import torch

    from kmerlsh_tpu_torch import kernels
    from kmerlsh_tpu_torch.cluster import engine

    dev = counts.device
    s, n = counts.shape
    values, sizes = kernels.abundance_transform(
        counts, torch.as_tensor(np.asarray(v, np.float32), device=dev))
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    parent = slots.clone()
    planes = kernels.draw_planes(seed, len(thresholds), s, dev)
    na = int((sizes > 0).sum())
    for it, thr in enumerate(np.asarray(thresholds, np.float32)):
        if na == 0:
            break
        values, sizes, slots, _ = engine._one_iteration(
            values, sizes, slots, parent, planes[it], float(thr),
            engine._active_h_of(na), merged=False)
        nxt = int((sizes > 0).sum())
        values, sizes, slots = values[:, :na], sizes[:na], slots[:na]
        na = nxt
    values, sizes, slots = engine.compact_sort(values, sizes, slots)
    out = kernels.finalize(values[:, :na].contiguous(), sizes[:na],
                           slots[:na], parent)
    stats = dict(pull_seconds=0.0, pull_bytes=0, pull_host_allocs=0)
    return engine._pull(*out, stats), parent


if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else "."
    m = generate(target)
    print(f"wrote {m['lists']['A']} and {m['lists']['B']}")
