"""The data generators: count matrices, source sequences, their k-mers and
FASTQs, made from the run's seed on the card in a few large calls.

Frozen copies, rewritten to draw from a ``torch.Generator`` on the device:

  profile_pool      kmerlsh_tpu_torch/testdata.py:167 ``profile_pool``
                    (bench.py make_data's 3-level profile hierarchy)
  counts_of         chip_smoke.py:237 ``counts_of``
  make_counts       chip_smoke.py:247 ``make_counts``
  source_profiles   chip_smoke.py:1716-1724 (phase 6: one profile a
                    source, 3% shifted up in group A, 3% in group B)
  window_keys       kmerlsh_tpu_torch/testdata.py:240 ``window_keys`` and
                    kmer/codec.py ``canonical_key`` (the memcmp key of the
                    packed k-mer, the smaller of a k-mer and its reverse
                    complement), computed directly on the card
  fastq_records     kmerlsh_tpu_torch/testdata.py:260
                    ``write_source_fastqs`` (half copies of sources with
                    0.5% substitutions, half random sequence)

Nothing here imports the program: the harness hands what these make to the
program and to the reference alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BASES = np.frombuffer(b"ACGT", np.uint8)
_SIGN = -(1 << 63)         # int64 with only the top bit: flips unsigned order


def schedule(iterations: int, min_similarity: float) -> np.ndarray:
    """The anneal schedule ``pipeline._fused_single_batch`` builds: 0.95
    (the deep init pass), then 0.95 − step · i for i < iterations, step =
    (0.95 − min_similarity) / iterations."""
    step = (0.95 - min_similarity) / iterations
    return np.concatenate([[0.95], 0.95 - step * np.arange(iterations)]
                          ).astype(np.float32)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number; the
    ``stream``-th of them, so that set-up parts draw independently)."""
    mixed = np.random.SeedSequence([seed % 2**64, stream]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def profile_pool(draw, n_base: int, s: int) -> torch.Tensor:
    """f32 [P, s] unit profiles, P = 15 n_base: n_base roots and a 3-level
    similarity hierarchy below them (cosine 0.93, 0.89, 0.85 between
    levels). ``draw(shape)`` gives standard normals, in the order
    ``testdata.profile_pool`` draws them."""
    cur = draw((n_base, s))
    cur = cur / torch.linalg.vector_norm(cur, dim=1, keepdim=True)
    nodes = [cur]
    for lev in range(3):
        cos = 0.93 - 0.04 * lev
        sin = math.sqrt(1 - cos * cos)
        kids = []
        for sgn in (1.0, -1.0):
            orth = draw(tuple(cur.shape))
            orth = orth - (orth * cur).sum(1, keepdim=True) * cur
            orth = orth / torch.linalg.vector_norm(orth, dim=1, keepdim=True)
            kids.append(cos * cur + sgn * sin * orth)
        cur = torch.cat(kids)
        nodes.append(cur)
    return torch.cat(nodes)


def to_uint16(x: torch.Tensor) -> torch.Tensor:
    """int32 in [0, 65535] → uint16 of the same values (through int16 bits,
    which every PyTorch build converts to)."""
    return (x - ((x > 32767).to(torch.int32) << 16)).to(torch.int16).view(
        torch.uint16)


def counts_of(profiles: torch.Tensor, rows: torch.Tensor,
              g: torch.Generator) -> torch.Tensor:
    """uint16 [S, len(rows)] on the profiles' device: log-abundance 4 +
    the profile of each row + 0.01 noise (profiles f32 [S, P])."""
    vals = 4.0 + profiles[:, rows]
    vals += 0.01 * torch.randn(vals.shape, device=vals.device, generator=g)
    counts = torch.clamp(torch.round(torch.expm1(vals)), 1, 65535)
    del vals
    return to_uint16(counts.to(torch.int32))


def make_counts(n_rows: int, s: int, seed: int, device) -> torch.Tensor:
    """uint16 [s, n_rows] on ``device`` with bench.py make_data's
    distribution: rows drawn from a pool of max(64, n_rows >> 7) roots'
    hierarchy, log-abundance 4 + profile + 0.01 noise."""
    g = generator(seed, device)
    pool = profile_pool(
        lambda shape: torch.randn(shape, device=device, generator=g),
        max(64, n_rows >> 7), s)
    rows = torch.randint(0, pool.shape[0], (n_rows,), device=device,
                         generator=g)
    return counts_of(pool.T.contiguous(), rows, g)


def coverage_offsets(counts: torch.Tensor) -> np.ndarray:
    """f32 [S] v of the abundance transform: each sample's sum of log
    count over its nonzero counts, over the rows (io/counts.py's
    coverage / kmap_size, without the log file's rounding)."""
    c = counts.to(torch.int32)
    logs = torch.where(c > 0, torch.log(c.to(torch.float64)), 0.0)
    return (logs.sum(1) / counts.shape[1]).cpu().numpy().astype(np.float32)


def source_profiles(n_src: int, s: int, n1: int, n_base: int, seed: int,
                    device, shift_share: float, shift: float) -> torch.Tensor:
    """f32 [s, n_src]: one profile a source from a pool of n_base roots'
    hierarchy; ``shift_share`` of the sources shifted up by ``shift`` in
    group A's n1 samples, as many in group B's."""
    g = generator(seed, device, 1)
    pool = profile_pool(
        lambda shape: torch.randn(shape, device=device, generator=g),
        n_base, s)
    prof = pool[torch.randint(0, pool.shape[0], (n_src,), device=device,
                              generator=g)]
    kind = torch.rand(n_src, device=device, generator=g)
    up_a = (kind < shift_share)[:, None] & (torch.arange(s, device=device)
                                             < n1)[None, :]
    up_b = ((kind >= shift_share) & (kind < 2 * shift_share))[:, None] & (
        torch.arange(s, device=device) >= n1)[None, :]
    prof = prof + shift * (up_a | up_b).to(prof.dtype)
    return prof.T.contiguous()


def _key_shift(i: int) -> int:
    """Bit of base i's code in the memcmp key: base i sits at bits 2(i % 4)
    of byte i // 4 of the little-endian packed word, byte 0 on top."""
    return 56 - 8 * (i // 4) + 2 * (i % 4)


def window_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical memcmp keys of every k-window of each row of ``codes``
    (int codes 0–3 [n, L]) → int64 [n, L − k + 1] holding the uint64 key's
    bits XOR 2^63, so that signed order is the keys' unsigned order."""
    c = codes.to(torch.int64)
    n_w = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], n_w), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for i in range(k):
        fwd |= c[:, i:i + n_w] << _key_shift(i)
        rev |= (3 - c[:, k - 1 - i:k - 1 - i + n_w]) << _key_shift(i)
    return torch.minimum(fwd ^ _SIGN, rev ^ _SIGN)


def unflip(keys: torch.Tensor) -> np.ndarray:
    """uint64 keys on the host from :func:`window_keys`' form."""
    return (keys ^ _SIGN).cpu().numpy().view(np.uint64)


def random_codes(shape, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 4, shape, dtype=torch.uint8, device=device,
                         generator=g)


def fastq_codes(src: torch.Tensor, n_reads: int, g: torch.Generator,
                copy_share: float, sub_rate: float) -> torch.Tensor:
    """uint8 codes [n_reads, L] of one FASTQ: ``copy_share`` of the reads
    copies of random sources (src [n, L]) with ``sub_rate`` substitutions,
    the rest random sequence."""
    dev = src.device
    L = src.shape[1]
    codes = random_codes((n_reads, L), g, dev)
    copy = torch.rand(n_reads, device=dev, generator=g) < copy_share
    pick = torch.randint(0, src.shape[0], (n_reads,), device=dev, generator=g)
    codes = torch.where(copy[:, None], src[pick], codes)
    sub = (torch.rand((n_reads, L), device=dev, generator=g) < sub_rate) & \
        copy[:, None]
    return torch.where(sub, random_codes((n_reads, L), g, dev), codes)


def fastq_records(codes: np.ndarray) -> bytes:
    """FASTQ bytes of reads ``codes`` uint8 [n, L]: ``@r%08d``, the bases,
    ``+``, quality ``I`` at every base."""
    n, L = codes.shape
    width = 1 + 9 + 1 + L + 3 + L + 1
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    rec = np.empty((n, width), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    rec[:, 2:10] = ord("0") + digits
    rec[:, 10] = ord("\n")
    rec[:, 11:11 + L] = BASES[codes]
    rec[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 14 + L:14 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()
