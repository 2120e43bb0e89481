"""Peaks of one NVIDIA H100 and the least time of each mode-C kernel's
function.

The peaks are copied from chip_smoke.py (``HBM_BYTES_PER_S``,
``F32_FLOPS``): NVIDIA's data sheet for the H100 SXM, 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, at the full 700 W power
limit. A card set below it runs slower; the run reports its power limit
beside the share.

The counts are of each kernel's function, not of its implementation: every
input byte read once, every output byte written once, and the float32
operations the function needs, from the shapes of the call. A sort of int32
keys that returns the sorted keys and an int32 order moves 12 bytes a key
however many passes it makes; a finalize reads the parent forest once
however deep its chases go. The least time of a call is the larger of its
bytes over the memory rate and its operations over the float32 rate.
"""

from __future__ import annotations

import math
import re

from harness.trace import kernel_name

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
H_MAX = 30          # bucket bits of an LSH key at most (ops/rng.py H_MAX)

# mode-C kernels by the prefix of their names without ``void``, template
# arguments and parameters (harness.trace.kernel_name): K1a, K1b, K9, K2,
# K3 + K4, K5
MODE_C_KERNELS = {
    "kl_transform": "abundance_transform", "kl_project": "lsh_keys",
    "kl_quantize": "lsh_keys", "kl_sort": "sort_keys",
    "kl_permute": "permute_state", "kl_chain": "chain_collapse",
    "kl_fin_": "finalize",
}


def least_seconds(n_bytes: float, flops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def transform(S: int, M: int) -> tuple[float, float]:
    """K1a: uint16 counts [S, M] and v [S] in; f32 values [S, M] and int32
    sizes [M] out. Per value a log1p and a subtraction, per column S adds
    of the keep sum and a compare."""
    return 2 * S * M + 4 * S + 4 * S * M + 4 * M, 3 * S * M + M


def lsh_keys(S: int, M: int, h: int) -> tuple[float, float]:
    """K1b: values [S, M], sizes [M] and the h + 1 planes in use [S, h + 1]
    in; the combined key and the secondary projection [M] out. A
    multiply-add per value and plane."""
    return 4 * S * M + 4 * M + 4 * S * (h + 1) + 8 * M, 2 * S * (h + 1) * M


def sort_keys(M: int) -> tuple[float, float]:
    """K9: int32 keys [M] in; the sorted keys and an int32 order out."""
    return 12 * M, 0.0


def permute_state(S: int, M: int) -> tuple[float, float]:
    """K2: values [S, M], sizes, slots and the order [M] in; the permuted
    values, sizes and slots out."""
    return (4 * S * M + 12 * M) + (4 * S * M + 8 * M), 0.0


def chain_collapse(S: int, M: int, dying: int) -> tuple[float, float]:
    """K3 + K4: sorted values [S, M], sizes, slots and keys [M] in; values,
    sizes, slots and merged-into [M] out, and a parent entry for each of
    the ``dying`` slots. Per value three multiply-adds of the neighbour
    cosine and the weighted sum and mean of its chain."""
    return (4 * S * M + 12 * M) + (4 * S * M + 12 * M) + 4 * dying, 8 * S * M


def finalize(S: int, fc: int, cap0: int) -> tuple[float, float]:
    """K5: the fc alive columns (values [S, fc], sizes, slots) and the
    parent forest [cap0] in; members [cap0], lens, sizes [fc] and
    centroids [S, fc] out."""
    return (4 * S * fc + 8 * fc + 4 * cap0) + (4 * cap0 + 8 * fc
                                               + 4 * S * fc), 0.0


def active_h(n_alive: int) -> int:
    """The engine's bucket bits at n_alive alive columns:
    floor(log2(max(n_alive, 2))) in [1, H_MAX]."""
    return min(max(int(math.floor(math.log2(max(n_alive, 2)))), 1), H_MAX)


_PROGRAM = re.compile(r"^(transform|iter\[(\d+)\]|finalize)@(\d+)$")


def session_calls(programs, S: int, kept: int) -> list[tuple]:
    """(kernel, bytes, flops) of every kernel call of one mode-C session,
    from its ``LAST_SESSION["programs"]`` names: ``transform@cap0``, then
    ``iter[i]@cap`` (the iteration's capacity, which is the alive count
    before it from the second on), then ``finalize@alive``. ``kept`` is
    the alive count before the first iteration (the columns that pass the
    keep filter)."""
    steps = []
    for name, _ in programs:
        m = _PROGRAM.match(name)
        if m is None:
            raise ValueError(f"unknown program {name!r}")
        steps.append((m.group(1).split("[")[0], int(m.group(3))))
    if not steps or steps[0][0] != "transform" or steps[-1][0] != "finalize":
        raise ValueError(f"not one session: {[s for s, _ in steps]}")
    cap0 = steps[0][1]
    caps = [c for kind, c in steps if kind == "iter"]
    final = steps[-1][1]
    alive = [kept] + caps[1:] + [final]        # before each iteration, after
    calls = [("abundance_transform", *transform(S, cap0))]
    for i, cap in enumerate(caps):
        calls += [("lsh_keys", *lsh_keys(S, cap, active_h(alive[i]))),
                  ("sort_keys", *sort_keys(cap)),
                  ("permute_state", *permute_state(S, cap)),
                  ("chain_collapse",
                   *chain_collapse(S, cap, alive[i] - alive[i + 1]))]
    last = caps[-1] if caps else cap0
    calls += [("sort_keys", *sort_keys(last)),              # compact_sort
              ("permute_state", *permute_state(S, last)),
              ("finalize", *finalize(S, final, cap0))]
    return calls


def session_least_seconds(programs, S: int, kept: int) -> float:
    return sum(least_seconds(b, f) for _, b, f in
               session_calls(programs, S, kept))


def is_mode_c_kernel(name: str) -> bool:
    """Whether a device event of the trace, named as the trace names it
    (``void kl_project<4>(float const*, ...)``), is a mode-C kernel."""
    base = kernel_name(name)
    return any(base.startswith(p) for p in MODE_C_KERNELS)
