"""Time lsh_keys and finalize on one CUDA card and split each call's card
time by kernel.

    python3 tools/kernel_split.py [M ...]      (default 2^21 and 2^24)

It runs whichever ``kmerlsh_tpu_torch`` comes first on the path, so that
two trees can be compared on one card in one session: put a tree's root
first on PYTHONPATH (its kernels then build inside that tree). The inputs
are chip_smoke.py phase 3's at M x 20: counts with the distribution of
bench.py make_data, the transform, the keys of the first iteration at the
data's h, and for finalize the state and forest after six iterations.
Prints, for each M: each call's time (chip_smoke.cuda_ms: CUDA events
around 10 back-to-back calls, median of 5), the card's time of one call by
kernel (torch.profiler; the key sorts as ``sort``), and the forest's depth.
"""

from __future__ import annotations

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits where there is no card)

torch = cs.torch
from kmerlsh_tpu_torch import kernels, testdata  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.ops import rng  # noqa: E402


def split(fn) -> dict[str, float]:
    """ms of the card's time in one fn() by kernel name."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    by: dict[str, float] = {}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").split("(")[0]
            name = "sort" if "sort" in name.lower() else name
            by[name] = by.get(name, 0.0) + (e.time_range.end
                                            - e.time_range.start) * 1e-3
    return by


def report(what: str, M: int, fn) -> None:
    by = split(fn)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(by.items(), key=lambda kv: -kv[1]))
    cs.log(f"{what} at {M}: {cs.cuda_ms(fn):.4f} ms a call; card time of one "
           f"call {sum(by.values()):.4f} ms: {parts}")


def measure(M: int) -> None:
    S, dev = cs.S, cs.DEV
    counts = torch.from_numpy(cs.make_counts(M, seed=1)).to(dev)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / M).float())
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    planes = rng.draw_hyperplanes(0, 0, S).to(dev)
    report(f"lsh_keys (h = {h})", M,
           lambda: kernels.lsh_keys(vt, sz, planes, h))
    sl = torch.arange(M, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(6):
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(dev),
            0.95 - 0.01 * it, engine._active_h_of(int((sz > 0).sum())))
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    args = (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)
    depth = getattr(testdata, "forest_depth", None)   # not in older trees
    forest = ("" if depth is None else
              ", forest {} deep at most, {:.3f} on average".format(
                  *depth(parent)))
    report(f"finalize ({na} clusters{forest})", M,
           lambda: kernels.finalize(*args))


def main() -> None:
    cs.log(f"kmerlsh_tpu_torch from {os.path.dirname(kernels.__file__)}")
    for M in [int(a) for a in sys.argv[1:]] or [cs.LATE, cs.FULL]:
        measure(M)


if __name__ == "__main__":
    main()
