"""Out-of-core mode C on the CPU at a small size: how many merge rounds a
matrix takes and how its count compares with one batch's.

    python3 tools/out_of_core_rounds.py [N]          (default 2^16)

Makes N x 20 counts with the distribution of bench.py make_data
(``testdata.profile_pool``, chip_smoke.py's matrices scaled down), runs
``pipeline.init_clustering`` at a batch of N / 4 with merge windows of
N / 8 (chip_smoke.py phase 5b's ratios at 2^24 rows), the final anneal
(-I 20 -N 0.8) and, for comparison, one session over the whole matrix,
all with the kernels' plain versions. Prints the cluster count after the
batch passes and after each merge round, the tmp bytes, and both counts.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from kmerlsh_tpu_torch import pipeline, testdata  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.config import HyperParams  # noqa: E402
from kmerlsh_tpu_torch.utils.timing import Stages  # noqa: E402

S = 20


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    r = np.random.default_rng(0)
    pool = testdata.profile_pool(r, max(64, n >> 7), S)
    vals = 4.0 + pool[r.integers(0, len(pool), n)].T
    vals += 0.01 * r.normal(size=vals.shape)
    counts = np.clip(np.round(np.expm1(vals)), 1, 65535).astype(np.uint16)
    v = (np.log(counts.astype(np.float64)).sum(axis=1) / n).astype(
        np.float32)
    pipeline.MERGE_WINDOW_MIN = n // 8
    with tempfile.TemporaryDirectory() as work:
        counts.astype("<u2").tofile(os.path.join(work, "kmer_count.bin"))
        p = HyperParams(tmp_dir=os.path.join(work, "tmp"), work_dir=work,
                        batch_thresh=n // 4, min_similarity=0.8, seed=0)
        st = Stages()
        values, ids = pipeline.init_clustering(p, n, list(v), st, "cpu")
    _, _, final = engine.cluster(values, ids.sizes.astype(np.int32), 0.8, 20,
                                 seed=10_000, device="cpu")
    thr = np.concatenate([[0.95], 0.95 - 0.0075 * np.arange(20)])
    _, _, one = engine.cluster_counts(counts, v, thr.astype(np.float32),
                                      seed=0, device="cpu")
    print(f"{n} rows: clusters after the batch passes and each merge round "
          f"{st.metrics['tmp_rounds']}; tmp bytes {st.metrics['tmp_bytes']}; "
          f"out of core {len(final)} clusters, one batch {len(one)}")


if __name__ == "__main__":
    main()
