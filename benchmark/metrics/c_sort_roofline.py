"""c_sort_roofline (%, device trace): the least time of K9's function over
the keys the window's jobs sorted (harness.roofline.sort_keys: 12 bytes a
key over 3.35 TB/s), over K9's card time in the trace (the kernels whose
names start with ``kl_sort``, as metrics/c_sort_ms.py).

The keys are the program's own count: engine.LAST_SESSION["sorted_keys"],
every key a session passed to kernels.sort_keys (each iteration's, the
compaction's and finalize's two sorts). A run holds that counter for its
last job alone; each other job's count is that one scaled by the ratio of
the sorts its ``programs`` name (each iteration's capacity, the last one
again for the compaction, the rows and the clusters for finalize) to the
last job's. A program without the counter reads nothing."""

from harness import roofline
from harness.trace import kernel_name


def named_keys(record) -> int:
    """The keys a job's ``programs`` name for its sorts."""
    programs = record["programs"]
    calls = roofline.session_calls(programs, record["S"], record["kept"])
    named = sum(b for kind, b, _ in calls if kind == "sort_keys") // 12
    rows, clusters = (int(programs[i][0].split("@")[1]) for i in (0, -1))
    return named + rows + clusters


def read(run):
    if run.trace is None or not run.done or "error" in run.records[-1]:
        return None
    from kmerlsh_tpu_torch.cluster import engine

    last = engine.LAST_SESSION.get("sorted_keys")
    ns = sum(b - a for a, b, name in run.trace.device
             if kernel_name(name).startswith("kl_sort"))
    if not last or not ns:
        return None
    keys = last * sum(named_keys(r) for r in run.done) / named_keys(
        run.done[-1])
    return 100.0 * roofline.least_seconds(*roofline.sort_keys(keys)) / (
        ns * 1e-9)
