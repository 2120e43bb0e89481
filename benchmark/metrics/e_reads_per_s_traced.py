"""e_reads_per_s_traced (reads/s, host clock, in the traced run): the reads
of every mode-E job that ended in the window over the window's seconds,
from its opening to the end of its last job. A per-layer reading: mode E
is the host's work, and the host's speed drifts by up to 1.8x in spells
of minutes, so between runs the rate spreads wider than any bound that
could guard it end to end."""


def read(run):
    return sum(r["reads"] for r in run.done) / run.window_s
