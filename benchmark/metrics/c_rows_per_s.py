"""c_rows_per_s (rows/s, host clock): the rows of every mode-C job that
ended in the window over the window's seconds, from its opening to the
end of its last job."""


def read(run):
    return sum(r["rows"] for r in run.done) / run.window_s
