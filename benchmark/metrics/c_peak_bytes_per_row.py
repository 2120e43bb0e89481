"""c_peak_bytes_per_row (B/row): torch.cuda.max_memory_allocated over the
window (the count matrix on the card and each job's session) over the
cell's rows: utils/hbm.py divides the card's memory by a session's bytes
a row to size the batches of the out-of-core path."""


def read(run):
    if run.peak_bytes is None or not run.done:
        return None
    return run.peak_bytes / run.done[0]["rows"]
