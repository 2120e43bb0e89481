"""e_reserved_bytes (B): torch.cuda.max_memory_reserved over the window,
the card memory that mode E holds at its peak in the caching allocator's
segments: the clustering file's centroids for the t-test (clusters x
samples, the largest), the differential keys and their directory, and one
part's reads. Segments, not max_memory_allocated: the allocator leaves a
block unsplit where less than 1 MiB of its segment would remain, so the
allocated peak jumps by ~1.2 MB as the seed's cluster count crosses such
an edge (247,345 clusters at 124 samples), while the segments stay put."""


def read(run):
    if run.peak_reserved is None or not run.done:
        return None
    return float(run.peak_reserved)
