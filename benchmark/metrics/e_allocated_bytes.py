"""e_allocated_bytes (B, in the traced run): torch.cuda.max_memory_allocated
over the window, the tensors' side of e_reserved_bytes. It sits in two
modes ~1.2 MB apart by the seed's cluster count (see e_reserved_bytes),
so it reads a layer's change and guards nothing."""


def read(run):
    if run.peak_bytes is None or not run.done:
        return None
    return float(run.peak_bytes)
