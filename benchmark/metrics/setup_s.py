"""setup_s (s, host clock): from the process's start to the end of the
warm job: Python, PyTorch and CUDA start, the kernels' build where the
checkout has none yet and their load, the cell's data made from the seed,
and one job of the cell's own shape."""


def read(run):
    return run.setup_s
