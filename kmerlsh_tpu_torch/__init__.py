"""kmerlsh_tpu_torch: the kmerlsh pipeline on PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper card.

Modes K (k-mer counting) and B (count matrix) run on the host; mode C
(annealed LSH clustering, single batch) and the t-test of mode E run on a
torch device, and mode E's read scorer on the host or the device: the CUDA
kernels of :mod:`kmerlsh_tpu_torch.kernels` on a card, their plain PyTorch
versions on the CPU. ``kmerlsh_tpu`` (JAX) is the reference this package is
tested against; this package never imports jax.
"""
