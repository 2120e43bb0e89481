"""Plain PyTorch and NumPy references of what the benchmark's jobs compute.

Nothing here imports the program (``kmerlsh_tpu_torch``), the JAX package
or JAX: the mode-C session and the hyperplane draw are frozen copies of
the port's plain versions, the mode-E t-test is a float64 continued
fraction of its own, and the k-mer keys are computed from their
definition. The references take only what the harness made (the counts,
the coverage offsets, the raw files) and the program's outputs, which they
judge.
"""
