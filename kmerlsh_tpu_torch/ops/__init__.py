from kmerlsh_tpu_torch.ops import lsh, rng, segment, transform  # noqa: F401
