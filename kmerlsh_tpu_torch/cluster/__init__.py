from kmerlsh_tpu_torch.cluster import engine  # noqa: F401
