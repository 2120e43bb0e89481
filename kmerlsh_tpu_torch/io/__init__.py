from kmerlsh_tpu_torch.io import clusterio, counts, fastq, kmc, samples  # noqa: F401
