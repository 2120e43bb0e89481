# Copy of kmerlsh_tpu/io/samples.py; only its imports of this package changed.
"""Sample-list parsing.

Reference contract (``GetInput``, io/ioHT.cc:3-19): each line of the input
file is ``<fastq_path> <kmc_db_name>`` (whitespace separated). Unlike the
reference, blank lines are skipped instead of producing empty entries, and
a line missing the KMC name is a clear error instead of a silent empty
string that would fail much later inside the KMC reader.
"""

from __future__ import annotations


def get_input(path: str) -> tuple[list[str], list[str]]:
    samples: list[str] = []
    kmc_names: list[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(
                    f"{path}:{lineno}: expected '<fastq_path> <kmc_db_name>'"
                    f", got {line.strip()!r}")
            samples.append(parts[0])
            kmc_names.append(parts[1])
    return samples, kmc_names
