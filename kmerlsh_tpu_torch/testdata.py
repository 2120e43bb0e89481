"""Synthetic two-group FASTQ fixtures: kmerlsh_tpu.testdata, which imports
no JAX, under this package's name.

``python -m kmerlsh_tpu_torch.testdata <dir>`` writes the FASTQs plus the
two-column sample lists (``groupA.txt`` / ``groupB.txt``).
"""

from __future__ import annotations

import sys

from kmerlsh_tpu.testdata import generate

__all__ = ["generate"]

if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else "."
    m = generate(target)
    print(f"wrote {m['lists']['A']} and {m['lists']['B']}")
