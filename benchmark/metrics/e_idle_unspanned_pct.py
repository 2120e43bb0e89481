"""e_idle_unspanned_pct (%, program spans over the device trace): the share
of the mode-E window's device-idle seconds in which no ``kmerlsh.`` span of
the program is open; the arithmetic of c_idle_unspanned_pct."""

from pathlib import Path

from harness import spec

read = spec.metric_reader("c_idle_unspanned_pct",
                          Path(__file__).resolve().parents[1])
