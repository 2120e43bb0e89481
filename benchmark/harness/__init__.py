"""The benchmark harness of kmerlsh_tpu_torch: everything that is the same
for every cell (finding a cell's files, the measured window, the trace
arithmetic, the peaks and the roofline counts, the result line). What
belongs to one configuration, traffic mix or metric lives in a file of its
own under ``benchmark/``, found by the name ``BENCHMARK.json`` gives it."""
