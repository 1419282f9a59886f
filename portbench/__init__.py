"""portbench: the benchmark of paintfe_tpu_torch on NVIDIA GPUs.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of ../BENCHMARK.json once and prints one JSON line.  Each
configuration, traffic mix, per-layer metric, kernel count and reference
op sits in a file of its own, found by its name (see run.py).
"""
