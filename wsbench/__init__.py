"""wsbench: the benchmark of rangefilteredann_tpu_torch on NVIDIA GPUs.

`python3 wsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json. Everything a cell is made of is found by
name: its configuration in configs/, its traffic mix in traffic/, the limits
of its correctness check in limits/ and each per-layer metric's reader in
metrics/. The reference the outputs are judged against (reference.py) is
plain PyTorch and imports nothing of the program.
"""
