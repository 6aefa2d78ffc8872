"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints its result as the last
line of standard output. Everything that belongs to one configuration,
traffic mix or metric sits in a file of its own under this folder, found
by the name that `BENCHMARK.json` gives it (`harness.Bench`). Nothing
here imports JAX or the JAX package.
"""
