"""The benchmark of graphvite_tpu_torch on one or more NVIDIA GPUs:
`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (README.md)."""
