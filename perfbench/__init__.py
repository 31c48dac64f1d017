"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
run once by ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Configurations, traffic mixes and per-layer
metrics are files of their own, found by the names in ``BENCHMARK.json``."""
