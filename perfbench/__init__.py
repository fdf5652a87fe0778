"""The benchmark of the PyTorch and CUDA port (`mono_vifi_tpu_torch`).

`python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line last. Everything that belongs to a configuration, a traffic mix, a
cell or a per-layer metric is a file found by its name: `configs/`,
`traffic/`, `workloads/`, `metrics/`. The yardstick (the frozen plain
reference, the counts, the comparison that decides `correct`) lives here
and imports nothing of the port.
"""
