"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card and prints
one JSON line.  Everything a cell needs is found by name: its
configuration in `configs/`, its traffic mix in `traffic/`, the mix's
driver in `drivers/`, each per-layer metric's reader in `metrics/`, and
the limits of the comparison that decides `correct` in `limits/`.
"""
