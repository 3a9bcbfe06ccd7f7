"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything a cell needs is
found by name: its configuration in ``perfbench/configs/``, its traffic
mix in ``perfbench/traffic/``, its correctness limits in
``perfbench/limits/``, each per-layer metric's reader in
``perfbench/metrics/`` and each model family's plain reference in
``perfbench/reference/``.
"""
