"""The benchmark of the PyTorch and CUDA port (``cammiq_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Configurations, traffic mixes and per-layer metric readers are files
found by name (``configs/``, ``traffic/``, ``metrics/``); the plain reference
that decides ``correct`` is ``reference/``, which imports nothing of the port.
"""
