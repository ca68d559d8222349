"""Benchmark of the PyTorch and CUDA port (``legmov_tpu_torch``).

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything is found by name: configurations under
``configs/``, traffic mixes under ``traffic/``, the runners of each traffic
kind under ``kinds/``, one reader per metric under ``metrics/``, the
operation and byte counts behind each roofline under ``counts/`` and the
plain reference under ``reference/``.
"""
