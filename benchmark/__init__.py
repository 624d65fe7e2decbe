"""The benchmark of the PyTorch and CUDA port (``sitewhere_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Each
configuration, traffic mix and per-layer metric is a file of its own
(``configs/``, ``traffic/``, ``metrics/``), found by the name
``BENCHMARK.json`` gives it.  ``reference/`` holds the plain reference
and the comparison that decides ``correct``; it imports nothing of the
port.
"""
