"""The benchmark of ``metrics_tpu_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the root of the checkout lists the cells; ``run.py``
runs one of them. Everything a cell needs is found by name: its
configuration under ``configs/``, its traffic under ``traffic/`` (which names
its driver under ``drivers/``), each per-layer metric's reader under
``layers/`` and each configuration's plain reference under ``reference/``.
"""
