"""portbench: the benchmark of the PyTorch/CUDA port ``axctdprocessor_tpu_torch``.

Run one cell from the repository root::

    python3 portbench/run.py --workload drop600.auto --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` names the cells; each cell, configuration, traffic mix and
metric has a file of its own here, found by name (``core/registry.py``).
"""
