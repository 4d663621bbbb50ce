"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python3 benchport/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell, a configuration, a traffic mix or a metric needs is found by its
name (``BENCHMARK.json`` at the root, then ``configs/``, ``traffic/``,
``kinds/``, ``problems/`` and ``metrics/`` here); the yardstick, the
plain reference and the trace reduction are this package's own copies
and import nothing of the program.
"""
