"""The benchmark of the PyTorch / CUDA port (``pranet2_tpu_torch``).

``run.py`` runs one cell once on the card (see its docstring and
``BENCHMARK.json`` at the repository's root); ``calibrate.py`` reads the
numbers that set each cell's limits.  The layout, the drivers, readers
and files found by name, is described in ``harness.py``; the plain
reference the outputs are held to is ``reference/``, and the yardstick's
arithmetic (peaks, kernel work, FLOP counts) is ``work.py``.

CPU tests: ``python -m pytest perfbench -q``.  The control test needs the
card: ``python -m pytest perfbench/test_perfbench_control.py -m cuda``.
"""
