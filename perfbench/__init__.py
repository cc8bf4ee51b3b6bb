"""The benchmark of the PyTorch/CUDA port (``mmlspark_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``drivers/<driver>.py`` (named by the mix),
``datagen/<generator>.py`` (named by the configuration) and
``metrics/<metric>.py`` (one reader per per-layer metric). The plain
reference that decides ``correct`` is ``reference/``; it imports nothing of
the port.
"""
