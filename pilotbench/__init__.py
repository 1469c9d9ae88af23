"""pilotbench: the benchmark of the PyTorch and CUDA port of PilotDB
(``repro_torch``).  ``python3 pilotbench/run.py`` runs one cell of
``BENCHMARK.json``; README.md says how a cell, a mix or a metric is added."""
