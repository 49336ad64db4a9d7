"""Benchmark of the PyTorch and CUDA port of the reliability framework.

One command runs one cell (a configuration under a traffic mix) once:

    python -m psra_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, their configuration and
traffic files, and the metrics. Everything a cell needs is found by name:
``configs/<config>.json`` (the system and the study's thresholds),
``traffic/<traffic>.json`` (the study driver and its sizes),
``limits/<cell>.json`` (the limits of the comparison that decides
``correct``), ``studies/<driver>.py``, ``metrics/<metric>.py`` (one reader
a per-layer metric) and ``kernels/<kernel>.py`` (a kernel's operations
and bytes). The plain reference that judges the program's answers is in
``reference/`` and imports nothing of the program.
"""
