"""The benchmark of kaolin_tpu_torch on NVIDIA H100 cards.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that defines a cell is data found by name: the
configuration ``configs/<config>.json``, the cell ``workloads/<cell>.json``,
the driver ``drivers/<driver>.py`` that the configuration names, and one
reader ``metrics/<metric>.py`` per per-layer metric.  ``reference/`` holds
the plain PyTorch reference that decides ``correct``; it imports nothing of
the program.
"""
