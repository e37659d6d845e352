"""The benchmark of the PyTorch and CUDA port (``vectorsimilarity_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that measures lives here and imports nothing of the JAX package:
the data generator (``gen``), the float64 reference and its TF32 control
(``reference``), the comparison that decides ``correct`` (``judge``), the
roofline arithmetic (``roofline``) and the trace reduction (``trace``).
Configurations, traffic mixes and cells are data files under ``configs/``,
``traffic/`` and ``cells/``; each metric is a reader under ``metrics/``;
each index kind a set-up module under ``setups/``. All are found by name.
"""
