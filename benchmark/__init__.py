"""The benchmark of ``bert4rec_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Configurations (``configs/``), traffic mixes
(``traffic/``), drivers (``drivers/``, one per traffic kind) and per-layer
metric readers (``metrics/``) are found by the names in ``BENCHMARK.json``.
Nothing here imports ``jax`` or the JAX package.
"""
