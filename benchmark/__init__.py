"""The benchmark of ``jpeg_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` names the cells; each
cell's configuration (``configs/``), traffic mix (``traffic/``) and metric
readers (``metrics/``) are files of their own, found by name. The plain
reference that decides ``correct`` is ``reference/``.
"""
