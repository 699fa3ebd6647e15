"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``README.md`` says
how configurations, traffic mixes and metrics are found by name.
"""
