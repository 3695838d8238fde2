"""The benchmark of the PyTorch/CUDA port of the Alchemist offload engine
(``src/repro_torch``): the paper's two offload jobs, §4.1's CG over random
features and §4.2's truncated SVD, as cells of ``BENCHMARK.json``.
``python -m offload_bench.run --help`` runs one; see ``harness.py`` for
where each cell's files live."""
