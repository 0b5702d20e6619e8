"""mecbench: the benchmark of ``repro_torch`` on one NVIDIA H100.

Run a cell with ``python mecbench/run.py --workload NAME --seed N
--seconds S --trace 0|1`` from the repository's root; ``BENCHMARK.json``
names the cells.  Nothing here imports ``jax``, ``jaxlib`` or ``repro``.
"""
