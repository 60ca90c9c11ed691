"""The benchmark of ``repro_torch``'s mesh-integrated federated boost.

``run.py`` is the entry point; ``BENCHMARK.json`` at the repository root
names the cells.  Everything under this folder is the yardstick: the data
generator, the plain reference, the cost model and the metric readers.
"""
