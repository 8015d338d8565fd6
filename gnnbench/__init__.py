"""The benchmark of dgl_hack_tpu_torch: full-graph GNN training on one
NVIDIA H100, cell by cell, as ``BENCHMARK.json`` at the repository root
lists them.  ``run.py`` runs one cell once; ``README.md`` says how to add
a configuration, a traffic mix, a cell or a per-layer metric as new files.
"""
