"""The benchmark of the PyTorch and CUDA port (``dgl1_tpu_torch``): full-graph
training cells on one NVIDIA card, driven by ``BENCHMARK.json`` at the
repository's root. ``python3 -m gnnbench.run --help``."""
