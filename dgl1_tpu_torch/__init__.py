"""dgl1_tpu_torch: the PyTorch/CUDA port of dgl1_tpu for NVIDIA Hopper.

It keeps the JAX package's module names (``graph``, ``hub_format``,
``ops/engine_hub``, ``sampling``, ``dataloading``, ``nn/conv``,
``models``, ...; ``ops/engine_tile`` is ``engine_pallas``'s counterpart)
and imports neither JAX nor ``dgl1_tpu``. Entry points build on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written kernels (``csrc/``) are built
with nvcc at first use.
"""

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import (add_self_loop, remove_self_loop,
                                      reorder_graph, to_bidirected)
from dgl1_tpu_torch import (data, dataloading, models, nn,  # noqa: F401
                            ops, random, sampling)
from dgl1_tpu_torch.train import train, train_sampled

__all__ = ["Graph", "graph", "resolve_device", "add_self_loop",
           "remove_self_loop", "reorder_graph", "to_bidirected", "data",
           "dataloading", "models", "nn", "ops", "random", "sampling",
           "train", "train_sampled"]
