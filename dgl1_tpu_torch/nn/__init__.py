"""``dgl1_tpu_torch.nn``: graph neural network modules."""

from dgl1_tpu_torch.nn.conv import (EdgeWeightNorm, GATConv, GraphConv,
                                    RelGraphConv, SAGEConv)

__all__ = ["GraphConv", "EdgeWeightNorm", "GATConv", "SAGEConv",
           "RelGraphConv"]
