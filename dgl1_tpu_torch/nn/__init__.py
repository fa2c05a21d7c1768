"""``dgl1_tpu_torch.nn``: graph neural network modules."""

from dgl1_tpu_torch.nn.conv import (EdgeWeightNorm, GATConv, GraphConv,
                                    RelGraphConv, SAGEConv)
from dgl1_tpu_torch.nn.hetero import HeteroGraphConv
from dgl1_tpu_torch.nn.linear import HeteroEmbedding, HeteroLinear, TypedLinear

__all__ = ["GraphConv", "EdgeWeightNorm", "GATConv", "SAGEConv",
           "RelGraphConv", "HeteroGraphConv", "TypedLinear", "HeteroLinear",
           "HeteroEmbedding"]
