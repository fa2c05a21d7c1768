"""``dgl1_tpu_torch.nn``: graph neural network modules."""

from dgl1_tpu_torch.nn.conv import GATConv, GraphConv

__all__ = ["GraphConv", "GATConv"]
