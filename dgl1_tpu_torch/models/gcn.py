"""2+-layer GCN (the port's ``dgl1_tpu/models/gcn.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import GraphConv, _dropout

__all__ = ["GCN"]


class GCN(nn.Module):
    """``num_layers`` GraphConv layers, relu and dropout between them.
    Dropout masks come from the ``generator`` passed to :meth:`forward`
    (the default generator when None) and only while training."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, dropout: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            GraphConv(dims[i], dims[i + 1], device=dev, generator=generator)
            for i in range(num_layers))
        self.dropout = dropout

    def forward(self, g: Graph, feat, generator=None):
        h = feat
        for layer in self.layers[:-1]:
            h = torch.relu(layer(g, h))
            if self.training and self.dropout > 0:
                h = _dropout(h, self.dropout, generator)
        return self.layers[-1](g, h)
