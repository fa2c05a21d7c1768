"""2+-layer GCN (the port's ``dgl1_tpu/models/gcn.py``) and the GCN with
learnable edge weights."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import EdgeWeightNorm, GraphConv, _dropout

__all__ = ["GCN", "EdgeWeightedGCN"]


class GCN(nn.Module):
    """``num_layers`` GraphConv layers, relu and dropout between them.
    Dropout masks come from the ``generator`` passed to :meth:`forward`
    (the default generator when None) and only while training. ``norm``
    goes to every layer; ``edge_weight`` (E,) given to :meth:`forward`
    weights every layer's aggregation (the weighted GCN, usually with
    ``norm='none'`` and weights from ``EdgeWeightNorm``)."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 norm: str = "both", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            GraphConv(dims[i], dims[i + 1], norm=norm, device=dev,
                      generator=generator)
            for i in range(num_layers))
        self.dropout = dropout

    def forward(self, g: Graph, feat, generator=None, edge_weight=None):
        h = feat
        for layer in self.layers[:-1]:
            h = torch.relu(layer(g, h, edge_weight=edge_weight))
            if self.training and self.dropout > 0:
                h = _dropout(h, self.dropout, generator)
        return self.layers[-1](g, h, edge_weight=edge_weight)


class EdgeWeightedGCN(nn.Module):
    """A GCN whose aggregation weights are learnt per edge: ``theta``, one
    logit per edge of the graph the model is built for (zero at the start),
    gives ``EdgeWeightNorm('both')(g, sigmoid(theta))``, which weights
    every layer of a ``GCN(norm='none')``. With theta zero the weights are
    the symmetric GCN normalisation. This is the edge-mask contract of the
    reference's ``GNNExplainer``: weights through ``GraphConv(edge_weight=)``,
    optimised with the model's parameters.

    ``num_edges`` is the graph's ``num_edges_padded()``; padded edges get
    weight 0."""

    def __init__(self, num_edges: int, in_feats: int, hidden_feats: int,
                 out_feats: int, num_layers: int = 2, dropout: float = 0.5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.gcn = GCN(in_feats, hidden_feats, out_feats, num_layers,
                       dropout, norm="none", device=dev, generator=generator)
        self.theta = nn.Parameter(torch.zeros(num_edges, device=dev))
        self.edge_norm = EdgeWeightNorm("both")

    def edge_weight(self, g: Graph):
        """The (E,) normalised weights of the current logits."""
        return self.edge_norm(g, torch.sigmoid(self.theta))

    def forward(self, g: Graph, feat, generator=None):
        return self.gcn(g, feat, generator=generator,
                        edge_weight=self.edge_weight(g))
