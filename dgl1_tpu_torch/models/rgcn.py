"""R-GCN entity classification (the port's ``dgl1_tpu/models/rgcn.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import RelGraphConv, _xavier_uniform

__all__ = ["RGCN"]


class RGCN(nn.Module):
    """``num_layers`` RelGraphConv layers (``layers.{i}``, the reference's
    ``layer{i}``), relu between them, basis regularised when
    ``num_bases > 0``. With ``in_feats`` None the model is featureless: a
    learned ``embed`` (num_nodes, hidden) stands in for the input, as in
    the reference. :meth:`forward` takes the reference's arguments and
    hands ``etypes``, ``presorted``, ``etype_counts``, ``rel_graphs`` and
    ``union_graph`` to every layer."""

    def __init__(self, num_nodes: int, hidden_feats: int, out_feats: int,
                 num_rels: int, num_bases: int = 0, num_layers: int = 2,
                 self_loop: bool = True, dropout: float = 0.0,
                 in_feats: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed = None
        if in_feats is None:
            self.embed = nn.Parameter(_xavier_uniform(
                (num_nodes, hidden_feats), generator).to(dev))
            in_feats = hidden_feats
        reg = "basis" if num_bases > 0 else None
        self.layers = nn.ModuleList(
            RelGraphConv(in_feats if i == 0 else hidden_feats,
                         out_feats if i == num_layers - 1 else hidden_feats,
                         num_rels, regularizer=reg, num_bases=num_bases,
                         self_loop=self_loop, dropout=dropout,
                         activation=torch.relu if i != num_layers - 1
                         else None, device=dev, generator=generator)
            for i in range(num_layers))

    def forward(self, g: Graph, etypes=None, feat=None, *,
                presorted: bool = False, etype_counts=None, rel_graphs=None,
                union_graph=None, generator=None):
        h = self.embed if feat is None else feat
        for layer in self.layers:
            h = layer(g, h, etypes, presorted=presorted,
                      etype_counts=etype_counts, rel_graphs=rel_graphs,
                      union_graph=union_graph, generator=generator)
        return h
