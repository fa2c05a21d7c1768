"""Heterogeneous graph attention network (the port's
``dgl1_tpu/models/han.py``): a ``GATConv`` per metapath graph
(``transform.metapath_reachable_graph``), mixed by a semantic attention
over the metapaths, then a linear classifier."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import GATConv
from dgl1_tpu_torch.nn.linear import dense

__all__ = ["SemanticAttention", "HANLayer", "HAN"]


class SemanticAttention(nn.Module):
    """Attention over M metapath channels of ``z`` (N, M, D): each channel
    scored by ``score(tanh(project(z)))`` averaged over the nodes, the
    scores softmaxed over the channels, the channels summed with those
    weights. Parameters ``project`` (with bias) and ``score`` (no bias),
    the reference's names."""

    def __init__(self, in_size: int, hidden_size: int = 128, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.project = dense(in_size, hidden_size, True, dev, generator)
        self.score = dense(hidden_size, 1, False, dev, generator)

    def forward(self, z):
        w = self.score(torch.tanh(self.project(z)))       # (N, M, 1)
        beta = torch.softmax(w.mean(dim=0), dim=0)         # (M, 1)
        return (z * beta[None]).sum(dim=1)                 # (N, D)


class HANLayer(nn.Module):
    """A ``GATConv`` per metapath graph (``gat_<i>``: ``num_heads`` heads
    of ``out_feats``, feature and attention dropout ``dropout``, elu),
    heads flattened, then :class:`SemanticAttention` (``semantic``)."""

    def __init__(self, num_metapaths: int, in_feats: int, out_feats: int,
                 num_heads: int = 8, dropout: float = 0.6, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_metapaths = num_metapaths
        for i in range(num_metapaths):
            setattr(self, f"gat_{i}", GATConv(
                in_feats, out_feats, num_heads=num_heads, feat_drop=dropout,
                attn_drop=dropout, activation=F.elu, device=dev,
                generator=generator))
        self.semantic = SemanticAttention(out_feats * num_heads, device=dev,
                                          generator=generator)

    def forward(self, graphs: Sequence[Graph], h, generator=None):
        if len(graphs) != self.num_metapaths:
            raise ValueError(f"{len(graphs)} graphs for "
                             f"{self.num_metapaths} metapaths")
        outs = []
        for i, g in enumerate(graphs):
            z = getattr(self, f"gat_{i}")(g, h, generator=generator)
            outs.append(z.reshape(z.shape[0], -1))
        return self.semantic(torch.stack(outs, dim=1))


class HAN(nn.Module):
    """``num_layers`` :class:`HANLayer` (``layers.<i>``, the reference's
    ``layer<i>``) and a linear classifier (``predict``), on the list of
    metapath graphs (one node type). Dropout draws from the ``generator``
    passed to :meth:`forward`, only while training."""

    def __init__(self, num_metapaths: int, in_feats: int, hidden_feats: int,
                 out_feats: int, num_heads: int = 8, num_layers: int = 1,
                 dropout: float = 0.6, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            HANLayer(num_metapaths,
                     in_feats if i == 0 else hidden_feats * num_heads,
                     hidden_feats, num_heads=num_heads, dropout=dropout,
                     device=dev, generator=generator)
            for i in range(num_layers))
        self.predict = dense(hidden_feats * num_heads, out_feats, True, dev,
                             generator)

    def forward(self, graphs: Sequence[Graph], h, generator=None):
        for layer in self.layers:
            h = layer(graphs, h, generator=generator)
        return self.predict(h)
