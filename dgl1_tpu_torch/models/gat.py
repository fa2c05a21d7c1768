"""Multi-head GAT (the port's ``dgl1_tpu/models/gat.py``): hidden layers
of ``heads`` heads with ELU between them, a last layer of ``out_heads``
heads averaged."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import GATConv

__all__ = ["GAT"]


class GAT(nn.Module):
    """``num_layers`` GATConv layers (``layers.{i}``, the reference's
    ``layer{i}``). Dropout (features and attention) runs only while
    training, with masks and seeds from the ``generator`` passed to
    :meth:`forward`."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, heads: int = 8, out_heads: int = 1,
                 feat_drop: float = 0.6, attn_drop: float = 0.6,
                 negative_slope: float = 0.2, residual: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(feat_drop=feat_drop, attn_drop=attn_drop,
                  negative_slope=negative_slope, residual=residual,
                  device=dev, generator=generator)
        dims = [in_feats] + [hidden_feats * heads] * (num_layers - 1)
        self.layers = nn.ModuleList(
            [GATConv(dims[i], hidden_feats, num_heads=heads, **kw)
             for i in range(num_layers - 1)]
            + [GATConv(dims[-1], out_feats, num_heads=out_heads, **kw)])

    def forward(self, g: Graph, feat, generator=None):
        h = feat
        for layer in self.layers[:-1]:
            h = layer(g, h, generator=generator)
            h = torch.nn.functional.elu(h.reshape(h.shape[0], -1))
        return self.layers[-1](g, h, generator=generator).mean(dim=1)
