"""Deep Graph Infomax (the port's ``dgl1_tpu/models/dgi.py``, after DGL's
``examples/pytorch/dgi``): node embeddings trained by telling each
node's embedding, scored against a sigmoid summary of the graph, from the
embedding of a row-shuffled copy of the features (the corruption)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import GraphConv, _xavier_uniform

__all__ = ["DGI", "DGIEncoder", "PReLU"]


class PReLU(nn.Module):
    """flax's ``PReLU``: one learnable ``negative_slope`` (0.01 at the
    start)."""

    def __init__(self, device=None):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(
            0.01, device=resolve_device(device)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class DGIEncoder(nn.Module):
    """``num_layers`` of ``conv{i}`` (GraphConv) then ``prelu{i}``."""

    def __init__(self, in_feats: int, hidden: int, num_layers: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"conv{i}", GraphConv(
                in_feats if i == 0 else hidden, hidden, device=dev,
                generator=generator))
            setattr(self, f"prelu{i}", PReLU(dev))

    def forward(self, g: Graph, x):
        for i in range(self.num_layers):
            x = getattr(self, f"prelu{i}")(getattr(self, f"conv{i}")(g, x))
        return x


class DGI(nn.Module):
    """``DGI(in_feats, hidden)(g, feat, perm)`` is the loss: binary cross
    entropy of ``h @ (discriminator @ sigmoid(mean h))`` with the real
    embeddings as positives and those of ``feat[perm]`` as negatives.
    ``perm`` None draws ``torch.randperm`` from ``generator`` (on its
    device; the CPU when None). :meth:`embed` gives the embeddings."""

    def __init__(self, in_feats: int, hidden: int, num_layers: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = DGIEncoder(in_feats, hidden, num_layers, dev,
                                  generator)
        self.discriminator = nn.Parameter(_xavier_uniform(
            (hidden, hidden), generator).to(dev))

    def embed(self, g: Graph, feat):
        return self.encoder(g, feat)

    def forward(self, g: Graph, feat, perm=None, generator=None):
        if perm is None:
            perm = torch.randperm(
                feat.shape[0], generator=generator,
                device=generator.device if generator is not None else "cpu")
        pos = self.encoder(g, feat)
        neg = self.encoder(g, feat[perm.to(feat.device)])
        v = self.discriminator @ torch.sigmoid(pos.mean(dim=0))
        sp = torch.nn.functional.softplus
        return sp(-(pos @ v)).mean() + sp(neg @ v).mean()
