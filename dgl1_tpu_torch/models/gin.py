"""GIN graph classifier (the port's ``dgl1_tpu/models/gin.py``, after
the GIN paper and DGL's ``examples/pytorch/gin``): ``num_layers - 1``
GINConv blocks, each with a 2-layer MLP and a LayerNorm, and a readout of
every layer's representation (the input included) summed into the
logits."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import GINConv, _dropout, _layer_norm, dense
from dgl1_tpu_torch.nn.glob import AvgPooling, SumPooling

__all__ = ["GIN"]


class _MLP(nn.Module):
    """``fc{i}`` -> ``ln{i}`` -> relu for the hidden layers, then
    ``fc_out``."""

    def __init__(self, in_feats: int, hidden: int, out: int,
                 num_layers: int, dev, generator):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_feats] + [hidden] * (num_layers - 1)
        for i in range(num_layers - 1):
            setattr(self, f"fc{i}", dense(dims[i], hidden, True, dev,
                                          generator))
            setattr(self, f"ln{i}", _layer_norm(hidden, dev))
        self.fc_out = dense(dims[-1], out, True, dev, generator)

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        return self.fc_out(x)


class GIN(nn.Module):
    """``GIN(in_feats, hidden, classes)``: block i is ``relu(bn{i}(
    mlp{i}(gin{i}(g, x))))`` (``gin{i}``'s ``eps`` a parameter with
    ``learn_eps``), and the logits are the sum over the input and every
    block of ``pred{i}(pool(g, h))``, ``pool`` the ``'sum'`` or
    ``'mean'`` readout; dropout on the pooled rows while training, drawn
    from the ``generator`` passed to :meth:`forward`. On a padded batch of
    ``GraphDataLoader`` the logits have a row for the padding graph."""

    def __init__(self, in_feats: int, hidden: int, classes: int,
                 num_layers: int = 5, learn_eps: bool = False,
                 readout: str = "sum", dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers, self.dropout = num_layers, dropout
        self.pool = SumPooling() if readout == "sum" else AvgPooling()
        for i in range(num_layers - 1):
            d_in = in_feats if i == 0 else hidden
            setattr(self, f"mlp{i}", _MLP(d_in, hidden, hidden, 2, dev,
                                          generator))
            setattr(self, f"gin{i}", GINConv(learn_eps=learn_eps,
                                             device=dev))
            setattr(self, f"bn{i}", _layer_norm(hidden, dev))
        for i in range(num_layers):
            setattr(self, f"pred{i}", dense(in_feats if i == 0 else hidden,
                                            classes, True, dev, generator))

    def forward(self, g: Graph, x, generator=None):
        reps = [x]
        for i in range(self.num_layers - 1):
            x = getattr(self, f"mlp{i}")(getattr(self, f"gin{i}")(g, x))
            x = torch.relu(getattr(self, f"bn{i}")(x))
            reps.append(x)
        score = 0.0
        for i, h in enumerate(reps):
            hg = self.pool(g, h)
            if self.training and self.dropout > 0:
                hg = _dropout(hg, self.dropout, generator)
            score = score + getattr(self, f"pred{i}")(hg)
        return score
