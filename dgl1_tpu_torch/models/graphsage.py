"""GraphSAGE over a list of sampled blocks or a full graph (the port's
``dgl1_tpu/models/graphsage.py``)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import SAGEConv, _dropout

__all__ = ["GraphSAGE"]


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConv layers (``layers.{i}``, the reference's
    ``layer{i}``), relu and dropout between them. :meth:`forward` takes
    one block per layer (input side first) or one graph for all layers.
    Dropout masks come from the ``generator`` passed to :meth:`forward`,
    only while training."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 2, aggregator: str = "mean",
                 dropout: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], aggregator_type=aggregator,
                     device=dev, generator=generator)
            for i in range(num_layers))
        self.dropout = dropout

    def forward(self, g: Union[Graph, List[Graph]], feat, generator=None):
        blocks = g if isinstance(g, (list, tuple)) else [g] * len(self.layers)
        h = feat
        for i, layer in enumerate(self.layers):
            h = layer(blocks[i], h, generator=generator)
            if i != len(self.layers) - 1:
                h = torch.relu(h)
                if self.training and self.dropout > 0:
                    h = _dropout(h, self.dropout, generator)
        return h
