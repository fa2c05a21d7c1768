"""Layer-wise offline inference for models trained on sampled blocks (the
port's ``dgl1_tpu/dataloading/inference.py``): each layer runs over all
nodes in batches of one-layer full-neighbor blocks before the next layer
starts, so every edge is used once a layer and nothing is sampled."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.sampling.neighbor import sample_neighbors
from dgl1_tpu_torch.transform import to_block

__all__ = ["layerwise_inference"]


def layerwise_inference(g: Graph, feat: torch.Tensor,
                        layer_fns: Sequence[Callable],
                        batch_size: int = 4096) -> torch.Tensor:
    """``layer_fns[l](block, h_src)`` over every node, layer by layer:
    each batch of dst nodes gets the block of all its in-edges, moved to
    ``feat``'s device, and the rows of its sources. ``g`` lives on the
    host; returns the last layer's output for all nodes, on ``feat``'s
    device."""
    h = feat
    n = g.num_nodes()
    for fn in layer_fns:
        outs = []
        for lo in range(0, n, batch_size):
            seeds = np.arange(lo, min(lo + batch_size, n))
            frontier = sample_neighbors(g, seeds, fanout=-1,
                                        formats=("coo",))
            blk = to_block(frontier, seeds).to(h.device)
            ids = blk.srcdata["_ID"].long().clamp(0, h.shape[0] - 1)
            outs.append(fn(blk, h.index_select(0, ids)))
        h = torch.cat(outs, dim=0)
    return h
