"""DistNodeDataLoader: sampled mini-batches against a DistGraph.

The port's counterpart of ``dgl1_tpu/parallel/dist_dataloader.py``
(parity: ``python/dgl/distributed/dist_dataloader.py``). Each process
holds the full structure and samples locally with the port's sampler
(:class:`~dgl1_tpu_torch.dataloading.NodeDataLoader`), while features
stay in the DistTensor layout and are gathered per batch.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from dgl1_tpu_torch.dataloading.dataloader import NodeDataLoader
from dgl1_tpu_torch.parallel.dist_graph import DistGraph

__all__ = ["DistDataLoader", "DistNodeDataLoader"]


class DistNodeDataLoader:
    """Yields ``(input_nodes, output_nodes, blocks, mask, feats)``: the
    NodeDataLoader's batch on ``device`` (None: cuda) and the input
    nodes' rows of ``dist_g.ndata[feat_name]`` as a tensor there. The rows
    are gathered in the loader's workers beside the sampler
    (``NodeDataLoader(pull_features=)``), so the pull overlaps the
    consumer's step; ``loader.pull_s`` holds each pull's seconds."""

    def __init__(self, dist_g: DistGraph, nids, sampler, feat_name="feat",
                 batch_size: int = 1024, shuffle: bool = True,
                 seed: Optional[int] = None, device=None, **kw):
        from dgl1_tpu_torch.graph import resolve_device

        self.dist_g = dist_g
        self.feat_name = feat_name
        self.device = resolve_device(device)
        self.loader = NodeDataLoader(
            dist_g.g, nids, sampler, batch_size=batch_size, shuffle=shuffle,
            seed=seed, device=self.device, pull_features=self._pull, **kw)

    def _pull(self, input_nodes) -> torch.Tensor:
        rows = self.dist_g.ndata[self.feat_name][np.asarray(input_nodes)]
        return torch.as_tensor(np.asarray(rows)).to(self.device)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        return iter(self.loader)


DistDataLoader = DistNodeDataLoader
