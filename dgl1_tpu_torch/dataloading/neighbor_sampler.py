"""Multi-layer neighbor sampler producing static-shape padded blocks (the
port's ``dgl1_tpu/dataloading/neighbor_sampler.py``, homogeneous graphs
and the fused native sampler only).

Every block is padded to a bound that depends only on (batch size,
fanouts): src count <= dst * (fanout + 1), edge count <= dst * fanout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from dgl1_tpu_torch.sampling.fused import sample_block_fused, supports_fused

__all__ = ["NeighborSampler", "MultiLayerNeighborSampler"]


class NeighborSampler:
    """Samples ``len(fanouts)`` layers of blocks for a seed batch.

    Only what the fused native sampler covers is ported: uniform sampling
    without replacement with a positive fanout on a homogeneous graph.
    Edge exclusion, ``prob``, ``replace``, full neighborhoods (a negative
    fanout) and heterographs need the numpy sampler and ``to_block``,
    which are not ported yet, and raise NotImplementedError."""

    def __init__(self, fanouts: Sequence[int], replace: bool = False,
                 prob: Optional[str] = None):
        self.fanouts = list(fanouts)
        self.replace = replace
        self.prob = prob
        if any(int(f) <= 0 for f in self.fanouts):
            raise NotImplementedError(
                "full-neighborhood (negative) fanouts need the numpy "
                "sampler and to_block, which are not ported yet")
        if replace or prob is not None:
            raise NotImplementedError(
                "replace= and prob= need the numpy sampler, which is not "
                "ported yet")

    def _layer_bounds(self, batch_size: int) -> List[dict]:
        """Deterministic (src, edge) bounds per layer, outermost first."""
        bounds = []
        dst = batch_size
        for fanout in reversed(self.fanouts):
            src = dst * (fanout + 1)
            bounds.append({"src": src, "edges": dst * fanout})
            dst = src
        return list(reversed(bounds))

    def sample_blocks(self, g, seed_nodes,
                      rng: Optional[np.random.Generator] = None,
                      exclude_eids=None, num_real: Optional[int] = None):
        """Returns (input_nodes, output_nodes, blocks) as numpy ids and
        host blocks, blocks ordered input side first. ``num_real`` is the
        number of real seeds; the tail beyond it is padding and is never
        sampled."""
        if exclude_eids is not None:
            raise NotImplementedError(
                "exclude_eids needs the numpy sampler, which is not ported "
                "yet")
        if isinstance(seed_nodes, dict):
            raise NotImplementedError("heterographs are not ported yet")
        seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
        bounds = self._layer_bounds(len(seed_nodes))
        blocks = []
        seeds = seed_nodes
        num_real = len(seed_nodes) if num_real is None else int(num_real)
        for layer in reversed(range(len(self.fanouts))):
            fanout = self.fanouts[layer]
            if not supports_fused(g, fanout, self.prob, self.replace):
                raise NotImplementedError(
                    "NeighborSampler needs the fused native sampler (the "
                    "native library could not be built, or the graph is a "
                    "block); the numpy sampler is not ported yet")
            b = bounds[layer]
            blk = sample_block_fused(g, seeds, num_real, fanout,
                                     pad_src_to=b["src"],
                                     pad_edges_to=b["edges"], rng=rng)
            blocks.insert(0, blk)
            seeds = blk.srcdata["_ID"].numpy().astype(np.int64)
            num_real = blk.meta["num_real_src"]
        return seeds, seed_nodes, blocks


MultiLayerNeighborSampler = NeighborSampler
