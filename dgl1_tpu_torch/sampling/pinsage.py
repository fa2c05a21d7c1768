"""PinSAGE's neighbour sampler by random walks (the port's
``dgl1_tpu/sampling/pinsage.py``): the ``num_neighbors`` nodes most
visited by short walks from a seed become its weighted neighbours."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph
from dgl1_tpu_torch.sampling.randomwalks import _csr, walk_arrays

__all__ = ["RandomWalkNeighborSampler", "PinSAGESampler"]


class RandomWalkNeighborSampler:
    """For each seed, ``num_random_walks`` walks of ``num_traversals``
    steps (restart probability ``termination_prob``); the
    ``num_neighbors`` most visited nodes (ties in id order) become edges
    into the seed, their visit counts in ``edata['weights']``. The walks
    draw from ``np.random.default_rng(seed)`` as the reference's do. The
    frontier graph lives on the parent's device."""

    def __init__(self, g: Graph, num_traversals: int, termination_prob: float,
                 num_random_walks: int, num_neighbors: int,
                 seed: Optional[int] = None):
        self.g = g
        self.num_traversals = num_traversals
        self.termination_prob = termination_prob
        self.num_random_walks = num_random_walks
        self.num_neighbors = num_neighbors
        self.rng = np.random.default_rng(seed)
        self._indptr, self._nbr, _ = _csr(g)

    def __call__(self, seed_nodes) -> Graph:
        if isinstance(seed_nodes, torch.Tensor):
            seed_nodes = seed_nodes.cpu().numpy()
        seeds = np.asarray(seed_nodes, dtype=np.int64)
        starts = np.repeat(seeds, self.num_random_walks)
        traces = walk_arrays(self._indptr, self._nbr, starts,
                             self.num_traversals, self.rng,
                             self.termination_prob)
        visited = traces[:, 1:]  # the seed itself is not a neighbour
        src_list, dst_list, w_list = [], [], []
        k = self.num_random_walks
        for i, s in enumerate(seeds):
            vs = visited[i * k:(i + 1) * k].reshape(-1)
            vs = vs[(vs >= 0) & (vs != s)]
            if len(vs) == 0:
                continue
            uniq, counts = np.unique(vs, return_counts=True)
            top = np.argsort(-counts, kind="stable")[: self.num_neighbors]
            src_list.append(uniq[top])
            dst_list.append(np.full(len(top), s, dtype=np.int64))
            w_list.append(counts[top])
        if src_list:
            src = np.concatenate(src_list)
            dst = np.concatenate(dst_list)
            w = np.concatenate(w_list)
        else:
            src = dst = w = np.zeros(0, np.int64)
        frontier = graph((src, dst), num_nodes=self.g.num_nodes(),
                         device=self.g.device)
        frontier.edata["weights"] = torch.from_numpy(
            w.astype(np.float32)).to(self.g.device)
        return frontier


class PinSAGESampler(RandomWalkNeighborSampler):
    """``dgl.sampling.PinSAGESampler`` on a homogeneous projection: the
    reference's bipartite metapath collapses to 2-step walks on the
    projected graph."""

    def __init__(self, g: Graph, num_traversals: int = 2,
                 termination_prob: float = 0.5, num_random_walks: int = 10,
                 num_neighbors: int = 3, seed: Optional[int] = None):
        super().__init__(g, num_traversals, termination_prob,
                         num_random_walks, num_neighbors, seed)
