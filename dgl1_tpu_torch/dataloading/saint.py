"""GraphSAINT subgraph sampling (the port's
``dgl1_tpu/dataloading/saint.py``; "GraphSAINT: Graph Sampling Based
Inductive Learning Method").

Modes: 'node' (a degree-proportional node budget), 'edge' (edges with
probability proportional to 1/d_u + 1/d_v), 'walk' (the union of random
walks from ``budget = (roots, length)`` uniform roots). Each batch is the
node-induced subgraph of the sampled set, padded to multiples of
``node_pad_multiple`` nodes and ``edge_pad_multiple`` edges as the
reference pads it.

Normalisation: ``num_pre`` batches drawn at construction count how often
each node and edge is sampled; a batch carries ``ndata['loss_norm']``
(inverse node frequency, mean 1 over its real nodes) and
``edata['aggr_norm']`` (node count of the destination over edge count),
zero on padding. Sampling draws the reference's numpy stream, so one seed
gives the same batches in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.sampling.randomwalks import _csr, walk_arrays
from dgl1_tpu_torch.transform import _coo

__all__ = ["SAINTSampler"]


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


class SAINTSampler:
    """Iterate ``num_batches`` ``(subgraph, node_mask)`` pairs of ``g``:
    the subgraph on ``device`` (default ``cuda``) with its real nodes
    first, the parent's ndata rows gathered on the parent's device
    (padded rows read node 0; mask them), parent ids in
    ``ndata['_ID']``."""

    def __init__(self, g: Graph, mode: str, budget, num_batches: int,
                 num_pre: int = 20, seed: Optional[int] = None,
                 node_pad_multiple: int = 256,
                 edge_pad_multiple: int = 1024, device=None):
        if mode not in ("node", "edge", "walk"):
            raise ValueError(f"unknown SAINT mode {mode!r}")
        self.device = resolve_device(device)
        self.g = g
        self.mode = mode
        self.budget = budget
        self.num_batches = num_batches
        self.rng = np.random.default_rng(seed)
        self.npad = node_pad_multiple
        self.epad = edge_pad_multiple

        self._src, self._dst = (a.astype(np.int64) for a in _coo(g))
        n = g.num_nodes()
        self._indptr, self._nbr, _ = (_csr(g) if mode == "walk"
                                      else (None, None, None))
        deg = (np.bincount(self._dst, minlength=n)
               + np.bincount(self._src, minlength=n))
        self._deg = np.maximum(deg, 1)

        # +1 smoothing keeps every count positive.
        node_count = np.ones(n)
        edge_count = np.ones(len(self._src))
        for _ in range(num_pre):
            nodes = self._sample_nodes()
            node_count[nodes] += 1
            edge_count[self._edge_mask(nodes)] += 1
        self._node_count = node_count
        self._edge_count = edge_count

    def _sample_nodes(self) -> np.ndarray:
        n = self.g.num_nodes()
        if self.mode == "node":
            p = self._deg / self._deg.sum()
            k = min(int(self.budget), n)
            return np.unique(self.rng.choice(n, size=k, p=p))
        if self.mode == "edge":
            w = 1.0 / self._deg[self._src] + 1.0 / self._deg[self._dst]
            p = w / w.sum()
            k = min(int(self.budget), len(self._src))
            eids = self.rng.choice(len(self._src), size=k, p=p)
            return np.unique(np.concatenate([self._src[eids],
                                             self._dst[eids]]))
        roots, length = self.budget
        starts = self.rng.integers(0, n, int(roots))
        visited = walk_arrays(self._indptr, self._nbr, starts, int(length),
                              self.rng).reshape(-1)
        return np.unique(visited[visited >= 0])

    def _edge_mask(self, nodes: np.ndarray) -> np.ndarray:
        keep = np.zeros(self.g.num_nodes(), bool)
        keep[nodes] = True
        return keep[self._src] & keep[self._dst]

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        dev = self.device
        for _ in range(self.num_batches):
            nodes = self._sample_nodes()
            eids = np.nonzero(self._edge_mask(nodes))[0]
            relabel = np.full(self.g.num_nodes(), -1, np.int64)
            relabel[nodes] = np.arange(len(nodes))
            n_pad = _round_up(len(nodes), self.npad)
            e_pad = _round_up(max(len(eids), 1), self.epad)
            sg = graph((relabel[self._src[eids]], relabel[self._dst[eids]]),
                       num_nodes=n_pad, pad_edges_to=e_pad, device=dev)
            nid = np.pad(nodes, (0, n_pad - len(nodes))).astype(np.int32)
            sg.ndata["_ID"] = torch.from_numpy(nid).to(dev)
            for k, v in self.g.ndata.items():
                idx = torch.from_numpy(nid).to(v.device).long()
                sg.ndata[k] = v.index_select(0, idx).to(dev)
            loss_norm = 1.0 / self._node_count[nodes]
            loss_norm = loss_norm * (len(loss_norm) / loss_norm.sum())
            ln = np.zeros(n_pad, np.float32)
            ln[: len(nodes)] = loss_norm
            sg.ndata["loss_norm"] = torch.from_numpy(ln).to(dev)
            an = np.zeros(e_pad, np.float32)
            an[: len(eids)] = (self._node_count[self._dst[eids]]
                               / self._edge_count[eids])
            sg.edata["aggr_norm"] = torch.from_numpy(an).to(dev)
            mask = torch.zeros(n_pad, dtype=torch.bool)
            mask[: len(nodes)] = True
            yield sg, mask.to(dev)
