"""Stochastic-block-model mixtures for community detection (the port's
``dgl1_tpu/data/sbm.py``; LGNN's training data, synthetic upstream too).
Each item is ``(graph, line_graph, pm_pd)``: the graph, its
non-backtracking line graph and the dense (N, E_pad) incidence factor
``Pm+Pd``, the graph and line graph padded to bucketed edge counts as the
reference pads them."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from dgl1_tpu_torch.data.base import to_tensor
from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import _coo, line_graph

__all__ = ["SBMMixtureDataset"]


def _sbm_graph(n_nodes: int, n_communities: int, p: float, q: float, rng):
    """An undirected SBM with in-community probability p and q across."""
    comm = np.repeat(np.arange(n_communities),
                     n_nodes // n_communities)[:n_nodes]
    if comm.shape[0] < n_nodes:
        comm = np.concatenate(
            [comm, rng.integers(0, n_communities, n_nodes - comm.shape[0])])
    us, vs = np.triu_indices(n_nodes, k=1)
    prob = np.where(comm[us] == comm[vs], p, q)
    keep = rng.random(us.shape[0]) < prob
    s, d = us[keep], vs[keep]
    return np.concatenate([s, d]), np.concatenate([d, s]), comm


def _round(x, m):
    return max((int(x) + m - 1) // m * m, m)


class SBMMixtureDataset:
    """``SBMMixtureDataset(n_graphs, n_nodes, n_communities)``
    (``dgl.data.SBMMixtureDataset``): p and q from the (c + lambda
    sqrt(c), c - lambda sqrt(c)) mixture of ``avg_deg`` c, lambda drawn
    per graph (``pq="Appendix_C"``) or fixed (a number); graphs on
    ``device`` (default ``cuda``), labels the host community ids."""

    def __init__(self, n_graphs: int, n_nodes: int, n_communities: int,
                 avg_deg: float = 3.0, pq="Appendix_C",
                 pad_multiple: int = 256, seed: int = 0, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.graphs: List[Graph] = []
        self.line_graphs: List[Graph] = []
        self.pm_pds: List[torch.Tensor] = []
        self.labels: List[np.ndarray] = []
        for _ in range(n_graphs):
            lam = (rng.uniform(0.5, 2.0) if pq == "Appendix_C"
                   else float(pq))
            c = avg_deg
            p = min((c + lam * np.sqrt(c)) / n_nodes * n_communities, 1.0)
            q = max((c - lam * np.sqrt(c)) / n_nodes * n_communities, 0.0)
            src, dst, comm = _sbm_graph(n_nodes, n_communities, p, q, rng)
            e = int(src.shape[0])
            e_pad = _round(e, pad_multiple)
            g_real = graph((src, dst), num_nodes=n_nodes, device="cpu")
            g = graph((src, dst), num_nodes=n_nodes, pad_edges_to=e_pad,
                      device=dev)
            ls, ld = _coo(line_graph(g_real, backtracking=False))
            # Line-graph edge counts spread like degree^2: bucketed 4x
            # coarser, as the reference does.
            lg = graph((ls, ld), num_nodes=e_pad,
                       pad_edges_to=_round(len(ls), 4 * pad_multiple),
                       device=dev)
            pm_pd = np.zeros((n_nodes, e_pad), np.float32)
            pm_pd[src, np.arange(e)] += 1.0
            pm_pd[dst, np.arange(e)] += 1.0
            self.graphs.append(g)
            self.line_graphs.append(lg)
            self.pm_pds.append(to_tensor(pm_pd, dev))
            self.labels.append(comm)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, Graph, torch.Tensor]:
        return self.graphs[i], self.line_graphs[i], self.pm_pds[i]
