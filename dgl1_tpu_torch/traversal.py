"""Graph traversal frontiers (the port's ``dgl1_tpu/traversal.py``;
parity: ``python/dgl/traversal.py``). Host-side numpy over the graph's
CSR; each generator returns the list of its frontiers."""

from __future__ import annotations

from typing import List

import numpy as np

from dgl1_tpu_torch.graph import Graph

__all__ = ["bfs_nodes_generator", "bfs_edges_generator",
           "topological_nodes_generator", "dfs_edges_generator"]


def _csr(g: Graph):
    if g.csr_indptr is None:
        raise ValueError("traversal needs the graph's CSR (formats=)")
    return g.csr_indptr.cpu().numpy(), g.csr_dst.cpu().numpy()


def _sources(source) -> np.ndarray:
    return np.atleast_1d(np.asarray(source, dtype=np.int64))


def bfs_nodes_generator(g: Graph, source) -> List[np.ndarray]:
    """BFS node frontiers from ``source`` (``dgl.bfs_nodes_generator``)."""
    indptr, nbr = _csr(g)
    visited = np.zeros(g.num_nodes(), dtype=bool)
    frontier = np.unique(_sources(source))
    visited[frontier] = True
    out = []
    while len(frontier):
        out.append(frontier)
        nxt = [nbr[indptr[u]:indptr[u + 1]] for u in frontier]
        nxt = (np.unique(np.concatenate(nxt)).astype(np.int64) if nxt
               else np.array([], np.int64))
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
    return out


def bfs_edges_generator(g: Graph, source) -> List[np.ndarray]:
    """BFS edge frontiers: the edges that first reach each level."""
    indptr, nbr = _csr(g)
    eids_sorted = g.csr_eid.cpu().numpy()
    visited = np.zeros(g.num_nodes(), dtype=bool)
    frontier = np.unique(_sources(source))
    visited[frontier] = True
    out = []
    while len(frontier):
        lvl_edges, nxt_nodes = [], []
        for u in frontier:
            for j in range(indptr[u], indptr[u + 1]):
                v = nbr[j]
                if not visited[v]:
                    visited[v] = True
                    lvl_edges.append(eids_sorted[j])
                    nxt_nodes.append(v)
        if lvl_edges:
            out.append(np.asarray(lvl_edges, dtype=np.int64))
        frontier = np.asarray(nxt_nodes, dtype=np.int64)
    return out


def topological_nodes_generator(g: Graph) -> List[np.ndarray]:
    """Topological frontiers by Kahn's algorithm
    (``dgl.topological_nodes_generator``); raises on a cycle."""
    indptr, nbr = _csr(g)
    indeg = g.in_degrees().cpu().numpy().copy()
    frontier = np.nonzero(indeg == 0)[0]
    out = []
    seen = 0
    while len(frontier):
        out.append(frontier)
        seen += len(frontier)
        nxt = []
        for u in frontier:
            for v in nbr[indptr[u]:indptr[u + 1]]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        frontier = (np.unique(np.asarray(nxt, dtype=np.int64)) if nxt
                    else np.array([], np.int64))
    if seen != g.num_nodes():
        raise ValueError("graph has a cycle")
    return out


def dfs_edges_generator(g: Graph, source) -> List[np.ndarray]:
    """DFS edge order from ``source``, one edge a step."""
    indptr, nbr = _csr(g)
    eids_sorted = g.csr_eid.cpu().numpy()
    visited = np.zeros(g.num_nodes(), dtype=bool)
    stack = [int(s) for s in _sources(source)][::-1]
    for s in stack:
        visited[s] = True
    order = []
    while stack:
        u = stack.pop()
        for j in range(indptr[u + 1] - 1, indptr[u] - 1, -1):
            v = nbr[j]
            if not visited[v]:
                visited[v] = True
                order.append(eids_sorted[j])
                stack.append(v)
    return [np.asarray([e], dtype=np.int64) for e in order]
