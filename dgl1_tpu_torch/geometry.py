"""Point-cloud helpers (the port's ``dgl1_tpu/geometry.py``):
``farthest_point_sampler`` and ``neighbor_matching``."""

from __future__ import annotations

import numpy as np
import torch

from dgl1_tpu_torch.transform import _coo, _points

__all__ = ["farthest_point_sampler", "neighbor_matching"]


def farthest_point_sampler(pos, npoints: int, start_idx=None, *,
                           device=None):
    """Iterative farthest-point sampling (``dgl.geometry.
    farthest_point_sampler``): each step picks the point farthest from
    the chosen set, the first such index on a tie (as ``jnp.argmax``).

    ``pos``: (B, N, C) or (N, C) coordinates, computed on ``device``
    (default ``cuda``). Returns (B, npoints) (or (npoints,)) int64
    indices; a running min-distance field over every point, one
    vectorized step a pick."""
    x, _ = _points(pos, device)
    if x.dim() == 2:
        return farthest_point_sampler(x[None], npoints, start_idx,
                                      device=x.device)[0]
    b, n, _ = x.shape
    sel = torch.zeros((b, npoints), dtype=torch.int64, device=x.device)
    if start_idx is not None:
        sel[:, 0] = int(start_idx)
    mind = torch.full((b, n), float("inf"), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)
    for i in range(1, npoints):
        last = x[rows, sel[:, i - 1]]  # (B, C)
        d = ((x - last[:, None, :]) ** 2).sum(dim=-1)
        mind = torch.minimum(mind, d)
        sel[:, i] = mind.argmax(dim=-1)
    return sel


def neighbor_matching(g, num_clusters=None, edge_weights=None,
                      relabel_idx: bool = True) -> np.ndarray:
    """Greedy heavy-edge matching (``dgl.geometry.neighbor_matching``):
    visit edges by descending weight (stable), match both ends when
    neither is matched yet. Returns each node's cluster id (host numpy:
    coarsening is offline work); ``num_clusters`` is accepted for the
    reference's signature."""
    del num_clusters
    src, dst = _coo(g)
    e = len(src)
    n = g.num_nodes()
    if edge_weights is None:
        w = np.ones(e)
    elif isinstance(edge_weights, torch.Tensor):
        w = edge_weights.detach().cpu().numpy()[:e]
    else:
        w = np.asarray(edge_weights)[:e]
    order = np.argsort(-w, kind="stable")
    match = np.full(n, -1, np.int64)
    for i in order:
        u, v = int(src[i]), int(dst[i])
        if u != v and match[u] < 0 and match[v] < 0:
            match[u] = v
            match[v] = u
    cluster = np.arange(n)
    matched = match >= 0
    cluster[matched] = np.minimum(np.arange(n)[matched], match[matched])
    if relabel_idx:
        _, cluster = np.unique(cluster, return_inverse=True)
    return cluster
