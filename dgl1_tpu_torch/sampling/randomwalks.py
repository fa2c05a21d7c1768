"""Random walks on the host with numpy (the port's
``dgl1_tpu/sampling/randomwalks.py``): one vectorized step for every
walker at a time, the loop over the walk's length.

The generator is drawn in the reference's order and shapes, so one seed
gives the same traces in both packages. The walked graph may live on any
device: its CSR arrays are read on the host (no copy when it is there).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import Graph

__all__ = ["random_walk", "node2vec_random_walk"]


def _csr(g: Graph, prob: Optional[str] = None):
    """(indptr, neighbours, cumulative weights or None) as int64/float64
    host arrays; the weights are ``edata[prob]`` in CSR order."""
    g._need_csr()
    indptr = g.csr_indptr.cpu().numpy().astype(np.int64)
    nbr = g.csr_dst.cpu().numpy().astype(np.int64)
    wc = None
    if prob is not None and prob in g.edata:
        e = g.num_edges()
        w = (g.edata[prob].detach().cpu().numpy().astype(np.float64)
             .reshape(-1)[:e])
        wc = np.cumsum(w[g.csr_eid.cpu().numpy()[:e]])
    return indptr, nbr, wc


def _step(indptr, nbr, cur, rng, w_cumsum=None):
    """One step of every walker: (next nodes, degrees of ``cur``); the
    next node is undefined where the degree is 0."""
    deg = indptr[cur + 1] - indptr[cur]
    if len(nbr) == 0:
        return cur.copy(), deg
    if w_cumsum is None:
        step = np.floor(
            rng.random(len(cur)) * np.maximum(deg, 1)).astype(np.int64)
        # A dead end at the array's end would index one past nbr; the
        # caller masks it out.
        return nbr[np.minimum(indptr[cur] + step, len(nbr) - 1)], deg
    # Weighted: the row's inverse CDF by a search of the global cumsum.
    lo = indptr[cur]
    hi = indptr[cur + 1]
    base = np.where(lo > 0, w_cumsum[lo - 1], 0.0)
    total = w_cumsum[np.maximum(hi - 1, 0)] - base
    u = base + rng.random(len(cur)) * np.maximum(total, 1e-30)
    pos = np.searchsorted(w_cumsum, u, side="right")
    pos = np.minimum(pos, np.maximum(hi - 1, 0))
    return nbr[np.minimum(np.maximum(pos, lo), len(nbr) - 1)], deg


def walk_arrays(indptr, nbr, starts, length: int, rng,
                restart_prob: float = 0.0, w_cumsum=None) -> np.ndarray:
    """Traces (num_starts, length + 1) of walks on raw CSR arrays, -1
    after a walk ends (a dead end or a restart)."""
    cur = np.asarray(starts, dtype=np.int64)
    n = len(cur)
    traces = np.full((n, length + 1), -1, dtype=np.int64)
    traces[:, 0] = cur
    alive = np.ones((n,), dtype=bool)
    for t in range(1, length + 1):
        nxt, deg = _step(indptr, nbr, cur, rng, w_cumsum)
        alive = alive & (deg > 0)
        if restart_prob > 0:
            alive = alive & (rng.random(n) >= restart_prob)
        cur = np.where(alive, nxt, cur)
        traces[alive, t] = nxt[alive]
    return traces


def random_walk(g, nodes, length: Optional[int] = None,
                restart_prob: float = 0.0,
                rng: Optional[np.random.Generator] = None,
                metapath: Optional[list] = None,
                prob: Optional[str] = None):
    """Random walk from each start node (``dgl.sampling.random_walk``).

    Homogeneous: ``length`` uniform (or ``prob``-weighted, an edata key)
    steps; returns traces (num_seeds, length + 1), -1 marking a walk that
    ended (a dead end or a restart).

    Heterogeneous: ``metapath`` is a list of etypes walked one relation a
    step; returns ``(traces, types)``, ``types`` indexing ``g.ntypes`` per
    trace column.
    """
    rng = rng or dgl_random.default_rng()
    cur = np.asarray(nodes, dtype=np.int64)
    if metapath is None:
        if length is None:
            raise ValueError("length is required without a metapath")
        indptr, nbr, wc = _csr(g, prob)
        return walk_arrays(indptr, nbr, cur, length, rng, restart_prob, wc)

    canon = [g.to_canonical_etype(et) for et in metapath]
    for a, b in zip(canon[:-1], canon[1:]):
        if a[2] != b[0]:
            raise ValueError(f"metapath discontinuity: {a} -> {b}")
    n = len(cur)
    traces = np.full((n, len(canon) + 1), -1, dtype=np.int64)
    traces[:, 0] = cur
    alive = np.ones((n,), dtype=bool)
    for t, c in enumerate(canon, start=1):
        indptr, nbr, wc = _csr(g.rel_graphs[c], prob)
        # An ended walk keeps a node of an earlier type, which may be out
        # of this relation's range: step it from node 0 instead (its
        # result is dropped; the draws are the same).
        nxt, deg = _step(indptr, nbr, np.where(alive, cur, 0), rng, wc)
        alive = alive & (deg > 0)
        if restart_prob > 0:
            alive = alive & (rng.random(n) >= restart_prob)
        cur = np.where(alive, nxt, cur)
        traces[alive, t] = nxt[alive]
    ntype_ix = {nt: i for i, nt in enumerate(g.ntypes)}
    types = np.asarray([ntype_ix[canon[0][0]]] + [ntype_ix[c[2]]
                                                  for c in canon],
                       dtype=np.int64)
    return traces, types


def node2vec_random_walk(g: Graph, nodes, p: float, q: float,
                         walk_length: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """node2vec's biased second-order walk
    (``dgl.sampling.node2vec_random_walk``) by rejection sampling, at
    most 32 tries a step, then a uniform pick."""
    rng = rng or dgl_random.default_rng()
    indptr, nbr, _ = _csr(g)
    cur = np.asarray(nodes, dtype=np.int64)
    n = len(cur)
    traces = np.full((n, walk_length + 1), -1, dtype=np.int64)
    traces[:, 0] = cur
    prev = np.full((n,), -1, dtype=np.int64)
    max_bias = max(1.0, 1.0 / p, 1.0 / q)
    for t in range(1, walk_length + 1):
        deg = indptr[cur + 1] - indptr[cur]
        alive = deg > 0
        nxt = cur.copy()
        for i in np.nonzero(alive)[0]:
            s, d = indptr[cur[i]], deg[i]
            for _ in range(32):
                cand = nbr[s + int(rng.integers(d))]
                if prev[i] < 0:
                    bias = 1.0
                elif cand == prev[i]:
                    bias = 1.0 / p
                else:
                    lo, hi = indptr[prev[i]], indptr[prev[i] + 1]
                    bias = 1.0 if np.any(nbr[lo:hi] == cand) else 1.0 / q
                if rng.random() < bias / max_bias:
                    nxt[i] = cand
                    break
            else:
                nxt[i] = nbr[s + int(rng.integers(d))]
        prev = np.where(alive, cur, prev)
        cur = np.where(alive, nxt, cur)
        traces[alive, t] = cur[alive]
    return traces
