"""Neighbor sampling on the host with numpy (the port's
``dgl1_tpu/sampling/neighbor.py``).

Sampling is a host producer: the device only sees the blocks built from
what it samples (``dataloading``). Without replacement, a row keeps the
``fanout`` candidates with the smallest random keys; with ``prob`` the
keys are Efraimidis-Spirakis' ``-log(u) / w``. The generator is drawn in
the reference's order and shapes, so one seed gives the same edges in
both packages; the keys are selected by one ``lexsort`` as the reference
does, but for rows of many candidates, which take a partition with the
same result (:func:`_smallest_keys`). The sampled parent stays on the
host: its CSC arrays are read in place (no copy).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import Graph, block, graph

__all__ = ["sample_neighbors", "sample_neighbors_arrays", "select_topk"]


def _ranges(starts: np.ndarray, degs: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+d) ranges without a Python loop over rows."""
    total = int(degs.sum())
    if total == 0:
        return np.zeros((0,), dtype=np.int64)
    off = np.repeat(np.cumsum(degs) - degs, degs)
    return np.repeat(starts, degs) + (np.arange(total) - off)


def _host(g: Graph) -> None:
    if g.device.type != "cpu":
        raise ValueError("the sampling parent must live on the host: build "
                         "it with device='cpu'")


def _csc_arrays(g: Graph):
    """The parent's CSC as numpy views of its host tensors (no copy)."""
    _host(g)
    return g.csc_indptr.numpy(), g.csc_src.numpy(), g.csc_eid.numpy()


def _csr_arrays(g: Graph):
    _host(g)
    return g.csr_indptr.numpy(), g.csr_dst.numpy(), g.csr_eid.numpy()


def _edge_prob(data: dict, prob: Optional[str]):
    """A relation's weights, or None where it has none."""
    if prob is None or prob not in data:
        return None
    return data[prob].detach().cpu().numpy().reshape(-1)


def sample_neighbors_arrays(indptr: np.ndarray, nbr: np.ndarray,
                            eid: Optional[np.ndarray], seeds: np.ndarray,
                            fanout: int, replace: bool = False,
                            rng: Optional[np.random.Generator] = None,
                            prob: Optional[np.ndarray] = None):
    """Row-wise sampling on raw CSC (or CSR) arrays: up to ``fanout``
    entries of each seed's row (all of them for a negative fanout), with
    replacement or without, uniform or weighted by ``prob[eid]``. Returns
    ``(nbr_sampled, seed_index_per_sample, eid_sampled)``; a seed that
    appears twice is sampled twice, each with its own index."""
    rng = rng or dgl_random.default_rng()
    seeds = np.asarray(seeds, dtype=np.int64)
    starts = indptr[seeds].astype(np.int64)
    degs = (indptr[seeds + 1] - indptr[seeds]).astype(np.int64)

    if fanout < 0:
        seed_idx = np.repeat(np.arange(len(seeds)), degs)
        picked = _ranges(starts, degs)
    elif replace:
        k = fanout
        valid = degs > 0
        r = rng.random((len(seeds), k))
        idx = np.floor(r * np.maximum(degs, 1)[:, None]).astype(np.int64)
        picked = (starts[:, None] + idx)[valid].reshape(-1)
        seed_idx = np.repeat(np.arange(len(seeds))[valid], k)
    else:
        k = fanout
        counts = np.minimum(degs, k)
        seed_of_cand = np.repeat(np.arange(len(seeds)), degs)
        cand = _ranges(starts, degs)
        if prob is not None:
            w = np.maximum(prob[eid[cand] if eid is not None else cand],
                           1e-30)
            key = -np.log(np.maximum(rng.random(cand.shape), 1e-300)) / w
        else:
            key = rng.random(cand.shape)
        sel, seed_idx = _smallest_keys(key, seed_of_cand, degs, counts)
        picked = cand[sel]

    nbr_s = nbr[picked]
    eid_s = eid[picked] if eid is not None else picked
    return nbr_s, seed_idx, eid_s


# Rows with at least this many candidates take their smallest keys by a
# partition instead of the one lexsort over all candidates (a hub row of
# 10^6 in-edges made that sort most of a batch's sampling time).
_PARTITION_MIN = 4096


def _smallest_keys(key: np.ndarray, seed_of_cand: np.ndarray,
                   degs: np.ndarray, counts: np.ndarray):
    """Each seed's ``counts[i]`` candidates of smallest key, seed by seed,
    smallest key first, equal keys in candidate order: exactly what
    ``np.lexsort((key, seed_of_cand))`` keeps of each seed's head (the
    reference's selection), with rows of ``_PARTITION_MIN`` candidates or
    more selected by ``np.partition``. Candidates are grouped by seed in
    seed order. Returns (candidate indices, their seed indices)."""
    n = len(degs)
    big = (degs >= _PARTITION_MIN) & (counts > 0)
    sub = (np.flatnonzero(~big[seed_of_cand]) if big.any()
           else np.arange(len(key)))
    order = sub[np.lexsort((key[sub], seed_of_cand[sub]))]
    sorted_seed = seed_of_cand[order]
    seg_start = np.searchsorted(sorted_seed, np.arange(n))
    keep = (np.arange(len(order)) - seg_start[sorted_seed]
            < counts[sorted_seed])
    if not big.any():
        return order[keep], sorted_seed[keep]
    idx, seed = [order[keep]], [sorted_seed[keep]]
    starts = np.cumsum(degs) - degs
    for i in np.flatnonzero(big):
        seg = key[starts[i]:starts[i] + degs[i]]
        c = int(counts[i])
        kth = np.partition(seg, c - 1)[c - 1]
        lt = np.flatnonzero(seg < kth)
        sel = np.concatenate([lt, np.flatnonzero(seg == kth)[: c - len(lt)]])
        idx.append(starts[i] + sel[np.lexsort((sel, seg[sel]))])
        seed.append(np.full(c, i, dtype=np.int64))
    idx, seed = np.concatenate(idx), np.concatenate(seed)
    o = np.argsort(seed, kind="stable")
    return idx[o], seed[o]


def _etype_fanout(fanout, canonical):
    """An int-or-dict fanout for one canonical edge type (keyed by the
    canonical triple or the edge type's name)."""
    if isinstance(fanout, dict):
        if canonical in fanout:
            return int(fanout[canonical])
        if canonical[1] in fanout:
            return int(fanout[canonical[1]])
        raise KeyError(f"fanout dict has no entry for etype {canonical!r}")
    return int(fanout)


def _sample_hetero_arrays(hg, nodes: dict, fanout, prob, replace, rng,
                          edge_dir: str = "in"):
    """Per relation, in canonical order, the sampled ``(src, seed_index,
    dst, eid)`` arrays of ``_sample_neighbors_hetero`` (``src``/``dst`` in
    the parent's node spaces; ``seed_index`` into ``nodes`` of the seed
    side), or None where the relation samples nothing. Draws from ``rng``
    in the reference's order."""
    out = {}
    for c in hg.canonical_etypes:
        st, _, dt = c
        seeds = nodes.get(dt if edge_dir == "in" else st)
        k = _etype_fanout(fanout, c)
        if seeds is None or len(seeds) == 0 or k == 0:
            out[c] = None
            continue
        rel = hg.rel_graphs[c]
        p = _edge_prob(rel.edata, prob)
        if edge_dir == "in":
            nbr, seed_idx, eids = sample_neighbors_arrays(
                *_csc_arrays(rel), seeds, k, replace, rng, p)
            out[c] = (nbr, seed_idx, seeds[seed_idx], eids)
        else:
            nbr, seed_idx, eids = sample_neighbors_arrays(
                *_csr_arrays(rel), seeds, k, replace, rng, p)
            out[c] = (seeds[seed_idx], seed_idx, nbr, eids)
    return out


def _hetero_nodes(hg, nodes) -> dict:
    if not isinstance(nodes, dict):
        if len(hg.ntypes) != 1:
            raise ValueError("nodes must be a {ntype: ids} dict on a "
                             "multi-ntype heterograph")
        nodes = {hg.ntypes[0]: nodes}
    return {nt: np.asarray(v, dtype=np.int64) for nt, v in nodes.items()}


def _frontier_rel(src, dst, eids, n_src: int, n_dst: int, formats):
    fr = block((src, dst), num_src_nodes=n_src, num_dst_nodes=n_dst,
               formats=formats or ("coo",), device="cpu")
    fr.edata["_ID"] = torch.from_numpy(np.asarray(eids, np.int32))
    return fr


def _sample_neighbors_hetero(hg, nodes, fanout, prob, replace, rng, formats,
                             edge_dir: str = "in"):
    """Per relation ``(st, et, dt)``, up to ``fanout[et]`` in-edges of the
    ``dt`` seeds (out-edges of the ``st`` seeds with ``edge_dir='out'``);
    a hetero frontier in the parent's node spaces with per-relation
    ``edata['_ID']``. Relations without seeds get an empty frontier."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    rng = rng or dgl_random.default_rng()
    nodes = _hetero_nodes(hg, nodes)
    counts = {nt: hg.num_nodes(nt) for nt in hg.ntypes}
    rels = {}
    empty = np.zeros((0,), np.int64)
    for c, got in _sample_hetero_arrays(hg, nodes, fanout, prob, replace,
                                        rng, edge_dir).items():
        src, _, dst, eids = got if got is not None else (empty,) * 4
        rels[c] = _frontier_rel(src, dst, eids, counts[c[0]], counts[c[2]],
                                formats)
    return HeteroGraph(rels, counts)


def sample_neighbors(g, nodes, fanout, edge_dir: str = "in",
                     prob: Optional[str] = None, replace: bool = False,
                     rng: Optional[np.random.Generator] = None,
                     formats=None):
    """Sample up to ``fanout`` in-edges (or out-edges) of each seed node
    (``dgl.sampling.sample_neighbors``); a negative fanout takes them all.
    Returns a frontier graph on the host in the parent's node space whose
    edges are the sampled ones, the parent's edge ids in
    ``edata['_ID']``. ``prob`` names an edge feature of weights. On a
    heterograph ``nodes`` is a ``{ntype: ids}`` dict and ``fanout`` an int
    or a per-edge-type dict. ``formats`` restricts the frontier's layouts
    (the block pipeline reads only its edge list). The parent lives on
    the host."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if edge_dir not in ("in", "out"):
        raise ValueError("edge_dir must be 'in' or 'out'")
    if isinstance(g, HeteroGraph):
        return _sample_neighbors_hetero(g, nodes, fanout, prob, replace,
                                        rng, formats, edge_dir)
    if edge_dir == "out":
        rev = sample_neighbors(g.reverse(copy_edata=True), nodes, fanout,
                               "in", prob, replace, rng, formats=formats)
        return rev.reverse(copy_edata=True)
    nodes = np.asarray(nodes, dtype=np.int64)
    p = (None if prob is None
         else g.edata[prob].detach().cpu().numpy().reshape(-1))
    nbr, seed_idx, eids = sample_neighbors_arrays(
        *_csc_arrays(g), nodes, fanout, replace, rng, p)
    frontier = graph((nbr, nodes[seed_idx]), num_nodes=g.num_src_nodes(),
                     formats=formats, device="cpu")
    frontier.edata["_ID"] = torch.from_numpy(eids.astype(np.int32))
    return frontier


def select_topk(g, k: int, weight: str, nodes=None, edge_dir: str = "in",
                ascending: bool = False):
    """The subgraph keeping each node's ``k`` in-edges (out-edges with
    ``edge_dir='out'``) of largest ``edata[weight]`` (smallest with
    ``ascending``), in the parent's node space with ``edata['_ID']``
    (``dgl.sampling.select_topk``). One ``lexsort`` of the selected rows'
    edges by (row, weight), no loop over nodes."""
    from dgl1_tpu_torch.transform import edge_subgraph

    if edge_dir == "out":
        indptr, _, eid = _csr_arrays(g)
        num_rows = g.num_src_nodes()
    elif edge_dir == "in":
        indptr, _, eid = _csc_arrays(g)
        num_rows = g.num_dst_nodes()
    else:
        raise ValueError("edge_dir must be 'in' or 'out'")
    w = g.edata[weight].detach().cpu().numpy().reshape(-1)[: g.num_edges()]
    if nodes is None:
        nodes = np.arange(num_rows)
    nodes = np.asarray(nodes, dtype=np.int64)
    counts = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return edge_subgraph(g, np.zeros((0,), np.int64),
                             relabel_nodes=False)
    owner = np.repeat(np.arange(len(nodes)), counts)
    flat = (np.repeat(indptr[nodes], counts)
            + (np.arange(total)
               - np.repeat(np.cumsum(counts) - counts, counts)))
    ids = eid[flat].astype(np.int64)
    order = np.lexsort((w[ids], owner))
    rank = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    sel = rank < k if ascending else rank >= counts[owner] - k
    keep = ids[order][sel]
    return edge_subgraph(g, np.sort(keep), relabel_nodes=False)
