"""Batching graphs by disjoint union (the port's ``dgl1_tpu/batch.py``):
``batch``, ``unbatch``, ``batch_num_nodes`` and ``batch_num_edges``, for
graphs and heterographs.

A batch is one graph built through :func:`graph` (every layout its
in-degrees earn), its features concatenated on the device. The per-graph
node and edge counts ride in ``meta['_batch_num_nodes']`` /
``meta['_batch_num_edges']`` (host int32 arrays; dicts by node type and
canonical edge type for a heterograph) and feed the segment readouts of
``readout.py`` and ``nn/glob.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import _coo

__all__ = ["batch", "unbatch", "batch_num_nodes", "batch_num_edges"]


def _concat(parts, dev):
    return torch.cat([p.to(dev) for p in parts], dim=0)


def _batch_hetero(graphs, dev):
    from dgl1_tpu_torch.heterograph import heterograph

    ntypes, cetypes = graphs[0].ntypes, graphs[0].canonical_etypes
    for g in graphs[1:]:
        if g.ntypes != ntypes or g.canonical_etypes != cetypes:
            raise ValueError("batched heterographs must share the schema")
    offs = {nt: np.cumsum([0] + [g.num_nodes(nt) for g in graphs])
            for nt in ntypes}
    data = {}
    for c in cetypes:
        st, _, dt = c
        coos = [_coo(g.rel_graphs[c]) for g in graphs]
        data[c] = (np.concatenate([s + offs[st][i]
                                   for i, (s, _) in enumerate(coos)]),
                   np.concatenate([d + offs[dt][i]
                                   for i, (_, d) in enumerate(coos)]))
    big = heterograph(data, num_nodes_dict={nt: int(offs[nt][-1])
                                            for nt in ntypes}, device=dev)
    for nt in ntypes:
        for key in graphs[0].nframes[nt]:
            if all(key in g.nframes[nt] for g in graphs):
                big.nframes[nt][key] = _concat(
                    [g.nframes[nt][key] for g in graphs], dev)
    for c in cetypes:
        for key in graphs[0].rel_graphs[c].edata:
            if all(key in g.rel_graphs[c].edata for g in graphs):
                big.rel_graphs[c].edata[key] = _concat(
                    [g.rel_graphs[c].edata[key][: g.rel_graphs[c]
                                                .num_edges()]
                     for g in graphs], dev)
    big.meta["_batch_num_nodes"] = {
        nt: np.asarray([g.num_nodes(nt) for g in graphs], np.int32)
        for nt in ntypes}
    big.meta["_batch_num_edges"] = {
        c: np.asarray([g.rel_graphs[c].num_edges() for g in graphs],
                      np.int32) for c in cetypes}
    return big


def batch(graphs: Sequence, *, device=None):
    """The disjoint union of ``graphs`` (``dgl.batch``), placed on
    ``device`` (default ``cuda``): nodes and edges in graph order, the
    features that every graph has concatenated. Heterographs batch node
    type by node type and relation by relation."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if not graphs:
        raise ValueError("batch needs at least one graph")
    dev = resolve_device(device)
    if isinstance(graphs[0], HeteroGraph):
        return _batch_hetero(graphs, dev)
    offsets = np.cumsum([0] + [g.num_nodes() for g in graphs])
    coos = [_coo(g) for g in graphs]
    big = graph((np.concatenate([s + o for (s, _), o in zip(coos, offsets)]),
                 np.concatenate([d + o for (_, d), o in zip(coos, offsets)])),
                num_nodes=int(offsets[-1]), device=dev)
    for key in graphs[0].ndata:
        if all(key in g.ndata for g in graphs):
            big.ndata[key] = _concat([g.ndata[key][: g.num_nodes()]
                                      for g in graphs], dev)
    for key in graphs[0].edata:
        if all(key in g.edata for g in graphs):
            big.edata[key] = _concat([g.edata[key][: g.num_edges()]
                                      for g in graphs], dev)
    big.meta["_batch_num_nodes"] = np.asarray(
        [g.num_nodes() for g in graphs], np.int32)
    big.meta["_batch_num_edges"] = np.asarray(
        [g.num_edges() for g in graphs], np.int32)
    return big


def _as_counts(counts, g):
    return torch.as_tensor(np.asarray(counts, np.int32), device=g.device)


def batch_num_nodes(g, ntype: str = None):
    """(B,) int32 node counts of the batched graphs (one count for a graph
    that is not a batch), on g's device; ``ntype`` picks a heterograph's
    node type (optional when it has one)."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    per = g.meta.get("_batch_num_nodes")
    if not isinstance(g, HeteroGraph):
        return _as_counts([g.num_nodes()] if per is None else per, g)
    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    if nt is None:
        raise ValueError("ntype required on a multi-type heterograph")
    return _as_counts([g.num_nodes(nt)] if per is None else per[nt], g)


def batch_num_edges(g, etype=None):
    """(B,) int32 edge counts of the batched graphs, on g's device;
    ``etype`` picks a heterograph's relation (optional when it has one)."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    per = g.meta.get("_batch_num_edges")
    if not isinstance(g, HeteroGraph):
        return _as_counts([g.num_edges()] if per is None else per, g)
    cs = g.canonical_etypes
    c = (g.to_canonical_etype(etype) if etype is not None
         else cs[0] if len(cs) == 1 else None)
    if c is None:
        raise ValueError("etype required on a multi-etype heterograph")
    return _as_counts([g.rel_graphs[c].num_edges()] if per is None
                      else per[c], g)


def _unbatch_hetero(bg) -> list:
    from dgl1_tpu_torch.heterograph import heterograph

    bnn = {nt: np.asarray(v) for nt, v in bg.meta["_batch_num_nodes"].items()}
    bne = {c: np.asarray(v) for c, v in bg.meta["_batch_num_edges"].items()}
    k = len(next(iter(bnn.values())))
    n_off = {nt: np.concatenate([[0], np.cumsum(v)]) for nt, v in bnn.items()}
    e_off = {c: np.concatenate([[0], np.cumsum(v)]) for c, v in bne.items()}
    coos = {c: _coo(bg.rel_graphs[c]) for c in bg.canonical_etypes}
    out = []
    for i in range(k):
        data = {}
        for c, (src, dst) in coos.items():
            st, _, dt = c
            lo, hi = e_off[c][i], e_off[c][i + 1]
            data[c] = (src[lo:hi] - n_off[st][i], dst[lo:hi] - n_off[dt][i])
        g = heterograph(data, num_nodes_dict={nt: int(bnn[nt][i])
                                              for nt in bg.ntypes},
                        device=bg.device)
        for nt in bg.ntypes:
            for key, v in bg.nframes[nt].items():
                g.nframes[nt][key] = v[n_off[nt][i]:n_off[nt][i + 1]]
        for c in bg.canonical_etypes:
            for key, v in bg.rel_graphs[c].edata.items():
                g.rel_graphs[c].edata[key] = v[e_off[c][i]:e_off[c][i + 1]]
        out.append(g)
    return out


def unbatch(bg) -> List[Graph]:
    """The graphs of a batch (``dgl.unbatch``), each renumbered from 0 and
    with its slices of the batch's features, on the batch's device."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if isinstance(bg, HeteroGraph):
        return _unbatch_hetero(bg)
    bnn = batch_num_nodes(bg).cpu().numpy()
    bne = batch_num_edges(bg).cpu().numpy()
    n_off = np.concatenate([[0], np.cumsum(bnn)])
    e_off = np.concatenate([[0], np.cumsum(bne)])
    src, dst = _coo(bg)
    out = []
    for i in range(len(bnn)):
        g = graph((src[e_off[i]:e_off[i + 1]] - n_off[i],
                   dst[e_off[i]:e_off[i + 1]] - n_off[i]),
                  num_nodes=int(bnn[i]), device=bg.device)
        for k, v in bg.ndata.items():
            g.ndata[k] = v[n_off[i]:n_off[i + 1]]
        for k, v in bg.edata.items():
            g.edata[k] = v[e_off[i]:e_off[i + 1]]
        out.append(g)
    return out
