"""Graph-level readouts over batched graphs (the port's
``dgl1_tpu/readout.py``): ``readout_nodes``/``readout_edges`` and their
``sum``/``mean``/``max`` names, ``softmax_*``, ``broadcast_*`` and
``topk_*``.

Every readout is a segment op over the batch's contiguous per-graph
lengths (``batch_num_nodes``/``batch_num_edges``): ``index_add`` and
``scatter_reduce`` in plain torch, as the reference's are XLA segment ops
outside any Pallas kernel. ``topk_*`` lays the batch out as a (B, max_n,
...) tile padded with -/+inf and sorts it. A feature is a key of
``g.ndata``/``g.edata`` or a tensor.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.batch import batch_num_edges, batch_num_nodes
from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.segment import (segment_ids_from_lengths,
                                        segment_reduce, segment_softmax)

__all__ = ["readout_nodes", "readout_edges", "sum_nodes", "sum_edges",
           "mean_nodes", "mean_edges", "max_nodes", "max_edges",
           "softmax_nodes", "softmax_edges", "broadcast_nodes",
           "broadcast_edges", "topk_nodes", "topk_edges"]


def _node_feat(g: Graph, feat):
    x = g.ndata[feat] if isinstance(feat, str) else feat
    return x[: g.num_nodes()]


def _edge_feat(g: Graph, feat):
    x = g.edata[feat] if isinstance(feat, str) else feat
    return x[: g.num_edges()]


def _readout(seglen, x, weight, op: str):
    if weight is not None:
        x = x * weight.reshape(tuple(weight.shape)
                               + (1,) * (x.dim() - weight.dim()))
    return segment_reduce(seglen, x, op)


def readout_nodes(g: Graph, feat, weight=None, *, op: str = "sum"):
    """Per-graph ``op`` (sum, mean, max, min, prod) of a node feature,
    optionally weighted by a node field: (B, \\*feat_dims); an empty graph
    gives 0."""
    w = None if weight is None else _node_feat(g, weight)
    return _readout(batch_num_nodes(g), _node_feat(g, feat), w, op)


def readout_edges(g: Graph, feat, weight=None, *, op: str = "sum"):
    """Per-graph ``op`` of an edge feature (as :func:`readout_nodes`)."""
    w = None if weight is None else _edge_feat(g, weight)
    return _readout(batch_num_edges(g), _edge_feat(g, feat), w, op)


def sum_nodes(g, feat, weight=None):
    return readout_nodes(g, feat, weight, op="sum")


def sum_edges(g, feat, weight=None):
    return readout_edges(g, feat, weight, op="sum")


def mean_nodes(g, feat, weight=None):
    return readout_nodes(g, feat, weight, op="mean")


def mean_edges(g, feat, weight=None):
    return readout_edges(g, feat, weight, op="mean")


def max_nodes(g, feat, weight=None):
    return readout_nodes(g, feat, weight, op="max")


def max_edges(g, feat, weight=None):
    return readout_edges(g, feat, weight, op="max")


def softmax_nodes(g: Graph, feat):
    """Softmax of a node feature within each graph of the batch."""
    return segment_softmax(batch_num_nodes(g), _node_feat(g, feat))


def softmax_edges(g: Graph, feat):
    return segment_softmax(batch_num_edges(g), _edge_feat(g, feat))


def _broadcast(seglen, total: int, graph_feat):
    ids = segment_ids_from_lengths(seglen, total).long()
    return graph_feat.index_select(0, ids.clamp(max=graph_feat.shape[0] - 1))


def broadcast_nodes(g: Graph, graph_feat):
    """A per-graph feature (B, ...) repeated onto every node of its graph:
    (N, ...)."""
    return _broadcast(batch_num_nodes(g), g.num_nodes(), graph_feat)


def broadcast_edges(g: Graph, graph_feat):
    return _broadcast(batch_num_edges(g), g.num_edges(), graph_feat)


def _topk(seglen, x, k: int, descending: bool, sortby):
    lengths = seglen.cpu()
    if k > int(lengths.min()):
        raise ValueError(f"topk: k={k} exceeds the smallest graph "
                         f"({int(lengths.min())} nodes/edges) in the batch")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    total, max_n, b = x.shape[0], int(lengths.max()), len(lengths)
    ids = segment_ids_from_lengths(seglen, total).long()
    starts = torch.cumsum(seglen, 0) - seglen
    rank = torch.arange(total, device=x.device) - starts.long()[ids]
    fill = float("-inf") if descending else float("inf")
    dense = x.new_full((b, max_n) + tuple(x.shape[1:]), fill)
    dense[ids, rank] = x
    # A stable sort keeps the lower position first among equal keys, as
    # lax.top_k does.
    if sortby is None:
        keys = dense.movedim(1, -1)
        vals, idx = torch.sort(keys, dim=-1, descending=descending,
                               stable=True)
        vals = vals[..., :k].movedim(-1, 1)
        idx = idx[..., :k].movedim(-1, 1)
    else:
        _, idx = torch.sort(dense[..., sortby], dim=-1,
                            descending=descending, stable=True)
        idx = idx[:, :k]
        gidx = idx.reshape(idx.shape + (1,) * (dense.dim() - 2)).expand(
            (b, k) + tuple(dense.shape[2:]))
        vals = dense.gather(1, gidx)
    if squeeze:
        vals = vals[..., 0]
        if sortby is None:
            idx = idx[..., 0]
    return vals, idx


def topk_nodes(g: Graph, feat, k: int, *, descending: bool = True,
               sortby=None):
    """Per-graph top ``k`` nodes by feature value (``dgl.topk_nodes``):
    with ``sortby=None`` every feature column ranked on its own (values
    and indices (B, k, D)); with ``sortby=j`` whole rows ranked by column
    j (values (B, k, D), indices (B, k)). Indices are positions within
    each graph; equal values keep the lower position first."""
    return _topk(batch_num_nodes(g), _node_feat(g, feat), k, descending,
                 sortby)


def topk_edges(g: Graph, feat, k: int, *, descending: bool = True,
               sortby=None):
    return _topk(batch_num_edges(g), _edge_feat(g, feat), k, descending,
                 sortby)
