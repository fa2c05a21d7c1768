"""Graph-level readout modules (the port's ``dgl1_tpu/nn/glob.py``):
``SumPooling``, ``AvgPooling``, ``MaxPooling``, ``SortPooling``,
``GlobalAttentionPooling``, ``Set2Set``, ``SetTransformerEncoder`` /
``Decoder`` and ``WeightAndSum``.

Each runs over a batched graph with the per-graph segment lengths of
``batch.batch_num_nodes``: segment ops, no loop over the graphs. The set
transformer's attention is one (Nq, Nk) score matrix per head with the
pairs of different graphs masked, as in the reference. Parameters keep
the reference's names (``from_jax_params``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.batch import batch_num_nodes
from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import (_layer_norm, _reset_lstm,
                                    _xavier_uniform, dense)
from dgl1_tpu_torch.ops.segment import (segment_ids_from_lengths,
                                        segment_reduce, segment_softmax)

__all__ = ["SumPooling", "AvgPooling", "MaxPooling", "SortPooling",
           "GlobalAttentionPooling", "Set2Set", "WeightAndSum",
           "SetTransformerEncoder", "SetTransformerDecoder"]


def _readout(g: Graph, feat, op: str):
    return segment_reduce(batch_num_nodes(g), feat[: g.num_src_nodes()], op)


class SumPooling(nn.Module):
    def forward(self, g: Graph, feat):
        return _readout(g, feat, "sum")


class AvgPooling(nn.Module):
    def forward(self, g: Graph, feat):
        return _readout(g, feat, "mean")


class MaxPooling(nn.Module):
    def forward(self, g: Graph, feat):
        return _readout(g, feat, "max")


class SortPooling(nn.Module):
    """Each node's channels sorted ascending, then each graph's top ``k``
    nodes by the last (largest) channel, in descending order (equal keys
    in node order), zero rows past a graph's node count: (B, k * F)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, g: Graph, feat):
        seglen = batch_num_nodes(g)
        ids = segment_ids_from_lengths(seglen, feat.shape[0]).long()
        feat = torch.sort(feat, dim=-1).values
        by_key = torch.sort(-feat[:, -1], stable=True).indices
        order = by_key[torch.sort(ids[by_key], stable=True).indices]
        starts = (torch.cumsum(seglen, 0) - seglen).long()
        ar = torch.arange(self.k, device=feat.device)
        idx = (starts[:, None] + ar[None]).clamp(0, feat.shape[0] - 1)
        valid = ar[None] < seglen[:, None]
        rows = feat[order].index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (feat.shape[-1],))
        return torch.where(valid[..., None], rows,
                           torch.zeros_like(rows)).reshape(seglen.shape[0],
                                                           -1)


class GlobalAttentionPooling(nn.Module):
    """``sum over nodes of softmax(gate_nn(h)) * feat_nn(h)`` per graph
    (the softmax within each graph); ``feat_nn`` None keeps ``h``."""

    def __init__(self, gate_nn: nn.Module,
                 feat_nn: Optional[nn.Module] = None):
        super().__init__()
        self.gate_nn, self.feat_nn = gate_nn, feat_nn

    def forward(self, g: Graph, feat):
        seglen = batch_num_nodes(g)
        a = segment_softmax(seglen, self.gate_nn(feat))
        h = self.feat_nn(feat) if self.feat_nn is not None else feat
        return segment_reduce(seglen, a * h, "sum")


class Set2Set(nn.Module):
    """Set2Set (``n_iters`` rounds of an LSTM query attending over each
    graph's nodes): (B, 2 * input_dim). ``lstm`` is a ``torch.nn.LSTM`` of
    input ``2 * input_dim`` and width ``input_dim`` with ``bias_ih_l0``
    held at zero (flax's ``OptimizedLSTMCell``); ``n_layers`` is the
    reference's and, as there, one cell runs."""

    def __init__(self, input_dim: int, n_iters: int = 6, n_layers: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim, self.n_iters, self.n_layers = (input_dim, n_iters,
                                                       n_layers)
        self.lstm = nn.LSTM(2 * input_dim, input_dim, batch_first=True,
                            device=dev)
        _reset_lstm(self.lstm, generator)

    def forward(self, g: Graph, feat):
        seglen = batch_num_nodes(g)
        b, d = seglen.shape[0], self.input_dim
        ids = segment_ids_from_lengths(seglen, feat.shape[0]).long()
        state = (feat.new_zeros((1, b, d)), feat.new_zeros((1, b, d)))
        q_star = feat.new_zeros((b, 2 * d))
        for _ in range(self.n_iters):
            q, state = self.lstm(q_star[:, None], state)
            q = q[:, 0]
            e = (feat * q.index_select(0, ids)).sum(dim=-1, keepdim=True)
            a = segment_softmax(seglen, e)
            q_star = torch.cat([q, segment_reduce(seglen, a * feat, "sum")],
                               dim=-1)
        return q_star


def _masked_multihead_attention(q, k, v, q_ids, k_ids, num_heads):
    """Attention of ``q`` (Nq, d) over ``k``/``v`` (Nk, d) restricted to
    pairs of the same graph: one (H, Nq, Nk) score matrix, the other
    pairs at -1e30."""
    nq, d = q.shape
    dh = d // num_heads
    qh = q.reshape(nq, num_heads, dh)
    kh = k.reshape(k.shape[0], num_heads, dh)
    vh = v.reshape(v.shape[0], num_heads, dh)
    score = torch.einsum("qhd,khd->hqk", qh, kh) / math.sqrt(dh)
    mask = q_ids[:, None] == k_ids[None, :]
    score = torch.where(mask[None], score, torch.full_like(score, -1e30))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(score, dim=-1), vh)
    return out.reshape(nq, d)


class _MAB(nn.Module):
    """Multihead attention block: ``ln0(q + wo(MHA))`` then ``ln1(h +
    ff1(relu(ff0(h))))``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dev,
                 generator):
        super().__init__()
        self.num_heads = num_heads
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, dense(d_model, d_model, True, dev, generator))
        self.ln0 = _layer_norm(d_model, dev)
        self.ff0 = dense(d_model, d_ff, True, dev, generator)
        self.ff1 = dense(d_ff, d_model, True, dev, generator)
        self.ln1 = _layer_norm(d_model, dev)

    def forward(self, q, kv, q_ids, kv_ids):
        att = _masked_multihead_attention(self.wq(q), self.wk(kv),
                                          self.wv(kv), q_ids, kv_ids,
                                          self.num_heads)
        h = self.ln0(q + self.wo(att))
        return self.ln1(h + self.ff1(torch.relu(self.ff0(h))))


def _graph_ids(g: Graph, total: int):
    return segment_ids_from_lengths(batch_num_nodes(g), total)


def _repeat_ids(n_graphs: int, m: int, device):
    return torch.arange(n_graphs, dtype=torch.int32,
                        device=device).repeat_interleave(m)


class SetTransformerEncoder(nn.Module):
    """Set transformer encoder over each graph's node set: ``n_layers``
    blocks, ``'sab'`` (self-attention) or ``'isab'`` (through ``m``
    learned inducing points, ``inducing{i}``); a ``proj`` first when
    ``in_feats != d_model``. Returns (N, d_model)."""

    def __init__(self, in_feats: int, d_model: int, num_heads: int = 4,
                 d_ff: int = 256, n_layers: int = 1, block_type: str = "sab",
                 m: int = 16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block_type not in ("sab", "isab"):
            raise ValueError(f"unknown block_type {block_type!r}")
        dev = resolve_device(device)
        self.block_type, self.n_layers, self.m = block_type, n_layers, m
        self.proj = (dense(in_feats, d_model, True, dev, generator)
                     if in_feats != d_model else None)
        for i in range(n_layers):
            if block_type == "sab":
                setattr(self, f"sab{i}", _MAB(d_model, num_heads, d_ff, dev,
                                              generator))
                continue
            setattr(self, f"inducing{i}", nn.Parameter(
                _xavier_uniform((m, d_model), generator).to(dev)))
            for j in (0, 1):
                setattr(self, f"isab{i}_{j}", _MAB(d_model, num_heads, d_ff,
                                                   dev, generator))

    def forward(self, g: Graph, feat):
        n = g.num_src_nodes()
        x = feat[:n]
        if self.proj is not None:
            x = self.proj(x)
        ids = _graph_ids(g, n)
        b = batch_num_nodes(g).shape[0]
        for i in range(self.n_layers):
            if self.block_type == "sab":
                x = getattr(self, f"sab{i}")(x, x, ids, ids)
                continue
            ind = getattr(self, f"inducing{i}").repeat(b, 1)
            ind_ids = _repeat_ids(b, self.m, x.device)
            h = getattr(self, f"isab{i}_0")(ind, x, ind_ids, ids)
            x = getattr(self, f"isab{i}_1")(x, h, ids, ind_ids)
        return x


class SetTransformerDecoder(nn.Module):
    """Set transformer readout: ``pma_ff(relu(x))``, then ``k`` learned
    ``seeds`` a graph attending to its nodes (``pma``), ``n_layers``
    self-attention blocks over the seeds: (B, k * d_model)."""

    def __init__(self, in_feats: int, d_model: int, num_heads: int = 4,
                 d_ff: int = 256, n_layers: int = 1, k: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.n_layers, self.k, self.d_model = n_layers, k, d_model
        self.proj = (dense(in_feats, d_model, True, dev, generator)
                     if in_feats != d_model else None)
        self.pma_ff = dense(d_model, d_model, True, dev, generator)
        self.seeds = nn.Parameter(_xavier_uniform((k, d_model),
                                                  generator).to(dev))
        self.pma = _MAB(d_model, num_heads, d_ff, dev, generator)
        for i in range(n_layers):
            setattr(self, f"sab{i}", _MAB(d_model, num_heads, d_ff, dev,
                                          generator))

    def forward(self, g: Graph, feat):
        n = g.num_src_nodes()
        x = feat[:n]
        if self.proj is not None:
            x = self.proj(x)
        ids = _graph_ids(g, n)
        b = batch_num_nodes(g).shape[0]
        x = self.pma_ff(torch.relu(x))
        s_ids = _repeat_ids(b, self.k, x.device)
        s = self.pma(self.seeds.repeat(b, 1), x, s_ids, ids)
        for i in range(self.n_layers):
            s = getattr(self, f"sab{i}")(s, s, s_ids, s_ids)
        return s.reshape(b, self.k * self.d_model)


class WeightAndSum(nn.Module):
    """``sum over nodes of sigmoid(atom_weighting(h)) * h`` per graph."""

    def __init__(self, in_feats: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.atom_weighting = dense(in_feats, 1, True, resolve_device(device),
                                    generator)

    def forward(self, g: Graph, feat):
        w = torch.sigmoid(self.atom_weighting(feat))
        return segment_reduce(batch_num_nodes(g),
                              w * feat[: g.num_src_nodes()], "sum")
