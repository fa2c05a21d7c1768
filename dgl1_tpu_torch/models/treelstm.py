"""Tree-LSTM (Tai et al. 2015) on topological propagation (the port's
``dgl1_tpu/models/treelstm.py``).

Edges point child -> parent; the recurrence runs leaves to root through
:func:`dgl1_tpu_torch.core.prop_nodes_topo` (host-scheduled frontiers,
exact-width mailboxes) or, given a :func:`~dgl1_tpu_torch.core.
topo_schedule`, :func:`~dgl1_tpu_torch.core.prop_nodes_topo_compiled`
(zero-padded mailboxes, masked writes).

``ChildSumTreeLSTMCell``: h~ is the sum of the children's h, one forget
gate transform applied to each child. ``NAryTreeLSTMCell``: arity
``n_ary``, position-dependent U over the concatenated child states. As in
the reference, the reduce adds ``U_iou`` of the children to the stored
``W_iou x`` term (zero on interior nodes under the token mask).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import _dropout, _init_on, dense

__all__ = ["TreeLSTM", "ChildSumTreeLSTMCell", "NAryTreeLSTMCell"]


class _Cell(nn.Module):
    """A cell's parameters for ``k`` child slots: ``W_iou`` (x -> 3h),
    ``U_iou`` (k h -> 3h), ``b_iou`` (3h), ``U_f`` (k h -> k h, with
    bias)."""

    def __init__(self, x_size: int, h_size: int, k: int, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        dev = resolve_device(device)
        self.h_size = h_size
        self.W_iou = dense(x_size, 3 * h_size, bias=False, device=dev,
                           generator=generator)
        self.U_iou = dense(k * h_size, 3 * h_size, bias=False, device=dev,
                           generator=generator)
        self.b_iou = nn.Parameter(torch.zeros(3 * h_size, device=dev))
        self.U_f = dense(k * h_size, k * h_size, device=dev,
                         generator=generator)

    def message_func(self, edges):
        return {"h": edges.src["h"], "c": edges.src["c"]}

    def apply_node_func(self, nodes):
        iou = nodes.data["iou"] + self.b_iou
        i, o, u = torch.chunk(iou, 3, dim=-1)
        c = torch.sigmoid(i) * torch.tanh(u) + nodes.data["c"]
        return {"h": torch.sigmoid(o) * torch.tanh(c), "c": c}


class ChildSumTreeLSTMCell(_Cell):
    """One child slot (``U_iou`` and ``U_f`` of h), the forget gate
    applied to each child."""

    def __init__(self, x_size: int, h_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(x_size, h_size, 1, device, generator)

    def reduce_func(self, nodes):
        h = nodes.mailbox["h"]
        f = torch.sigmoid(self.U_f(h))
        c = (f * nodes.mailbox["c"]).sum(dim=1)
        return {"iou": nodes.data["iou"] + self.U_iou(h.sum(dim=1)), "c": c}


class NAryTreeLSTMCell(_Cell):
    """Arity ``n_ary``: ``U_iou`` (n_ary h -> 3h), ``U_f`` (n_ary h ->
    n_ary h); a node with fewer children has its missing slots zero, one
    with more raises."""

    def __init__(self, x_size: int, h_size: int, n_ary: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(x_size, h_size, n_ary, device, generator)
        self.n_ary = n_ary

    def reduce_func(self, nodes):
        h = nodes.mailbox["h"]
        n, d = h.shape[:2]
        if d > self.n_ary:
            raise ValueError(f"NAryTreeLSTMCell(n_ary={self.n_ary}) got a "
                             f"node with {d} children")
        h_cat = h.reshape(n, d * self.h_size)
        if d < self.n_ary:
            h_cat = torch.nn.functional.pad(
                h_cat, (0, (self.n_ary - d) * self.h_size))
        f = torch.sigmoid(self.U_f(h_cat)[:, : d * self.h_size])
        c = (f.reshape(n, d, self.h_size) * nodes.mailbox["c"]).sum(dim=1)
        return {"iou": nodes.data["iou"] + self.U_iou(h_cat), "c": c}


class TreeLSTM(nn.Module):
    """Sentiment-style tree classifier: embed the leaf tokens, run the
    Tree-LSTM leaves to root, classify every node's h (the reference SST
    example's ``TreeLSTM``). Parameters: ``embedding``, ``cell``
    (``W_iou``, ``U_iou``, ``b_iou``, ``U_f``) and ``cls``.

    Forward ``(g, tokens, token_mask, schedule=None, generator=None)``:
    ``tokens`` (N,) vocabulary ids (0 on interior nodes), ``token_mask``
    (N,) 1.0 on word nodes; ``schedule`` a ``topo_schedule(g)`` for the
    compiled level loop, else the eager frontier loop. Dropout masks come
    from ``generator``, and only while training."""

    def __init__(self, num_vocab: int, x_size: int, h_size: int,
                 num_classes: int, dropout: float = 0.0,
                 cell_type: str = "childsum", n_ary: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if cell_type == "childsum":
            self.cell = ChildSumTreeLSTMCell(x_size, h_size, dev, generator)
        elif cell_type == "nary":
            self.cell = NAryTreeLSTMCell(x_size, h_size, n_ary, dev,
                                         generator)
        else:
            raise ValueError(cell_type)
        self.h_size = h_size
        self.dropout = dropout
        # flax's ``Embed``: a normal of std 1/sqrt(x_size).
        self.embedding = nn.Embedding(num_vocab, x_size, device=dev)
        with torch.no_grad():
            self.embedding.weight.copy_(_init_on(
                self.embedding.weight.shape, generator,
                lambda w: nn.init.normal_(w, std=1.0 / math.sqrt(x_size),
                                          generator=generator)))
        self.cls = dense(h_size, num_classes, device=dev, generator=generator)

    def forward(self, g: Graph, tokens, token_mask, schedule=None,
                generator: Optional[torch.Generator] = None):
        from dgl1_tpu_torch import core

        cell = self.cell
        emb = self.embedding(tokens.long())
        if self.training and self.dropout > 0:
            emb = _dropout(emb, self.dropout, generator)
        n = g.num_dst_nodes()
        g.ndata["iou"] = cell.W_iou(emb) * token_mask[:, None]
        g.ndata["h"] = emb.new_zeros((n, self.h_size))
        g.ndata["c"] = emb.new_zeros((n, self.h_size))
        if schedule is not None:
            core.prop_nodes_topo_compiled(
                g, schedule, cell.message_func, cell.reduce_func,
                apply_node_func=cell.apply_node_func)
        else:
            core.prop_nodes_topo(g, cell.message_func, cell.reduce_func,
                                 apply_node_func=cell.apply_node_func)
        h = g.ndata.pop("h")
        g.ndata.pop("c", None)
        g.ndata.pop("iou", None)
        if self.training and self.dropout > 0:
            h = _dropout(h, self.dropout, generator)
        return self.cls(h)
