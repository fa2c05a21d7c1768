"""NN utilities (the port's ``dgl1_tpu/nn/utils.py``): ``Sequential``,
``WeightBasis``, ``JumpingKnowledge`` and ``LabelPropagation``."""

from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dgl1_tpu_torch.graph import resolve_device
from dgl1_tpu_torch.nn.conv import _reset_lstm, _xavier_uniform, dense
from dgl1_tpu_torch.ops import gspmm

__all__ = ["WeightBasis", "Sequential", "JumpingKnowledge",
           "LabelPropagation"]


def _takes_graph(layer) -> bool:
    """The reference's rule: a layer takes ``(graph, feat)`` when its call
    has ``*args`` or at least two positional parameters; a callable
    without a signature (a torch builtin) takes the features alone."""
    fn = layer.forward if isinstance(layer, nn.Module) else layer
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return (any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params)
            or sum(p.kind in positional for p in params) >= 2)


class Sequential(nn.Module):
    """Graph modules in a chain, ``(graph, feat)`` threaded through each;
    a layer that takes no graph (an activation, ``nn.Linear``) gets the
    features alone. The modules among ``layers`` are ``layers.{i}``, as
    flax names them ``layers_{i}``."""

    def __init__(self, layers: Sequence):
        super().__init__()
        self.calls = list(layers)
        self.layers = nn.ModuleDict({str(i): m for i, m in enumerate(layers)
                                     if isinstance(m, nn.Module)})

    def forward(self, g, feat):
        for layer in self.calls:
            feat = layer(g, feat) if _takes_graph(layer) else layer(feat)
        return feat


class WeightBasis(nn.Module):
    """``num_outputs`` weights of ``shape`` from ``num_bases`` shared bases
    (the R-GCN regulariser): ``w_comp @ weight``, parameters ``weight``
    (B, \\*shape) and ``w_comp`` (O, B)."""

    def __init__(self, shape: Tuple[int, ...], num_bases: int,
                 num_outputs: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.shape, self.num_bases, self.num_outputs = (tuple(shape),
                                                        num_bases,
                                                        num_outputs)
        self.weight = nn.Parameter(_xavier_uniform(
            (num_bases,) + self.shape, generator).to(dev))
        self.w_comp = nn.Parameter(_xavier_uniform(
            (num_outputs, num_bases), generator).to(dev))

    def forward(self):
        flat = self.weight.reshape(self.num_bases, -1)
        return (self.w_comp @ flat).reshape((self.num_outputs,) + self.shape)


class JumpingKnowledge(nn.Module):
    """Per-layer node representations combined: ``'cat'``, ``'max'`` or
    ``'lstm'`` (a bidirectional LSTM over the layer axis scores each layer
    through ``att``, the layers summed with the softmax of the scores).
    ``lstm_cells`` are the two directions, ``torch.nn.LSTM``s of width
    ``in_feats`` (``bias_ih_l0`` held at zero), flax's
    ``OptimizedLSTMCell_0`` / ``_1``."""

    def __init__(self, mode: str = "cat", in_feats: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("cat", "max", "lstm"):
            raise ValueError(f"unknown mode {mode!r}")
        dev = resolve_device(device)
        self.mode = mode
        if mode == "lstm":
            if in_feats is None:
                raise ValueError("mode 'lstm' needs in_feats")
            self.lstm_cells = nn.ModuleList(
                nn.LSTM(in_feats, in_feats, batch_first=True, device=dev)
                for _ in range(2))
            for cell in self.lstm_cells:
                _reset_lstm(cell, generator)
            self.att = dense(2 * in_feats, 1, True, dev, generator)

    def forward(self, feat_list):
        if self.mode == "cat":
            return torch.cat(list(feat_list), dim=-1)
        if self.mode == "max":
            return torch.stack(list(feat_list), dim=0).max(dim=0).values
        seq = torch.stack(list(feat_list), dim=1)
        fwd, _ = self.lstm_cells[0](seq)
        bwd, _ = self.lstm_cells[1](seq.flip(1))
        alpha = self.att(torch.cat([fwd, bwd.flip(1)], dim=-1))[..., 0]
        return torch.einsum("nl,nlf->nf", torch.softmax(alpha, dim=-1), seq)


class LabelPropagation(nn.Module):
    """Label propagation, no parameters: ``k`` rounds of ``Y = alpha *
    norm(A) Y + (1 - alpha) Y`` (``'sym'``: ``D_in^-1/2 A D_out^-1/2``,
    ``'rw'``: ``D_in^-1 A``; degrees clamped at 1; a ``copy_lhs`` sum
    g-SpMM), clamped to [0, 1], the rows of ``mask`` reset to their known
    labels each round. Integer labels become one-hot rows."""

    def __init__(self, k: int = 3, alpha: float = 0.9,
                 norm_type: str = "sym", clamp: bool = True,
                 reset: bool = True):
        super().__init__()
        self.k, self.alpha, self.norm_type = k, alpha, norm_type
        self.clamp, self.reset = clamp, reset

    def forward(self, g, labels, mask=None):
        y = labels.to(torch.float32)
        if y.dim() == 1:
            num = int(labels.max()) + 1
            y = torch.eye(num, dtype=torch.float32,
                          device=labels.device)[labels.long()]
        if mask is not None:
            y = torch.where(mask[:, None], y, torch.zeros_like(y))
        init = y
        deg_in = g.in_degrees().to(y.dtype).clamp_min(1.0)
        deg_out = g.out_degrees().to(y.dtype).clamp_min(1.0)
        for _ in range(self.k):
            h = y
            if self.norm_type == "sym":
                h = h * deg_out.pow(-0.5)[:, None]
            h = gspmm(g, "copy_lhs", "sum", h, None)
            h = (h * deg_in.pow(-0.5)[:, None] if self.norm_type == "sym"
                 else h / deg_in[:, None])
            y = self.alpha * h + (1.0 - self.alpha) * y
            if self.clamp:
                y = y.clamp(0.0, 1.0)
            if self.reset and mask is not None:
                y = torch.where(mask[:, None], init, y)
        return y
