"""Graph convolution modules (the port's ``dgl1_tpu/nn/conv.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.ops import gspmm, gsddmm
from dgl1_tpu_torch.ops.attention import can_fuse_attention, gat_attention
from dgl1_tpu_torch.ops.edge_softmax import edge_softmax

__all__ = ["GraphConv", "GATConv", "SAGEConv"]


def _dropout(x, p: float, generator):
    """Inverted dropout with a mask drawn from ``generator`` (the default
    generator when None)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _init_on(shape, generator, fill):
    """A tensor of ``shape`` drawn by ``fill`` on the generator's device
    (the CPU when None), so one seed gives the same values everywhere."""
    t = torch.empty(shape, device=(generator.device if generator is not None
                                   else "cpu"))
    fill(t)
    return t


class GraphConv(nn.Module):
    """GCN layer: ``out = act(D_in^-1/2 A D_out^-1/2 X W + b)`` for
    ``norm='both'`` (also ``'right'``, ``'left'``, ``'none'``).

    When ``in_feats > out_feats`` the features are projected before the
    aggregation, which then runs on the narrower width (the reference's
    mult-order rule). The bias is a parameter of its own, added after the
    normalisation. Parameters: ``weight.weight`` (out, in) and ``bias``
    (out,); :func:`dgl1_tpu_torch.params.from_jax_params` maps the
    reference's flax parameters onto them."""

    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 weight: bool = True, bias: bool = True,
                 activation: Optional[Callable] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in ("both", "right", "left", "none"):
            raise ValueError(f"invalid norm {norm!r}")
        dev = resolve_device(device)
        self.in_feats, self.out_feats, self.norm = in_feats, out_feats, norm
        self.weight = (nn.Linear(in_feats, out_feats, bias=False, device=dev)
                       if weight else None)
        self.bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                     if bias else None)
        self.activation = activation
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-uniform weight, zero bias. The weight is drawn on the
        generator's device (the CPU when None) and copied, so one seed
        gives the same weights on every device."""
        if self.weight is not None:
            with torch.no_grad():
                self.weight.weight.copy_(_init_on(
                    self.weight.weight.shape, generator,
                    lambda t: nn.init.xavier_uniform_(t,
                                                      generator=generator)))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @staticmethod
    def _deg_norm(deg, dtype, power):
        deg = deg.to(dtype)
        return torch.where(deg > 0, deg, torch.ones_like(deg)) ** power

    def forward(self, g: Graph, feat):
        power = -0.5 if self.norm == "both" else -1.0
        feat_src = feat
        if self.norm in ("both", "left"):
            norm = self._deg_norm(g.out_degrees(), feat.dtype, power)
            feat_src = feat * norm[: feat.shape[0], None]

        def agg(x):
            return gspmm(g, "copy_lhs", "sum", x, None)

        if self.weight is not None:
            if self.in_feats > self.out_feats:
                rst = agg(self.weight(feat_src))
            else:
                rst = self.weight(agg(feat_src))
        else:
            rst = agg(feat_src)

        if self.norm in ("both", "right"):
            rst = rst * self._deg_norm(g.in_degrees(), rst.dtype,
                                       power)[:, None]
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class GATConv(nn.Module):
    """Graph attention layer: ``fc`` -> per-edge ``leaky_relu(el_u + er_v)``
    -> edge softmax -> weighted sum, multi-head. Returns (num_dst, H, F).

    The path is chosen as the reference chooses it: the fused hub
    attention (:func:`dgl1_tpu_torch.ops.gat_attention`) when the graph
    has a hub layout, else the composed g-SDDMM -> edge_softmax -> u_mul_e
    chain. The reference's middle choice, block-dense attention, needs the
    block-dense layout, which is not ported yet (ROADMAP item 9); hub-free
    graphs take the composed chain.

    Parameters, named so :func:`dgl1_tpu_torch.params.from_jax_params`
    maps the reference's flax tree unchanged: ``fc.weight`` (H*F, in),
    ``attn_l`` and ``attn_r`` (1, H, F), ``bias`` (1, H, F) and, with
    ``residual``, ``res_fc.weight``. Feature dropout masks and the
    attention-dropout seed come from the ``generator`` passed to
    :meth:`forward`, and only while training."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None, bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        h, f = num_heads, out_feats
        self.num_heads, self.out_feats = h, f
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.fc = nn.Linear(in_feats, h * f, bias=False, device=dev)
        self.attn_l = nn.Parameter(torch.empty((1, h, f), device=dev))
        self.attn_r = nn.Parameter(torch.empty((1, h, f), device=dev))
        self.bias = (nn.Parameter(torch.zeros((1, h, f), device=dev))
                     if bias else None)
        self.res_fc = (nn.Linear(in_feats, h * f, bias=False, device=dev)
                       if residual else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-normal fc (gain sqrt 2, as the reference GATConv of DGL)
        and attention vectors (fan over heads and features, as flax's
        xavier_normal on (1, H, F)); zero bias."""
        gain = nn.init.calculate_gain("relu")
        h, f = self.num_heads, self.out_feats
        std = (2.0 / (h + f)) ** 0.5
        with torch.no_grad():
            for lin in (self.fc, self.res_fc):
                if lin is not None:
                    lin.weight.copy_(_init_on(
                        lin.weight.shape, generator,
                        lambda t: nn.init.xavier_normal_(
                            t, gain=gain, generator=generator)))
            for p in (self.attn_l, self.attn_r):
                p.copy_(_init_on(p.shape, generator,
                                 lambda t: nn.init.normal_(
                                     t, std=std, generator=generator)))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, g: Graph, feat, generator=None):
        h, f = self.num_heads, self.out_feats
        drop_f = self.training and self.feat_drop > 0
        h_src = _dropout(feat, self.feat_drop, generator) if drop_f else feat
        feat_src = self.fc(h_src).reshape(-1, h, f)
        el = (feat_src * self.attn_l).sum(dim=-1, keepdim=True)
        er = (feat_src * self.attn_r).sum(dim=-1, keepdim=True)
        attn_drop = self.attn_drop if self.training else 0.0

        rst = None
        if can_fuse_attention(g):
            seed = None
            if attn_drop > 0.0:
                seed = torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                    generator=generator,
                    device=(generator.device if generator is not None
                            else "cpu"))
            rst = gat_attention(g, el, er, feat_src, self.negative_slope,
                                attn_drop, seed)
        if rst is None:
            e = gsddmm(g, "add", el, er, lhs_target="u", rhs_target="v")
            e = torch.nn.functional.leaky_relu(e, self.negative_slope)
            a = edge_softmax(g, e)
            if attn_drop > 0.0:
                a = _dropout(a, attn_drop, generator)
            rst = gspmm(g, "mul", "sum", feat_src, a)

        if self.res_fc is not None:
            h_dst = (_dropout(feat, self.feat_drop, generator) if drop_f
                     else feat)
            rst = rst + self.res_fc(h_dst).reshape(-1, h, f)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class SAGEConv(nn.Module):
    """GraphSAGE layer with the ``mean``, ``gcn`` and ``pool``
    aggregators (the reference's ``SAGEConv``; ``lstm`` is not ported
    yet and raises NotImplementedError).

    ``mean``: ``fc_self(h_dst) + fc_neigh(mean of h_src over in-edges)``;
    ``gcn``: ``fc_neigh((sum + h_dst) / (in_degree + 1))``; ``pool``:
    ``fc_self(h_dst) + fc_neigh(max of relu(fc_pool(h_src)))``. The bias is
    a parameter of its own. On a block, ``h_dst`` is the first
    ``num_dst_nodes`` rows of ``h_src`` (dst nodes come first on the src
    side). Parameters ``fc_self.weight``, ``fc_neigh.weight`` (out, in),
    ``fc_pool.weight`` (in, in) with ``fc_pool.bias``, and ``bias`` (out,):
    :func:`dgl1_tpu_torch.params.from_jax_params` maps the reference's
    flax tree onto them. Feature dropout draws from the ``generator``
    passed to :meth:`forward`, only while training."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator_type: str = "mean", feat_drop: float = 0.0,
                 bias: bool = True, activation: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator_type == "lstm":
            raise NotImplementedError(
                "the lstm aggregator is not ported yet")
        if aggregator_type not in ("mean", "gcn", "pool"):
            raise ValueError(f"invalid aggregator {aggregator_type!r}")
        dev = resolve_device(device)
        self.aggregator_type = aggregator_type
        self.feat_drop = feat_drop
        self.activation = activation
        self.fc_pool = (nn.Linear(in_feats, in_feats, device=dev)
                        if aggregator_type == "pool" else None)
        self.fc_self = (nn.Linear(in_feats, out_feats, bias=False, device=dev)
                        if aggregator_type != "gcn" else None)
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False, device=dev)
        self.bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                     if bias else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-uniform weights with the relu gain (as DGL's SAGEConv),
        zero biases; drawn on the generator's device and copied."""
        gain = nn.init.calculate_gain("relu")
        with torch.no_grad():
            for lin in (self.fc_pool, self.fc_self, self.fc_neigh):
                if lin is None:
                    continue
                lin.weight.copy_(_init_on(
                    lin.weight.shape, generator,
                    lambda t: nn.init.xavier_uniform_(t, gain=gain,
                                                      generator=generator)))
                if lin.bias is not None:
                    lin.bias.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, g: Graph, feat, generator=None):
        h_src = feat
        h_dst = h_src[: g.num_dst_nodes()] if g.is_block else h_src
        if self.training and self.feat_drop > 0:
            h_src = _dropout(h_src, self.feat_drop, generator)
            h_dst = _dropout(h_dst, self.feat_drop, generator)
        agg = self.aggregator_type
        if agg == "mean":
            h_neigh = self.fc_neigh(gspmm(g, "copy_lhs", "mean", h_src, None))
        elif agg == "gcn":
            s = gspmm(g, "copy_lhs", "sum", h_src, None)
            deg = g.in_degrees().to(h_src.dtype)[:, None]
            h_neigh = self.fc_neigh((s + h_dst) / (deg + 1.0))
        else:
            h_pool = torch.relu(self.fc_pool(h_src))
            h_neigh = self.fc_neigh(gspmm(g, "copy_lhs", "max", h_pool, None))
        rst = h_neigh if agg == "gcn" else self.fc_self(h_dst) + h_neigh
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst
