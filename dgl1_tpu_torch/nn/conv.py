"""Graph convolution modules (the port's ``dgl1_tpu/nn/conv.py``):
``GraphConv``, ``EdgeWeightNorm``, ``GATConv``, ``SAGEConv`` and
``RelGraphConv``."""

from __future__ import annotations

from typing import Callable, Optional

import math

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.ops import gspmm, gsddmm
from dgl1_tpu_torch.ops.attention import can_fuse_attention, gat_attention
from dgl1_tpu_torch.ops.battention import bdense_gat_attention
from dgl1_tpu_torch.ops.edge_softmax import edge_softmax
from dgl1_tpu_torch.ops.engine_xla import gather_rows, take_fill
from dgl1_tpu_torch.ops.segment import gather_mm, segment_mm

__all__ = ["GraphConv", "EdgeWeightNorm", "GATConv", "SAGEConv",
           "RelGraphConv"]


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
    normalisation. ``edge_weight`` (E,), a scalar per edge, turns the
    aggregation into ``u_mul_e`` (the reference's weighted GCN and the
    GNNExplainer mask contract). ``feat`` may be a ``(src, dst)`` pair, as
    ``HeteroGraphConv`` passes on a bipartite relation: the source side is
    aggregated and each normalisation reads its own side's degrees.
    Parameters: ``weight.weight`` (out, in)
    and ``bias`` (out,); :func:`dgl1_tpu_torch.params.from_jax_params`
    maps the reference's flax parameters onto them."""

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

    def forward(self, g: Graph, feat, edge_weight=None):
        power = -0.5 if self.norm == "both" else -1.0
        # A (src, dst) pair (a block's two sides): only the source side
        # is aggregated.
        feat_src = feat[0] if isinstance(feat, (tuple, list)) else feat
        if self.norm in ("both", "left"):
            norm = self._deg_norm(g.out_degrees(), feat_src.dtype, power)
            feat_src = feat_src * norm[: feat_src.shape[0], None]

        def agg(x):
            if edge_weight is None:
                return gspmm(g, "copy_lhs", "sum", x, None)
            ew = edge_weight.reshape((-1,) + (1,) * (x.dim() - 1))
            return gspmm(g, "mul", "sum", x, ew)

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


class EdgeWeightNorm:
    """Normalise scalar edge weights for the weighted GCN (the reference's
    ``EdgeWeightNorm``, a plain callable without parameters):

    ``'both'``: ``c_ij = w_ij / sqrt(out_w(i) * in_w(j))``;
    ``'right'``: ``c_ij = w_ij / in_w(j)``,

    with ``in_w``/``out_w`` the weighted in/out degrees plus ``eps``
    (``copy_rhs`` sums over the graph and its reverse). Under ``'both'``
    a real edge weight <= 0 raises ValueError, as the reference does on
    concrete weights (one host read of the weights). Padded edges get 0."""

    def __init__(self, norm: str = "both", eps: float = 0.0):
        if norm not in ("both", "right"):
            raise ValueError(f"invalid norm {norm!r}")
        self.norm, self.eps = norm, eps

    def __call__(self, g: Graph, edge_weight):
        w = edge_weight
        if self.norm == "both" and bool((w[: g.num_edges()] <= 0).any()):
            raise ValueError("EdgeWeightNorm: non-positive edge weights are "
                             "not allowed with norm='both'")
        in_w = gspmm(g, "copy_rhs", "sum", None, w) + self.eps
        src, dst = g.edges()
        if self.norm == "right":
            out = w / gather_rows(torch.where(in_w > 0, in_w,
                                              torch.ones_like(in_w)), dst)
        else:
            out_w = gspmm(g.reverse(copy_edata=False), "copy_rhs", "sum",
                          None, w) + self.eps
            prod = gather_rows(out_w, src) * gather_rows(in_w, dst)
            out = w / torch.sqrt(torch.where(prod > 0, prod,
                                             torch.ones_like(prod)))
        if g.edge_mask is None:
            return out
        return torch.where(g.edge_mask, out, torch.zeros_like(out))


class GATConv(nn.Module):
    """Graph attention layer: ``fc`` -> per-edge ``leaky_relu(el_u + er_v)``
    -> edge softmax -> weighted sum, multi-head. Returns (num_dst, H, F).

    The path is chosen as the reference chooses it: the fused hub
    attention (:func:`dgl1_tpu_torch.ops.gat_attention`) when the graph
    has a hub layout and a head is at most ``MAX_HEAD_DIM`` (384)
    features wide (the port's kernels stage a head's features in one
    shared-memory stripe; the reference takes any width); else, when the graph has a block-dense layout and
    no attention dropout applies (``attn_drop`` 0 or not training), the
    block-dense attention (:func:`dgl1_tpu_torch.ops.bdense_gat_attention`);
    else the composed g-SDDMM -> edge_softmax -> u_mul_e chain.

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
        if can_fuse_attention(g, f):
            seed = None
            if attn_drop > 0.0:
                seed = torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                    generator=generator,
                    device=(generator.device if generator is not None
                            else "cpu"))
            rst = gat_attention(g, el, er, feat_src, self.negative_slope,
                                attn_drop, seed)
        if rst is None and attn_drop == 0.0:
            rst = bdense_gat_attention(g, el, er, feat_src,
                                       self.negative_slope)
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
    """GraphSAGE layer with the ``mean``, ``gcn``, ``pool`` and ``lstm``
    aggregators (the reference's ``SAGEConv``).

    ``mean``: ``fc_self(h_dst) + fc_neigh(mean of h_src over in-edges)``;
    ``gcn``: ``fc_neigh((sum + h_dst) / (in_degree + 1))``; ``pool``:
    ``fc_self(h_dst) + fc_neigh(max of relu(fc_pool(h_src)))``; ``lstm``:
    ``fc_self(h_dst) + fc_neigh(last output of an LSTM over the
    in-neighbors)``, the LSTM run over each bucket of the ELL layout
    (``g.ell_dst``) as one batch of sequences in slot order, each row's
    output taken at its degree (a row of degree 0 reads one zero input,
    as the reference's ``seq_lengths`` of 1 does). ``lstm`` is a
    ``torch.nn.LSTM`` of width ``in_feats`` whose ``bias_ih_l0`` is held
    at zero (flax's ``OptimizedLSTMCell`` has one bias a gate, on the
    hidden side). The bias is
    a parameter of its own; ``norm``, a callable, is applied last, after
    the activation, as in the reference. On a block, ``h_dst`` is the first
    ``num_dst_nodes`` rows of ``h_src`` (dst nodes come first on the src
    side). Parameters ``fc_self.weight``, ``fc_neigh.weight`` (out, in),
    ``fc_pool.weight`` (in, in) with ``fc_pool.bias``, ``lstm.*`` and
    ``bias`` (out,): :func:`dgl1_tpu_torch.params.from_jax_params` maps
    the reference's flax tree onto them. Feature dropout draws from the
    ``generator`` passed to :meth:`forward`, only while training."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator_type: str = "mean", feat_drop: float = 0.0,
                 bias: bool = True, norm: Optional[Callable] = None,
                 activation: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator_type not in ("mean", "gcn", "pool", "lstm"):
            raise ValueError(f"invalid aggregator {aggregator_type!r}")
        dev = resolve_device(device)
        self.aggregator_type = aggregator_type
        self.feat_drop = feat_drop
        self.norm = norm
        self.activation = activation
        self.fc_pool = (nn.Linear(in_feats, in_feats, device=dev)
                        if aggregator_type == "pool" else None)
        self.lstm = (nn.LSTM(in_feats, in_feats, batch_first=True,
                             device=dev)
                     if aggregator_type == "lstm" else None)
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
            if self.lstm is not None:
                # Per gate: input kernels normal of std 1/sqrt(in),
                # orthogonal hidden kernels, zero biases (the scales of
                # flax's OptimizedLSTMCell).
                f = self.lstm.hidden_size
                for g in range(4):
                    rows = slice(g * f, (g + 1) * f)
                    self.lstm.weight_ih_l0[rows].copy_(_init_on(
                        (f, f), generator, lambda t: nn.init.normal_(
                            t, 0.0, 1.0 / math.sqrt(f),
                            generator=generator)))
                    self.lstm.weight_hh_l0[rows].copy_(_init_on(
                        (f, f), generator, lambda t: nn.init.orthogonal_(
                            t, generator=generator)))
                self.lstm.bias_ih_l0.zero_()
                self.lstm.bias_hh_l0.zero_()
        if self.lstm is not None:
            self.lstm.bias_ih_l0.requires_grad_(False)

    def _lstm_neigh(self, g: Graph, h_src):
        """The last LSTM output of each row's in-neighbors, bucket by
        bucket of ``g.ell_dst`` (slots at or above 2^29 are padding)."""
        if g.ell_dst is None:
            raise ValueError("lstm aggregator requires ELL layout")
        idx = g.ell_dst["idx"].long()
        outs = []
        off = 0
        for k, n_b in g.ell_dst_meta:
            if n_b == 0:
                continue
            sl = idx[off:off + n_b * k]
            valid = (sl < (1 << 29)).reshape(n_b, k)
            seq = h_src.index_select(0, sl.clamp(0, h_src.shape[0] - 1))
            seq = torch.where(valid[..., None], seq.reshape(n_b, k, -1),
                              torch.zeros((), dtype=h_src.dtype,
                                          device=h_src.device))
            lengths = valid.sum(dim=1).clamp(min=1)
            ys, _ = self.lstm(seq)
            outs.append(ys[torch.arange(n_b, device=ys.device), lengths - 1])
            off += n_b * k
        stacked = (torch.cat(outs, dim=0) if outs
                   else h_src.new_zeros((0, h_src.shape[-1])))
        inv = g.ell_dst["inv_perm"]
        return stacked if inv.shape[0] == 0 else take_fill(stacked, inv)

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
        elif agg == "pool":
            h_pool = torch.relu(self.fc_pool(h_src))
            h_neigh = self.fc_neigh(gspmm(g, "copy_lhs", "max", h_pool, None))
        else:
            h_neigh = self.fc_neigh(self._lstm_neigh(g, h_src))
        rst = h_neigh if agg == "gcn" else self.fc_self(h_dst) + h_neigh
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        if self.norm is not None:
            rst = self.norm(rst)
        return rst


def _uniform_(t, bound, generator):
    return nn.init.uniform_(t, -bound, bound, generator=generator)


def _xavier_uniform(shape, generator):
    """flax's ``xavier_uniform`` on ``shape``: fans over the last two axes
    times the leading (batch) axes, drawn on the generator's device."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    bound = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
    return _init_on(shape, generator,
                    lambda t: _uniform_(t, bound, generator))


class RelGraphConv(nn.Module):
    """Relational GCN layer (the reference's ``RelGraphConv``): messages
    ``h[src] @ W[etype]``, with ``W`` per relation or from ``num_bases``
    bases (``regularizer='basis'``: ``W = einsum('rb,bio->rio', coeff,
    basis)``), summed per destination, plus ``h_dst @ loop_weight``, the
    bias, the activation and dropout.

    Paths, as the reference takes them:

    * ``rel_graphs=`` (``transform.typed_subgraphs``): per relation one
      projection and one ``copy_lhs`` g-SpMM, projecting first when
      ``out <= in``; ``norm`` must then be per destination (num_dst, 1);
    * otherwise the per-edge path: ``gsddmm copy_lhs`` gathers
      ``h[src]``, ``segment_mm`` (``presorted``: edges sorted by relation,
      ``etype_counts`` per relation) or ``gather_mm`` (``etypes``)
      projects, ``norm`` (E, 1) scales, ``gspmm copy_rhs`` sums.

    * ``union_graph=`` (``transform.typed_union_graph``): ``z =
      einsum('nf,rfo->rno', h, W)`` reshaped to (R*N, out), one
      ``copy_lhs`` g-SpMM over the relation-stacked block, times
      ``norm`` (num_dst, 1).

    Parameters keep the reference's layout so
    :func:`dgl1_tpu_torch.params.from_jax_params` maps them unchanged:
    ``weight`` (R, in, out) or ``basis`` (B, in, out) and ``coeff`` (R,
    B), ``loop_weight`` (in, out), ``h_bias`` (out,). Dropout draws from
    the ``generator`` passed to :meth:`forward`, only while training."""

    def __init__(self, in_feats: int, out_feats: int, num_rels: int,
                 regularizer: Optional[str] = None, num_bases: int = 0,
                 bias: bool = True, activation: Optional[Callable] = None,
                 self_loop: bool = True, dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if regularizer not in (None, "basis"):
            raise ValueError(f"unsupported regularizer {regularizer!r}")
        dev = resolve_device(device)
        self.in_feats, self.out_feats = in_feats, out_feats
        self.num_rels, self.regularizer = num_rels, regularizer
        self.activation, self.dropout = activation, dropout

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=dev))

        if regularizer == "basis":
            self.basis = param(num_bases, in_feats, out_feats)
            self.coeff = param(num_rels, num_bases)
        else:
            self.weight = param(num_rels, in_feats, out_feats)
        self.loop_weight = param(in_feats, out_feats) if self_loop else None
        self.h_bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                       if bias else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's xavier-uniform on every weight, zero bias; drawn on the
        generator's device and copied."""
        with torch.no_grad():
            for p in (getattr(self, "weight", None),
                      getattr(self, "basis", None),
                      getattr(self, "coeff", None), self.loop_weight):
                if p is not None:
                    p.copy_(_xavier_uniform(tuple(p.shape), generator))
            if self.h_bias is not None:
                self.h_bias.zero_()

    def _weights(self):
        """(R, in, out) per-relation weights."""
        if self.regularizer == "basis":
            return torch.einsum("rb,bio->rio", self.coeff, self.basis)
        return self.weight

    def forward(self, g: Graph, feat, etypes=None, norm=None, *,
                presorted: bool = False, etype_counts=None, rel_graphs=None,
                union_graph=None, generator=None):
        weight = self._weights()
        h_src = feat
        h_dst = feat[: g.num_dst_nodes()] if g.is_block else feat
        if union_graph is not None:
            if union_graph.num_src_nodes() != self.num_rels * h_src.shape[0]:
                raise ValueError(
                    f"union_graph has {union_graph.num_src_nodes()} source "
                    f"nodes, not num_rels * {h_src.shape[0]}")
            z = torch.einsum("nf,rfo->rno", h_src, weight).reshape(
                self.num_rels * h_src.shape[0], self.out_feats)
            rst = gspmm(union_graph, "copy_lhs", "sum", z, None)
            if norm is not None:
                rst = rst * norm
        elif rel_graphs is not None:
            rst = 0.0
            for r, gr in enumerate(rel_graphs):
                if self.out_feats <= self.in_feats:
                    # Project first: the g-SpMM moves the narrower tensor.
                    rst = rst + gspmm(gr, "copy_lhs", "sum",
                                      h_src @ weight[r], None)
                else:
                    rst = rst + gspmm(gr, "copy_lhs", "sum", h_src,
                                      None) @ weight[r]
            if norm is not None:
                rst = rst * norm
        else:
            h_edge = gsddmm(g, "copy_lhs", h_src, None, lhs_target="u")
            if presorted:
                if etype_counts is None:
                    raise ValueError("presorted=True requires etype_counts")
                msg = segment_mm(h_edge, weight, etype_counts)
            else:
                msg = gather_mm(h_edge, weight, etypes)
            if norm is not None:
                msg = msg * norm
            rst = gspmm(g, "copy_rhs", "sum", None, msg)
        if self.loop_weight is not None:
            rst = rst + h_dst @ self.loop_weight
        if self.h_bias is not None:
            rst = rst + self.h_bias
        if self.activation is not None:
            rst = self.activation(rst)
        if self.training and self.dropout > 0:
            rst = _dropout(rst, self.dropout, generator)
        return rst
