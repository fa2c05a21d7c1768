"""Graph convolution modules (the port's ``dgl1_tpu/nn/conv.py``), every
one of the reference's: ``GraphConv``, ``EdgeWeightNorm``, ``GATConv``,
``SAGEConv``, ``RelGraphConv``, and ``DotGatConv`` to ``HGTConv`` in the
reference's file order.

Each keeps the reference's engine calls: a ``gspmm``/``gsddmm``/
``edge_softmax`` there is the same call with the same op and reducer
here, so on a card it runs whichever hand kernel the graph's layouts
earn; the dense convs are plain matmuls on a dense adjacency, as the
reference's are. Parameters keep the reference's names (a flax ``Dense``
is an ``nn.Linear`` of the same name), so
:func:`dgl1_tpu_torch.params.from_jax_params` carries a flax tree onto
them; the port's own initial values are drawn from ``generator`` on its
device (the CPU when None)."""

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
from dgl1_tpu_torch.utils.profiler import span

__all__ = ["GraphConv", "EdgeWeightNorm", "GATConv", "SAGEConv",
           "RelGraphConv", "DotGatConv", "GINConv", "SGConv", "APPNPConv",
           "TAGConv", "ChebConv", "EdgeConv", "GatedGraphConv", "AGNNConv",
           "NNConv", "DenseGraphConv", "DenseSAGEConv", "GMMConv",
           "DenseChebConv", "CFConv", "AtomicConv", "GATv2Conv", "EGATConv",
           "EdgeGATConv", "GCN2Conv", "PNAConv", "HGTConv",
           "shifted_softplus", "dense", "FlaxGRUCell"]


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


def _lecun_normal(shape, generator):
    """flax's ``Dense`` kernel init (``lecun_normal``) on an (out, in)
    weight: a normal of std ``sqrt(1 / in) / 0.8796...`` truncated at two
    std, drawn on the generator's device."""
    std = math.sqrt(1.0 / shape[-1]) / 0.87962566103423978
    return _init_on(shape, generator, lambda t: nn.init.trunc_normal_(
        t, std=std, a=-2 * std, b=2 * std, generator=generator))


def dense(in_size: int, out_size: int, bias: bool = True, device=None,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` initialised as the reference's flax ``Dense``: the
    weight lecun normal (:func:`_lecun_normal`), drawn on the generator's
    device (the CPU when None) so one seed gives the same weights on every
    device, and a zero bias."""
    lin = nn.Linear(in_size, out_size, bias=bias, device=device)
    with torch.no_grad():
        lin.weight.copy_(_lecun_normal(lin.weight.shape, generator))
        if lin.bias is not None:
            lin.bias.zero_()
    return lin


def _reset_lstm(lstm, generator):
    """flax's OptimizedLSTMCell scheme, per gate: lecun normal input
    kernels (:func:`_lecun_normal`: std 1/sqrt(in), truncated at two
    std), orthogonal hidden kernels, zero biases; ``bias_ih_l0`` stays
    zero and frozen, since the flax cell has one bias a gate, on the
    hidden side."""
    f, n_in = lstm.hidden_size, lstm.input_size
    with torch.no_grad():
        for g in range(4):
            rows = slice(g * f, (g + 1) * f)
            lstm.weight_ih_l0[rows].copy_(_lecun_normal((f, n_in),
                                                        generator))
            lstm.weight_hh_l0[rows].copy_(_init_on(
                (f, f), generator, lambda t: nn.init.orthogonal_(
                    t, generator=generator)))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    lstm.bias_ih_l0.requires_grad_(False)


class FlaxGRUCell(nn.GRUCell):
    """flax's ``GRUCell`` as a ``torch.nn.GRUCell`` (its four tensors, so
    ``from_jax_params`` loads it): stepped through ``torch.gru_cell`` with
    the r and z parts of ``bias_hh`` held out (flax has a hidden bias on n
    only), so those stay as loaded: zero. Drawn as flax draws it, per gate
    (r, z, n): lecun normal input kernels (:func:`_lecun_normal`),
    orthogonal hidden kernels, zero biases. ``forward(x, h)``."""

    def __init__(self, in_feats: int, out_feats: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_feats, out_feats, device=device)
        f = out_feats
        with torch.no_grad():
            for g in range(3):
                rows = slice(g * f, (g + 1) * f)
                self.weight_ih[rows].copy_(_lecun_normal((f, in_feats),
                                                         generator))
                self.weight_hh[rows].copy_(_init_on(
                    (f, f), generator, lambda t: nn.init.orthogonal_(
                        t, generator=generator)))
            self.bias_ih.zero_()
            self.bias_hh.zero_()
        self.register_buffer("_hh_mask", torch.cat([
            torch.zeros(2 * f, device=device),
            torch.ones(f, device=device)]), persistent=False)

    def forward(self, x, h):
        return torch.gru_cell(x, h, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh * self._hh_mask)


def _layer_norm(f: int, device):
    """flax's ``LayerNorm`` (epsilon 1e-6) over the last axis."""
    return nn.LayerNorm(f, eps=1e-6, device=device)


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
        """The weight as the reference's flax ``Dense`` (lecun normal),
        zero bias. The weight is drawn on the generator's device (the CPU
        when None) and copied, so one seed gives the same weights on every
        device."""
        if self.weight is not None:
            with torch.no_grad():
                self.weight.weight.copy_(_lecun_normal(
                    self.weight.weight.shape, generator))
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
        """fc and res_fc as the reference's flax ``Dense`` (lecun normal),
        attention vectors as its ``xavier_normal`` on (1, H, F) (fan over
        heads and features); zero bias."""
        h, f = self.num_heads, self.out_feats
        std = (2.0 / (h + f)) ** 0.5
        with torch.no_grad():
            for lin in (self.fc, self.res_fc):
                if lin is not None:
                    lin.weight.copy_(_lecun_normal(lin.weight.shape,
                                                   generator))
            for p in (self.attn_l, self.attn_r):
                p.copy_(_init_on(p.shape, generator,
                                 lambda t: nn.init.normal_(
                                     t, std=std, generator=generator)))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, g: Graph, feat, generator=None):
        h, f = self.num_heads, self.out_feats
        drop_f = self.training and self.feat_drop > 0
        with span("gat.project"):
            h_src = (_dropout(feat, self.feat_drop, generator) if drop_f
                     else feat)
            feat_src = self.fc(h_src).reshape(-1, h, f)
            el = (feat_src * self.attn_l).sum(dim=-1, keepdim=True)
            er = (feat_src * self.attn_r).sum(dim=-1, keepdim=True)
        attn_drop = self.attn_drop if self.training else 0.0

        with span("gat.attention"):
            rst = None
            if can_fuse_attention(g, f):
                seed = None
                if attn_drop > 0.0:
                    seed = torch.randint(
                        -2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                        generator=generator,
                        device=(generator.device if generator is not None
                                else "cpu"))
                rst = gat_attention(g, el, er, feat_src,
                                    self.negative_slope, attn_drop, seed)
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
            with span("gat.residual"):
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
        """Weights as the reference's flax ``Dense`` layers (lecun
        normal), zero biases; drawn on the generator's device and
        copied."""
        with torch.no_grad():
            for lin in (self.fc_pool, self.fc_self, self.fc_neigh):
                if lin is None:
                    continue
                lin.weight.copy_(_lecun_normal(lin.weight.shape, generator))
                if lin.bias is not None:
                    lin.bias.zero_()
            if self.bias is not None:
                self.bias.zero_()
        if self.lstm is not None:
            _reset_lstm(self.lstm, generator)

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


# ----------------------------------------------------------------------
# The other convs, in the reference's file order
# ----------------------------------------------------------------------

def _split_feat(feat):
    """A single tensor, or a (src, dst) pair on a block."""
    if isinstance(feat, (tuple, list)):
        return feat[0], feat[1]
    return feat, feat


def _src_dst(g: Graph, feat):
    """(h_src, h_dst), with h_dst the first ``num_dst_nodes`` rows of a
    single tensor on a block (the reference's rule for most convs)."""
    h_src, h_dst = _split_feat(feat)
    if not isinstance(feat, (tuple, list)) and g.is_block:
        h_dst = h_src[: g.num_dst_nodes()]
    return h_src, h_dst


def _param(shape, dev, generator, fill):
    return nn.Parameter(_init_on(shape, generator, fill).to(dev))


def _xavier_normal_param(shape, dev, generator):
    """flax's ``xavier_normal`` on (1, H, F): fans H and F."""
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return _param(shape, dev, generator,
                  lambda t: nn.init.normal_(t, std=std, generator=generator))


def _scalar_param(value, dev):
    return nn.Parameter(torch.tensor(float(value), device=dev))


def _maybe_drop(x, p: float, training: bool, generator):
    return _dropout(x, p, generator) if training and p > 0 else x


class DotGatConv(nn.Module):
    """Dot-product attention (``dotgatconv.py``): a shared ``fc`` (no
    bias), logits ``u_dot_v / sqrt(F)``, edge softmax, ``u_mul_e`` sum.
    Returns (num_dst, H, F)."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_heads, self.out_feats = num_heads, out_feats
        self.fc = dense(in_feats, num_heads * out_feats, False, dev,
                        generator)

    def forward(self, g: Graph, feat):
        h_src, h_dst = _split_feat(feat)
        h, f = self.num_heads, self.out_feats
        feat_src = self.fc(h_src).reshape(-1, h, f)
        feat_dst = (feat_src[: g.num_dst_nodes()] if g.is_block
                    else self.fc(h_dst).reshape(-1, h, f))
        e = gsddmm(g, "dot", feat_src, feat_dst, lhs_target="u",
                   rhs_target="v")
        a = edge_softmax(g, e / math.sqrt(f))
        return gspmm(g, "mul", "sum", feat_src, a)


class GINConv(nn.Module):
    """Graph isomorphism layer (``ginconv.py``): ``apply_func((1 + eps) *
    h_dst + aggregate(h_src))`` with the ``sum``, ``max`` or ``mean``
    aggregate; ``eps`` a parameter with ``learn_eps``."""

    def __init__(self, apply_func: Optional[Callable] = None,
                 aggregator_type: str = "sum", init_eps: float = 0.0,
                 learn_eps: bool = False, device=None):
        super().__init__()
        if aggregator_type not in ("sum", "max", "mean"):
            raise ValueError(f"invalid aggregator {aggregator_type!r}")
        dev = resolve_device(device)
        self.apply_func = apply_func
        self.aggregator_type = aggregator_type
        self.init_eps = init_eps
        self.eps = _scalar_param(init_eps, dev) if learn_eps else None

    def forward(self, g: Graph, feat):
        h_src, h_dst = _src_dst(g, feat)
        agg = gspmm(g, "copy_lhs", self.aggregator_type, h_src, None)
        eps = self.eps if self.eps is not None else self.init_eps
        rst = (1.0 + eps) * h_dst + agg
        return self.apply_func(rst) if self.apply_func is not None else rst


def _gcn_norm_spmm(g: Graph, feat):
    """One symmetric-normalised propagation ``D_in^-1/2 A D_out^-1/2 X``
    (a ``copy_lhs`` sum g-SpMM)."""
    def norm(deg):
        deg = deg.to(feat.dtype)
        return torch.where(deg > 0, deg, torch.ones_like(deg)) ** -0.5

    x = feat * norm(g.out_degrees())[:, None]
    return gspmm(g, "copy_lhs", "sum", x, None) * norm(g.in_degrees())[:, None]


class SGConv(nn.Module):
    """Simplified GCN (``sgconv.py``): ``k`` propagations, then ``fc``."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 1,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.fc = dense(in_feats, out_feats, bias, resolve_device(device),
                        generator)

    def forward(self, g: Graph, feat):
        x = feat
        for _ in range(self.k):
            x = _gcn_norm_spmm(g, x)
        return self.fc(x)


class APPNPConv(nn.Module):
    """Personalised propagation (``appnpconv.py``): ``k`` steps of ``h =
    (1 - alpha) Ahat h + alpha h0``; no parameters. ``edge_drop`` is
    accepted for the reference's signature and unused there too."""

    def __init__(self, k: int = 10, alpha: float = 0.1,
                 edge_drop: float = 0.0, device=None):
        super().__init__()
        resolve_device(device)
        self.k, self.alpha, self.edge_drop = k, alpha, edge_drop

    def forward(self, g: Graph, feat):
        h = feat
        for _ in range(self.k):
            h = (1.0 - self.alpha) * _gcn_norm_spmm(g, h) + self.alpha * feat
        return h


class TAGConv(nn.Module):
    """Topology-adaptive GCN (``tagconv.py``): ``lin`` over the hops
    ``[X, Ahat X, ..., Ahat^k X]`` concatenated."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 2,
                 bias: bool = True, activation: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.activation = k, activation
        self.lin = dense(in_feats * (k + 1), out_feats, bias,
                         resolve_device(device), generator)

    def forward(self, g: Graph, feat):
        hops, x = [feat], feat
        for _ in range(self.k):
            x = _gcn_norm_spmm(g, x)
            hops.append(x)
        rst = self.lin(torch.cat(hops, dim=-1))
        return self.activation(rst) if self.activation is not None else rst


class ChebConv(nn.Module):
    """Chebyshev conv (``chebconv.py``): ``k`` terms ``T_0 = X``, ``T_1 =
    L_hat X``, ``T_i = 2 L_hat T_{i-1} - T_{i-2}`` of the scaled
    Laplacian ``L_hat = 2 / lambda_max (I - Ahat) - I``, then ``fc`` over
    them concatenated."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 2,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.fc = dense(in_feats * k, out_feats, bias, resolve_device(device),
                        generator)

    def forward(self, g: Graph, feat, lambda_max: float = 2.0):
        def l_hat(x):
            return (2.0 / lambda_max) * (x - _gcn_norm_spmm(g, x)) - x

        t_prev, t_cur = feat, l_hat(feat)
        terms = [t_prev] + ([t_cur] if self.k > 1 else [])
        for _ in range(2, self.k):
            t_next = 2.0 * l_hat(t_cur) - t_prev
            terms.append(t_next)
            t_prev, t_cur = t_cur, t_next
        return self.fc(torch.cat(terms, dim=-1))


class EdgeConv(nn.Module):
    """DGCNN's EdgeConv (``edgeconv.py``): ``max over in-edges of
    theta(h_u - h_v) + phi(h_v)``: ``u_sub_v``, then a ``copy_e`` max
    g-SpMM."""

    def __init__(self, in_feats: int, out_feats: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.theta = dense(in_feats, out_feats, True, dev, generator)
        self.phi = dense(in_feats, out_feats, True, dev, generator)

    def forward(self, g: Graph, feat):
        h_src, h_dst = _split_feat(feat)
        diff = gsddmm(g, "sub", h_src, h_dst, lhs_target="u", rhs_target="v")
        phi_e = gsddmm(g, "copy_lhs", self.phi(h_dst), None, lhs_target="v")
        return gspmm(g, "copy_rhs", "max", None, self.theta(diff) + phi_e)


class GatedGraphConv(nn.Module):
    """Gated graph conv (``gatedgraphconv.py``): the input zero-padded to
    ``out_feats``, then ``n_steps`` of ``h = GRU(h, sum over in-edges of
    h_u @ W[etype])`` (the per-edge ``copy_u``, a ``copy_e`` sum). ``gru``
    is a :class:`FlaxGRUCell`. ``weight`` (T, out, out)."""

    def __init__(self, in_feats: int, out_feats: int, n_steps: int = 1,
                 n_etypes: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if in_feats > out_feats:
            raise ValueError("GatedGraphConv needs in_feats <= out_feats")
        self.out_feats, self.n_steps, self.n_etypes = (out_feats, n_steps,
                                                      n_etypes)
        self.weight = nn.Parameter(_xavier_uniform(
            (n_etypes, out_feats, out_feats), generator).to(dev))
        self.gru = FlaxGRUCell(out_feats, out_feats, dev, generator)

    def forward(self, g: Graph, feat, etypes=None):
        if feat.shape[-1] < self.out_feats:
            feat = torch.nn.functional.pad(
                feat, (0, self.out_feats - feat.shape[-1]))
        h = feat
        for _ in range(self.n_steps):
            src_h = gsddmm(g, "copy_lhs", h, None, lhs_target="u")
            if self.n_etypes == 1 or etypes is None:
                msg = src_h @ self.weight[0]
            else:
                msg = gather_mm(src_h, self.weight, etypes)
            a = gspmm(g, "copy_rhs", "sum", None, msg)
            h = self.gru(a, h)
        return h


def _unit_rows(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


class AGNNConv(nn.Module):
    """Attention-based GNN (``agnnconv.py``): logits ``beta * cos(h_u,
    h_v)`` (``u_dot_v`` of unit rows), edge softmax, ``u_mul_e`` sum;
    ``beta`` a parameter with ``learn_beta``."""

    def __init__(self, init_beta: float = 1.0, learn_beta: bool = True,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.init_beta = init_beta
        self.beta = _scalar_param(init_beta, dev) if learn_beta else None

    def forward(self, g: Graph, feat):
        h_src, h_dst = _split_feat(feat)
        beta = self.beta if self.beta is not None else self.init_beta
        cos = gsddmm(g, "dot", _unit_rows(h_src), _unit_rows(h_dst),
                     lhs_target="u", rhs_target="v")
        return gspmm(g, "mul", "sum", h_src, edge_softmax(g, beta * cos))


class NNConv(nn.Module):
    """Edge-conditioned conv (``nnconv.py``): the message ``h_u @
    reshape(edge_func(e), (in, out))`` per edge, reduced by
    ``aggregator_type`` (a ``copy_e`` g-SpMM), plus ``res_fc(h_dst)`` and
    ``bias``."""

    def __init__(self, in_feats: int, out_feats: int, edge_func: Callable,
                 aggregator_type: str = "mean", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_feats, self.out_feats = in_feats, out_feats
        self.edge_func = edge_func
        self.aggregator_type = aggregator_type
        self.res_fc = dense(in_feats, out_feats, False, dev, generator)
        self.bias = nn.Parameter(torch.zeros(out_feats, device=dev))

    def forward(self, g: Graph, feat, efeat):
        h_src, h_dst = _split_feat(feat)
        w = self.edge_func(efeat).reshape(-1, self.in_feats, self.out_feats)
        src_h = gsddmm(g, "copy_lhs", h_src, None, lhs_target="u")
        msg = torch.einsum("ei,eio->eo", src_h, w)
        rst = gspmm(g, "copy_rhs", self.aggregator_type, None, msg)
        return rst + self.res_fc(h_dst) + self.bias


class DenseGraphConv(nn.Module):
    """GraphConv on a dense adjacency ``adj`` (N_dst, N_src)
    (``densegraphconv.py``): ``norm`` 'both' (degrees clamped at 1),
    'right' or 'none'."""

    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.norm = norm
        self.weight = dense(in_feats, out_feats, False, dev, generator)
        self.bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                     if bias else None)

    def forward(self, adj, feat):
        adj = adj.to(feat.dtype)
        if self.norm == "both":
            feat = feat * adj.sum(dim=0).clamp_min(1.0).pow(-0.5)[:, None]
        rst = adj @ self.weight(feat)
        if self.norm == "both":
            rst = rst * adj.sum(dim=1).clamp_min(1.0).pow(-0.5)[:, None]
        elif self.norm == "right":
            rst = rst / adj.sum(dim=1, keepdim=True).clamp_min(1.0)
        return rst + self.bias if self.bias is not None else rst


class DenseSAGEConv(nn.Module):
    """Mean SAGEConv on a dense adjacency (``densesageconv.py``): ``fc``
    over ``[h, mean of the neighbours]``; ``adj`` (N_dst, N_src), or a
    batch of them (B, N_dst, N_src) with ``feat`` (B, N_src, F)."""

    def __init__(self, in_feats: int, out_feats: int, bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = dense(2 * in_feats, out_feats, bias, resolve_device(device),
                        generator)

    def forward(self, adj, feat):
        adj = adj.to(feat.dtype)
        h_neigh = (adj @ feat) / adj.sum(dim=-1, keepdim=True).clamp_min(1.0)
        return self.fc(torch.cat([feat, h_neigh], dim=-1))


class GMMConv(nn.Module):
    """MoNet (``gmmconv.py``): per edge, K gaussian weights of the pseudo
    coordinates (``mu``, ``inv_sigma`` (K, dim)) mix the K projections
    ``fc(h_u)``; reduced by ``aggregator_type`` (a ``copy_e`` g-SpMM)."""

    def __init__(self, in_feats: int, out_feats: int, dim: int,
                 n_kernels: int, aggregator_type: str = "sum", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.out_feats, self.n_kernels = out_feats, n_kernels
        self.aggregator_type = aggregator_type
        self.mu = _param((n_kernels, dim), dev, generator,
                         lambda t: nn.init.normal_(t, std=0.1,
                                                   generator=generator))
        self.inv_sigma = nn.Parameter(torch.ones((n_kernels, dim),
                                                 device=dev))
        self.fc = dense(in_feats, n_kernels * out_feats, False, dev,
                        generator)

    def forward(self, g: Graph, feat, pseudo):
        h_src, _ = _split_feat(feat)
        diff = pseudo[:, None, :] - self.mu[None]
        w = torch.exp(-0.5 * ((diff * self.inv_sigma[None]) ** 2).sum(-1))
        proj = self.fc(h_src).reshape(-1, self.n_kernels, self.out_feats)
        src_e = gsddmm(g, "copy_lhs", proj, None, lhs_target="u")
        msg = (src_e * w[..., None]).sum(dim=1)
        return gspmm(g, "copy_rhs", self.aggregator_type, None, msg)


class DenseChebConv(nn.Module):
    """Chebyshev conv on a dense adjacency (``densechebconv.py``): ``k``
    terms of ``L_hat = 2 / lambda_max (I - D^-1/2 A D^-1/2) - I`` (row
    degrees clamped at 1), each through its own ``W_i``, plus ``bias``."""

    def __init__(self, in_feats: int, out_feats: int, k: int,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.k = k
        for i in range(k):
            setattr(self, f"W_{i}", dense(in_feats, out_feats, False, dev,
                                          generator))
        self.bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                     if bias else None)

    def forward(self, adj, feat, lambda_max: float = 2.0):
        adj = adj.to(feat.dtype)
        eye = torch.eye(adj.shape[0], dtype=feat.dtype, device=feat.device)
        deg = adj.sum(dim=1).clamp_min(1.0).pow(-0.5)
        lap_hat = (2.0 / lambda_max) * (eye - deg[:, None] * adj
                                        * deg[None, :]) - eye
        t_prev, t_cur = feat, None
        out = self.W_0(t_prev)
        if self.k > 1:
            t_cur = lap_hat @ feat
            out = out + self.W_1(t_cur)
        for i in range(2, self.k):
            t_next = 2.0 * (lap_hat @ t_cur) - t_prev
            out = out + getattr(self, f"W_{i}")(t_next)
            t_prev, t_cur = t_cur, t_next
        return out + self.bias if self.bias is not None else out


def shifted_softplus(x):
    """SchNet's ``ln(1 + e^x) - ln 2``."""
    return torch.nn.functional.softplus(x) - math.log(2.0)


class CFConv(nn.Module):
    """SchNet's continuous-filter conv (``cfconv.py``): a filter network
    over the edge features (``filter_1``, ``filter_2`` with shifted
    softplus) weights ``project_node(h_u)`` (a ``u_mul_e`` sum), then
    ``project_out1`` and shifted softplus."""

    def __init__(self, node_in_feats: int, edge_in_feats: int,
                 hidden_feats: int, out_feats: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.project_node = dense(node_in_feats, hidden_feats, False, dev,
                                  generator)
        self.filter_1 = dense(edge_in_feats, hidden_feats, True, dev,
                              generator)
        self.filter_2 = dense(hidden_feats, hidden_feats, True, dev,
                              generator)
        self.project_out1 = dense(hidden_feats, out_feats, True, dev,
                                  generator)

    def forward(self, g: Graph, node_feat, edge_feat):
        h_src, _ = _split_feat(node_feat)
        w = shifted_softplus(self.filter_2(shifted_softplus(
            self.filter_1(edge_feat))))
        rst = gspmm(g, "mul", "sum", self.project_node(h_src), w)
        return shifted_softplus(self.project_out1(rst))


class AtomicConv(nn.Module):
    """Atomic convolution of ACNN (``atomicconv.py``): K radial filters of
    each edge's distance (gaussian ``exp(-beta (d - mu)^2)`` times a
    cosine cutoff), summed per destination and source atom type (one
    ``u_mul_e`` sum of the (N, T, 1) one-hot types by the (E, 1, K)
    filters): (N, T * K). No parameters."""

    def __init__(self, interaction_cutoffs, rbf_kernel_means,
                 rbf_kernel_scaling, features_to_use=(1.0,), device=None):
        super().__init__()
        dev = resolve_device(device)
        for name, v in (("cut", interaction_cutoffs),
                        ("mu", rbf_kernel_means),
                        ("beta", rbf_kernel_scaling),
                        ("types", features_to_use)):
            self.register_buffer(name, torch.tensor(
                [float(x) for x in v], device=dev), persistent=False)

    def forward(self, g: Graph, feat, distances):
        d = distances.reshape(-1, 1)
        rbf = torch.exp(-self.beta[None] * (d - self.mu[None]) ** 2)
        inside = (d <= self.cut[None]).to(rbf.dtype)
        env = 0.5 * (torch.cos(math.pi * d / self.cut[None].clamp_min(1e-6))
                     + 1.0)
        e_feat = rbf * env * inside
        z = _split_feat(feat)[0].reshape(-1, 1)
        onehot = ((z - self.types[None]).abs() < 1e-6).to(e_feat.dtype)
        ue = gspmm(g, "mul", "sum", onehot[:, :, None], e_feat[:, None, :])
        return ue.reshape(-1, onehot.shape[1] * e_feat.shape[1])


class GATv2Conv(nn.Module):
    """GATv2 (``gatv2conv.py``): logits ``attn . leaky_relu(fc_src h_u +
    fc_dst h_v)`` (``u_add_v`` on (E, H, F)), edge softmax, ``u_mul_e``
    sum of ``fc_src h_u``, the residual ``res_fc``. Returns (num_dst, H,
    F). Dropout draws from the ``generator`` passed to :meth:`forward`,
    only while training."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 1,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 share_weights: bool = False, bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        h, f = num_heads, out_feats
        self.num_heads, self.out_feats = h, f
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope, self.activation = negative_slope, activation
        self.fc_src = dense(in_feats, h * f, bias, dev, generator)
        self.fc_dst = (None if share_weights
                       else dense(in_feats, h * f, bias, dev, generator))
        self.attn = _xavier_normal_param((1, h, f), dev, generator)
        self.res_fc = (dense(in_feats, h * f, False, dev, generator)
                       if residual else None)

    def forward(self, g: Graph, feat, generator=None):
        h_src, h_dst = _src_dst(g, feat)
        h_src = _maybe_drop(h_src, self.feat_drop, self.training, generator)
        h_dst = _maybe_drop(h_dst, self.feat_drop, self.training, generator)
        h, f = self.num_heads, self.out_feats
        feat_src = self.fc_src(h_src).reshape(-1, h, f)
        if self.fc_dst is None:
            feat_dst = (feat_src[: g.num_dst_nodes()] if g.is_block
                        else feat_src)
        else:
            feat_dst = self.fc_dst(h_dst).reshape(-1, h, f)
        eij = gsddmm(g, "add", feat_src, feat_dst, lhs_target="u",
                     rhs_target="v")
        eij = torch.nn.functional.leaky_relu(eij, self.negative_slope)
        a = edge_softmax(g, (eij * self.attn).sum(dim=-1, keepdim=True))
        a = _maybe_drop(a, self.attn_drop, self.training, generator)
        rst = gspmm(g, "mul", "sum", feat_src, a)
        if self.res_fc is not None:
            rst = rst + self.res_fc(h_dst).reshape(-1, h, f)
        return self.activation(rst) if self.activation is not None else rst


class EGATConv(nn.Module):
    """GAT with edge features (``egatconv.py``): ``f_ij = leaky_relu(
    fc_ni h_i + fc_nj h_j + fc_fij f_ij)`` is the new edge feature and,
    dotted with ``attn``, the logit; returns ``(u_mul_e sum of fc_node
    h_u, f_ij)``: (num_dst, H, Fn) and (E, H, Fe)."""

    def __init__(self, in_node_feats: int, in_edge_feats: int,
                 out_node_feats: int, out_edge_feats: int,
                 num_heads: int = 1, bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        h, fn_, fe = num_heads, out_node_feats, out_edge_feats
        self.num_heads, self.out_node_feats, self.out_edge_feats = h, fn_, fe
        self.fc_ni = dense(in_node_feats, h * fe, bias, dev, generator)
        self.fc_nj = dense(in_node_feats, h * fe, bias, dev, generator)
        self.fc_fij = dense(in_edge_feats, h * fe, bias, dev, generator)
        self.attn = _xavier_normal_param((1, h, fe), dev, generator)
        self.fc_node = dense(in_node_feats, h * fn_, bias, dev, generator)

    def forward(self, g: Graph, feat, efeat):
        h_src, h_dst = _src_dst(g, feat)
        h, fn_, fe = self.num_heads, self.out_node_feats, self.out_edge_feats
        f_tmp = gsddmm(g, "add", self.fc_ni(h_src).reshape(-1, h, fe),
                       self.fc_nj(h_dst).reshape(-1, h, fe),
                       lhs_target="u", rhs_target="v")
        f_out = torch.nn.functional.leaky_relu(
            f_tmp + self.fc_fij(efeat).reshape(-1, h, fe), 0.2)
        a = edge_softmax(g, (f_out * self.attn).sum(dim=-1, keepdim=True))
        feat_src = self.fc_node(h_src).reshape(-1, h, fn_)
        return gspmm(g, "mul", "sum", feat_src, a), f_out


class EdgeGATConv(nn.Module):
    """GAT whose logits and messages take edge features
    (``edgegatconv.py``): logits ``leaky_relu(el_u + er_v + ee)``, edge
    softmax, messages ``(fc h_u + fc_edge e) * a`` summed (a ``copy_e``
    g-SpMM), the residual ``res_fc`` and ``bias`` (1, H, F)."""

    def __init__(self, in_feats: int, edge_feats: int, out_feats: int,
                 num_heads: int = 1, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 residual: bool = True,
                 activation: Optional[Callable] = None, bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        h, f = num_heads, out_feats
        self.num_heads, self.out_feats = h, f
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope, self.activation = negative_slope, activation
        self.fc = dense(in_feats, h * f, False, dev, generator)
        self.fc_edge = dense(edge_feats, h * f, False, dev, generator)
        self.attn_l = _xavier_normal_param((1, h, f), dev, generator)
        self.attn_r = _xavier_normal_param((1, h, f), dev, generator)
        self.attn_e = _xavier_normal_param((1, h, f), dev, generator)
        self.res_fc = (dense(in_feats, h * f, False, dev, generator)
                       if residual else None)
        self.bias = (nn.Parameter(torch.zeros((1, h, f), device=dev))
                     if bias else None)

    def forward(self, g: Graph, feat, efeat, generator=None):
        h_src, h_dst = _src_dst(g, feat)
        h_src = _maybe_drop(h_src, self.feat_drop, self.training, generator)
        h_dst = _maybe_drop(h_dst, self.feat_drop, self.training, generator)
        h, f = self.num_heads, self.out_feats
        feat_src = self.fc(h_src).reshape(-1, h, f)
        feat_dst = (feat_src[: g.num_dst_nodes()] if g.is_block
                    else feat_src)
        feat_edge = self.fc_edge(efeat).reshape(-1, h, f)
        el = (feat_src * self.attn_l).sum(dim=-1, keepdim=True)
        er = (feat_dst * self.attn_r).sum(dim=-1, keepdim=True)
        ee = (feat_edge * self.attn_e).sum(dim=-1, keepdim=True)
        e = gsddmm(g, "add", el, er, lhs_target="u", rhs_target="v") + ee
        a = edge_softmax(g, torch.nn.functional.leaky_relu(
            e, self.negative_slope))
        a = _maybe_drop(a, self.attn_drop, self.training, generator)
        msg = gsddmm(g, "copy_lhs", feat_src, None,
                     lhs_target="u") + feat_edge
        rst = gspmm(g, "copy_rhs", "sum", None, msg * a)
        if self.res_fc is not None:
            rst = rst + self.res_fc(h_dst).reshape(-1, h, f)
        if self.bias is not None:
            rst = rst + self.bias
        return self.activation(rst) if self.activation is not None else rst


class GCN2Conv(nn.Module):
    """GCNII (``gcn2conv.py``): ``(1 - beta) (h + h0) + beta (fc(h) +
    fc_0(h0))`` with ``h = (1 - alpha) Ahat feat`` (degrees clamped at 1),
    ``h0 = alpha feat_0`` and ``beta = log(lambda_ / layer + 1)``, which
    goes to 0 (the identity map) as ``layer`` grows; one shared ``fc`` on
    ``h + h0`` with ``project_initial_features``. ``in_feats`` is both
    widths."""

    def __init__(self, in_feats: int, layer: int = 1, alpha: float = 0.1,
                 lambda_: float = 1.0, project_initial_features: bool = False,
                 bias: bool = True, activation: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.alpha, self.activation = alpha, activation
        self.beta = math.log(lambda_ / layer + 1.0)
        self.fc = dense(in_feats, in_feats, bias, dev, generator)
        self.fc_0 = (None if project_initial_features
                     else dense(in_feats, in_feats, bias, dev, generator))

    def forward(self, g: Graph, feat, feat_0):
        deg_out = g.out_degrees().to(feat.dtype).clamp_min(1.0)
        deg_in = g.in_degrees().to(feat.dtype).clamp_min(1.0)
        h = gspmm(g, "copy_lhs", "sum", feat * deg_out.pow(-0.5)[:, None],
                  None) * deg_in.pow(-0.5)[:, None]
        h = (1.0 - self.alpha) * h
        h0 = self.alpha * feat_0
        b = self.beta
        if self.fc_0 is None:
            rst = (1.0 - b) * (h + h0) + b * self.fc(h + h0)
        else:
            rst = (1.0 - b) * (h + h0) + b * (self.fc(h) + self.fc_0(h0))
        return self.activation(rst) if self.activation is not None else rst


class PNAConv(nn.Module):
    """Principal neighbourhood aggregation (``pnaconv.py``): the
    aggregators (mean, max, min, std, var, sum; ``copy_lhs`` g-SpMMs) at
    full width, times the degree scalers (identity; amplification
    ``log(d + 1) / delta``; attenuation ``delta / log(d + 1)``, d the
    in-degree clamped at 1), split into ``num_towers`` towers
    (``tower_{t}`` on ``[h_dst slice, aggregates slice]``), ``mixing``,
    dropout and the residual when the widths agree."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregators=("mean", "max", "min", "std"),
                 scalers=("identity", "amplification", "attenuation"),
                 delta: float = 1.0, num_towers: int = 1,
                 dropout: float = 0.0, residual: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if in_feats % num_towers:
            raise ValueError("in_feats must divide num_towers")
        for name in aggregators:
            if name not in ("mean", "max", "min", "std", "var", "sum"):
                raise ValueError(f"unknown aggregator {name!r}")
        for name in scalers:
            if name not in ("identity", "amplification", "attenuation"):
                raise ValueError(f"unknown scaler {name!r}")
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.delta, self.num_towers = delta, num_towers
        self.dropout, self.residual = dropout, residual
        self.out_feats = out_feats
        tw_in, tw_out = in_feats // num_towers, out_feats // num_towers
        width = tw_in * (1 + len(aggregators) * len(scalers))
        for t in range(num_towers):
            setattr(self, f"tower_{t}", dense(width, tw_out, True, dev,
                                              generator))
        self.mixing = dense(tw_out * num_towers, out_feats, True, dev,
                            generator)

    def forward(self, g: Graph, feat, generator=None):
        h_src, h_dst = _src_dst(g, feat)
        fin = h_src.shape[-1]
        aggs, mean = [], None
        for name in self.aggregators:
            if name in ("mean", "var", "std") and mean is None:
                mean = gspmm(g, "copy_lhs", "mean", h_src, None)
            if name == "mean":
                aggs.append(mean)
            elif name in ("sum", "max", "min"):
                aggs.append(gspmm(g, "copy_lhs", name, h_src, None))
            else:
                sq = gspmm(g, "copy_lhs", "mean", h_src * h_src, None)
                var = (sq - mean * mean).clamp_min(0.0)
                aggs.append(torch.sqrt(var + 1e-5) if name == "std" else var)
        h_agg = torch.cat(aggs, dim=-1)
        logd = torch.log(g.in_degrees().to(h_agg.dtype).clamp_min(1.0)
                         + 1.0)[:, None]
        scaled = []
        for name in self.scalers:
            if name == "identity":
                scaled.append(h_agg)
            elif name == "amplification":
                scaled.append(h_agg * (logd / self.delta))
            else:
                scaled.append(h_agg * (self.delta / logd.clamp_min(1e-5)))
        n_t = self.num_towers
        tw_in = fin // n_t
        h_cat = torch.cat(scaled, dim=-1).reshape(
            -1, len(self.scalers) * len(self.aggregators), fin)
        outs = []
        for t in range(n_t):
            part = h_cat[:, :, t * tw_in:(t + 1) * tw_in].reshape(
                h_cat.shape[0], -1)
            outs.append(getattr(self, f"tower_{t}")(torch.cat(
                [h_dst[:, t * tw_in:(t + 1) * tw_in], part], dim=-1)))
        rst = self.mixing(torch.cat(outs, dim=-1))
        rst = _maybe_drop(rst, self.dropout, self.training, generator)
        if self.residual and h_dst.shape[-1] == self.out_feats:
            rst = rst + h_dst
        return rst


def _per_type_heads(x, w, types):
    """``out[e] = x[e] @ w[types[e]]`` per head: ``x`` (E, H, D), ``w``
    (R, H, D, F); rows whose type is outside [0, R) are zero, as the
    reference's one-hot mixture gives them. One batched matmul per type
    over its rows, so no (E, R, ...) tensor is formed."""
    out = x.new_zeros(x.shape[:2] + (w.shape[-1],))
    for r in range(w.shape[0]):
        rows = (types == r).nonzero().squeeze(1)
        out.index_copy_(0, rows, torch.einsum(
            "ehd,hdf->ehf", x.index_select(0, rows), w[r]))
    return out


class HGTConv(nn.Module):
    """Heterogeneous graph transformer layer (``hgtconv.py``) on a
    homogeneous graph with integer node and edge types (``ntype`` (N,),
    ``etype`` (E,)): per-type Q/K/V (``TypedLinear``), per-relation
    attention and message maps (``relation_att``, ``relation_msg`` (R, H,
    D, D)) and priorities (``relation_pri``), edge softmax, a ``copy_e``
    sum of the weighted messages, gelu, ``linear_a``, the sigmoid ``skip``
    gate where the widths agree, and an optional ``norm``. Dropout on the
    attention draws from the ``generator`` passed to :meth:`forward`,
    only while training."""

    def __init__(self, in_size: int, head_size: int, num_heads: int,
                 num_ntypes: int, num_etypes: int, dropout: float = 0.2,
                 use_norm: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from dgl1_tpu_torch.nn.linear import TypedLinear

        dev = resolve_device(device)
        h, d = num_heads, head_size
        self.num_heads, self.head_size = h, d
        self.num_etypes, self.dropout = num_etypes, dropout
        for name in ("linear_q", "linear_k", "linear_v"):
            setattr(self, name, TypedLinear(in_size, h * d, num_ntypes,
                                            device=dev, generator=generator))
        self.relation_att = nn.Parameter(_xavier_uniform(
            (num_etypes, h, d, d), generator).to(dev))
        self.relation_msg = nn.Parameter(_xavier_uniform(
            (num_etypes, h, d, d), generator).to(dev))
        self.relation_pri = nn.Parameter(torch.ones((num_etypes, h),
                                                    device=dev))
        self.linear_a = TypedLinear(h * d, h * d, num_ntypes, device=dev,
                                    generator=generator)
        self.skip = nn.Parameter(torch.ones((num_ntypes,), device=dev))
        self.norm = _layer_norm(h * d, dev) if use_norm else None

    def forward(self, g: Graph, x, ntype, etype, generator=None):
        h, d = self.num_heads, self.head_size
        ntype = torch.as_tensor(ntype, device=x.device).long()
        q = self.linear_q(x, ntype).reshape(-1, h, d)
        k = self.linear_k(x, ntype).reshape(-1, h, d)
        v = self.linear_v(x, ntype).reshape(-1, h, d)
        k_e = gsddmm(g, "copy_lhs", k, None, lhs_target="u")
        v_e = gsddmm(g, "copy_lhs", v, None, lhs_target="u")
        q_e = gsddmm(g, "copy_rhs", None, q, rhs_target="v")
        et = torch.as_tensor(etype, device=x.device).long()
        if et.shape[0] < k_e.shape[0]:  # the padded edge count
            et = torch.cat([et, et.new_zeros(k_e.shape[0] - et.shape[0])])
        kt = _per_type_heads(k_e, self.relation_att, et)
        mt = _per_type_heads(v_e, self.relation_msg, et)
        in_range = ((et >= 0) & (et < self.num_etypes)).to(x.dtype)[:, None]
        pri = self.relation_pri[et.clamp(0, self.num_etypes - 1)] * in_range
        logits = (kt * q_e).sum(dim=-1) * pri / math.sqrt(d)
        a = edge_softmax(g, logits[..., None])
        a = _maybe_drop(a, self.dropout, self.training, generator)
        h_agg = gspmm(g, "copy_rhs", "sum", None, mt * a)
        out = self.linear_a(torch.nn.functional.gelu(
            h_agg.reshape(-1, h * d), approximate="tanh"), ntype)
        alpha = torch.sigmoid(self.skip)[ntype][:, None]
        if x.shape == out.shape:
            out = alpha * out + (1.0 - alpha) * x
        return self.norm(out) if self.norm is not None else out
