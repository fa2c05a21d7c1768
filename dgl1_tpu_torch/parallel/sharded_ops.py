"""Sharded sparse ops: the halo exchange and each part's local reduce.

The port's counterpart of ``dgl1_tpu/parallel/sharded_ops.py``. The
reference runs one program over a device mesh (``shard_map``); here one
process runs one partition (rank p of a ``torch.distributed`` group owns
part p, a :class:`~dgl1_tpu_torch.parallel.halo.LocalPartition`), and
``jax.lax.all_to_all`` becomes ``all_to_all_single`` over equal splits
(every pair is padded to ``m_halo`` / ``m_part`` rows). Each exchange is
an autograd Function whose backward is the same exchange of the
cotangent blocks (an all_to_all over equal splits is its own transpose),
so halo cotangents return to their owners. Gradients of replicated
parameters are the sum of every rank's: :func:`allreduce_grads`.

The local reduces run the existing kernels on per-partition layouts:
K9 (``tile_sum``) over the halo tiles, K11 (``block_mm``) over the
block-dense descriptors, the hub engine (K1, K2, K3, K4a/b) over the
partitioned hub layouts and the fused attention (K6, K7, K8). With no
process group and one part, an exchange is the identity (the block goes
to its own rank).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.nn.functional import leaky_relu

from dgl1_tpu_torch.graph import TILE_ROWS
from dgl1_tpu_torch.ops.engine_xla import take_fill
from dgl1_tpu_torch.ops.precision import get_matmul_precision
from dgl1_tpu_torch.parallel.halo import LocalPartition

__all__ = [
    "wire_all_to_all",
    "halo_exchange",
    "halo_update_combined",
    "fill_halo_combined",
    "local_spmm_sum",
    "make_local_spmm",
    "make_local_spmm_bdense",
    "fused_attention_local",
    "partial_merge",
    "scatter_to_slots",
    "sharded_gspmm",
    "sharded_gspmm_combined",
    "make_sharded_gcn_matvec",
    "make_sharded_gcn_matvec_combined",
    "sharded_gat_attention",
    "sharded_gat_attention_fused",
    "make_sharded_gat_layer",
    "allreduce_grads",
    "all_reduce_sum",
]

NEG = -1e30


# ----------------------------------------------------------------------
# Exchanges
# ----------------------------------------------------------------------

def _all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` (P, m, *f): block q goes to rank q; returns the blocks
    received, block q from rank q."""
    x = x.contiguous()
    if not dist.is_initialized():
        if x.shape[0] != 1:
            raise RuntimeError(
                f"an exchange over {x.shape[0]} parts needs an initialized "
                f"torch.distributed group (parallel.initialize)")
        return x.clone()
    world = dist.get_world_size(group)
    if x.shape[0] != world:
        raise ValueError(f"{x.shape[0]} send blocks for a world of {world}")
    if x.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError("a CUDA tensor cannot be exchanged over a gloo "
                         "group: initialize with device='cuda' (nccl)")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _wire_a2a(wire: str, sbuf: torch.Tensor, group=None) -> torch.Tensor:
    """One halo all_to_all with the wire format applied to the payload:
    "f32" (exact), "bf16" (half the bytes) or "int8" (a quarter: a
    per-row absmax scale and an int8 mantissa rounded half to even, the
    scale riding a second exchange)."""
    if wire == "bf16" and sbuf.dtype == torch.float32:
        return _all_to_all(sbuf.to(torch.bfloat16), group).to(sbuf.dtype)
    if wire == "int8" and sbuf.dtype == torch.float32:
        s = sbuf.abs().amax(dim=-1, keepdim=True) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.round(sbuf / s).to(torch.int8)
        return (_all_to_all(q, group).to(sbuf.dtype)
                * _all_to_all(s, group))
    return _all_to_all(sbuf, group)


class _WireAllToAll(torch.autograd.Function):
    """The wire-compressed exchange; its backward sends the cotangent
    blocks back over the same wire (int8 rounding is straight-through)."""

    @staticmethod
    def forward(ctx, sbuf, wire, group):
        ctx.wire, ctx.group = wire, group
        return _wire_a2a(wire, sbuf, group)

    @staticmethod
    def backward(ctx, ct):
        return _wire_a2a(ctx.wire, ct, ctx.group), None, None


def wire_all_to_all(wire: str, sbuf: torch.Tensor, group=None):
    """Differentiable all_to_all of ``sbuf`` (P, m, *f) over ``wire``."""
    return _WireAllToAll.apply(sbuf, wire, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward passes the cotangent through (each
    rank's copy of the sum feeds the same replicated loss)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        if dist.is_initialized():
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-reduce (SUM) over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def allreduce_grads(params, group=None) -> None:
    """Sum the gradients of replicated parameters over the ranks (the
    reference gets this from the transpose of ``shard_map``)."""
    if not dist.is_initialized():
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def halo_exchange(pl: LocalPartition, feat_local: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Send this part's owned rows to the parts that read them and return
    the combined (n_loc + P*m_halo, *f) table the local ``esrc`` indexes:
    owned rows, then the halo slots of owner 0, 1, ..."""
    sbuf = feat_local.index_select(0, pl.send_idx.reshape(-1).long())
    sbuf = sbuf.reshape(tuple(pl.send_idx.shape) + tuple(feat_local.shape[1:]))
    rbuf = wire_all_to_all(pl.halo_dtype, sbuf, group)
    halo = rbuf.reshape((-1,) + tuple(feat_local.shape[1:])).to(
        feat_local.dtype)
    return torch.cat([feat_local, halo], dim=0)


class _HaloUpdate(torch.autograd.Function):
    """Refresh the halo slots of a combined-layout activation: the owned
    rows feed the send gather and the received blocks overwrite rows
    [n_loc, n_loc + P*m_halo). The backward zeroes those rows of the
    cotangent, sends their blocks back and adds them at the send rows
    (the reference's hand-written transpose)."""

    @staticmethod
    def forward(ctx, x, send_idx, n_loc, wire, group):
        ctx.save_for_backward(send_idx)
        ctx.n_loc, ctx.wire, ctx.group = n_loc, wire, group
        feat = tuple(x.shape[1:])
        sbuf = x.index_select(0, send_idx.reshape(-1).long()).reshape(
            tuple(send_idx.shape) + feat)
        rbuf = _wire_a2a(wire, sbuf, group)
        out = x.clone()
        out[n_loc: n_loc + rbuf.shape[0] * rbuf.shape[1]] = rbuf.reshape(
            (-1,) + feat).to(x.dtype)
        return out

    @staticmethod
    def backward(ctx, ct):
        (send_idx,) = ctx.saved_tensors
        n_loc = ctx.n_loc
        p_, m_halo = send_idx.shape
        feat = tuple(ct.shape[1:])
        ct_halo = ct[n_loc: n_loc + p_ * m_halo]
        back = _wire_a2a(ctx.wire, ct_halo.reshape((p_, m_halo) + feat),
                         ctx.group).reshape((p_ * m_halo,) + feat)
        g = ct.clone()
        g[n_loc: n_loc + p_ * m_halo] = 0
        # Unused send slots point at row 0 and carry zero cotangent.
        g.index_add_(0, send_idx.reshape(-1).long(), back.to(ct.dtype))
        return g, None, None, None, None


def halo_update_combined(pl: LocalPartition, x_comb: torch.Tensor,
                         group=None) -> torch.Tensor:
    """``x_comb`` (R, *f) in the [owned | halo slots | pad] layout (R =
    ``hub_rows``) with its halo slots refreshed from their owners."""
    return _HaloUpdate.apply(x_comb, pl.send_idx, pl.n_loc, pl.halo_dtype,
                             group)


def fill_halo_combined(pl: LocalPartition, group=None):
    """``fill(x) -> x`` with the halo slots filled once, for a combined
    buffer whose owned rows do not change across steps (the input
    features of full-graph training): feed it to paths built with
    ``halo_filled=True``, whose first layer then skips the update."""
    def fill(x):
        with torch.no_grad():
            return halo_update_combined(pl, x, group)

    return fill


# ----------------------------------------------------------------------
# Local reduces
# ----------------------------------------------------------------------

def _tiled_sum(tiles, values: torch.Tensor, num_target: int):
    """K9 over a part's tile descriptors in gather mode: slot s reads row
    ``tiles["gather"][s]`` of ``values``; the +1 row block is the scratch
    block the cross-part tile padding aims at. Rows of row blocks with no
    tile are zero (``block_mask``)."""
    from dgl1_tpu_torch.ops.tile_kernels import tile_sum

    feat = tuple(values.shape[1:])
    flat = math.prod(feat)
    v2 = values.reshape(values.shape[0], flat).to(torch.float32).contiguous()
    n_row_blocks = -(-num_target // TILE_ROWS) + 1
    out = tile_sum(tiles["rows"], tiles["first"], tiles["lid"], v2,
                   n_row_blocks, idx=tiles["gather"])[:num_target]
    row_mask = tiles["block_mask"].repeat_interleave(TILE_ROWS)[:num_target]
    out = torch.where(row_mask[:, None], out, torch.zeros_like(out))
    return out.to(values.dtype).reshape((num_target,) + feat)


class _TiledSpmm(torch.autograd.Function):
    """Sum of the combined table into the output rows over the forward
    tiles; the backward reduces the cotangent into the combined space over
    the reverse tiles. K9 both ways."""

    @staticmethod
    def forward(ctx, combined, tiles_fwd, tiles_rev, n_out, n_comb):
        ctx.tiles_rev, ctx.n_comb = tiles_rev, n_comb
        return _tiled_sum(tiles_fwd, combined, n_out)

    @staticmethod
    def backward(ctx, ct):
        return (_tiled_sum(ctx.tiles_rev, ct, ctx.n_comb),
                None, None, None, None)


def _bdense_dir(bd, x2: torch.Tensor, transpose: bool, n_valid: int,
                bf16: bool):
    """One dense-tier reduce over a part's block descriptors (K11):
    forward, combined -> output rows over ``a`` and ``row_ptr``;
    transposed, cotangent -> combined rows over ``ab`` and ``col_ptr``.
    The cross-part padding blocks sit past the run pointers and are never
    visited; rows of runs without a block are zero."""
    from dgl1_tpu_torch.ops.bdense_kernels import block_mm

    if transpose:
        return block_mm(True, bd["ab"], bd["col_ptr"], bd["rbb"], x2,
                        n_valid, bf16)
    return block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], x2, n_valid,
                    bf16)


class _BDenseSpmm(torch.autograd.Function):
    """Block-dense + tile-tail local sum: K11 over the dense blocks plus
    K9 over the leftover edges, both directions."""

    @staticmethod
    def forward(ctx, combined, bd, tiles_fwd, tiles_rev, n_out, n_comb,
                bf16):
        ctx.bd, ctx.tiles_rev, ctx.n_comb, ctx.bf16 = (bd, tiles_rev,
                                                       n_comb, bf16)
        feat = tuple(combined.shape[1:])
        x2 = combined.reshape(combined.shape[0], -1).to(
            torch.float32).contiguous()
        dense = _bdense_dir(bd, x2, False, n_out, bf16)
        tail = _tiled_sum(tiles_fwd, x2, n_out)
        return (dense + tail).to(combined.dtype).reshape((n_out,) + feat)

    @staticmethod
    def backward(ctx, ct):
        feat = tuple(ct.shape[1:])
        ct2 = ct.reshape(ct.shape[0], -1).to(torch.float32).contiguous()
        dense = _bdense_dir(ctx.bd, ct2, True, ctx.n_comb, ctx.bf16)
        tail = _tiled_sum(ctx.tiles_rev, ct2, ctx.n_comb)
        g = (dense + tail).to(ct.dtype).reshape((ctx.n_comb,) + feat)
        return g, None, None, None, None, None, None


def make_local_spmm(n_out: int, n_comb: int):
    """``fn(tiles_fwd, tiles_rev, combined)``: the tile-engine local sum
    into n_out rows, its backward into the n_comb combined rows (K9 both
    ways)."""
    def fn(tiles_fwd, tiles_rev, combined):
        return _TiledSpmm.apply(combined, tiles_fwd, tiles_rev, n_out,
                                n_comb)

    return fn


def make_local_spmm_bdense(n_out: int, n_comb: int):
    """``fn(bd, tiles_fwd, tiles_rev, combined)``: the block-dense tier
    (K11) plus the tile tail (K9), both directions."""
    def fn(bd, tiles_fwd, tiles_rev, combined):
        return _BDenseSpmm.apply(combined, bd, tiles_fwd, tiles_rev, n_out,
                                 n_comb, get_matmul_precision() == "bf16")

    return fn


def _hub_sum(pl: LocalPartition, x_rows: torch.Tensor) -> torch.Tensor:
    """copy_u sum of (R, *f) rows through the hub engine on the part's
    layout (R sources, R destinations): K1, K2, K3 and the ELL tail
    forward, K4a/K4b and K2 backward, as on one device."""
    from dgl1_tpu_torch.ops.engine_hub import _HubSum

    rep = math.prod(x_rows.shape[1:])
    return _HubSum.apply(pl.hub_graph(), "copy_lhs", 1, rep, x_rows, None,
                         get_matmul_precision() == "bf16")


def _hub_local_spmm(pl: LocalPartition, combined: torch.Tensor):
    """The hub engine's local reduce: the combined table lifted to the R
    rows the layout is built in (one copy; the combined-layout path keeps
    activations at R rows and avoids it), summed, cut to n_out rows."""
    widths = [0, 0] * (combined.dim() - 1) + [0, pl.hub_rows
                                              - combined.shape[0]]
    x_pad = torch.nn.functional.pad(combined, widths)
    return _hub_sum(pl, x_pad)[: pl.n_out]


def local_spmm_sum(pl: LocalPartition, combined: torch.Tensor):
    """Sum over this part's edges of the combined (n_comb, *f) table into
    its (n_out, *f) output rows (owned rows, then the vertex-cut partial
    slots): the hub engine, block-dense with a tile tail, tiles (K9), or,
    without descriptors, a gather and ``index_add`` (padded edges hold the
    destination n_out and land on a dropped row)."""
    n_out, n_comb = pl.n_out, pl.n_comb
    if pl.hub is not None:
        return _hub_local_spmm(pl, combined)
    if pl.bdense is not None:
        return make_local_spmm_bdense(n_out, n_comb)(
            pl.bdense, pl.tiles_fwd, pl.tiles_rev, combined)
    if pl.tiles_fwd is not None:
        return make_local_spmm(n_out, n_comb)(pl.tiles_fwd, pl.tiles_rev,
                                              combined)
    msg = combined.index_select(0, pl.esrc.long())
    out = combined.new_zeros((n_out + 1,) + tuple(combined.shape[1:]))
    return out.index_add(0, pl.edst.long(), msg)[:n_out]


def _take_fill(x, idx, fill: float = 0.0):
    """``take_fill`` over an index of any shape."""
    return take_fill(x, idx.reshape(-1), fill).reshape(
        tuple(idx.shape) + tuple(x.shape[1:]))


class _PartialMerge(torch.autograd.Function):
    """Fold received vertex-cut partials into the owned rows:
    ``out[v] = own[v] + sum_p recv[recv_pos[v, p]]`` (out-of-range
    positions add 0). Both directions are gathers: the transpose routes
    row v's cotangent to each slot through ``slot_node``."""

    @staticmethod
    def forward(ctx, out_own, recv_flat, recv_pos, slot_node):
        ctx.save_for_backward(slot_node)
        return out_own + _take_fill(recv_flat, recv_pos).sum(dim=1)

    @staticmethod
    def backward(ctx, ct):
        (slot_node,) = ctx.saved_tensors
        return ct, _take_fill(ct, slot_node), None, None


def partial_merge(recv_pos, slot_node, out_own, recv_flat):
    """See :class:`_PartialMerge` (the reference's argument order)."""
    return _PartialMerge.apply(out_own, recv_flat, recv_pos, slot_node)


class _ScatterToSlots(torch.autograd.Function):
    """Owner-side dual of :func:`partial_merge`: owned rows laid out in
    the per-sender partial-slot order (``slot_node`` sentinel -> zero
    row); the backward is the ``recv_pos`` gather-sum."""

    @staticmethod
    def forward(ctx, x, slot_node, recv_pos):
        ctx.save_for_backward(recv_pos)
        return _take_fill(x, slot_node)

    @staticmethod
    def backward(ctx, ct):
        (recv_pos,) = ctx.saved_tensors
        return _take_fill(ct, recv_pos).sum(dim=1), None, None


def scatter_to_slots(slot_node, recv_pos, x):
    return _ScatterToSlots.apply(x, slot_node, recv_pos)


def _merge_partials(pl: LocalPartition, y: torch.Tensor, group=None):
    """Vertex cut: send the partial-slot rows of ``y`` (n_out, *f) to their
    owners and fold what arrives into the owned rows (n_loc, *f)."""
    feat = tuple(y.shape[1:])
    pbuf = y[pl.n_loc: pl.n_out].reshape((pl.num_parts, pl.m_part) + feat)
    recv = wire_all_to_all("f32", pbuf, group).reshape((-1,) + feat)
    return partial_merge(pl.recv_pos, pl.slot_node, y[: pl.n_loc], recv)


def sharded_gspmm(pl: LocalPartition, feat_local: torch.Tensor, group=None,
                  edge_weight: Optional[torch.Tensor] = None):
    """copy_u (or u_mul_e with ``edge_weight`` (e_loc, 1..)) + sum over the
    partitioned graph: (n_loc, *f) owned rows in, (n_loc, *f) out. In
    vertex-cut mode the partial rows travel to their owners and are
    folded in (:func:`partial_merge`)."""
    combined = halo_exchange(pl, feat_local, group)
    if edge_weight is None:
        y = local_spmm_sum(pl, combined)
    else:
        msg = combined.index_select(0, pl.esrc.long()) * edge_weight
        y = combined.new_zeros((pl.n_out + 1,) + tuple(msg.shape[1:]))
        y = y.index_add(0, pl.edst.long(), msg)[: pl.n_out]
    if pl.m_part == 0:
        return y
    return _merge_partials(pl, y, group)


def sharded_gspmm_combined(pl: LocalPartition, x_comb: torch.Tensor,
                           group=None, halo_filled: bool = False):
    """copy_u + sum in the combined layout (R, *f) -> (R, *f): the halo
    update, then the hub engine at R rows with no pad or slice copy.
    Owned results in rows [0, n_loc); every other row of the result is
    zero (the next layer's halo update fills its slots). In vertex-cut
    mode the partial slots are exchanged and folded first.
    ``halo_filled``: ``x_comb``'s halo slots already hold the owners'
    current rows (static input features filled once by
    :func:`fill_halo_combined`), so the update is skipped."""
    if pl.hub is None:
        raise ValueError("combined layout requires hub=... at build")
    x2 = x_comb if halo_filled else halo_update_combined(pl, x_comb, group)
    y = _hub_sum(pl, x2)
    if pl.m_part == 0:
        return y
    merged = _merge_partials(pl, y, group)
    pad = y.new_zeros((pl.hub_rows - pl.n_loc,) + tuple(y.shape[1:]))
    return torch.cat([merged, pad], dim=0)


def _norms(pl: LocalPartition):
    """Owned rows' out- and in-degree norms deg^-1/2 (1 at degree 0)."""
    def inv_sqrt(d):
        return torch.where(d > 0, d, torch.ones_like(d)) ** -0.5

    return inv_sqrt(pl.out_deg), inv_sqrt(pl.in_deg)


def make_sharded_gcn_matvec(pl: LocalPartition, group=None):
    """``y = D^-1/2 A D^-1/2 x`` over the partitioned graph with global
    degrees: ``fn(x)`` maps this part's (n_loc, F) rows to its (n_loc, F)
    rows, the rows of the single-device GraphConv aggregation."""
    norm_out, norm_in = _norms(pl)

    def fn(x):
        h = x * norm_out[:, None]
        return sharded_gspmm(pl, h, group) * norm_in[:, None]

    return fn


def make_sharded_gcn_matvec_combined(pl: LocalPartition, group=None,
                                     halo_filled: bool = False):
    """The combined-layout matvec: ``fn(x)`` with x, y (R, F); owned rows
    [0, n_loc), every other row of y zero. ``halo_filled``: see
    :func:`sharded_gspmm_combined`; the out-norm of a prefilled halo row
    is its carried node's (``halo_out_deg``), so the buffer must hold raw
    features."""
    if pl.hub is None:
        raise ValueError("combined layout requires hub=... at build")
    r = pl.hub_rows
    norm_out, norm_in = _norms(pl)
    if halo_filled:
        hod = pl.halo_out_deg
        norm_out = torch.cat([norm_out, torch.where(
            hod > 0, hod, torch.ones_like(hod)) ** -0.5])
    norm_out = torch.nn.functional.pad(norm_out, (0, r - norm_out.shape[0]))
    norm_in = torch.nn.functional.pad(norm_in, (0, r - norm_in.shape[0]))

    def fn(x):
        agg = sharded_gspmm_combined(pl, x * norm_out[:, None], group,
                                     halo_filled)
        return agg * norm_in[:, None]

    return fn


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

def _segment_max(z, idx, n: int):
    """Per-segment max of (E, H) rows into (n, H), -inf where empty."""
    out = z.new_full((n,) + tuple(z.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx[:, None].expand_as(z), z, "amax",
                              include_self=True)


def _segment_sum(x, idx, n: int):
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, idx, x)


def sharded_gat_attention(pl: LocalPartition, el_local, er_local, ft_local,
                          negative_slope: float = 0.2, group=None):
    """``out[d] = sum_e softmax_d(leaky_relu(el[s] + er[d])) * ft[s]``
    over the partitioned graph, by gathers and segment sums.

    el, er (n_loc, H), ft (n_loc, H, D) owned rows; returns (n_loc, H, D).
    With destination-owner placement every destination's in-edges are
    local and the softmax is exact with no cross-part statistics: el and
    ft ride the halo exchange. In vertex-cut mode (``m_part`` > 0) it is
    a cross-part online softmax (:func:`_vertex_cut_gat_attention`)."""
    if pl.m_part:
        return _vertex_cut_gat_attention(pl, el_local, er_local, ft_local,
                                         negative_slope, group)
    n_loc = pl.n_loc
    h, d = ft_local.shape[1], ft_local.shape[2]
    el_c = halo_exchange(pl, el_local, group)
    ft_c = halo_exchange(pl, ft_local.reshape(n_loc, h * d), group)
    esrc, edst = pl.esrc.long(), pl.edst.long()
    valid = (edst < n_loc)[:, None]  # n_loc marks padded edge slots
    dcl = edst.clamp(max=n_loc)
    el_e = el_c.index_select(0, esrc)
    er_pad = torch.cat([er_local, er_local.new_zeros((1, h))], dim=0)
    z = leaky_relu(el_e + er_pad.index_select(0, dcl), negative_slope)
    z = torch.where(valid, z, torch.full_like(z, NEG))
    # The max shift carries no gradient (exact per destination).
    m = _segment_max(z.detach(), dcl, n_loc + 1).clamp_min(NEG)[:n_loc]
    m_pad = torch.cat([m, m.new_zeros((1, h))], dim=0)
    p = torch.where(valid, torch.exp(z - m_pad.index_select(0, dcl)),
                    torch.zeros_like(z))
    ft_e = ft_c.index_select(0, esrc).reshape(-1, h, d)
    num = _segment_sum(p[:, :, None] * ft_e, dcl, n_loc + 1)[:n_loc]
    den = _segment_sum(p, dcl, n_loc + 1)[:n_loc]
    return num / den.clamp_min(1e-30)[:, :, None]


def _vertex_cut_gat_attention(pl: LocalPartition, el_local, er_local,
                              ft_local, negative_slope: float, group=None):
    """Cross-part online-softmax attention: each part computes (max,
    exp-sum, weighted numerator) partials over its share of a split
    destination's in-edges; the owners' er rows reach the edge-holding
    parts through one exchange (:func:`scatter_to_slots`), the packed
    partials come back through another, and the owner merges them with
    ``exp(m_p - M)`` rescaling: the exact softmax, forward and gradient."""
    p_ = pl.num_parts
    n_loc, m_part, n_out = pl.n_loc, pl.m_part, pl.n_out
    h, d = ft_local.shape[1], ft_local.shape[2]

    el_c = halo_exchange(pl, el_local, group)
    ft_c = halo_exchange(pl, ft_local.reshape(n_loc, h * d), group)
    er_sbuf = scatter_to_slots(pl.slot_node, pl.recv_pos, er_local)
    er_tail = wire_all_to_all("f32", er_sbuf.reshape(p_, m_part, h),
                              group).reshape(p_ * m_part, h)
    er_ext = torch.cat([er_local, er_tail], dim=0)  # (n_out, H)

    esrc, edst = pl.esrc.long(), pl.edst.long()
    valid = (edst < n_out)[:, None]  # n_out marks padded edge slots
    dcl = edst.clamp(max=n_out - 1)
    z = leaky_relu(el_c.index_select(0, esrc) + er_ext.index_select(0, dcl),
                   negative_slope)
    z = torch.where(valid, z, torch.full_like(z, NEG))

    dseg = edst.clamp(max=n_out)
    m_row = _segment_max(z.detach(), dseg, n_out + 1).clamp_min(NEG)[:n_out]
    p_e = torch.where(valid, torch.exp(z - m_row.index_select(0, dcl)),
                      torch.zeros_like(z))
    ft_e = ft_c.index_select(0, esrc).reshape(-1, h, d)
    s_row = _segment_sum(p_e, dseg, n_out + 1)[:n_out]
    n_row = _segment_sum(p_e[:, :, None] * ft_e, dseg, n_out + 1)[:n_out]

    # (m, s, n) partials of foreign destinations to their owners, packed
    # along the feature axis into one exchange.
    pack = torch.cat([m_row[n_loc:], s_row[n_loc:],
                      n_row[n_loc:].reshape(-1, h * d)], dim=-1)
    recv = wire_all_to_all("f32", pack.reshape(p_, m_part, h * (2 + d)),
                           group).reshape(p_ * m_part, h * (2 + d))
    recv_m = recv[:, :h].detach()
    recv_s = recv[:, h:2 * h]
    recv_n = recv[:, 2 * h:]

    # Owner-side merge: the global max, then exp(m_p - M) rescaling.
    own_m, own_s = m_row[:n_loc], s_row[:n_loc]
    own_n = n_row[:n_loc].reshape(n_loc, h * d)
    gathered_m = _take_fill(recv_m, pl.recv_pos, NEG)  # (n_loc, P, H)
    big_m = torch.maximum(own_m, gathered_m.amax(dim=1))
    w_own = torch.exp(own_m - big_m)
    denom = own_s * w_own
    numer = own_n * w_own[:, :, None].expand(n_loc, h, d).reshape(
        n_loc, h * d)
    m_slot = _take_fill(big_m, pl.slot_node, 0.0)
    w_slot = torch.exp(recv_m - m_slot)  # empty partials: m=-1e30 -> 0
    s_slot = recv_s * w_slot
    n_slot = recv_n * w_slot[:, :, None].expand(p_ * m_part, h, d).reshape(
        p_ * m_part, h * d)
    denom = partial_merge(pl.recv_pos, pl.slot_node, denom, s_slot)
    numer = partial_merge(pl.recv_pos, pl.slot_node, numer, n_slot)
    return numer.reshape(n_loc, h, d) / denom.clamp_min(1e-30)[:, :, None]


def fused_attention_local(pl: LocalPartition, el_c, er_local, ft_c,
                          negative_slope: float = 0.2):
    """The fused attention (K6 forward; K7 and K8 backward) on this part's
    hub layout over combined tables el_c (n_comb, H) and ft_c (n_comb,
    H*D) and owned er (n_loc, H); returns the owned rows (n_loc, H, D)."""
    from dgl1_tpu_torch.ops.attention import gat_attention

    r, n_loc = pl.hub_rows, pl.n_loc
    h = er_local.shape[1]
    d = ft_c.shape[1] // h
    el2 = torch.nn.functional.pad(el_c, (0, 0, 0, r - el_c.shape[0]))
    ft2 = torch.nn.functional.pad(ft_c, (0, 0, 0, r - ft_c.shape[0]))
    er2 = torch.nn.functional.pad(er_local, (0, 0, 0, r - n_loc))
    out = gat_attention(pl.hub_graph(), el2, er2, ft2.reshape(r, h, d),
                        negative_slope)
    if out is None:
        raise ValueError(f"the fused attention declines heads of {h} x {d} "
                         f"on this layout")
    return out[:n_loc]


def sharded_gat_attention_fused(pl: LocalPartition, el_local, er_local,
                                ft_local, negative_slope: float = 0.2,
                                group=None):
    """The attention of :func:`sharded_gat_attention` through the fused
    hub kernels on each part's layout. Needs a hub build and
    destination-owner placement (vertex-cut graphs take the segment
    path's online softmax)."""
    if pl.hub is None:
        raise ValueError("fused sharded attention requires hub=... at build")
    if pl.m_part:
        raise ValueError("vertex-cut placement: use sharded_gat_attention "
                         "(cross-part online softmax)")
    n_loc = pl.n_loc
    h, d = ft_local.shape[1], ft_local.shape[2]
    el_c = halo_exchange(pl, el_local, group)
    ft_c = halo_exchange(pl, ft_local.reshape(n_loc, h * d), group)
    return fused_attention_local(pl, el_c, er_local, ft_c, negative_slope)


def make_sharded_gat_layer(pl: LocalPartition, negative_slope: float = 0.2,
                           group=None, fused: bool = False):
    """``fn(el, er, ft) -> out``, the sharded GAT aggregation on this
    part's rows; the dense projections are the caller's (replicated
    weights, gradients summed by :func:`allreduce_grads`). ``fused``:
    the hub kernels (needs ``hub=...`` and halo placement)."""
    attn = sharded_gat_attention_fused if fused else sharded_gat_attention

    def fn(el, er, ft):
        return attn(pl, el, er, ft, negative_slope, group)

    return fn
