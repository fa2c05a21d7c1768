"""Tile engine for g-SpMM: sum, mean, max and min over edge tiles.

The port's counterpart of ``dgl1_tpu/ops/engine_pallas.py``. The graph's
tile layouts (``Graph.tdst`` for the forward, ``Graph.tsrc`` for grad_u;
``graph._build_tiles``) put each row block's edges in 1024-slot tiles.
The reduction is K9 (:func:`tile_kernels.tile_sum`) or K10
(:func:`tile_kernels.tile_minmax`). For ``copy_lhs`` and ``copy_rhs`` the
kernel reads the operand's rows through the layout's ``gather`` or
``eid`` itself, so no per-slot message tensor exists; the binary ops
build their messages (one row per slot: the gathers, then the op) in
torch glue. Padding slots are never read by either kernel, so the glue
does not mask them. Backward passes are ``torch.autograd.Function``s
mirroring the reference's ``custom_vjp``s: grad_u is K9 over ``tsrc``,
grad_e a gather; max/min recompute which edges hold the extremum and
split the cotangent evenly over ties (tie counts by K9 over ``tdst``).
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.graph import TILE_ROWS, Graph
from dgl1_tpu_torch.ops import tile_kernels as K
from dgl1_tpu_torch.ops.engine_ell import _mask_e, _sum_to_shape
from dgl1_tpu_torch.ops.engine_xla import _binary, gather_rows

__all__ = ["gspmm_tile"]

_SUPPORTED_OPS = ("copy_lhs", "copy_rhs", "add", "sub", "mul", "div")


def _operand(op: str, tiles: dict, u, e):
    """What K9/K10 read in the given tile direction: ``(src, idx,
    feat_shape)``. A copy op hands over its operand flattened to (n, flat)
    float32 with the layout's index (``gather`` for u, ``eid`` for e); a
    binary op builds its (n_slots, flat) messages and no index."""
    if op == "copy_lhs":
        x, idx = u, tiles["gather"]
    elif op == "copy_rhs":
        x, idx = e, tiles["eid"]
    else:
        ug = gather_rows(u, tiles["gather"])
        eg = gather_rows(e, tiles["eid"])
        x, idx = _binary(op, ug, eg), None
    feat_shape = tuple(x.shape[1:])
    return x.reshape(x.shape[0], -1).float().contiguous(), idx, feat_shape


def _tiled_reduce(op: str, tiles: dict, u, e, num_target: int):
    """One g-SpMM sum in the given tile direction (K9). Rows of row blocks
    without edges are zero: K9 writes its identity there."""
    src, idx, feat_shape = _operand(op, tiles, u, e)
    n_rb = max(-(-num_target // TILE_ROWS), 1)
    out = K.tile_sum(tiles["rows"], tiles["first"], tiles["lid"], src, n_rb,
                     idx)
    dtype = (u if u is not None else e).dtype
    return out[:num_target].to(dtype).reshape((num_target,) + feat_shape)


def _tiled_minmax(op: str, is_max: bool, tiles: dict, u, e,
                  num_target: int):
    """Forward max/min in the given tile direction (K10); rows with no
    edges, and non-finite results, are zero (the reference's
    semantics)."""
    src, idx, feat_shape = _operand(op, tiles, u, e)
    n_rb = max(-(-num_target // TILE_ROWS), 1)
    out = K.tile_minmax(is_max, tiles["rows"], tiles["first"], tiles["lid"],
                        src, n_rb, idx)
    out = out[:num_target]
    row_mask = tiles["block_mask"].repeat_interleave(TILE_ROWS)[:num_target]
    out = torch.where(row_mask[:, None] & torch.isfinite(out), out,
                      torch.zeros_like(out))
    dtype = (u if u is not None else e).dtype
    return out.to(dtype).reshape((num_target,) + feat_shape)


class _TileSum(torch.autograd.Function):
    """Sum over ``tdst``; the backward of ``_gspmm_sum_bwd``."""

    @staticmethod
    def forward(ctx, g, op, u, e):
        ctx.g, ctx.op = g, op
        ctx.save_for_backward(u, e)
        return _tiled_reduce(op, g.tdst, u, e, g.num_dst_nodes())

    @staticmethod
    def backward(ctx, ct):
        g, op = ctx.g, ctx.op
        u, e = ctx.saved_tensors
        ct = ct.contiguous()
        need_u, need_e = ctx.needs_input_grad[2], ctx.needs_input_grad[3]

        def rev(op2, uu, ee):
            return _tiled_reduce(op2, g.tsrc, uu, ee, g.num_src_nodes())

        def ct_dst():
            return gather_rows(ct, g.dst)

        gu = ge = None
        if op in ("copy_lhs", "add", "sub") and need_u:
            gu = _sum_to_shape(rev("copy_lhs", ct, None), u.shape[1:])
        if op == "copy_rhs" and need_e:
            ge = _sum_to_shape(_mask_e(ct_dst(), g.edge_mask), e.shape[1:])
        elif op in ("add", "sub") and need_e:
            gf = ct_dst() if op == "add" else -ct_dst()
            ge = _sum_to_shape(_mask_e(gf, g.edge_mask), e.shape[1:])
        elif op == "mul":
            if need_u:
                gu = _sum_to_shape(rev("mul", ct, e), u.shape[1:])
            if need_e:
                ge = _sum_to_shape(_mask_e(gather_rows(u, g.src) * ct_dst(),
                                           g.edge_mask), e.shape[1:])
        elif op == "div":
            if need_u:
                gu = _sum_to_shape(rev("mul", ct, 1.0 / e), u.shape[1:])
            if need_e:
                ge = _sum_to_shape(_mask_e(
                    -gather_rows(u, g.src) * ct_dst() / (e * e),
                    g.edge_mask), e.shape[1:])
        return None, None, gu, ge


class _TileMinMax(torch.autograd.Function):
    """Max/min over ``tdst``; the backward of ``_gspmm_minmax_bwd``: the
    cotangent goes to the edges whose message equals the result, split
    evenly over ties. Gathers and two K9 reductions, no scatter."""

    @staticmethod
    def forward(ctx, g, op, is_max, u, e):
        out = _tiled_minmax(op, is_max, g.tdst, u, e, g.num_dst_nodes())
        ctx.g, ctx.op = g, op
        ctx.save_for_backward(u, e, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        g, op = ctx.g, ctx.op
        u, e, out = ctx.saved_tensors
        ct = ct.contiguous()
        need_u, need_e = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        ug = gather_rows(u, g.src) if u is not None else None
        if op == "copy_lhs":
            msg = ug
        elif op == "copy_rhs":
            msg = e
        else:
            msg = _binary(op, ug, e)
        eq = msg == gather_rows(out, g.dst)
        if g.edge_mask is not None:
            eq = eq & g.edge_mask.reshape((-1,) + (1,) * (msg.dim() - 1))
        eq = eq.to(msg.dtype)
        # Tie counts per destination row, then the even split.
        ties = _tiled_reduce("copy_rhs", g.tdst, None, eq, g.num_dst_nodes())
        ties_e = gather_rows(ties, g.dst).clamp(min=1.0)
        gmsg = eq * gather_rows(ct, g.dst) / ties_e

        def rev(m):
            return _tiled_reduce("copy_rhs", g.tsrc, None, m,
                                 g.num_src_nodes())

        gu = ge = None
        if need_u:
            if op in ("copy_lhs", "add", "sub"):
                gu = _sum_to_shape(rev(gmsg), u.shape[1:])
            elif op == "mul":
                gu = _sum_to_shape(rev(gmsg * e), u.shape[1:])
            elif op == "div":
                gu = _sum_to_shape(rev(gmsg / e), u.shape[1:])
        if need_e:
            if op in ("copy_rhs", "add"):
                ge_full = gmsg
            elif op == "sub":
                ge_full = -gmsg
            elif op == "mul":
                ge_full = gmsg * ug
            else:  # div
                ge_full = -gmsg * ug / (e * e)
            ge = _sum_to_shape(_mask_e(ge_full, g.edge_mask), e.shape[1:])
        return None, None, None, gu, ge


def gspmm_tile(g: Graph, op: str, reduce_op: str, u, e):
    """Tile-engine g-SpMM; returns None when the call is not covered (no
    tile layouts, an unknown op or reduce, missing or non-float
    operands)."""
    if g.tdst is None or g.tsrc is None:
        return None
    if op not in _SUPPORTED_OPS or reduce_op not in ("sum", "mean", "max",
                                                     "min"):
        return None
    for data in (u, e):
        if data is not None and not data.is_floating_point():
            return None
    if op != "copy_rhs" and u is None or op != "copy_lhs" and e is None:
        return None
    u_in = u if op != "copy_rhs" else None
    e_in = e if op != "copy_lhs" else None
    if reduce_op in ("max", "min"):
        return _TileMinMax.apply(g, op, reduce_op == "max", u_in, e_in)
    out = _TileSum.apply(g, op, u_in, e_in)
    if reduce_op == "mean":
        deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
        out = out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))
    return out
