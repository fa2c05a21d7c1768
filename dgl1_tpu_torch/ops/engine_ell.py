"""Degree-bucketed ELL engine for g-SpMM, in plain torch.

The port's counterpart of ``dgl1_tpu/ops/engine_ell.py``. Rows are
grouped by padded degree k; each bucket is a dense (n_rows, k) gather-index
matrix, so a reduce is a gather plus a sum over k. Results come back
bucket-sorted and are restored by one fill-gather through ``inv_perm``.
The reference runs this in XLA with no Pallas kernel, so no hand kernel
is owed here. Backward: grad_u is the same reduce over the reverse
direction (``Graph.ell_src``), or, on sampled blocks, which carry no
``ell_src``, K9 over the reverse tiles (``engine_tile._tiled_reduce`` on
``Graph.tsrc``); grad_e is a gather, zero on padded edges.

Spans (``utils/profiler.py``): ``ell.stack`` around each stack and
``ell.permute`` around the inverse permute, wherever they are called
from; each stack adds its padded slots (n_rows * k over its buckets) to
the counter ``ell.slots`` and its real edges (the meta's ``real``, kept
on the host by the builder) to ``ell.real``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.engine_xla import _binary, gather_rows, take_fill
from dgl1_tpu_torch.utils.profiler import count, span, tracing

__all__ = ["gspmm_ell", "ell_reduce", "ell_stack"]

_SUPPORTED_OPS = ("copy_lhs", "copy_rhs", "add", "sub", "mul", "div")
_PAD = 1 << 29  # gather indices at or above this are padding slots


def ell_reduce(meta: Tuple, ell: dict, op: str, reduce_op: str,
               u, e, num_target: int):
    """One reduce over the given ELL direction; meta = ((k, n_rows), ...),
    ell = {idx, eid, inv_perm}."""
    stacked = ell_stack(meta, ell["idx"], ell["eid"], op, reduce_op, u, e)
    if ell["inv_perm"].shape[0] == 0:
        # Uniform layout (graph._build_ell_uniform): rows already in order.
        return stacked
    with span("ell.permute"):
        return take_fill(stacked, ell["inv_perm"])


def ell_stack(meta: Tuple, idx, eid, op: str, reduce_op: str, u, e):
    """Bucket-sorted per-row reductions without the final inverse
    permute: (n_nonzero_rows, *feat). The hub engine appends its hub block
    to this before one shared permute."""
    with span("ell.stack"):
        real = getattr(meta, "real", None) if tracing() else None
        if real is not None:
            count("ell.slots", sum(k * n_b for k, n_b in meta))
            count("ell.real", real)
        return _stack(meta, idx, eid, op, reduce_op, u, e)


def _stack(meta, idx, eid, op, reduce_op, u, e):
    ident = {"max": float("-inf"), "min": float("inf")}.get(reduce_op, 0.0)
    # sum/mean with copy_lhs or mul: a fill-gather makes padding slots
    # the identity with no masking pass.
    fused_fill = reduce_op in ("sum", "mean") and op in ("copy_lhs", "mul")
    outs = []
    off = 0
    for k, n_b in meta:
        sl = idx[off:off + n_b * k]
        if op != "copy_rhs":
            take = take_fill if fused_fill else gather_rows
            mu = take(u, sl).reshape((n_b, k) + tuple(u.shape[1:]))
        if op != "copy_lhs":
            me = gather_rows(e, eid[off:off + n_b * k]).reshape(
                (n_b, k) + tuple(e.shape[1:]))
        if op == "copy_lhs":
            msg = mu
        elif op == "copy_rhs":
            msg = me
        else:
            msg = _binary(op, mu, me)
        if not fused_fill:
            valid = (sl < _PAD).reshape((n_b, k) + (1,) * (msg.dim() - 2))
            msg = torch.where(valid, msg, torch.full((), ident,
                                                     dtype=msg.dtype,
                                                     device=msg.device))
        if reduce_op in ("sum", "mean"):
            red = msg.sum(dim=1)
        elif reduce_op == "max":
            red = msg.amax(dim=1)
        else:
            red = msg.amin(dim=1)
        outs.append(red)
        off += n_b * k
    if outs:
        return torch.cat(outs, dim=0)
    x = u if u is not None else e
    return x.new_zeros((0,) + tuple(x.shape[1:]))


def _sum_to_shape(x, shape):
    """Sum a broadcast gradient back to (rows, *shape)."""
    want = (x.shape[0],) + tuple(shape)
    while x.dim() > len(want):
        x = x.sum(dim=1)
    axes = tuple(i for i in range(1, x.dim())
                 if want[i] == 1 and x.shape[i] != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x.reshape(want)


def _mask_e(ge, emask):
    """Zero the cotangent rows of padded edges (they never contributed)."""
    if emask is None:
        return ge
    m = emask.reshape((-1,) + (1,) * (ge.dim() - 1))
    return torch.where(m, ge, torch.zeros_like(ge))


class _EllSum(torch.autograd.Function):
    """Sum-reduce over ``ell_dst`` with the reverse-direction backward of
    the reference's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, g, op, u, e):
        ctx.g, ctx.op = g, op
        ctx.save_for_backward(u, e)
        return ell_reduce(g.ell_dst_meta, g.ell_dst, op, "sum", u, e,
                          g.num_dst_nodes())

    @staticmethod
    def backward(ctx, ct):
        g, op = ctx.g, ctx.op
        u, e = ctx.saved_tensors
        ct = ct.contiguous()

        def rev(op2, uu, ee):
            if g.ell_src is not None:
                return ell_reduce(g.ell_src_meta, g.ell_src, op2, "sum", uu,
                                  ee, g.num_src_nodes())
            # Sampled blocks carry no src-direction ELL: K9 over tsrc.
            from dgl1_tpu_torch.ops.engine_tile import _tiled_reduce

            count("layout.read.tile")
            return _tiled_reduce(op2, g.tsrc, uu, ee, g.num_src_nodes())

        def ct_dst():
            return gather_rows(ct, g.dst)

        def ge_of(x):
            return _sum_to_shape(_mask_e(x, g.edge_mask), e.shape[1:])

        gu = ge = None
        need_u = ctx.needs_input_grad[2]
        need_e = ctx.needs_input_grad[3]
        if op in ("copy_lhs", "add", "sub") and need_u:
            gu = _sum_to_shape(rev("copy_lhs", ct, None), u.shape[1:])
        if op == "copy_rhs" and need_e:
            ge = ge_of(ct_dst())
        elif op in ("add", "sub") and need_e:
            gf = ct_dst() if op == "add" else -ct_dst()
            ge = ge_of(gf)
        elif op == "mul":
            if need_u:
                gu = _sum_to_shape(rev("mul", ct, e), u.shape[1:])
            if need_e:
                ge = ge_of(gather_rows(u, g.src) * ct_dst())
        elif op == "div":
            if need_u:
                gu = _sum_to_shape(rev("mul", ct, 1.0 / e), u.shape[1:])
            if need_e:
                ge = ge_of(-gather_rows(u, g.src) * ct_dst() / (e * e))
        return None, None, gu, ge


def gspmm_ell(g: Graph, op: str, reduce_op: str, u, e):
    """ELL-engine g-SpMM; returns None when not covered (no dst ELL, or
    neither a src ELL nor reverse tiles for the backward)."""
    if g.ell_dst is None or (g.ell_src is None and g.tsrc is None):
        return None
    if op not in _SUPPORTED_OPS or reduce_op not in ("sum", "mean"):
        return None
    for data in (u, e):
        if data is not None and not data.is_floating_point():
            return None
    if op != "copy_rhs" and u is None or op != "copy_lhs" and e is None:
        return None
    count("layout.read.ell")
    out = _EllSum.apply(g, op, u, e)
    if reduce_op == "mean":
        deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
        out = out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))
    return out
