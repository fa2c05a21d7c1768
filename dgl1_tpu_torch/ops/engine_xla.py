"""The oracle engine for g-SpMM and g-SDDMM: gathers + ``index_add``
with autograd.

The port's counterpart of ``dgl1_tpu/ops/engine_xla.py`` (the module keeps
the reference's name). g-SpMM gathers per-edge messages in CSC
(dst-sorted) order and reduces them per destination; g-SDDMM gathers node
data onto edges in user edge order. Every other engine is tested against
this one.
"""

from __future__ import annotations

from typing import Optional

import torch

from dgl1_tpu_torch.graph import Graph

__all__ = ["gspmm_xla", "gsddmm_xla", "SPMM_OPS", "SPMM_REDUCES",
           "SDDMM_OPS", "gather_rows", "take_fill"]

SPMM_OPS = ("add", "sub", "mul", "div", "copy_lhs", "copy_rhs")
SPMM_REDUCES = ("sum", "max", "min", "mean", "prod")
SDDMM_OPS = ("add", "sub", "mul", "div", "dot", "copy_lhs", "copy_rhs")


def _binary(op: str, lhs, rhs):
    if op == "add":
        return lhs + rhs
    if op == "sub":
        return lhs - rhs
    if op == "mul":
        return lhs * rhs
    if op == "div":
        return lhs / rhs
    if op == "dot":
        return (lhs * rhs).sum(dim=-1, keepdim=True)
    raise ValueError(f"unknown binary op {op!r}")


def gather_rows(x, idx):
    """``jnp.take(x, idx, axis=0, mode="clip")``: sentinel (out-of-range)
    indices clip to the last row; their values are never consumed."""
    return x.index_select(0, idx.long().clamp(0, x.shape[0] - 1))


def take_fill(x, idx, fill: float = 0.0):
    """``jnp.take(x, idx, axis=0, mode="fill", fill_value=fill)``: rows for
    indices outside ``[0, len(x))`` are ``fill``. ``index_select`` has no
    fill mode, so the index is clamped and the result masked."""
    idx = idx.long()
    valid = (idx >= 0) & (idx < x.shape[0])
    if x.shape[0] == 0:
        return x.new_full((idx.shape[0],) + tuple(x.shape[1:]), fill)
    rows = x.index_select(0, idx.clamp(0, x.shape[0] - 1))
    mask = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, rows, torch.full((), fill, dtype=x.dtype,
                                              device=x.device))


def gspmm_xla(g: Graph, op: str, reduce_op: str, u: Optional[torch.Tensor],
              e: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-edge ``op(u[src], e)``, then ``reduce_op`` per destination.
    ``u``: (num_src, *feat) or None; ``e``: (num_edges, *feat) in
    user edge order or None. Returns (num_dst, *feat_out)."""
    if op not in SPMM_OPS:
        raise ValueError(f"gspmm op {op!r} not in {SPMM_OPS}")
    if reduce_op not in SPMM_REDUCES:
        raise ValueError(f"gspmm reduce {reduce_op!r} not in {SPMM_REDUCES}")
    num_dst = g.num_dst_nodes()
    # Padded edges (sampled blocks) sit past the real ones in CSC order.
    n_e = g.num_edges()
    seg = g.csc_dst[:n_e].long()
    csc_src, csc_eid = g.csc_src[:n_e], g.csc_eid[:n_e]

    if op == "copy_lhs":
        if u is None:
            raise ValueError("copy_lhs requires u")
        msg = gather_rows(u, csc_src)
    elif op == "copy_rhs":
        if e is None:
            raise ValueError("copy_rhs requires e")
        msg = gather_rows(e, csc_eid)
    else:
        if u is None or e is None:
            raise ValueError(f"op {op!r} requires both u and e")
        msg = _binary(op, gather_rows(u, csc_src), gather_rows(e, csc_eid))

    shape = (num_dst,) + tuple(msg.shape[1:])
    if reduce_op in ("sum", "mean"):
        out = msg.new_zeros(shape).index_add(0, seg, msg)
        if reduce_op == "mean":
            deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
            out = out / deg.reshape((num_dst,) + (1,) * (out.dim() - 1))
        return out
    idx = seg.reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
    red = {"prod": "prod", "max": "amax", "min": "amin"}[reduce_op]
    out = msg.new_zeros(shape).scatter_reduce(
        0, idx, msg, reduce=red, include_self=False)
    if reduce_op == "prod":
        # Empty segments: the identity, as segment_prod gives.
        empty = (g.in_degrees() == 0).reshape(
            (num_dst,) + (1,) * (out.dim() - 1))
        return torch.where(empty, torch.ones_like(out), out)
    # Empty max/min rows are 0, as in the reference.
    return out


def gsddmm_xla(g: Graph, op: str, lhs: Optional[torch.Tensor],
               rhs: Optional[torch.Tensor], lhs_target: str = "u",
               rhs_target: str = "v") -> torch.Tensor:
    """Per-edge binary ``op`` between data on any two of source nodes
    (``'u'``), destination nodes (``'v'``) and edges (``'e'``). Returns
    (num_edges, *feat_out) in user edge order."""
    if op not in SDDMM_OPS:
        raise ValueError(f"gsddmm op {op!r} not in {SDDMM_OPS}")

    def fetch(data, target):
        if data is None:
            raise ValueError(f"gsddmm op {op!r} missing operand for "
                             f"{target!r}")
        if target == "u":
            return gather_rows(data, g.src)
        if target == "v":
            return gather_rows(data, g.dst)
        if target == "e":
            return data
        raise ValueError(f"unknown target {target!r}")

    if op == "copy_lhs":
        return fetch(lhs, lhs_target)
    if op == "copy_rhs":
        return fetch(rhs, rhs_target)
    return _binary(op, fetch(lhs, lhs_target), fetch(rhs, rhs_target))
