"""Edge softmax (the port's ``dgl1_tpu/ops/edge_softmax.py``): softmax of
edge logits over each destination's incoming edges, composed as the
reference composes it (max -> sub -> exp -> sum -> div) from g-SpMM and
g-SDDMM, so each step runs on whichever engine serves it. Padded edges
(``g.edge_mask`` False) take -inf in the max and 0 in ``exp``, so their
weight is 0 and a padded graph gives the weights of the exact-size one."""

from __future__ import annotations

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.sddmm import gsddmm
from dgl1_tpu_torch.ops.spmm import gspmm

__all__ = ["edge_softmax"]


def edge_softmax(g: Graph, logits, norm_by: str = "dst"):
    """Softmax of ``logits`` (num_edges, *f) over each destination's
    incoming edges, or with ``norm_by='src'`` over each source's outgoing
    edges (the softmax of the reverse graph, as the reference takes it)."""
    if norm_by == "src":
        return edge_softmax(g.reverse(copy_edata=False), logits,
                            norm_by="dst")
    if norm_by != "dst":
        raise ValueError("norm_by must be 'src' or 'dst'")
    squeeze = logits.dim() == 1
    if squeeze:
        logits = logits[:, None]
    mask = None
    if g.edge_mask is not None:
        mask = g.edge_mask.reshape((-1,) + (1,) * (logits.dim() - 1))
        neg_inf = torch.full_like(logits, float("-inf"))
    # Softmax is shift-invariant, so the max is a constant for autograd
    # (the reference's stop_gradient). Padded logits must not reach it.
    safe = logits if mask is None else torch.where(mask, logits, neg_inf)
    mx = gspmm(g, "copy_rhs", "max", None, safe).detach()
    shifted = gsddmm(g, "sub", logits, mx, lhs_target="e", rhs_target="v")
    if mask is not None:
        # exp(-inf) = 0 on padded edges, and a zero gradient there (a
        # masked exp of a large padded logit would give inf * 0 = NaN).
        shifted = torch.where(mask, shifted, neg_inf)
    ex = torch.exp(shifted)
    denom = gspmm(g, "copy_rhs", "sum", None, ex)
    # 1e-30, not 1e-38: a subnormal floor flushes to zero (0/0 = NaN).
    denom = torch.clamp_min(denom, 1e-30)
    out = gsddmm(g, "div", ex, denom, lhs_target="e", rhs_target="v")
    return out[..., 0] if squeeze else out
