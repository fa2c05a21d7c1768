"""Segment ops (the port's ``dgl1_tpu/ops/segment.py``:
``segment_ids_from_lengths``, ``segment_reduce``, ``segment_softmax``,
``segment_mm``, ``gather_mm``).

``segment_reduce`` and ``segment_softmax`` are ``index_add`` and
``scatter_reduce`` over the segment ids, as the reference's are XLA
segment ops.

The reference's ``segment_mm`` is ``jax.lax.ragged_dot`` and its
``gather_mm`` a one-hot einsum, both XLA with no Pallas kernel, so the
port runs them as plain ``torch.matmul`` calls, one per relation, and no
hand kernel is owed. Neither builds a per-row (N, K, M) weight tensor.
"""

from __future__ import annotations

import torch

__all__ = ["segment_ids_from_lengths", "segment_reduce", "segment_softmax",
           "segment_mm", "gather_mm"]


def _lengths(seglen):
    """Host ints of the segment lengths (one sync for a device tensor)."""
    if isinstance(seglen, torch.Tensor):
        return [int(x) for x in seglen.tolist()]
    return [int(x) for x in seglen]


def segment_ids_from_lengths(seglen, total: int):
    """(total,) int32 segment id of every element for segments of lengths
    ``seglen`` (S,); elements past the last segment get id S."""
    seglen = torch.as_tensor(seglen)
    offsets = torch.cumsum(seglen, 0)
    pos = torch.arange(total, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets, pos, right=True).to(torch.int32)


def _seg_ids(seglen, value):
    seglen = torch.as_tensor(seglen, device=value.device)
    return seglen, segment_ids_from_lengths(seglen, value.shape[0]).long()


def _scatter(value, ids, num_segments: int, reduce: str, init: float):
    out = value.new_full((num_segments,) + tuple(value.shape[1:]), init)
    idx = ids.reshape((-1,) + (1,) * (value.dim() - 1)).expand_as(value)
    return out.scatter_reduce(0, idx, value, reduce, include_self=False)


def segment_reduce(seglen, value, reducer: str = "sum"):
    """Reduce ``value`` (total, ...) within contiguous segments of lengths
    ``seglen`` (S,) (``dgl.ops.segment_reduce``): sum, mean, max, min or
    prod; an empty segment gives 0 (prod: 1)."""
    seglen, ids = _seg_ids(seglen, value)
    n = seglen.shape[0]
    shape = (n,) + (1,) * (value.dim() - 1)
    if reducer in ("sum", "mean"):
        out = value.new_zeros((n,) + tuple(value.shape[1:])).index_add(
            0, ids, value)
        if reducer == "mean":
            out = out / seglen.clamp_min(1).to(out.dtype).reshape(shape)
        return out
    if reducer == "prod":
        return _scatter(value, ids, n, "prod", 1.0)
    if reducer not in ("max", "min"):
        raise ValueError(f"unknown reducer {reducer!r}")
    # +-inf, not 0: amax/amin's backward counts an initial value equal to
    # the result among the ties (see engine_xla.gspmm_xla).
    out = _scatter(value, ids, n, "amax" if reducer == "max" else "amin",
                   float("-inf") if reducer == "max" else float("inf"))
    return torch.where((seglen == 0).reshape(shape), torch.zeros_like(out),
                       out)


def segment_softmax(seglen, value):
    """Softmax of ``value`` within contiguous segments of lengths
    ``seglen``, shifted by each segment's max (a constant for autograd)."""
    seglen, ids = _seg_ids(seglen, value)
    n = seglen.shape[0]
    mx = _scatter(value.detach(), ids, n, "amax", float("-inf"))
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(value - mx.index_select(0, ids))
    s = ex.new_zeros((n,) + tuple(ex.shape[1:])).index_add(0, ids, ex)
    return ex / s.clamp_min(1e-38).index_select(0, ids)


class _SegmentMM(torch.autograd.Function):
    """Grouped GEMM whose forward and backward write each group's rows
    into their slice of one output. (Slicing under autograd would give
    every group's input gradient as a zero-filled full-size tensor and
    sum R of them.)"""

    @staticmethod
    def forward(ctx, a, b, lengths):
        ctx.save_for_backward(a, b)
        ctx.lengths = lengths
        out = a.new_empty((a.shape[0], b.shape[-1]))
        off = 0
        for r, n in enumerate(lengths):
            torch.matmul(a[off:off + n], b[r], out=out[off:off + n])
            off += n
        out[off:].zero_()
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.contiguous()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.empty_like(a)
        if ctx.needs_input_grad[1]:
            gb = torch.empty_like(b)
        off = 0
        for r, n in enumerate(ctx.lengths):
            g_r = grad[off:off + n]
            if ga is not None:
                torch.matmul(g_r, b[r].t(), out=ga[off:off + n])
            if gb is not None:
                torch.matmul(a[off:off + n].t(), g_r, out=gb[r])
            off += n
        if ga is not None:
            ga[off:].zero_()
        if gb is not None:
            gb[len(ctx.lengths):].zero_()
        return ga, gb, None


def segment_mm(a, b, seglen_a):
    """Grouped GEMM: rows of ``a`` (N, K) in R contiguous groups of
    lengths ``seglen_a`` (R,); group r times ``b[r]`` (K, M). Rows past
    the last group are zero, as ``ragged_dot`` gives them."""
    lengths = tuple(_lengths(seglen_a))
    if sum(lengths) > a.shape[0] or len(lengths) > b.shape[0]:
        raise ValueError("segment lengths exceed the rows of a or the "
                         "groups of b")
    return _SegmentMM.apply(a, b, lengths)


def gather_mm(a, b, idx_b):
    """``out[i] = a[i] @ b[idx_b[i]]`` for ``a`` (N, K), ``b`` (R, K, M);
    rows whose index is outside [0, R) are zero, as the reference's
    one-hot gives them. One matmul per relation over its rows."""
    idx = torch.as_tensor(idx_b, device=a.device).long()
    out = a.new_zeros((a.shape[0], b.shape[-1]))
    for r in range(b.shape[0]):
        rows = (idx == r).nonzero().squeeze(1)
        out.index_copy_(0, rows, a.index_select(0, rows) @ b[r])
    return out
