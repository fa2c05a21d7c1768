"""Block-dense GAT attention: exact softmax attention aggregation on the
clustered 128 x 128 adjacency blocks of ``bdense_format.py``, the hub-free
counterpart of the fused hub attention (``ops/attention.py``).

The port's counterpart of ``dgl1_tpu/ops/battention.py``, which is
written in jnp only, so no hand kernel is owed here. Every rb row (128
destinations) computes the softmax statistics over its dense blocks at
once: logits, shifted exponentials and the aggregation live in
(rows, blocks, 128, 128, H) tensors of one chunk of rb rows, never as
per-edge (E, H) tensors. The reference's ``lax.map(vmap(row))`` is a loop
over chunks of rb rows written as a batch dimension, each chunk sized to
about ``_CHUNK_ELEMS`` elements. Leftover (tail) edges compute partials
through the ELL stacks (autograd handles their grads) and the two merge by
the two-way online-softmax combine. The dense tier's backward is
hand-written (``_DensePartials``): rb-major for ger, cb-major for gel and
gft, gathers only.

Multi-edges are exact: the block count enters the softmax as an edge
multiplicity (count * exp(z)). ``CALLS["bdense_gat_attention"]`` counts
the calls that computed (not those that declined).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dgl1_tpu_torch.bdense_format import BLK, BDenseMeta
from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.engine_ell import ell_stack
from dgl1_tpu_torch.ops.engine_xla import gather_rows, take_fill
from dgl1_tpu_torch.utils.profiler import count

__all__ = ["can_fuse_battention", "bdense_gat_attention", "CALLS"]

NEG = -1e30
# Elements of one chunk's (rows, blocks, 128, 128, H) tensors: 2^25
# float32 = 128 MB each, about eight alive at once in the backward.
_CHUNK_ELEMS = 1 << 25

CALLS = {"bdense_gat_attention": 0}


def _leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


def _dleaky(x, slope):
    return torch.where(x >= 0, 1.0, slope)


class _Static(NamedTuple):
    num_src: int
    num_dst: int
    h: int
    d: int
    slope: float
    meta: BDenseMeta


def can_fuse_battention(g: Graph) -> bool:
    """The graph has a block-dense layout with at least one dense block."""
    return g.bdense_meta is not None and g.bdense_meta.n_blocks > 0


def _pad_rows(x, rows):
    """``x`` with zero rows appended up to ``rows`` (``x`` itself when it
    has them: a padded copy of a (2^20, 256) ``ft`` is 1 GB)."""
    if x.shape[0] == rows:
        return x
    return torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 1) + (0, rows - x.shape[0]))


def _chunks(n: int, maxb: int, h: int):
    """Row ranges of at most ``_CHUNK_ELEMS // (maxb*128*128*h)`` rows."""
    step = max(_CHUNK_ELEMS // (maxb * BLK * BLK * h), 1)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def _gather_blocks(ptr, ids, maxb: int, n_blocks: int):
    """(kidx, mask) of shape (rows, maxb): the blocks of rows ``ids`` from
    run pointers ``ptr``, the last block repeated (and masked) past a
    run's end; clamped into [0, n_blocks) for empty trailing runs."""
    start = ptr[ids].long()
    cnt = ptr[ids + 1].long() - start
    j = torch.arange(maxb, device=ptr.device)
    kidx = start[:, None] + torch.minimum(j[None, :],
                                          (cnt - 1).clamp(min=0)[:, None])
    return kidx.clamp(max=n_blocks - 1), j[None, :] < cnt[:, None]


def _counts(a3, kidx, bmask, dtype):
    return a3[kidx].to(dtype) * bmask[:, :, None, None]


def _row_pass(static, bd, el3, ft3, er3):
    """Forward dense partials, rb-major: for every rb row the exact softmax
    stats over its blocks. el3 (n_cb, BLK, H), ft3 (n_cb, BLK, H, D), er3
    (n_rb, BLK, H). Returns m, num, den over the first num_dst rows."""
    meta = static.meta
    maxb, slope = meta.max_row_blocks, static.slope
    a3 = bd["a"].view(-1, BLK, BLK)  # (K, dst, src)
    cb, row_ptr = bd["cb"].long(), bd["row_ptr"]
    ms, nums, dens = [], [], []
    for lo, hi in _chunks(meta.n_rb, maxb, static.h):
        ids = torch.arange(lo, hi, device=row_ptr.device)
        kidx, bmask = _gather_blocks(row_ptr, ids, maxb, meta.n_blocks)
        cnt = _counts(a3, kidx, bmask, el3.dtype)  # (R, b, dst, src)
        cbs = cb[kidx]                        # (R, b)
        el_b = el3[cbs]                       # (R, b, src, H)
        x_b = ft3[cbs]                        # (R, b, src, H, D)
        er_r = er3[ids]                       # (R, dst, H)
        # z[r, b, dst, src, H]
        z = _leaky(el_b[:, :, None] + er_r[:, None, :, None], slope)
        mask = (cnt > 0)[..., None]
        m = torch.where(mask, z, NEG).amax(dim=(1, 3))  # (R, dst, H)
        p = cnt[..., None] * torch.exp(z - m[:, None, :, None])
        p = torch.where(mask, p, 0.0)
        del z
        dens.append(p.sum(dim=(1, 3)))
        nums.append(torch.einsum("rbzsh,rbshd->rzhd", p, x_b))
        ms.append(m)
    n = static.num_dst
    h, d = static.h, static.d
    return (torch.cat(ms).reshape(-1, h)[:n],
            torch.cat(nums).reshape(-1, h, d)[:n],
            torch.cat(dens).reshape(-1, h)[:n])


def _row_bwd(static, bd, el3, ft3, er3, m3, gnum3, gden3):
    """rb-major backward pass: ger (dst-side logit grads)."""
    meta = static.meta
    maxb, slope = meta.max_row_blocks, static.slope
    a3 = bd["a"].view(-1, BLK, BLK)
    cb, row_ptr = bd["cb"].long(), bd["row_ptr"]
    gers = []
    for lo, hi in _chunks(meta.n_rb, maxb, static.h):
        ids = torch.arange(lo, hi, device=row_ptr.device)
        kidx, bmask = _gather_blocks(row_ptr, ids, maxb, meta.n_blocks)
        cnt = _counts(a3, kidx, bmask, el3.dtype)
        cbs = cb[kidx]
        el_b, x_b, er_r = el3[cbs], ft3[cbs], er3[ids]
        raw = el_b[:, :, None] + er_r[:, None, :, None]  # (R,b,dst,src,H)
        p = cnt[..., None] * torch.exp(_leaky(raw, slope)
                                       - m3[ids][:, None, :, None])
        p = torch.where((cnt > 0)[..., None], p, 0.0)
        ctx = torch.einsum("rzhd,rbshd->rbzsh", gnum3[ids], x_b)
        gz = p * (ctx + gden3[ids][:, None, :, None])
        del p, ctx
        gers.append((gz * _dleaky(raw, slope)).sum(dim=(1, 3)))
    return torch.cat(gers).reshape(-1, static.h)[: static.num_dst]


def _col_bwd(static, bd, el3, ft3, er3, m3, gnum3, gden3):
    """cb-major backward pass: gel and gft (src-side grads)."""
    meta = static.meta
    maxb, slope = meta.max_col_blocks, static.slope
    ab3 = bd["ab"].view(-1, BLK, BLK)  # cb-sorted, (dst, src)
    rbb, col_ptr = bd["rbb"].long(), bd["col_ptr"]
    gels, gxs = [], []
    for lo, hi in _chunks(meta.n_cb, maxb, static.h):
        cc = torch.arange(lo, hi, device=col_ptr.device)
        kidx, bmask = _gather_blocks(col_ptr, cc, maxb, meta.n_blocks)
        cnt = _counts(ab3, kidx, bmask, el3.dtype)  # (R, b, dst, src)
        rbs = rbb[kidx]                       # (R, b)
        er_b, m_b = er3[rbs], m3[rbs]         # (R, b, dst, H)
        gnum_b, gden_b = gnum3[rbs], gden3[rbs]
        el_c, x_c = el3[cc], ft3[cc]          # (R, src, H), (R, src, H, D)
        raw = el_c[:, None, None] + er_b[:, :, :, None]  # (R,b,dst,src,H)
        p = cnt[..., None] * torch.exp(_leaky(raw, slope)
                                       - m_b[:, :, :, None])
        p = torch.where((cnt > 0)[..., None], p, 0.0)
        ctx = torch.einsum("rbzhd,rshd->rbzsh", gnum_b, x_c)
        gz = p * (ctx + gden_b[:, :, :, None])
        del ctx
        gels.append((gz * _dleaky(raw, slope)).sum(dim=(1, 2)))
        del gz, raw
        gxs.append(torch.einsum("rbzsh,rbzhd->rshd", p, gnum_b))
    n = static.num_src
    return (torch.cat(gels).reshape(-1, static.h)[:n],
            torch.cat(gxs).reshape(-1, static.h, static.d)[:n])


def _padded(static, el2, er2, ft3):
    m = static.meta
    h, d = static.h, static.d
    return (_pad_rows(el2, m.n_cb * BLK).reshape(m.n_cb, BLK, h),
            _pad_rows(ft3, m.n_cb * BLK).reshape(m.n_cb, BLK, h, d),
            _pad_rows(er2, m.n_rb * BLK).reshape(m.n_rb, BLK, h))


class _DensePartials(torch.autograd.Function):
    """(m, num, den) softmax partials of the dense tier per destination.
    ``m`` is a shift constant (not differentiable, as a softmax shift):
    the backward routes the cotangents of num and den only. Saves the
    inputs and ``m``, which the backward re-walks the blocks with."""

    @staticmethod
    def forward(ctx, static, bd, el2, er2, ft3):
        ctx.static, ctx.bd = static, bd
        m, num, den = _row_pass(static, bd, *_padded(static, el2, er2, ft3))
        ctx.save_for_backward(el2, er2, ft3, m)
        ctx.mark_non_differentiable(m)
        return m, num, den

    @staticmethod
    def backward(ctx, _gm, gnum, gden):
        static, bd = ctx.static, ctx.bd
        el2, er2, ft3, m = ctx.saved_tensors
        meta = static.meta
        rows = meta.n_rb * BLK
        el3, ft3p, er3 = _padded(static, el2, er2, ft3)
        m3 = _pad_rows(m, rows).reshape(meta.n_rb, BLK, static.h)
        gnum3 = _pad_rows(gnum.to(el2.dtype), rows).reshape(
            meta.n_rb, BLK, static.h, static.d)
        gden3 = _pad_rows(gden.to(el2.dtype), rows).reshape(
            meta.n_rb, BLK, static.h)
        ger = _row_bwd(static, bd, el3, ft3p, er3, m3, gnum3, gden3)
        gel, gft = _col_bwd(static, bd, el3, ft3p, er3, m3, gnum3, gden3)
        return (None, None, gel.to(el2.dtype), ger.to(er2.dtype),
                gft.to(ft3.dtype))


def _tail_partials(static, bd, el2, er2, ft3):
    """Exact per-destination softmax partials over the tail edges (plain
    differentiable torch; autograd handles their grads)."""
    meta = static.meta
    # Per-dst max of el over tail in-edges; leaky is monotonic so
    # m_t = leaky(max_el + er).
    mstack = ell_stack(meta.tail_meta_dst, bd["t_idx"], bd["t_eid"],
                       "copy_lhs", "max", el2, None)
    m_el = take_fill(mstack, bd["t_inv"], NEG)[: static.num_dst]
    m_t = _leaky(m_el + er2, static.slope)
    # The shift is a constant for autograd everywhere it appears (its
    # gradient cancels only within a pure num/den quotient and would leak
    # into er through the cross-tier merge).
    m_t = torch.where(m_el <= NEG / 2, NEG, m_t).detach()
    z = _leaky(gather_rows(el2, bd["t_src"]) + gather_rows(er2, bd["t_dst"]),
               static.slope)
    p = torch.exp(z - gather_rows(m_t, bd["t_dst"]))  # (n_tail, H)
    num_stack = ell_stack(meta.tail_meta_dst, bd["t_idx"], bd["t_eid"],
                          "mul", "sum", ft3, p[:, :, None])
    den_stack = ell_stack(meta.tail_meta_dst, bd["t_idx"], bd["t_eid"],
                          "copy_rhs", "sum", None, p)
    num_t = take_fill(num_stack, bd["t_inv"])[: static.num_dst]
    den_t = take_fill(den_stack, bd["t_inv"])[: static.num_dst]
    return m_t, num_t, den_t


def bdense_gat_attention(g: Graph, el, er, ft, negative_slope: float = 0.2):
    """Fused attention on block-dense graphs:
    ``out[d] = sum_e softmax_d(leaky_relu(el[s] + er[d])) * ft[s]``.

    el: (num_src, H) or (num_src, H, 1); er likewise over dst; ft:
    (num_src, H, D). Returns (num_dst, H, D), or None when the graph has
    no block-dense layout with a dense tier (the caller falls back)."""
    if not can_fuse_battention(g):
        return None
    CALLS["bdense_gat_attention"] += 1
    count("layout.read.bdense")
    el2 = el.reshape(el.shape[0], -1)
    er2 = er.reshape(er.shape[0], -1)
    h, d = el2.shape[1], ft.shape[-1]
    static = _Static(num_src=g.num_src_nodes(), num_dst=g.num_dst_nodes(),
                     h=h, d=d, slope=float(negative_slope),
                     meta=g.bdense_meta)
    ft3 = ft.reshape(-1, h, d)
    m_d, num_d, den_d = _DensePartials.apply(static, g.bdense, el2, er2,
                                             ft3)
    if g.bdense["t_src"].shape[0] == 0:  # fully covered: no tail tier
        m_t = torch.full_like(m_d, NEG)
        num_t = torch.zeros_like(num_d)
        den_t = torch.zeros_like(den_d)
    else:
        m_t, num_t, den_t = _tail_partials(static, g.bdense, el2, er2, ft3)

    # Two-way online-softmax merge (the shifts are constants; the exp
    # factors still scale the num/den cotangents).
    mm = torch.maximum(m_d, m_t)
    mm_safe = torch.where(mm <= NEG / 2, 0.0, mm)
    sd = torch.where(m_d <= NEG / 2, 0.0, torch.exp(m_d - mm_safe))
    st = torch.where(m_t <= NEG / 2, 0.0, torch.exp(m_t - mm_safe))
    num = num_d * sd[:, :, None] + num_t * st[:, :, None]
    den = den_d * sd + den_t * st
    # Double-where: zero-in-degree rows divide by 1, not a tiny floor
    # (whose backward squares the reciprocal and overflows to inf, which
    # the masking then turns into NaN).
    has = den > 0
    den_safe = torch.where(has, den, 1.0)
    out = torch.where(has[:, :, None], num / den_safe[:, :, None], 0.0)
    return out.to(ft.dtype)
