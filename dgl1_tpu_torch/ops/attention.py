"""Fused multi-head graph attention on the hub-dense layout.

The port's counterpart of ``dgl1_tpu/ops/attention.py``: the whole GAT
chain (SDDMM logits -> leaky_relu -> edge_softmax -> u_mul_e SpMM)

    out[d] = sum_e softmax_d(leaky_relu(el[src_e] + er[d]))_e * ft[src_e]

without an (E, H) or (E, H*D) tensor, as a ``torch.autograd.Function``
mirroring the reference's ``custom_vjp`` (``_attn_forward`` and ``_bwd``):

* hub rows (the layout's dense and chunked groups) run through K6
  (:func:`attn_kernels.attn_fwd`): num, den and the group-level max of
  el, ``mraw``; the softmax shift is ``mz = leaky(er + mraw)``, exact
  through the monotonic leaky_relu;
* tail rows take the exact per-destination ELL max of el, and their
  numerator and denominator ride one payload ``[p * ft | p]`` through one
  ``copy_rhs`` ELL stack (the reference's default tail payload fusion);
* the extracted self-loop diagonal adds its term node-wise;
* ``out = num / max(den, 1e-30)``;
* backward recomputes p: K7 (:func:`attn_kernels.attn_bwd_src`) gives
  grad_ft, grad_el and per-chunk grad_er partials over the window-major
  layout, K8 (:func:`attn_kernels.ger_reduce`) folds the partials per
  group, and the tail and diagonal mirror the forward. A layout whose
  ``full_bwd`` has no ``gperm`` descriptors takes grad_er from K7's
  g-major mode (:func:`attn_kernels.attn_bwd_grp`) over ``full_fwd``
  instead, as the reference does; the port's builder always emits
  ``gperm``, so only a stripped layout goes that way.

Attention dropout masks the numerator terms with per-(edge, head) masks
hashed from a seed and the original edge id (``attn_kernels.drop_mask``),
the same bits in the kernels, the tail and the diagonal. The bf16 matmul
mode (``ops/precision.py``), read when the forward runs and kept for its
backward, reaches K6 and K7 as the reference's ``dt`` does; the tail, the
diagonal and K8 stay float32.

Spans (``utils/profiler.py``): the forward's ``attn.fwd.hub`` (K6),
``attn.fwd.tail_max`` (the node-level shift), ``attn.fwd.tail``,
``attn.fwd.merge``, ``attn.fwd.diag`` and ``attn.fwd.normalize``; the
backward's ``attn.bwd.hub`` (K7), ``attn.bwd.ger`` (K8), ``attn.bwd.tail``,
``attn.bwd.merge`` and ``attn.bwd.diag``.

Not ported: ``el_in_ft`` lane packing and the backward split/streaming
options (TPU memory-residency tricks). Heads wider than ``MAX_HEAD_DIM``
features decline (the layer then takes the block-dense or composed
path).
"""

from __future__ import annotations

import torch
from torch.nn.functional import leaky_relu

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.hub_format import BLK, SENT
from dgl1_tpu_torch.ops import attn_kernels as AK
from dgl1_tpu_torch.ops.engine_ell import ell_reduce, ell_stack
from dgl1_tpu_torch.ops.engine_xla import take_fill
from dgl1_tpu_torch.ops.precision import get_matmul_precision
from dgl1_tpu_torch.utils.profiler import count, span

__all__ = ["gat_attention", "can_fuse_attention"]

NEG = AK.NEG


def _dleaky(x, slope):
    return torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, slope))


def _merge_t_inv(meta, hub, stacked, hub_block, num_dst: int, fill: float):
    """Tail stack + hub block back to destination order: a concat and pad
    when the layout is an identity (hub-relabeled graphs), else a
    fill-gather through ``t_inv``."""
    if meta.identity_expand:
        small = torch.cat([hub_block, stacked], dim=0)
        return torch.nn.functional.pad(
            small, (0, 0, 0, num_dst - small.shape[0]), value=fill)
    return take_fill(torch.cat([stacked, hub_block], dim=0), hub["t_inv"],
                     fill)


def _attn_forward(g: Graph, slope, drop, h, d, el2, er2, ft2, seed, bf16):
    m = g.hub_dst_meta
    hub = g.hub_dst
    num_dst = g.num_dst_nodes()
    f = h * d
    count("layout.read.hub")
    with span("attn.fwd.hub"):
        er_g = take_fill(er2, hub["hub_ids"])
        num_hub, den_hub, mraw_hub = AK.attn_fwd(
            hub["full_fwd"], el2, er_g, ft2, h, d, slope, drop, seed,
            m.n_groups, bf16)

    # Node-level shift: hub rows take K6's group max, tail rows the exact
    # per-destination ELL max, and the diagonal joins node-wise.
    with span("attn.fwd.tail_max"):
        mstack = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid"],
                           "copy_lhs", "max", el2, None)
        mraw = _merge_t_inv(m, hub, mstack, mraw_hub, num_dst, NEG)
        if m.has_diag:
            diag = hub["diag"][:, None] > 0
            mraw = torch.maximum(mraw, torch.where(
                diag, el2[:num_dst], torch.full_like(mraw, NEG)))
        mz = leaky_relu(mraw + er2, slope)

    # Tail, in compact tail-slot space: one payload [p * mask * ft | p]
    # through one copy_rhs stack.
    with span("attn.fwd.tail"):
        ts, td = hub["tail_src"], hub["tail_dst"]
        el_t = take_fill(el2, ts)
        er_mz = take_fill(torch.cat([er2, mz], dim=1), td)
        z = leaky_relu(el_t + er_mz[:, :h], slope)
        valid = (ts != SENT)[:, None]
        p_t = torch.where(valid, torch.exp(z - er_mz[:, h:]),
                          torch.zeros_like(z))
        p_num_t = p_t * AK.drop_mask(hub["tail_eid"], seed, drop, h) \
            if drop > 0.0 else p_t
        ft_ts = take_fill(ft2, ts)
        prod = (p_num_t[:, :, None] * ft_ts.reshape(-1, h, d)).reshape(-1, f)
        fused = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid_c"],
                          "copy_rhs", "sum", None,
                          torch.cat([prod, p_t], dim=1))
    with span("attn.fwd.merge"):
        num = _merge_t_inv(m, hub, fused[:, :f], num_hub, num_dst, 0.0)
        den = _merge_t_inv(m, hub, fused[:, f:], den_hub, num_dst, 0.0)

    if m.has_diag:
        with span("attn.fwd.diag"):
            z_ii = leaky_relu(el2[:num_dst] + er2, slope)
            p_ii = torch.where(diag, torch.exp(z_ii - mz),
                               torch.zeros_like(mz))
            p_num_ii = p_ii * AK.drop_mask(hub["diag_eid"], seed, drop, h) \
                if drop > 0.0 else p_ii
            num = num + (p_num_ii[:, :, None] * ft2[:num_dst].reshape(
                -1, h, d)).reshape(num_dst, f)
            den = den + p_ii

    # A normal floor: 1e-38 is subnormal and would flush to 0 (0/0 = NaN
    # at zero-in-degree rows).
    with span("attn.fwd.normalize"):
        den_safe = torch.clamp_min(den, 1e-30)
        out = num.reshape(-1, h, d) / den_safe[:, :, None]
    return out, mz, den_safe


def _attn_backward(g: Graph, slope, drop, h, d, el2, er2, ft2, seed, mz,
                   den, out, ct, bf16):
    m = g.hub_dst_meta
    hub = g.hub_dst
    num_src, num_dst = g.num_src_nodes(), g.num_dst_nodes()
    f = h * d
    with span("attn.bwd.hub"):
        ct2 = ct.reshape(-1, f).to(torch.float32).contiguous()
        ct3 = ct2.reshape(-1, h, d)
        # Softmax jacobian row term, node-level: rho = <ct, out> per head.
        rho = (ct3 * out).sum(dim=2)
        lse = mz + torch.log(den)  # den is already floored at 1e-30
        ids = hub["hub_ids"]
        lay = hub["full_bwd"]
        group_rows = (take_fill(er2, ids), take_fill(lse, ids),
                      take_fill(rho, ids))
        ft_ct = (ft2, take_fill(ct2, ids))
        gft_hub, gel_hub, gerp = AK.attn_bwd_src(
            lay, el2, *group_rows, *ft_ct, h, d, slope, drop, seed, m.n_win,
            bf16)
        win_rows = hub["win_mask_full"].repeat_interleave(BLK)[:, None]
        gft_hub = torch.where(win_rows, gft_hub, torch.zeros_like(gft_hub))
        gel_hub = torch.where(win_rows, gel_hub, torch.zeros_like(gel_hub))
    with span("attn.bwd.ger"):
        if "gperm" in lay:
            ger_hub = AK.ger_reduce(lay, gerp, m.n_groups)
        else:  # the reference's route for layouts without gperm descriptors
            ger_hub = AK.attn_bwd_grp(hub["full_fwd"], el2, *group_rows,
                                      *ft_ct, h, d, slope, drop, seed,
                                      m.n_groups, bf16)

    # Tail, compact slot space: one src-side and one dst-side gather.
    with span("attn.bwd.tail"):
        ts, td = hub["tail_src"], hub["tail_dst"]
        el_ts = take_fill(el2, ts)
        packed = take_fill(torch.cat([er2, lse, rho], dim=1), td)
        s_t = el_ts + packed[:, :h]
        valid = (ts != SENT)[:, None]
        # Padding slots gather lse = 0, so exp stays finite before the
        # mask.
        a_t = torch.where(valid, torch.exp(leaky_relu(s_t, slope)
                                           - packed[:, h:2 * h]),
                          torch.zeros_like(s_t))
        ft_ts = take_fill(ft2, ts).reshape(-1, h, d)
        ct_td = take_fill(ct2, td).reshape(-1, h, d)
        g_t = (ft_ts * ct_td).sum(dim=2)
        a_num_t = a_t
        if drop > 0.0:
            m_t = AK.drop_mask(hub["tail_eid"], seed, drop, h)
            a_num_t, g_t = a_t * m_t, g_t * m_t
        q_t = a_t * (g_t - packed[:, 2 * h:]) * _dleaky(s_t, slope)
        rev = {"idx": hub["r_idx"], "eid": hub["r_eid_c"],
               "inv_perm": hub["r_inv"]}
        pay_b = torch.cat([(a_num_t[:, :, None] * ct_td).reshape(-1, f),
                           q_t], dim=1)
        fused_b = ell_reduce(m.tail_meta_src, rev, "copy_rhs", "sum", None,
                             pay_b, num_src)
        ger_stack = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid_c"],
                              "copy_rhs", "sum", None, q_t)

    with span("attn.bwd.merge"):
        gft = gft_hub[:num_src] + fused_b[:, :f]
        gel = gel_hub[:num_src] + fused_b[:, f:]
        ger = _merge_t_inv(m, hub, ger_stack, ger_hub, num_dst, 0.0)

    if m.has_diag:
        with span("attn.bwd.diag"):
            diag = hub["diag"][:, None] > 0
            ft3 = ft2[:num_dst].reshape(-1, h, d)
            z_raw = el2[:num_dst] + er2
            p_ii = torch.where(diag, torch.exp(leaky_relu(z_raw, slope)
                                               - mz),
                               torch.zeros_like(mz))
            a_ii = p_ii / den
            a_num_ii = a_ii
            g_ii = (ct3[:num_dst] * ft3).sum(dim=2)
            if drop > 0.0:
                m_ii = AK.drop_mask(hub["diag_eid"], seed, drop, h)
                a_num_ii, g_ii = a_ii * m_ii, g_ii * m_ii
            q_ii = a_ii * (g_ii - rho) * _dleaky(z_raw, slope)
            # gft and gel are fresh sums: safe to update in place.
            gft[:num_dst] += (a_num_ii[:, :, None] * ct3[:num_dst]).reshape(
                num_dst, f)
            gel[:num_dst] += q_ii
            ger = ger + q_ii
    return gel, ger, gft


class _GatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, slope, drop, h, d, el2, er2, ft2, seed, bf16):
        out, mz, den = _attn_forward(g, slope, drop, h, d, el2, er2, ft2,
                                     seed, bf16)
        ctx.g, ctx.cfg = g, (slope, drop, h, d, bf16)
        ctx.save_for_backward(el2, er2, ft2, seed, mz, den, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        el2, er2, ft2, seed, mz, den, out = ctx.saved_tensors
        slope, drop, h, d, bf16 = ctx.cfg
        gel, ger, gft = _attn_backward(ctx.g, slope, drop, h, d, el2, er2,
                                       ft2, seed, mz, den, out, ct, bf16)
        return None, None, None, None, None, gel, ger, gft, None, None


def can_fuse_attention(g: Graph, head_dim=None) -> bool:
    """Whether the fused attention takes ``g`` (a hub layout with the
    compact tail ids) and, given ``head_dim``, heads that wide: at most
    :data:`attn_kernels.MAX_HEAD_DIM` features."""
    if head_dim is not None and head_dim > AK.MAX_HEAD_DIM:
        return False
    return (g.hub_dst is not None and g.hub_dst_meta is not None
            and "t_eid_c" in g.hub_dst)


def gat_attention(g: Graph, el, er, ft, negative_slope: float = 0.2,
                  attn_drop: float = 0.0, seed=None):
    """``out[d] = sum_e softmax_d(leaky_relu(el[s] + er[d])) * ft[s]``.

    el: (num_src, H) or (num_src, H, 1); er likewise over destinations;
    ft: (num_src, H, D). Returns (num_dst, H, D), or None where the
    reference declines (no hub layout, H > 128, mismatched heads) or D
    passes ``MAX_HEAD_DIM``; callers then take another path.
    ``attn_drop`` > 0 needs ``seed``, an int32 (1,) tensor on ft's device:
    masks are hashed from it and the edge ids inside the kernels.
    """
    if not can_fuse_attention(g, ft.shape[2]):
        return None
    if attn_drop > 0.0:
        if seed is None:
            raise ValueError("attn_drop > 0 requires a seed tensor")
        if "tail_eid" not in g.hub_dst:
            return None
    h, d = ft.shape[1], ft.shape[2]
    if h > BLK:
        return None
    el2 = el.reshape(el.shape[0], -1).to(torch.float32).contiguous()
    er2 = er.reshape(er.shape[0], -1).to(torch.float32).contiguous()
    if el2.shape[1] != h or er2.shape[1] != h:
        return None
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=ft.device)
    seed = seed.to(device=ft.device, dtype=torch.int32).reshape(1)
    ft2 = ft.reshape(ft.shape[0], h * d).to(torch.float32).contiguous()
    out = _GatAttention.apply(g, float(negative_slope), float(attn_drop), h,
                              d, el2, er2, ft2, seed,
                              get_matmul_precision() == "bf16")
    return out.reshape(g.num_dst_nodes(), h, d).to(ft.dtype)
