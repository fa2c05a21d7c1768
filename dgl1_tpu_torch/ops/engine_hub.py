"""Hub-dense HYB engine for g-SpMM: ``copy_lhs``, ``mul`` (u_mul_e) and
``copy_rhs`` (copy_e) with ``sum``/``mean``.

The port's counterpart of ``dgl1_tpu/ops/engine_hub.py`` (``_hub_forward``
and ``_bwd``), as a ``torch.autograd.Function``. The layout
(``hub_format.py``) has three tiers:

* **dense**: the static count matrix ``C``; copy_lhs forward ``C^T @ U``
  (K1), grad_u ``C @ ct`` (K4a with the tail fused in, or K4b);
* **chunked**: per 1024-slot chunk a row gather and scatter-add (K2),
  copy_lhs forward over ``part_fwd`` and grad_u over ``part_bwd`` (window
  mask applied after the kernel);
* **ELL tail**: ``engine_ell.ell_stack``.

The weighted ops skip the count matrix, as the reference does: every hub
edge goes through the full layout, forward by K2 in mul or rhs mode over
``full_fwd``, grad_u of mul by K2 mul over ``full_bwd``, grad_e by K5
over ``full_fwd`` gathered to edge order through ``edge_to_fslot``, plus
the tail's per-edge dot (mul) or gather (rhs) and the diagonal. Per-edge
weights are a scalar per edge or one per head, ``(H, 1, ...)`` against
``u`` of ``(H, ...)`` (``_weight_heads``).

The forward merges ``[tail stack | hub block]`` back to destination order
by the identity concat (hub-relabeled graphs), the descriptor expand (K3)
or a fill-gather through ``t_inv``, under the reference's gates, and adds
the extracted self-loop diagonal: K3 adds it in its output pass, the
other two merges in torch. The kernels live in ``hub_kernels.py``:
on CPU tensors they run their plain torch versions. They compute in
float32 with float32 accumulation; under the bf16 matmul mode
(``ops/precision.py``, read when the forward runs and kept for its
backward) K1, K2, K4 and K5 round what the reference casts to bf16, as
the reference passes ``dt`` to them; K3, the ELL tail and the diagonal
stay float32.
"""

from __future__ import annotations

import math

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.hub_format import BLK, EXPAND_PACK, HubMeta
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops.engine_ell import ell_reduce, ell_stack
from dgl1_tpu_torch.ops.engine_xla import take_fill
from dgl1_tpu_torch.ops.precision import get_matmul_precision
from dgl1_tpu_torch.utils.profiler import count

__all__ = ["gspmm_hub"]

# The reference's gates, kept so both engines take the same branches:
# the expand kernel when the padded merged block is at most 4 MB, the
# fused backward when the padded tail-src stack is at most 12 MB.
_EXPAND_VMEM_BYTES = 4 * 1024 * 1024
_BWD_TAIL_VMEM_BYTES = 12 * 1024 * 1024


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _use_expand(m: HubMeta, hub, n_merged: int) -> bool:
    m_pad = _round_up(n_merged, 32)
    return (m.n_tail_rows + m.n_groups * BLK < EXPAND_PACK
            and hub["x_desc"].shape[0] > 0
            and m_pad * BLK * 4 <= _EXPAND_VMEM_BYTES)


def _use_fused_bwd(m: HubMeta, hub) -> bool:
    n_src_rows = int(sum(n for _, n in m.tail_meta_src))
    m_tail_pad = _round_up(max(n_src_rows, 1), 32)
    return (m.n_dense > 0 and 0 < n_src_rows < EXPAND_PACK
            and hub["gb_desc"].shape[0] > 0
            and m_tail_pad * BLK * 4 <= _BWD_TAIL_VMEM_BYTES)


def _ell_operands(op, x2, e2, he: int, rep: int):
    """(u, e) for ``ell_stack``/``ell_reduce`` with per-head shapes, so a
    per-edge weight broadcasts over its head's features."""
    if op == "copy_lhs":
        return x2, None
    if op == "copy_rhs":
        return None, e2
    return x2.reshape(x2.shape[0], he, rep), e2.reshape(e2.shape[0], he, 1)


def _hub_block(g: Graph, op, u2, e2, he: int, rep: int, bf16: bool):
    """The hub rows (n_groups*128, width) of the sum, in slot order."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    if op != "copy_lhs":
        mode = "mul" if op == "mul" else "rhs"
        return K.chunk_weighted(mode, hub["full_fwd"], e2,
                                u2 if op == "mul" else None, m.n_groups,
                                he, rep, bf16)
    parts = []
    if m.n_dense:
        parts.append(K.dense_fwd(hub["dense_c"], u2, bf16))
    if m.n_groups > m.n_dense:
        parts.append(K.chunk_sum(hub["part_fwd"], u2,
                                 m.n_groups - m.n_dense, bf16))
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def _diag_weight(g: Graph, e2):
    """(num_dst, he) weights of the extracted self-loop edges (zero on
    nodes without one)."""
    hub = g.hub_dst
    return take_fill(e2, hub["diag_eid"]) * hub["diag"][:, None]


def _diag_term(g: Graph, op, u2, e2, he: int, rep: int):
    """The extracted single self-loop edges' share of the sum."""
    nd = g.num_dst_nodes()
    if op == "copy_lhs":
        return g.hub_dst["diag"][:, None] * u2[:nd]
    ed = _diag_weight(g, e2)
    if op == "copy_rhs":
        return ed
    return (u2[:nd].reshape(nd, he, rep) * ed[:, :, None]).reshape(nd, -1)


def _diag_operands(g: Graph, op, u2, e2):
    """(diag_w, diag_u) of K3's epilogue: the same term as
    :func:`_diag_term`, weight (num_dst, he) times u2's rows (copy_lhs,
    mul) or the weight alone (copy_rhs)."""
    if op == "copy_lhs":
        return g.hub_dst["diag"][:, None], u2
    ed = _diag_weight(g, e2)
    return (ed, None) if op == "copy_rhs" else (ed, u2)


def _hub_forward(g: Graph, op, u2, e2, he: int, rep: int, bf16: bool):
    """(num_dst, width) sum over in-edges of copy_lhs (width f of u2),
    u_mul_e (f = he*rep) or copy_e (he); u2 (num_src, f) and e2 (E, he)
    are f32."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    num_dst = g.num_dst_nodes()
    hub_block = _hub_block(g, op, u2, e2, he, rep, bf16)
    stacked = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid"], op,
                        "sum", *_ell_operands(op, u2, e2, he, rep))
    stacked = stacked.reshape(stacked.shape[0], hub_block.shape[1])
    if m.identity_expand:
        # Destinations are [hub slots | tail stack | zero-degree rows].
        small = torch.cat([hub_block, stacked], dim=0)
        out = torch.nn.functional.pad(small,
                                      (0, 0, 0, num_dst - small.shape[0]))
    else:
        merged = torch.cat([stacked, hub_block], dim=0)
        if _use_expand(m, hub, merged.shape[0]):
            # K3 adds the diagonal in its output pass.
            diag = _diag_operands(g, op, u2, e2) if m.has_diag else ()
            return K.expand(merged, hub["x_starts"], hub["x_desc"], num_dst,
                            *diag)
        out = take_fill(merged, hub["t_inv"])
    if m.has_diag:
        out = out + _diag_term(g, op, u2, e2, he, rep)
    return out


def _chunk_grad(g: Graph, ct_part, bf16: bool):
    """Chunked-tier grad_u over the window-major layout, rows of windows
    no chunk writes masked to zero (the reference's win_mask_part)."""
    m: HubMeta = g.hub_dst_meta
    out = K.chunk_sum(g.hub_dst["part_bwd"], ct_part, m.n_win, bf16)
    win_rows = g.hub_dst["win_mask_part"].repeat_interleave(BLK)
    out = torch.where(win_rows[:, None], out, torch.zeros_like(out))
    return out[: g.num_src_nodes()]


def _hub_backward(g: Graph, ct2, bf16: bool):
    """grad_u (num_src, f) of the copy_lhs sum for the cotangent ct2
    (num_dst, f)."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    num_src, num_dst = g.num_src_nodes(), g.num_dst_nodes()
    kd = m.n_dense * BLK
    ct_hubs = take_fill(ct2, hub["hub_ids"])
    if _use_fused_bwd(m, hub):
        tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                         "copy_lhs", "sum", ct2, None)
        gu = K.dense_bwd_fused(hub["dense_c"], ct_hubs[:kd].contiguous(),
                               tail, hub["gb_starts"], hub["gb_desc"],
                               num_src, bf16)
        if m.n_groups > m.n_dense:
            gu = gu + _chunk_grad(g, ct_hubs[kd:].contiguous(), bf16)
    else:
        gu = ell_reduce(m.tail_meta_src, _tail_src_ell(hub), "copy_lhs",
                        "sum", ct2, None, num_src)
        if m.n_dense:
            gu = gu + K.dense_bwd(hub["dense_c"], ct_hubs[:kd].contiguous(),
                                  num_src, bf16)
        if m.n_groups > m.n_dense:
            gu = gu + _chunk_grad(g, ct_hubs[kd:].contiguous(), bf16)
    if m.has_diag:
        gu[:num_dst] += hub["diag"][:, None] * ct2[:num_dst]  # gu is fresh
    return gu


def _tail_src_ell(hub):
    return {"idx": hub["r_idx"], "eid": hub["r_eid"],
            "inv_perm": hub["r_inv"]}


def _weighted_grad_u(g: Graph, ct2, ct_hubs, e2, he: int, rep: int,
                     bf16: bool):
    """grad_u (num_src, f) of u_mul_e: K2 mul over the window-major full
    layout, the tail's reverse reduce and the diagonal. Rows of windows no
    chunk writes stay zero (the kernel's output starts zeroed), so the
    reference's ``win_mask_full`` changes nothing here."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    num_src, nd = g.num_src_nodes(), g.num_dst_nodes()
    gu = K.chunk_weighted("mul", hub["full_bwd"], e2, ct_hubs, m.n_win, he,
                          rep, bf16)[:num_src]
    tail = ell_reduce(m.tail_meta_src, _tail_src_ell(hub), "mul", "sum",
                      *_ell_operands("mul", ct2, e2, he, rep), num_src)
    gu = gu + tail.reshape(num_src, -1)
    if m.has_diag:
        ct3 = ct2[:nd].reshape(nd, he, rep)
        gu[:nd] += (ct3 * _diag_weight(g, e2)[:, :, None]).reshape(nd, -1)
    return gu


def _weighted_grad_e(g: Graph, op, u2, ct2, ct_hubs, he: int, rep: int,
                     bf16: bool):
    """grad_e (E, he) of u_mul_e or copy_e: K5 on the hub slots, gathered
    to edge order through ``edge_to_fslot`` (zero for tail, diagonal and
    padded edges), plus the tail's per-edge dot (mul) or gather (rhs) and
    the diagonal, each added at its own edge ids. The reference gathers
    those two through ``edge_to_tslot`` and ``diag_edge_dst``, two more
    passes over every edge; the compact adds give the same sums (padding
    entries of the tail and nodes without a self-loop add zero)."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    nd = g.num_dst_nodes()
    mul = op == "mul"
    ge_hub = K.edge_grad("mul" if mul else "rhs", hub["full_fwd"],
                         u2 if mul else None, ct_hubs, he, rep, bf16)
    if mul:
        us = take_fill(u2.reshape(-1, he, rep), hub["tail_src"])
        cs = take_fill(ct2.reshape(-1, he, rep), hub["tail_dst"])
        ge_tail = (us * cs).sum(2)
    else:
        ge_tail = take_fill(ct2, hub["tail_dst"])
    ge = take_fill(ge_hub, hub["edge_to_fslot"])
    ge.index_add_(0, hub["tail_eid"].long(), ge_tail)
    if m.has_diag:
        if mul:
            ge_diag = (u2[:nd].reshape(nd, he, rep)
                       * ct2[:nd].reshape(nd, he, rep)).sum(2)
        else:
            ge_diag = ct2[:nd]
        ge.index_add_(0, hub["diag_eid"].long(),
                      ge_diag * hub["diag"][:, None])
    return ge


def _flat32(x, cols):
    return x.reshape(x.shape[0], cols).to(torch.float32).contiguous()


class _HubSum(torch.autograd.Function):
    """Sum over in-edges of copy_lhs, u_mul_e or copy_e on the hub layout,
    with the reference's backward (``_bwd``); gradients that
    ``needs_input_grad`` does not ask for are skipped. ``bf16``: the
    matmul mode, for the forward and its backward."""

    @staticmethod
    def forward(ctx, g, op, he, rep, u, e, bf16):
        ctx.g, ctx.op, ctx.he, ctx.rep, ctx.bf16 = g, op, he, rep, bf16
        ctx.u_meta = None if u is None else (u.shape, u.dtype)
        ctx.e_meta = None if e is None else (e.shape, e.dtype)
        u2 = None if u is None else _flat32(u, -1)
        e2 = None if e is None else _flat32(e, he)
        if op == "mul":
            # grad_u of u_mul_e needs e, its grad_e needs u; copy_lhs and
            # copy_e need neither, so their inputs are not kept alive.
            need_u, need_e = ctx.needs_input_grad[4], ctx.needs_input_grad[5]
            ctx.save_for_backward(u2 if need_e else None,
                                  e2 if need_u else None)
        out = _hub_forward(g, op, u2, e2, he, rep, bf16)
        x = e if op == "copy_rhs" else u
        return out.to(x.dtype).reshape((g.num_dst_nodes(),)
                                       + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        g, op, he, rep, bf16 = ctx.g, ctx.op, ctx.he, ctx.rep, ctx.bf16
        u2, e2 = ctx.saved_tensors if op == "mul" else (None, None)
        ct2 = _flat32(ct, -1)
        need_u, need_e = ctx.needs_input_grad[4], ctx.needs_input_grad[5]
        gu = ge = None
        if op == "copy_lhs":
            if need_u:
                gu = _hub_backward(g, ct2, bf16)
        else:
            ct_hubs = take_fill(ct2, g.hub_dst["hub_ids"])
            if op == "mul" and need_u:
                gu = _weighted_grad_u(g, ct2, ct_hubs, e2, he, rep, bf16)
            if need_e:
                ge = _weighted_grad_e(g, op, u2, ct2, ct_hubs, he, rep,
                                      bf16)
        if gu is not None:
            gu = gu.to(ctx.u_meta[1]).reshape(ctx.u_meta[0])
        if ge is not None:
            ge = ge.to(ctx.e_meta[1]).reshape(ctx.e_meta[0])
        return None, None, None, None, gu, ge, None


def _weight_heads(u_feat, e_feat):
    """(he, rep) of a supported weight broadcast, or None: a scalar per
    edge ((1,)*k) against any u_feat, or per head (H, 1, ...) against
    u_feat starting with H."""
    he = math.prod(e_feat)
    if he == 1:
        if len(e_feat) > len(u_feat):
            return None
        return 1, math.prod(u_feat)
    if (e_feat and e_feat[0] == he and len(e_feat) <= len(u_feat)
            and u_feat and u_feat[0] == he):
        return he, math.prod(u_feat) // he
    return None


def gspmm_hub(g: Graph, op: str, reduce_op: str, u, e):
    """Hub-engine g-SpMM. Returns None where the reference declines: no
    hub layout, a reduce other than sum/mean, an op other than copy_lhs,
    mul and copy_rhs, a missing or non-float operand, or a weight shape
    that ``_weight_heads`` does not cover."""
    if g.hub_dst is None or g.hub_dst_meta is None:
        return None
    if reduce_op not in ("sum", "mean"):
        return None
    he, rep = 1, 1
    if op == "copy_lhs":
        if u is None:
            return None
        e = None
    elif op == "mul":
        if u is None or e is None:
            return None
        hr = _weight_heads(tuple(u.shape[1:]), tuple(e.shape[1:]))
        if hr is None:
            return None
        he, rep = hr
    elif op == "copy_rhs":
        if e is None:
            return None
        e_feat = tuple(e.shape[1:])
        he = math.prod(e_feat)
        if he != 1 and not (e_feat and e_feat[0] == he):
            return None
        he, u = max(he, 1), None
    else:
        return None
    if any(x is not None and not x.is_floating_point() for x in (u, e)):
        return None
    if e is not None and e.shape[0] != g.num_edges_padded():
        # The layout's edge ids index every edge; the kernels skip an id
        # past e's end, so a short e would silently drop edges.
        raise ValueError(f"edge data has {e.shape[0]} rows, the graph "
                         f"{g.num_edges_padded()} edges")
    count("layout.read.hub")
    out = _HubSum.apply(g, op, he, rep, u, e,
                        get_matmul_precision() == "bf16")
    if reduce_op == "mean":
        deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
        out = out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))
    return out
