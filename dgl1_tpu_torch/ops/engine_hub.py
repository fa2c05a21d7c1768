"""Hub-dense HYB engine for g-SpMM, ``copy_lhs`` with ``sum``/``mean``.

The port's counterpart of ``dgl1_tpu/ops/engine_hub.py`` (``_hub_forward``
and ``_bwd``), as a ``torch.autograd.Function``. The layout
(``hub_format.py``) has three tiers:

* **dense**: the static count matrix ``C``; forward ``C^T @ U`` (K1),
  grad_u ``C @ ct`` (K4a with the tail fused in, or K4b);
* **chunked**: per 1024-slot chunk a row gather and scatter-add (K2),
  forward over ``part_fwd`` and grad_u over ``part_bwd`` (window mask
  applied after the kernel);
* **ELL tail**: ``engine_ell.ell_stack``.

The forward merges ``[tail stack | hub block]`` back to destination order
by the identity concat (hub-relabeled graphs), the descriptor expand (K3)
or a fill-gather through ``t_inv``, under the reference's gates, and adds
the extracted self-loop diagonal. The kernels live in ``hub_kernels.py``:
on CPU tensors they run their plain torch versions. They compute in
float32 with float32 accumulation; the reference's bf16 matmul mode
(``set_matmul_precision``) is not ported.

``mul`` and ``copy_rhs`` need the chunk kernel's mul/rhs modes and the
edge-gradient kernel, which are not ported: they raise
NotImplementedError instead of falling through to another engine.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.hub_format import BLK, EXPAND_PACK, HubMeta
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops.engine_ell import ell_reduce, ell_stack
from dgl1_tpu_torch.ops.engine_xla import take_fill

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


def _hub_forward(g: Graph, u2):
    """(num_dst, f) sum over in-edges of u2 (num_src, f) f32."""
    m: HubMeta = g.hub_dst_meta
    hub = g.hub_dst
    num_dst = g.num_dst_nodes()
    parts = []
    if m.n_dense:
        parts.append(K.dense_fwd(hub["dense_c"], u2))
    if m.n_groups > m.n_dense:
        parts.append(K.chunk_sum(hub["part_fwd"], u2,
                                 m.n_groups - m.n_dense))
    hub_block = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
    stacked = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid"],
                        "copy_lhs", "sum", u2, None)
    if m.identity_expand:
        # Destinations are [hub slots | tail stack | zero-degree rows].
        small = torch.cat([hub_block, stacked], dim=0)
        out = torch.nn.functional.pad(small,
                                      (0, 0, 0, num_dst - small.shape[0]))
    else:
        merged = torch.cat([stacked, hub_block], dim=0)
        if _use_expand(m, hub, merged.shape[0]):
            out = K.expand(merged, hub["x_starts"], hub["x_desc"], num_dst)
        else:
            out = take_fill(merged, hub["t_inv"])
    if m.has_diag:
        out = out + hub["diag"][:, None] * u2[:num_dst]
    return out


def _chunk_grad(g: Graph, ct_part):
    """Chunked-tier grad_u over the window-major layout, rows of windows
    no chunk writes masked to zero (the reference's win_mask_part)."""
    m: HubMeta = g.hub_dst_meta
    out = K.chunk_sum(g.hub_dst["part_bwd"], ct_part, m.n_win)
    win_rows = g.hub_dst["win_mask_part"].repeat_interleave(BLK)
    out = torch.where(win_rows[:, None], out, torch.zeros_like(out))
    return out[: g.num_src_nodes()]


def _hub_backward(g: Graph, ct2):
    """grad_u (num_src, f) of the sum for the cotangent ct2 (num_dst, f)."""
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
                               num_src)
        if m.n_groups > m.n_dense:
            gu = gu + _chunk_grad(g, ct_hubs[kd:].contiguous())
    else:
        gu = ell_reduce(m.tail_meta_src, {"idx": hub["r_idx"],
                                          "eid": hub["r_eid"],
                                          "inv_perm": hub["r_inv"]},
                        "copy_lhs", "sum", ct2, None, num_src)
        if m.n_dense:
            gu = gu + K.dense_bwd(hub["dense_c"], ct_hubs[:kd].contiguous(),
                                  num_src)
        if m.n_groups > m.n_dense:
            gu = gu + _chunk_grad(g, ct_hubs[kd:].contiguous())
    if m.has_diag:
        gu[:num_dst] += hub["diag"][:, None] * ct2[:num_dst]  # gu is fresh
    return gu


class _HubCopyLhsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u):
        ctx.g = g
        ctx.u_shape, ctx.u_dtype = u.shape, u.dtype
        u2 = u.reshape(u.shape[0], -1).to(torch.float32).contiguous()
        out = _hub_forward(g, u2)
        return out.to(u.dtype).reshape((g.num_dst_nodes(),)
                                       + tuple(u.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        ct2 = ct.reshape(ct.shape[0], -1).to(torch.float32).contiguous()
        gu = _hub_backward(g, ct2)
        return None, gu.to(ctx.u_dtype).reshape(ctx.u_shape)


def gspmm_hub(g: Graph, op: str, reduce_op: str, u, e):
    """Hub-engine g-SpMM. Returns None where the reference declines (no
    hub layout, a reduce other than sum/mean, missing or non-float
    operands); raises NotImplementedError for the unported ops."""
    if g.hub_dst is None or g.hub_dst_meta is None:
        return None
    if reduce_op not in ("sum", "mean"):
        return None
    if op in ("mul", "copy_rhs"):
        raise NotImplementedError(
            f"hub engine op {op!r} needs _chunk_kernel in mul/rhs mode (K2 "
            "mul/rhs) and _edge_grad_kernel (K5) of "
            "dgl1_tpu/ops/engine_hub.py, which are not ported yet; use "
            "set_engine('ell') or 'xla'")
    if op != "copy_lhs" or u is None or not u.is_floating_point():
        return None
    out = _HubCopyLhsSum.apply(g, u)
    if reduce_op == "mean":
        deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
        out = out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))
    return out
