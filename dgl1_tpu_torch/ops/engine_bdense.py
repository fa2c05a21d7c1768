"""Block-dense engine for g-SpMM: ``copy_lhs`` with ``sum``/``mean``.

The port's counterpart of ``dgl1_tpu/ops/engine_bdense.py``, as a
``torch.autograd.Function``. On the layout of ``bdense_format.py`` the
forward is the dense tier through K11 (``out[rb] += A_k @ u[cb]``) plus
the leftover edges through the ELL tail (``t_*``); grad_u is K11 in
transpose mode over the same blocks (``gu[cb] += A_k^T @ ct[rb]``, in cb
order) plus the tail's reverse direction (``r_*``). The function keeps no
tensor for its backward: grad_u of a sum depends on the cotangent alone.
``mean`` divides by the in-degree clipped at 1. Every other call
declines (returns None) and dispatch falls through. Sums are float32;
under the bf16 matmul mode (``ops/precision.py``, read when the forward
runs and kept for its backward) K11 rounds A and x to bfloat16, as the
reference passes ``dt`` to ``_block_call``; the ELL tail stays float32.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops import bdense_kernels as K
from dgl1_tpu_torch.ops.engine_ell import ell_reduce
from dgl1_tpu_torch.ops.precision import get_matmul_precision
from dgl1_tpu_torch.utils.profiler import count

__all__ = ["gspmm_bdense"]


def _tail(bd, prefix: str):
    return {"idx": bd[f"{prefix}_idx"], "eid": bd[f"{prefix}_eid"],
            "inv_perm": bd[f"{prefix}_inv"]}


def _sum_dir(g: Graph, x2, transpose: bool, bf16: bool):
    """One direction of the sum: forward (by dst) or, transposed, by src."""
    m, bd = g.bdense_meta, g.bdense
    if transpose:
        n_out, tail_meta, tail = g.num_src_nodes(), m.tail_meta_src, "r"
    else:
        n_out, tail_meta, tail = g.num_dst_nodes(), m.tail_meta_dst, "t"
    out = ell_reduce(tail_meta, _tail(bd, tail), "copy_lhs",
                     "sum", x2, None, n_out)
    if m.n_blocks:
        if transpose:
            dense = K.block_mm(True, bd["ab"], bd["col_ptr"], bd["rbb"], x2,
                               n_out, bf16)
        else:
            dense = K.block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], x2,
                               n_out, bf16)
        out = dense + out
    return out


class _BDenseSum(torch.autograd.Function):
    """Sum over in-edges of copy_lhs on the block-dense layout, with the
    reference's ``custom_vjp`` backward (K11 transposed plus the reverse
    tail). Saves nothing."""

    @staticmethod
    def forward(ctx, g, u, bf16):
        ctx.g, ctx.bf16 = g, bf16
        ctx.u_meta = (u.shape, u.dtype)
        u2 = u.reshape(u.shape[0], -1).to(torch.float32).contiguous()
        out = _sum_dir(g, u2, transpose=False, bf16=bf16)
        return out.to(u.dtype).reshape((g.num_dst_nodes(),)
                                       + tuple(u.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        shape, dtype = ctx.u_meta
        ct2 = ct.reshape(ct.shape[0], -1).to(torch.float32).contiguous()
        gu = _sum_dir(ctx.g, ct2, transpose=True, bf16=ctx.bf16)
        return None, gu.to(dtype).reshape(shape), None


def gspmm_bdense(g: Graph, op: str, reduce_op: str, u, e):
    """Block-dense g-SpMM. Returns None where the reference declines: no
    block-dense layout, an op other than copy_lhs, a reduce other than
    sum/mean, or a missing or non-float ``u``."""
    if g.bdense is None or g.bdense_meta is None:
        return None
    if op != "copy_lhs" or reduce_op not in ("sum", "mean"):
        return None
    if u is None or not u.is_floating_point():
        return None
    count("layout.read.bdense")
    out = _BDenseSum.apply(g, u, get_matmul_precision() == "bf16")
    if reduce_op == "mean":
        deg = g.in_degrees().to(out.dtype).clamp(min=1.0)
        out = out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))
    return out
