"""Public g-SpMM front end and its sugar (the port's
``dgl1_tpu/ops/spmm.py``; parity: ``python/dgl/ops/spmm.py``): ``gspmm``
and the 30 names ``{copy_u, copy_e, u_add_e, u_sub_e, u_mul_e,
u_div_e}_{sum, max, min, mean, prod}``."""

from __future__ import annotations

import sys
from typing import Optional

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops import dispatch
from dgl1_tpu_torch.ops.engine_xla import SPMM_REDUCES, gspmm_xla

__all__ = ["gspmm"]


def gspmm(g: Graph, op: str, reduce_op: str,
          lhs_data: Optional[torch.Tensor],
          rhs_data: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-edge ``op(lhs_data[src], rhs_data)`` followed by a
    per-destination ``reduce_op``. ``lhs_data`` lives on source nodes,
    ``rhs_data`` on edges (user edge order). Returns (num_dst, ...)."""
    # 1-D features run as (N, 1) and are squeezed back.
    squeeze = False
    if lhs_data is not None and lhs_data.dim() == 1:
        lhs_data = lhs_data[:, None]
        squeeze = True
    if rhs_data is not None and rhs_data.dim() == 1:
        rhs_data = rhs_data[:, None]
        squeeze = True
    out = dispatch.dispatch_gspmm(g, op, reduce_op, lhs_data, rhs_data)
    if out is None:
        out = gspmm_xla(g, op, reduce_op, lhs_data, rhs_data)
    return out[..., 0] if squeeze and out.shape[-1] == 1 else out


def _make_sugar(op: str, reduce_op: str):
    if op.startswith("copy_"):
        target = op[len("copy_"):]

        def fn(g: Graph, x):
            if target == "u":
                return gspmm(g, "copy_lhs", reduce_op, x, None)
            return gspmm(g, "copy_rhs", reduce_op, None, x)

        fn.__doc__ = (f"``{op}_{reduce_op}(g, x)``: {target}-data copied "
                      f"along the edges, reduced by {reduce_op} at each "
                      f"destination.")
    else:
        def fn(g: Graph, u, e):
            return gspmm(g, op.split("_")[1], reduce_op, u, e)

        fn.__doc__ = (f"``{op}_{reduce_op}(g, u, e)``: per-edge ``{op}``, "
                      f"reduced by {reduce_op} at each destination.")
    fn.__name__ = f"{op}_{reduce_op}"
    return fn


_module = sys.modules[__name__]
for _reduce in SPMM_REDUCES:
    for _name in ("copy_u", "copy_e", "u_add_e", "u_sub_e", "u_mul_e",
                  "u_div_e"):
        _fn = _make_sugar(_name, _reduce)
        setattr(_module, _fn.__name__, _fn)
        __all__.append(_fn.__name__)
