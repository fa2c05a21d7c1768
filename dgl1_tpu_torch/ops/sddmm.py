"""Public g-SDDMM front end (the port's ``dgl1_tpu/ops/sddmm.py``):
``gsddmm`` and its sugar, ``copy_u``, ``copy_v`` and ``{x}_{op}_{y}`` for
``x != y`` in u, v, e and op in add, sub, mul, div, dot (``u_dot_v``,
link prediction's score, ...).

Every call runs on the oracle engine (``engine_xla.gsddmm_xla``), as in
the reference: its tiled Pallas g-SDDMM engine always declines, so its
oracle is its only g-SDDMM path too. ``core.apply_edges`` and the
messages of ``core.message_passing`` that read the destination
(``u_dot_v``, ...) reach it.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.engine_xla import gsddmm_xla

__all__ = ["gsddmm"]


def gsddmm(g: Graph, op: str, lhs_data: Optional[torch.Tensor],
           rhs_data: Optional[torch.Tensor], lhs_target: str = "u",
           rhs_target: str = "v") -> torch.Tensor:
    """Per-edge binary ``op`` between data on any two of source ``'u'``,
    destination ``'v'`` and edge ``'e'``. Returns (num_edges, ...) in user
    edge order."""
    squeeze = False
    if lhs_data is not None and lhs_data.dim() == 1:
        lhs_data = lhs_data[:, None]
        squeeze = True
    if rhs_data is not None and rhs_data.dim() == 1:
        rhs_data = rhs_data[:, None]
        squeeze = True
    out = gsddmm_xla(g, op, lhs_data, rhs_data, lhs_target, rhs_target)
    return out[..., 0] if squeeze and out.shape[-1] == 1 else out


def _make_sugar(lhs: str, op: str, rhs: str):
    def fn(g: Graph, x, y):
        return gsddmm(g, op, x, y, lhs_target=lhs, rhs_target=rhs)

    fn.__name__ = f"{lhs}_{op}_{rhs}"
    fn.__doc__ = (f"``{fn.__name__}(g, x, y)``: per-edge ``{lhs}-data {op} "
                  f"{rhs}-data``.")
    return fn


def copy_u(g: Graph, x):
    """Source-node data gathered onto the edges (user edge order)."""
    return gsddmm(g, "copy_lhs", x, None, lhs_target="u")


def copy_v(g: Graph, x):
    """Destination-node data gathered onto the edges (user edge order)."""
    return gsddmm(g, "copy_lhs", x, None, lhs_target="v")


__all__ += ["copy_u", "copy_v"]

_module = sys.modules[__name__]
for _lhs in ("u", "v", "e"):
    for _rhs in ("u", "v", "e"):
        if _lhs == _rhs:
            continue
        for _op in ("add", "sub", "mul", "div", "dot"):
            _fn = _make_sugar(_lhs, _op, _rhs)
            setattr(_module, _fn.__name__, _fn)
            __all__.append(_fn.__name__)
