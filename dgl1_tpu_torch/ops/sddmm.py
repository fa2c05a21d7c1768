"""Public g-SDDMM front end (the port's ``dgl1_tpu/ops/sddmm.py``).

Every call runs on the oracle engine (``engine_xla.gsddmm_xla``): the
reference's only other g-SDDMM engine is the tiled Pallas engine, which is
not ported yet.
"""

from __future__ import annotations

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
