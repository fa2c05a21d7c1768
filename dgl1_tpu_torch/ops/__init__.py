"""``dgl1_tpu_torch.ops``: the g-SpMM and g-SDDMM front ends with their
sugar (``copy_u_sum`` ... ``u_div_e_prod``; ``u_dot_v``, ``copy_u``,
...), engine dispatch, the engines (oracle, block-dense, ELL, hub, tile),
edge softmax, the fused GAT attention (hub and block-dense), the segment
ops and the kernels' matmul precision mode."""

from dgl1_tpu_torch.ops.dispatch import (get_engine, register_engine,
                                         set_auto_order, set_engine)
from dgl1_tpu_torch.ops.spmm import *  # noqa: F401,F403
from dgl1_tpu_torch.ops import spmm as _spmm
from dgl1_tpu_torch.ops.spmm import gspmm
from dgl1_tpu_torch.ops.sddmm import *  # noqa: F401,F403
from dgl1_tpu_torch.ops import sddmm as _sddmm
from dgl1_tpu_torch.ops.sddmm import gsddmm
from dgl1_tpu_torch.ops.edge_softmax import edge_softmax
from dgl1_tpu_torch.ops.attention import can_fuse_attention, gat_attention
from dgl1_tpu_torch.ops.battention import (bdense_gat_attention,
                                           can_fuse_battention)
from dgl1_tpu_torch.ops.segment import (gather_mm, segment_ids_from_lengths,
                                        segment_mm, segment_reduce,
                                        segment_softmax)
from dgl1_tpu_torch.ops.precision import (get_matmul_precision,
                                          matmul_precision,
                                          set_matmul_precision)
from dgl1_tpu_torch.ops import engine_bdense as _engine_bdense
from dgl1_tpu_torch.ops import engine_ell as _engine_ell
from dgl1_tpu_torch.ops import engine_hub as _engine_hub
from dgl1_tpu_torch.ops import engine_tile as _engine_tile

register_engine("bdense", _engine_bdense.gspmm_bdense)
register_engine("ell", _engine_ell.gspmm_ell)
register_engine("hub", _engine_hub.gspmm_hub)
register_engine("tile", _engine_tile.gspmm_tile)

__all__ = ["gspmm", "gsddmm", "edge_softmax", "gat_attention",
           "can_fuse_attention", "bdense_gat_attention",
           "can_fuse_battention", "segment_mm", "gather_mm",
           "segment_reduce", "segment_softmax",
           "segment_ids_from_lengths", "set_engine", "get_engine",
           "register_engine", "set_auto_order", "set_matmul_precision",
           "get_matmul_precision", "matmul_precision"]
__all__ += [n for n in _spmm.__all__ + _sddmm.__all__ if n not in __all__]
