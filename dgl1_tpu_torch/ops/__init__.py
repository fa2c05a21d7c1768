"""``dgl1_tpu_torch.ops``: the g-SpMM and g-SDDMM front ends, engine
dispatch, the engines (oracle, ELL, hub, tile), edge softmax and the
fused GAT attention."""

from dgl1_tpu_torch.ops.dispatch import (get_engine, register_engine,
                                         set_engine)
from dgl1_tpu_torch.ops.spmm import gspmm
from dgl1_tpu_torch.ops.sddmm import gsddmm
from dgl1_tpu_torch.ops.edge_softmax import edge_softmax
from dgl1_tpu_torch.ops.attention import can_fuse_attention, gat_attention
from dgl1_tpu_torch.ops import engine_ell as _engine_ell
from dgl1_tpu_torch.ops import engine_hub as _engine_hub
from dgl1_tpu_torch.ops import engine_tile as _engine_tile

register_engine("ell", _engine_ell.gspmm_ell)
register_engine("hub", _engine_hub.gspmm_hub)
register_engine("tile", _engine_tile.gspmm_tile)

__all__ = ["gspmm", "gsddmm", "edge_softmax", "gat_attention",
           "can_fuse_attention", "set_engine", "get_engine",
           "register_engine"]
