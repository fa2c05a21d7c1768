"""``dgl1_tpu_torch.models``: model zoo of the port (the reference's
names, and ``EdgeWeightedGCN`` and ``HeteroRGCN``)."""

from dgl1_tpu_torch.models.dgi import DGI, DGIEncoder
from dgl1_tpu_torch.models.gat import GAT
from dgl1_tpu_torch.models.gcn import GCN, EdgeWeightedGCN
from dgl1_tpu_torch.models.gin import GIN
from dgl1_tpu_torch.models.graphsage import GraphSAGE
from dgl1_tpu_torch.models.han import HAN, HANLayer, SemanticAttention
from dgl1_tpu_torch.models.lgnn import LGNN, LGNNCore, LGNNLayer
from dgl1_tpu_torch.models.rgcn import RGCN, HeteroRGCN
from dgl1_tpu_torch.models.treelstm import (ChildSumTreeLSTMCell,
                                            NAryTreeLSTMCell, TreeLSTM)

__all__ = ["GCN", "EdgeWeightedGCN", "GAT", "GraphSAGE", "RGCN", "HeteroRGCN",
           "HAN", "HANLayer", "SemanticAttention", "GIN", "LGNN",
           "LGNNLayer", "LGNNCore", "DGI", "DGIEncoder", "TreeLSTM",
           "ChildSumTreeLSTMCell", "NAryTreeLSTMCell"]
