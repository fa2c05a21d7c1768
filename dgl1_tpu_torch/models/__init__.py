"""``dgl1_tpu_torch.models``: model zoo of the port (the reference's
names less ``LGNN`` and the Tree-LSTM, not ported yet)."""

from dgl1_tpu_torch.models.dgi import DGI, DGIEncoder
from dgl1_tpu_torch.models.gat import GAT
from dgl1_tpu_torch.models.gcn import GCN, EdgeWeightedGCN
from dgl1_tpu_torch.models.gin import GIN
from dgl1_tpu_torch.models.graphsage import GraphSAGE
from dgl1_tpu_torch.models.han import HAN, HANLayer, SemanticAttention
from dgl1_tpu_torch.models.rgcn import RGCN, HeteroRGCN

__all__ = ["GCN", "EdgeWeightedGCN", "GAT", "GraphSAGE", "RGCN", "HeteroRGCN",
           "HAN", "HANLayer", "SemanticAttention", "GIN", "DGI",
           "DGIEncoder"]
