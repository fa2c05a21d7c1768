"""``dgl1_tpu_torch.models``: model zoo of the port."""

from dgl1_tpu_torch.models.gat import GAT
from dgl1_tpu_torch.models.gcn import GCN
from dgl1_tpu_torch.models.graphsage import GraphSAGE

__all__ = ["GCN", "GAT", "GraphSAGE"]
