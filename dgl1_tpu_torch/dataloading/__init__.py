"""Mini-batch sampling pipeline (the port's ``dgl1_tpu/dataloading``):
the fused neighbor sampler and the node dataloader. The other loaders
(edge, cluster, saint, graph) are not ported yet."""

from dgl1_tpu_torch.dataloading.dataloader import (DataLoader, NodeCollator,
                                                   NodeDataLoader)
from dgl1_tpu_torch.dataloading.neighbor_sampler import (
    MultiLayerNeighborSampler, NeighborSampler)

__all__ = ["NeighborSampler", "MultiLayerNeighborSampler", "NodeDataLoader",
           "DataLoader", "NodeCollator"]
