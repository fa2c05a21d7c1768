"""Mini-batch sampling pipeline (the port's ``dgl1_tpu/dataloading``):
the neighbor samplers, the node and edge loaders, the negative samplers,
layer-wise inference and the graph-classification loader. The cluster
and saint loaders are not ported yet."""

from dgl1_tpu_torch.dataloading.dataloader import (DataLoader, NodeCollator,
                                                   NodeDataLoader)
from dgl1_tpu_torch.dataloading.edge_dataloader import (
    EdgeDataLoader, as_edge_prediction_sampler)
from dgl1_tpu_torch.dataloading import negative_sampler
from dgl1_tpu_torch.dataloading.graph_dataloader import GraphDataLoader
from dgl1_tpu_torch.dataloading.inference import layerwise_inference
from dgl1_tpu_torch.dataloading.neighbor_sampler import (
    MultiLayerFullNeighborSampler, MultiLayerNeighborSampler,
    NeighborSampler)

__all__ = ["NeighborSampler", "MultiLayerNeighborSampler",
           "MultiLayerFullNeighborSampler", "NodeDataLoader", "DataLoader",
           "NodeCollator", "EdgeDataLoader", "as_edge_prediction_sampler",
           "negative_sampler", "layerwise_inference", "GraphDataLoader"]
