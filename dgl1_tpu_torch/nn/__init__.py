"""``dgl1_tpu_torch.nn``: graph neural network modules (the reference's
``dgl1_tpu.nn`` names)."""

from dgl1_tpu_torch.nn.conv import (AGNNConv, APPNPConv, AtomicConv,
                                    CFConv, ChebConv, DenseChebConv,
                                    DenseGraphConv, DenseSAGEConv,
                                    DotGatConv, EdgeConv, EdgeGATConv,
                                    EdgeWeightNorm, EGATConv, GATConv,
                                    GATv2Conv, GatedGraphConv, GCN2Conv,
                                    GINConv, GMMConv, GraphConv, HGTConv,
                                    NNConv, PNAConv, RelGraphConv, SAGEConv,
                                    SGConv, TAGConv)
from dgl1_tpu_torch.nn.explain import GNNExplainer
from dgl1_tpu_torch.nn.factory import KNNGraph, SegmentedKNNGraph
from dgl1_tpu_torch.nn.glob import (AvgPooling, GlobalAttentionPooling,
                                    MaxPooling, Set2Set,
                                    SetTransformerDecoder,
                                    SetTransformerEncoder, SortPooling,
                                    SumPooling, WeightAndSum)
from dgl1_tpu_torch.nn.hetero import HeteroGraphConv
from dgl1_tpu_torch.nn.linear import HeteroEmbedding, HeteroLinear, TypedLinear
from dgl1_tpu_torch.nn.softmax import edge_softmax
from dgl1_tpu_torch.nn.utils import (JumpingKnowledge, LabelPropagation,
                                     Sequential, WeightBasis)

__all__ = ["GraphConv", "GATConv", "DotGatConv", "SAGEConv", "RelGraphConv",
           "GINConv", "SGConv", "APPNPConv", "TAGConv", "ChebConv",
           "EdgeConv", "GatedGraphConv", "AGNNConv", "NNConv",
           "DenseGraphConv", "DenseSAGEConv", "DenseChebConv", "CFConv",
           "AtomicConv", "SumPooling", "AvgPooling", "MaxPooling",
           "SortPooling", "GlobalAttentionPooling", "Set2Set",
           "HeteroGraphConv", "edge_softmax", "WeightAndSum", "KNNGraph",
           "SegmentedKNNGraph", "WeightBasis", "Sequential",
           "SetTransformerEncoder", "SetTransformerDecoder", "GATv2Conv",
           "EGATConv", "EdgeGATConv", "GCN2Conv", "PNAConv",
           "JumpingKnowledge", "LabelPropagation", "HGTConv", "TypedLinear",
           "HeteroLinear", "HeteroEmbedding", "EdgeWeightNorm", "GMMConv",
           "GNNExplainer"]
