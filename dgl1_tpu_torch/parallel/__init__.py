"""The multi-device training layer (parity: DistDGL,
``python/dgl/distributed``): partitioners, the halo and vertex-cut
layouts, the sharded g-SpMM and GAT, the partitioned hub layouts, the
sharded GCN trainer, the typed (heterograph) partitions with the sharded
R-GCN layer and typed attention, tensor parallelism, the KVStore,
DistGraph and the data-parallel loader, over ``torch.distributed`` with
one process a partition. The port's counterpart of ``dgl1_tpu/parallel``.
"""

from dgl1_tpu_torch.parallel.partition import (
    edge_cut_fraction,
    greedy_partition_assignment,
    load_partition,
    metis_partition,
    metis_partition_assignment,
    multilevel_partition_assignment,
    partition_graph,
    random_partition_assignment,
)
from dgl1_tpu_torch.parallel.graph_partition_book import (
    GraphPartitionBook, edge_split, node_split)
from dgl1_tpu_torch.parallel.halo import (LocalPartition, PartitionedGraph,
                                          build_partitioned_graph,
                                          vertex_cut_edge_owner)
from dgl1_tpu_torch.parallel.sharded_ops import (
    halo_exchange,
    make_sharded_gat_layer,
    sharded_gat_attention,
    sharded_gspmm,
)
from dgl1_tpu_torch.parallel.hetero import (
    LocalHeteroPartition,
    PartitionedHeteroGraph,
    build_partitioned_hetero,
    hetero_edge_cut_fraction,
    hetero_partition_assignment,
    load_hetero_partition,
    make_sharded_hetero_attention,
    make_sharded_rgcn_layer,
    partition_hetero_graph,
    sharded_typed_attention,
    sharded_typed_gspmm,
)
from dgl1_tpu_torch.parallel.dist_graph import DistGraph, DistTensor
from dgl1_tpu_torch.parallel.dist_dataloader import (DistDataLoader,
                                                     DistNodeDataLoader)
from dgl1_tpu_torch.parallel.dist_context import exit_client, initialize
from dgl1_tpu_torch.parallel.kvstore import ShardedFeatureStore
from dgl1_tpu_torch.parallel.tp import make_tp_gcn_layer, shard_params_tp
from dgl1_tpu_torch.parallel import hub_shard, train  # noqa: F401
# DistDGL's name: DistEmbedding is the row-sparse NodeEmbedding with the
# sparse optimizers of dgl1_tpu_torch.optim.
from dgl1_tpu_torch.optim import NodeEmbedding as DistEmbedding

__all__ = [
    "partition_graph",
    "load_partition",
    "metis_partition_assignment",
    "metis_partition",
    "multilevel_partition_assignment",
    "greedy_partition_assignment",
    "random_partition_assignment",
    "edge_cut_fraction",
    "GraphPartitionBook",
    "node_split",
    "edge_split",
    "PartitionedGraph",
    "LocalPartition",
    "build_partitioned_graph",
    "vertex_cut_edge_owner",
    "sharded_gspmm",
    "sharded_gat_attention",
    "make_sharded_gat_layer",
    "halo_exchange",
    "hetero_partition_assignment",
    "hetero_edge_cut_fraction",
    "PartitionedHeteroGraph",
    "LocalHeteroPartition",
    "build_partitioned_hetero",
    "sharded_typed_gspmm",
    "make_sharded_rgcn_layer",
    "sharded_typed_attention",
    "make_sharded_hetero_attention",
    "partition_hetero_graph",
    "load_hetero_partition",
    "DistGraph",
    "DistTensor",
    "DistDataLoader",
    "DistNodeDataLoader",
    "initialize",
    "exit_client",
    "DistEmbedding",
    "ShardedFeatureStore",
    "make_tp_gcn_layer",
    "shard_params_tp",
]
