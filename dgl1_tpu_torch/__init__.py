"""dgl1_tpu_torch: the PyTorch/CUDA port of dgl1_tpu for NVIDIA Hopper.

It keeps the JAX package's module names (``graph``, ``hub_format``,
``ops/engine_hub``, ``sampling``, ``dataloading``, ``nn/conv``,
``models``, ...; ``ops/engine_tile`` is ``engine_pallas``'s counterpart)
and imports neither JAX nor ``dgl1_tpu``. Entry points build on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written kernels (``csrc/``) are built
with nvcc at first use.
"""

from dgl1_tpu_torch.graph import (Graph, block, create_block, from_scipy,
                                  graph, rand_bipartite, rand_graph,
                                  resolve_device)
from dgl1_tpu_torch.heterograph import (HeteroGraph, edge_type_subgraph,
                                        heterograph, node_type_subgraph)
from dgl1_tpu_torch.transform import (add_self_loop, compact_graphs,
                                      edge_subgraph,
                                      metapath_reachable_graph,
                                      node_subgraph, rcm_order,
                                      remove_self_loop, reorder_graph,
                                      reverse,
                                      to_bidirected, to_block,
                                      to_block_hetero, to_heterogeneous,
                                      to_homogeneous, typed_subgraphs,
                                      typed_union_graph)
from dgl1_tpu_torch import (data, dataloading, models, nn,  # noqa: F401
                            ops, optim, parallel, random, sampling)
from dgl1_tpu_torch.train import train, train_sampled, train_sampled_rgcn
from dgl1_tpu_torch import core, function, traversal, udf  # noqa: F401
from dgl1_tpu_torch import function as fn  # noqa: F401
from dgl1_tpu_torch.core import (filter_edges, filter_nodes, prop_edges,
                                 prop_edges_dfs, prop_nodes, prop_nodes_bfs,
                                 prop_nodes_topo, prop_nodes_topo_compiled,
                                 pull, push, topo_schedule)
from dgl1_tpu_torch.ops.edge_softmax import edge_softmax
from dgl1_tpu_torch.traversal import (bfs_edges_generator,
                                      bfs_nodes_generator,
                                      dfs_edges_generator,
                                      topological_nodes_generator)


DGLGraph = Graph
DGLHeteroGraph = HeteroGraph
NID = "_ID"
EID = "_ID"
NTYPE = "_TYPE"
ETYPE = "_TYPE"

__all__ = ["Graph", "graph", "block", "create_block", "rand_graph",
           "resolve_device", "HeteroGraph", "heterograph",
           "node_type_subgraph", "edge_type_subgraph", "add_self_loop",
           "remove_self_loop", "reorder_graph", "rcm_order", "to_bidirected",
           "edge_subgraph", "typed_subgraphs", "typed_union_graph",
           "to_homogeneous", "to_heterogeneous", "metapath_reachable_graph",
           "node_subgraph", "compact_graphs", "to_block", "to_block_hetero",
           "data", "dataloading", "models", "nn", "ops", "optim", "parallel",
           "random",
           "sampling", "train", "train_sampled", "train_sampled_rgcn",
           "rand_bipartite", "from_scipy", "core", "function", "fn",
           "traversal", "udf", "edge_softmax", "reverse", "DGLGraph",
           "DGLHeteroGraph", "NID", "EID", "NTYPE", "ETYPE", "filter_nodes",
           "filter_edges", "prop_nodes", "prop_edges", "prop_nodes_topo",
           "prop_nodes_topo_compiled", "topo_schedule", "prop_nodes_bfs",
           "prop_edges_dfs", "pull", "push", "bfs_nodes_generator",
           "bfs_edges_generator", "topological_nodes_generator",
           "dfs_edges_generator"]
