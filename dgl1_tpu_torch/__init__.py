"""dgl1_tpu_torch: the PyTorch/CUDA port of dgl1_tpu for NVIDIA Hopper.

It keeps the JAX package's module names (``graph``, ``hub_format``,
``ops/engine_hub``, ``sampling``, ``dataloading``, ``nn/conv``,
``models``, ...; ``ops/engine_tile`` is ``engine_pallas``'s counterpart)
and imports neither JAX nor ``dgl1_tpu``. Entry points build on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written kernels (``csrc/``) are built
with nvcc at first use.
"""

import sys as _sys

from dgl1_tpu_torch.graph import (Graph, block, create_block, from_networkx,
                                  from_scipy, graph, rand_bipartite,
                                  rand_graph, resolve_device, to_networkx)
from dgl1_tpu_torch.heterograph import (HeteroGraph, edge_type_subgraph,
                                        heterograph, node_type_subgraph)
from dgl1_tpu_torch.transform import (
    add_edges, add_nodes, add_reverse_edges, add_self_loop, compact_graphs,
    edge_subgraph, in_subgraph, khop_graph, knn_graph, laplacian_lambda_max,
    laplacian_pe, line_graph, merge, metapath_reachable_graph, node_subgraph,
    out_subgraph, random_walk_pe, rcm_order, remove_edges, remove_nodes,
    remove_self_loop, reorder_graph, reverse, segmented_knn_graph,
    shortest_dist, to_bidirected, to_block, to_block_hetero,
    to_heterogeneous, to_homogeneous, to_simple, typed_subgraphs,
    typed_union_graph)
from dgl1_tpu_torch import (data, dataloading, models, nn,  # noqa: F401
                            ops, optim, parallel, random, sampling,
                            transform)
from dgl1_tpu_torch import transform as transforms  # noqa: F401
from dgl1_tpu_torch.batch import (batch, batch_num_edges, batch_num_nodes,
                                  unbatch)
from dgl1_tpu_torch.data.serialize import load_graphs, save_graphs
from dgl1_tpu_torch.hub_format import hub_order
from dgl1_tpu_torch.random import seed
from dgl1_tpu_torch.readout import (broadcast_edges, broadcast_nodes,
                                    max_edges, max_nodes, mean_edges,
                                    mean_nodes, readout_edges, readout_nodes,
                                    softmax_edges, softmax_nodes, sum_edges,
                                    sum_nodes, topk_edges, topk_nodes)
from dgl1_tpu_torch.train import train, train_sampled, train_sampled_rgcn
from dgl1_tpu_torch import core, function, traversal, udf  # noqa: F401
from dgl1_tpu_torch import geometry, utils  # noqa: F401
from dgl1_tpu_torch.nn.explain import khop_in_subgraph
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


def apply_each(data, fn, *args, **kwargs):
    """``fn`` applied to every value of a dict (``{ntype: tensor}``), or
    to a bare value (``dgl.apply_each``)."""
    if isinstance(data, dict):
        return {k: fn(v, *args, **kwargs) for k, v in data.items()}
    return fn(data, *args, **kwargs)


# ``dgl.distributed``: the distributed layer under DistDGL's name (also
# importable as ``dgl1_tpu_torch.distributed``).
distributed = parallel
_sys.modules[__name__ + ".distributed"] = parallel

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
           "dfs_edges_generator", "from_networkx", "to_networkx", "seed",
           "save_graphs", "load_graphs", "batch", "unbatch",
           "batch_num_nodes", "batch_num_edges", "readout_nodes",
           "readout_edges", "sum_nodes", "sum_edges", "mean_nodes",
           "mean_edges", "max_nodes", "max_edges", "softmax_nodes",
           "softmax_edges", "broadcast_nodes", "broadcast_edges",
           "topk_nodes", "topk_edges", "transform", "transforms",
           "hub_order", "add_reverse_edges", "khop_graph", "to_simple",
           "line_graph", "add_edges", "remove_edges", "add_nodes",
           "remove_nodes", "laplacian_pe", "random_walk_pe", "in_subgraph",
           "out_subgraph", "knn_graph", "segmented_knn_graph",
           "laplacian_lambda_max", "merge", "shortest_dist", "apply_each",
           "distributed", "geometry", "utils", "khop_in_subgraph"]
