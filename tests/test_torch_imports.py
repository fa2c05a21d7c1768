"""The port imports no JAX and nothing of the JAX package, and asks for
CUDA by default."""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dgl1_tpu_torch as tdgl

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import dgl1_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dgl1_tpu_torch.__path__,
                                               "dgl1_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ml_dtypes", "dgl1_tpu"))
print(",".join(names), bad)
"""

# Modules each slice added; the probe must have imported every one.
_MODULES = ("graph", "hub_format", "ops.engine_hub", "ops.hub_kernels",
            "ops.attention", "ops.attn_kernels", "random", "sampling",
            "sampling.fused", "dataloading", "dataloading.dataloader",
            "dataloading.neighbor_sampler", "ops.engine_tile",
            "ops.tile_kernels", "models.graphsage", "ops.segment",
            "models.rgcn", "nn.conv", "transform", "data.synthetic",
            "bdense_format", "ops.bdense_kernels", "ops.engine_bdense",
            "ops.battention", "ops.precision", "tools.bench_models",
            "tools.chunk_walk_variants", "heterograph", "nn.hetero",
            "nn.linear", "models.han", "sampling.neighbor",
            "sampling.negative", "dataloading.edge_dataloader",
            "dataloading.negative_sampler", "dataloading.inference",
            "data.feature_store", "optim", "train", "parallel",
            "parallel.partition", "parallel.graph_partition_book",
            "parallel.halo", "parallel.hub_shard", "parallel.sharded_ops",
            "parallel.train", "parallel.tp", "parallel.kvstore",
            "parallel.dist_context", "parallel.dist_graph",
            "parallel.dist_dataloader", "tools.dryrun_multichip",
            "parallel.hetero", "function", "udf", "core", "traversal",
            "batch", "readout", "data.serialize", "nn.glob", "nn.softmax",
            "nn.utils", "nn.factory", "dataloading.graph_dataloader",
            "models.gin", "models.dgi", "sampling.randomwalks",
            "sampling.pinsage", "dataloading.saint", "dataloading.cluster",
            "nn.explain", "geometry", "models.lgnn", "models.treelstm",
            "utils", "utils.checkpoint", "utils.logging", "utils.profiler",
            "data.base", "data.utils", "data.citation", "data.reddit",
            "data.ogb", "data.gnn_benchmark", "data.knowledge",
            "data.minigc", "data.ppi_tu", "data.qm", "data.sbm", "data.sst",
            "data.csv_dataset", "tools.run_examples", "examples",
            "examples.train_gcn", "examples.train_gat", "examples.train_gcn2",
            "examples.train_citation_zoo", "examples.train_rgcn",
            "examples.train_han", "examples.train_hetero",
            "examples.train_sage_minibatch", "examples.train_rgcn_sampled",
            "examples.train_link_pred", "examples.train_hetero_link_pred",
            "examples.train_rgcn_link_pred", "examples.train_sign",
            "examples.train_dgi", "examples.train_cluster_gcn",
            "examples.train_saint", "examples.train_graph_classification",
            "examples.train_diffpool", "examples.train_chem",
            "examples.train_ggnn", "examples.train_pointcloud",
            "examples.train_transformer", "examples.train_gcmc",
            "examples.train_treelstm", "examples.train_lgnn",
            "examples.train_pinsage", "examples.train_metapath2vec",
            "examples.train_dgmg", "examples.train_dist",
            "examples.train_dist_sampled", "examples.train_rgcn_dist",
            "examples.train_rgcn_dist_sampled", "tools.profile_examples")


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, check=True)
    names, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    names = set(names.split(","))
    missing = [m for m in _MODULES if f"dgl1_tpu_torch.{m}" not in names]
    assert not missing, missing


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        g = tdgl.graph(([0, 1], [1, 2]), num_nodes=3)
        assert g.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.graph(([0, 1], [1, 2]), num_nodes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.models.GCN(4, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.data.powerlaw_graph(64, 2)
    g = tdgl.graph(([0, 1], [1, 2]), num_nodes=3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.to("cuda")
    hg = tdgl.heterograph({("a", "r", "b"): ([0], [0])}, device="cpu")
    # The typed-graph and heterograph entry points.
    for call in (lambda: tdgl.block(([0, 1], [1, 0]), 2, 2),
                 lambda: tdgl.heterograph({("a", "r", "b"): ([0], [0])}),
                 lambda: tdgl.nn.TypedLinear(3, 2, 2),
                 lambda: tdgl.models.HAN(1, 4, 2, 2),
                 lambda: tdgl.heterograph({("a", "r", "b"): ([0], [0])},
                                          device="cpu").to("cuda"),
                 # The sampling, loading and optimizer entry points.
                 lambda: tdgl.data.HostFeatureStore(torch.zeros(3, 2)
                                                    .numpy()),
                 lambda: tdgl.optim.NodeEmbedding.create(3, 2),
                 lambda: tdgl.models.HeteroRGCN([("a", "r", "b")],
                                                {"a": 2}, 2, 2),
                 lambda: tdgl.dataloading.EdgeDataLoader(g, [0], None),
                 lambda: tdgl.dataloading.NodeDataLoader(g, [0], None),
                 # The distributed layer.
                 lambda: tdgl.parallel.build_partitioned_graph(
                     g, [0, 0, 1], 2).local(0),
                 lambda: tdgl.parallel.train.init_gcn_params(2, 2, 2),
                 lambda: tdgl.parallel.initialize("127.0.0.1:1", 1, 0),
                 # The typed distributed layer and the front end.
                 lambda: tdgl.parallel.build_partitioned_hetero(
                     hg, {"a": [0], "b": [0]}, 1).local(0),
                 lambda: tdgl.parallel.DistGraph.from_hetero_partition(
                     "unused", "g", 0),
                 lambda: tdgl.parallel.load_hetero_partition("unused", "g",
                                                             0),
                 lambda: tdgl.rand_bipartite(3, 2, 4),
                 # The graph-level layer, the graph files, kNN, the convs.
                 lambda: tdgl.batch([g]),
                 lambda: tdgl.load_graphs("unused.npz"),
                 lambda: tdgl.knn_graph(np.zeros((4, 2)), 2),
                 lambda: tdgl.nn.KNNGraph(2),
                 lambda: tdgl.dataloading.GraphDataLoader([]),
                 lambda: tdgl.nn.GINConv(),
                 lambda: tdgl.nn.APPNPConv(),
                 lambda: tdgl.nn.DotGatConv(2, 2),
                 lambda: tdgl.nn.Set2Set(2),
                 lambda: tdgl.models.GIN(2, 2, 2),
                 lambda: tdgl.models.DGI(2, 2),
                 # The loaders, models, geometry and datasets.
                 lambda: tdgl.dataloading.SAINTSampler(g, "node", 2, 1,
                                                       num_pre=0),
                 lambda: tdgl.dataloading.ClusterGCNDataLoader(
                     g, 1, partition_assignment=np.zeros(3, np.int64)),
                 lambda: tdgl.models.LGNN(),
                 lambda: tdgl.models.TreeLSTM(4, 2, 2, 2),
                 lambda: tdgl.geometry.farthest_point_sampler(
                     np.zeros((4, 2)), 2),
                 lambda: tdgl.data.CoraGraphDataset(raw_dir="unused"),
                 lambda: tdgl.data.KarateClubDataset(),
                 lambda: tdgl.data.MiniGCDataset(1),
                 lambda: tdgl.data.PPIDataset("valid", raw_dir="unused"),
                 lambda: tdgl.data.TUDataset("MUTAG", raw_dir="unused"),
                 lambda: tdgl.data.GINDataset("MUTAG", raw_dir="unused"),
                 lambda: tdgl.data.QM7bDataset(1, raw_dir="unused"),
                 lambda: tdgl.data.QM9Dataset(num_molecules=1,
                                              raw_dir="unused"),
                 lambda: tdgl.data.SBMMixtureDataset(1, 8, 2),
                 lambda: tdgl.data.SSTDataset(raw_dir="unused"),
                 lambda: tdgl.data.CSVDataset("unused"),
                 # The trainers run on the card unless given --cpu.
                 lambda: importlib.import_module(
                     "dgl1_tpu_torch.examples.train_gcn").main(
                         ["--epochs", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
