"""Datasets and data of the port (the reference's ``dgl1_tpu/data``).

Each dataset reads raw or processed files under ``DGL1_TPU_DATA_DIR``
(default ``~/.dgl1_tpu``, the reference's) when they are there; otherwise
it generates a deterministic synthetic graph of the same schema and
statistics from the reference's seed (``dataset.is_synthetic``), so both
packages build the same arrays. Graphs are placed on ``device`` (default
``cuda``). Also: the synthetic generators, the host feature store and the
graph files (``save_graphs`` / ``load_graphs``).
"""

from dgl1_tpu_torch.data.base import GraphDataset, data_dir
from dgl1_tpu_torch.data.citation import (CiteseerGraphDataset,
                                          CoraGraphDataset,
                                          PubmedGraphDataset)
from dgl1_tpu_torch.data.csv_dataset import CSVDataset
from dgl1_tpu_torch.data.feature_store import (HostFeatureStore,
                                               prefetch_to_device)
from dgl1_tpu_torch.data.gnn_benchmark import (AmazonCoBuyComputerDataset,
                                               AmazonCoBuyPhotoDataset,
                                               CoauthorCSDataset,
                                               CoauthorPhysicsDataset,
                                               CoraFullDataset,
                                               KarateClubDataset)
from dgl1_tpu_torch.data.knowledge import (AIFBDataset, FB15k237Dataset,
                                           WN18Dataset)
from dgl1_tpu_torch.data.minigc import MiniGCDataset
from dgl1_tpu_torch.data.ogb import OGBDataset
from dgl1_tpu_torch.data.ppi_tu import GINDataset, PPIDataset, TUDataset
from dgl1_tpu_torch.data.qm import QM7bDataset, QM9Dataset
from dgl1_tpu_torch.data.reddit import RedditDataset
from dgl1_tpu_torch.data.sbm import SBMMixtureDataset
from dgl1_tpu_torch.data.serialize import load_graphs, save_graphs
from dgl1_tpu_torch.data.sst import SSTDataset
from dgl1_tpu_torch.data.synthetic import (  # noqa: F401
    geometric_graph, minibatch_graph, powerlaw_graph, sort_by_relation,
    synthetic_classification_graph, synthetic_mag_heterograph,
    typed_powerlaw_graph)
from dgl1_tpu_torch.data.utils import Subset, split_dataset

__all__ = ["powerlaw_graph", "geometric_graph", "typed_powerlaw_graph",
           "sort_by_relation", "synthetic_classification_graph",
           "minibatch_graph", "synthetic_mag_heterograph",
           "HostFeatureStore", "prefetch_to_device", "save_graphs",
           "load_graphs", "GraphDataset", "data_dir", "CoraGraphDataset",
           "CiteseerGraphDataset", "PubmedGraphDataset", "RedditDataset",
           "FB15k237Dataset", "WN18Dataset", "AIFBDataset", "OGBDataset",
           "MiniGCDataset", "CSVDataset", "PPIDataset", "TUDataset",
           "GINDataset", "CoraFullDataset", "CoauthorCSDataset",
           "CoauthorPhysicsDataset", "AmazonCoBuyComputerDataset",
           "AmazonCoBuyPhotoDataset", "KarateClubDataset",
           "SBMMixtureDataset", "SSTDataset", "QM7bDataset", "QM9Dataset",
           "Subset", "split_dataset"]
