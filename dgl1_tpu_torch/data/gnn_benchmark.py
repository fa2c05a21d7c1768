"""GNN-benchmark node-classification datasets and Zachary's karate club
(the port's ``dgl1_tpu/data/gnn_benchmark.py``).

The shchur/gnn-benchmark ``{name}.npz`` CSR files are parsed when present;
otherwise flagged synthetic SBMs with the real datasets' statistics (the
feature width capped at 512), from the reference's seeds. The karate club
is hard-coded, as upstream.
"""

from __future__ import annotations

import numpy as np

from dgl1_tpu_torch.data.base import GraphDataset, to_tensor
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph
from dgl1_tpu_torch.graph import graph, resolve_device
from dgl1_tpu_torch.transform import to_bidirected

__all__ = ["CoraFullDataset", "CoauthorCSDataset", "CoauthorPhysicsDataset",
           "AmazonCoBuyComputerDataset", "AmazonCoBuyPhotoDataset",
           "KarateClubDataset"]


class _GNNBenchmarkDataset(GraphDataset):
    # (num_nodes, num_edges~, feat_dim, num_classes) of the real datasets.
    stats = (0, 0, 0, 0)

    def _raw_path(self):
        return self.raw_dir / f"{self.name}.npz"

    def _has_raw(self) -> bool:
        return self._raw_path().exists()

    def _load_raw(self):
        """The gnn-benchmark CSR npz (adj_data/adj_indices/adj_indptr,
        features as attr_* CSR or attr_matrix, labels)."""
        with np.load(self._raw_path(), allow_pickle=True) as f:
            indptr = f["adj_indptr"]
            indices = f["adj_indices"]
            n = indptr.shape[0] - 1
            src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            dst = indices.astype(np.int64)
            if "attr_data" in f:
                from scipy.sparse import csr_matrix

                feat = csr_matrix(
                    (f["attr_data"], f["attr_indices"], f["attr_indptr"]),
                    shape=f["attr_shape"]).todense().astype(np.float32)
            else:
                feat = f["attr_matrix"].astype(np.float32)
            labels = f["labels"].astype(np.int64)
        g = to_bidirected(graph((src, dst), num_nodes=n, device=self.device))
        g.ndata["feat"] = to_tensor(np.asarray(feat), g.device)
        g.ndata["label"] = to_tensor(labels, g.device)
        return [g], {}

    def _generate(self):
        n, _e, d, c = self.stats
        g = synthetic_classification_graph(
            num_nodes=n, num_classes=c, feat_dim=min(d, 512),
            avg_degree=max(2.0, self.stats[1] / max(n, 1) / 2),
            seed=hash(self.name) % (2 ** 31), device=self.device)
        return [g], {}

    @property
    def num_classes(self):
        return self.stats[3]


class CoraFullDataset(_GNNBenchmarkDataset):
    name = "cora_full"
    stats = (19793, 126842, 8710, 70)


class CoauthorCSDataset(_GNNBenchmarkDataset):
    name = "coauthor_cs"
    stats = (18333, 163788, 6805, 15)


class CoauthorPhysicsDataset(_GNNBenchmarkDataset):
    name = "coauthor_physics"
    stats = (34493, 495924, 8415, 5)


class AmazonCoBuyComputerDataset(_GNNBenchmarkDataset):
    name = "amazon_co_buy_computer"
    stats = (13752, 491722, 767, 10)


class AmazonCoBuyPhotoDataset(_GNNBenchmarkDataset):
    name = "amazon_co_buy_photo"
    stats = (7650, 238162, 745, 8)


_KARATE_EDGES = [
    (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 0), (5, 0),
    (6, 0), (6, 4), (6, 5), (7, 0), (7, 1), (7, 2), (7, 3), (8, 0),
    (8, 2), (9, 2), (10, 0), (10, 4), (10, 5), (11, 0), (12, 0), (12, 3),
    (13, 0), (13, 1), (13, 2), (13, 3), (16, 5), (16, 6), (17, 0),
    (17, 1), (19, 0), (19, 1), (21, 0), (21, 1), (25, 23), (25, 24),
    (27, 2), (27, 23), (27, 24), (28, 2), (29, 23), (29, 26), (30, 1),
    (30, 8), (31, 0), (31, 24), (31, 25), (31, 28), (32, 2), (32, 8),
    (32, 14), (32, 15), (32, 18), (32, 20), (32, 22), (32, 23), (32, 29),
    (32, 30), (32, 31), (33, 8), (33, 9), (33, 13), (33, 14), (33, 15),
    (33, 18), (33, 19), (33, 20), (33, 22), (33, 23), (33, 26), (33, 27),
    (33, 28), (33, 29), (33, 30), (33, 31), (33, 32),
]
# Community labels (instructor 0, administrator 1).
_KARATE_LABELS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int64)


class KarateClubDataset:
    """Zachary's karate club (``dgl.data.KarateClubDataset``), on
    ``device`` (default ``cuda``)."""

    num_classes = 2

    def __init__(self, device=None):
        dev = resolve_device(device)
        e = np.asarray(_KARATE_EDGES, np.int64)
        g = to_bidirected(graph((e[:, 0], e[:, 1]), num_nodes=34,
                                device=dev))
        g.ndata["label"] = to_tensor(_KARATE_LABELS, dev)
        self.graphs = [g]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.graphs[i]
