"""Citation datasets: Cora, Citeseer, Pubmed (the port's
``dgl1_tpu/data/citation.py``).

The planetoid raw files (``ind.<name>.x / .y / .tx / .ty / .allx / .ally /
.graph / .test.index``) under the data directory are parsed as the
reference parses them; without them a flagged synthetic SBM with the real
datasets' statistics is generated (``is_synthetic``), from the
reference's seed, so both packages build the same graph.
"""

from __future__ import annotations

import pickle

import numpy as np

from dgl1_tpu_torch.data.base import GraphDataset, to_tensor
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph

__all__ = ["CoraGraphDataset", "CiteseerGraphDataset", "PubmedGraphDataset",
           "load_planetoid"]

_PLANETOID_SUFFIXES = ("x", "y", "tx", "ty", "allx", "ally", "graph",
                       "test.index")


def load_planetoid(raw_dir, name, device=None):
    """The planetoid pickle set as one labelled graph on ``device``
    (``CitationGraphDataset.process``): rows are vstack(allx, tx) with
    the test block put in ``test.index`` order (citeseer's isolated test
    ids get zero rows), labels the argmax of (ally, ty), edges from the
    adjacency pickle made bidirected; masks: train = [0, len(y)), val =
    the next 500, test = test.index."""
    from scipy import sparse as sp

    from dgl1_tpu_torch.graph import graph as make_graph
    from dgl1_tpu_torch.transform import to_bidirected

    objs = {}
    for suf in _PLANETOID_SUFFIXES:
        path = raw_dir / f"ind.{name}.{suf}"
        if suf == "test.index":
            objs[suf] = np.loadtxt(path, dtype=np.int64).reshape(-1)
        else:
            with open(path, "rb") as f:
                # py2-era pickles: latin1 keeps numpy buffers intact.
                objs[suf] = pickle.load(f, encoding="latin1")

    x, y = objs["x"], objs["y"]
    tx, ty = objs["tx"], objs["ty"]
    allx, ally = objs["allx"], objs["ally"]
    test_idx = objs["test.index"]  # tx row j is node test_idx[j]

    test_sorted = np.sort(test_idx)
    lo, hi = int(test_sorted[0]), int(test_sorted[-1])
    if hi - lo + 1 != len(test_idx):
        full = hi - lo + 1
        tx_full = sp.lil_matrix((full, x.shape[1]), dtype=np.float32)
        tx_full[test_sorted - lo, :] = tx
        tx = tx_full.tocsr()
        ty_full = np.zeros((full, y.shape[1]), dtype=ty.dtype)
        ty_full[test_sorted - lo] = ty
        ty = ty_full

    feats = sp.vstack((allx, tx)).tolil()
    feats[test_idx, :] = feats[test_sorted, :]
    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx] = labels_oh[test_sorted]
    labels = labels_oh.argmax(axis=1)

    n = feats.shape[0]
    adj = objs["graph"]
    src = np.concatenate(
        [np.full(len(vs), u, np.int64) for u, vs in adj.items() if len(vs)]
    ) if adj else np.zeros(0, np.int64)
    dst = np.concatenate(
        [np.asarray(list(vs), np.int64) for vs in adj.values() if len(vs)]
    ) if adj else np.zeros(0, np.int64)
    keep = (src < n) & (dst < n)
    g = to_bidirected(make_graph((src[keep], dst[keep]), num_nodes=n,
                                 device=device))
    dev = g.device

    train_mask = np.zeros(n, bool)
    train_mask[: y.shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True

    g.ndata["feat"] = to_tensor(np.asarray(feats.todense(),
                                           dtype=np.float32), dev)
    g.ndata["label"] = to_tensor(labels.astype(np.int32), dev)
    g.ndata["train_mask"] = to_tensor(train_mask, dev)
    g.ndata["val_mask"] = to_tensor(val_mask, dev)
    g.ndata["test_mask"] = to_tensor(test_mask, dev)
    return g


class _CitationDataset(GraphDataset):
    # (num_nodes, num_edges~, feat_dim, num_classes) of the real datasets.
    stats = (2708, 10556, 1433, 7)

    def _has_raw(self) -> bool:
        return all((self.raw_dir / f"ind.{self.name}.{suf}").exists()
                   for suf in _PLANETOID_SUFFIXES)

    def _load_raw(self):
        return [load_planetoid(self.raw_dir, self.name, self.device)], {}

    def _generate(self):
        n, _e, d, c = self.stats
        g = synthetic_classification_graph(
            num_nodes=n, num_classes=c, feat_dim=d,
            avg_degree=max(2.0, self.stats[1] / self.stats[0] / 2),
            seed=hash(self.name) % (2 ** 31), device=self.device)
        return [g], {}

    @property
    def num_classes(self):
        return self.stats[3]

    @property
    def num_labels(self):
        return self.num_classes


class CoraGraphDataset(_CitationDataset):
    name = "cora"
    stats = (2708, 10556, 1433, 7)


class CiteseerGraphDataset(_CitationDataset):
    name = "citeseer"
    stats = (3327, 9104, 3703, 6)


class PubmedGraphDataset(_CitationDataset):
    name = "pubmed"
    stats = (19717, 88648, 500, 3)
