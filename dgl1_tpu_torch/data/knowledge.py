"""Knowledge-graph datasets for R-GCN (the port's
``dgl1_tpu/data/knowledge.py``): FB15k-237, WN18 and AIFB.

The standard triple files are parsed when present; otherwise flagged
synthetic typed graphs with the real datasets' statistics, from the
reference's seeds.
"""

from __future__ import annotations

import numpy as np

from dgl1_tpu_torch.data.base import GraphDataset, to_tensor
from dgl1_tpu_torch.graph import graph

__all__ = ["FB15k237Dataset", "WN18Dataset", "AIFBDataset", "load_triples"]


def _typed_graph(num_nodes, num_edges, num_rels, seed, labeled_classes=None,
                 device=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges)
    dst = rng.integers(0, num_nodes, size=num_edges)
    # Relations skewed (Zipf-like) as in real knowledge graphs.
    rel_w = (np.arange(1, num_rels + 1) ** -1.1)
    rel_w /= rel_w.sum()
    etype = rng.choice(num_rels, size=num_edges, p=rel_w)
    g = graph((src, dst), num_nodes=num_nodes, device=device)
    dev = g.device
    g.edata["etype"] = to_tensor(etype.astype(np.int32), dev)
    if labeled_classes:
        # Entity classification (AIFB-style): labels follow the relation
        # histogram of each node's in-edges.
        sig = np.zeros((num_nodes, labeled_classes))
        for c in range(labeled_classes):
            rels = rng.choice(num_rels, size=3, replace=False)
            m = np.isin(etype, rels)
            np.add.at(sig[:, c], dst[m], 1.0)
        labels = sig.argmax(axis=1)
        g.ndata["label"] = to_tensor(labels.astype(np.int32), dev)
        idx = rng.permutation(num_nodes)
        train = np.zeros(num_nodes, dtype=bool)
        test = np.zeros(num_nodes, dtype=bool)
        train[idx[: num_nodes // 2]] = True
        test[idx[num_nodes // 2:]] = True
        g.ndata["train_mask"] = to_tensor(train, dev)
        g.ndata["test_mask"] = to_tensor(test, dev)
    return g


def load_triples(raw_dir, device=None):
    """The triple files (``train.txt`` / ``valid.txt`` / ``test.txt``,
    tab-separated ``head rel tail``; ``entities.dict`` /
    ``relations.dict`` honoured) as one graph on ``device`` with
    ``edata['etype']`` and per-edge split masks
    (``KnowledgeGraphDataset.process``: every triple is an edge, the
    splits are link splits)."""
    def read_dict(path):
        m = {}
        with open(path) as f:
            for line in f:
                idx, name = line.rstrip("\n").split("\t")
                m[name] = int(idx)
        return m

    ent2id = {}
    rel2id = {}
    if (raw_dir / "entities.dict").exists():
        ent2id = read_dict(raw_dir / "entities.dict")
    if (raw_dir / "relations.dict").exists():
        rel2id = read_dict(raw_dir / "relations.dict")

    def intern(m, key):
        if key not in m:
            m[key] = len(m)
        return m[key]

    triples = {}
    for part in ("train", "valid", "test"):
        rows = []
        with open(raw_dir / f"{part}.txt") as f:
            for line in f:
                h, r, t = line.rstrip("\n").split("\t")
                rows.append((intern(ent2id, h), intern(rel2id, r),
                             intern(ent2id, t)))
        triples[part] = np.asarray(rows, np.int64).reshape(-1, 3)

    allt = np.concatenate([triples[p] for p in ("train", "valid", "test")])
    n = len(ent2id)
    g = graph((allt[:, 0], allt[:, 2]), num_nodes=n, device=device)
    dev = g.device
    g.edata["etype"] = to_tensor(allt[:, 1].astype(np.int32), dev)
    e = len(allt)
    off = 0
    for part, field in (("train", "train_mask"), ("valid", "val_mask"),
                        ("test", "test_mask")):
        mask = np.zeros((e,), bool)
        mask[off: off + len(triples[part])] = True
        g.edata[field] = to_tensor(mask, dev)
        off += len(triples[part])
    g.meta["num_rels"] = len(rel2id)
    g.meta["num_entities"] = n
    return g


class _TripleDataset(GraphDataset):
    def _has_raw(self) -> bool:
        return all((self.raw_dir / f"{p}.txt").exists()
                   for p in ("train", "valid", "test"))

    def _load_raw(self):
        g = load_triples(self.raw_dir, self.device)
        self.num_rels = g.meta["num_rels"]
        return [g], {}


class FB15k237Dataset(_TripleDataset):
    name = "fb15k237"
    num_rels = 237

    def _generate(self):
        return [_typed_graph(14541, 310116, 237, seed=237,
                             device=self.device)], {}


class WN18Dataset(_TripleDataset):
    name = "wn18"
    num_rels = 18

    def _generate(self):
        return [_typed_graph(40943, 151442, 18, seed=18,
                             device=self.device)], {}


class AIFBDataset(GraphDataset):
    name = "aifb"
    num_rels = 45
    num_classes = 4

    def _generate(self):
        return [_typed_graph(8285, 58086, 45, seed=45, labeled_classes=4,
                             device=self.device)], {}
