"""OGB node-property datasets (the port's ``dgl1_tpu/data/ogb.py``):
ogbn-products, -arxiv, -mag, -papers100M.

The standard pre-downloaded directory (``raw/edge.csv.gz``,
``raw/node-feat.csv.gz``, ``raw/node-label.csv.gz``, optional
``raw/num-node-list.csv.gz``, splits under
``split/*/{train,valid,test}.csv.gz``; ``.csv`` and ``.npy`` accepted too)
is parsed when present; otherwise a flagged synthetic stand-in, scaled
down by the dataset's divisor unless ``scale`` is given, from the
reference's seed.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from dgl1_tpu_torch.data.base import GraphDataset, to_tensor
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph

__all__ = ["OGBDataset"]


def _find(dirpath: Path, stem: str):
    """``stem`` as .csv.gz, .csv or .npy under ``dirpath``, or None."""
    for suffix in (".csv.gz", ".csv", ".npy"):
        p = dirpath / f"{stem}{suffix}"
        if p.exists():
            return p
    return None


def _load_table(path: Path, dtype):
    """One OGB table (comma-separated numeric rows, or .npy)."""
    if path.suffix == ".npy":
        return np.load(path).astype(dtype)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


_STATS = {
    # name: (nodes, avg_degree, feat_dim, classes, scale_divisor)
    "ogbn-products": (2_449_029, 50, 100, 47, 20),
    "ogbn-arxiv": (169_343, 13, 128, 40, 1),
    "ogbn-mag": (736_389, 28, 128, 349, 10),
    "ogbn-papers100M": (111_059_956, 15, 128, 172, 1000),
}


class OGBDataset(GraphDataset):
    """``OGBDataset('ogbn-arxiv')``: one labelled graph. ``scale=1`` gives
    the true node count to the synthetic fallback."""

    def __init__(self, name: str, scale: int = 0, **kw):
        if name not in _STATS:
            raise ValueError(f"unknown OGB dataset {name!r}")
        self.ogb_name = name
        self.name = name.replace("-", "_")
        divisor = _STATS[name][4]
        self._scale = scale if scale > 0 else divisor
        self.num_classes = _STATS[name][3]
        super().__init__(**kw)

    def _has_raw(self) -> bool:
        return _find(self.raw_dir / "raw", "edge") is not None

    def _load_raw(self):
        """The homogeneous OGB node-property directory, as
        ``ogb.nodeproppred.DglNodePropPredDataset`` assembles it."""
        from dgl1_tpu_torch.graph import graph as make_graph

        raw = self.raw_dir / "raw"
        edges = _load_table(_find(raw, "edge"), np.int64)
        n_path = _find(raw, "num-node-list")
        feat_path = _find(raw, "node-feat")
        label_path = _find(raw, "node-label")
        if n_path is not None:
            n = int(_load_table(n_path, np.int64).reshape(-1)[0])
        else:
            n = int(edges.max()) + 1
        g = make_graph((edges[:, 0], edges[:, 1]), num_nodes=n,
                       device=self.device)
        dev = g.device
        if feat_path is not None:
            g.ndata["feat"] = to_tensor(_load_table(feat_path, np.float32),
                                        dev)
        if label_path is not None:
            g.ndata["label"] = to_tensor(
                _load_table(label_path, np.int64).reshape(-1)
                .astype(np.int32), dev)
        split_root = self.raw_dir / "split"
        if split_root.exists():
            schemes = sorted(p for p in split_root.iterdir() if p.is_dir())
            if schemes:
                for part, field in (("train", "train_mask"),
                                    ("valid", "val_mask"),
                                    ("test", "test_mask")):
                    p = _find(schemes[0], part)
                    if p is None:
                        continue
                    ids = _load_table(p, np.int64).reshape(-1)
                    mask = np.zeros((n,), bool)
                    mask[ids] = True
                    g.ndata[field] = to_tensor(mask, dev)
        return [g], {}

    def _generate(self):
        nodes, deg, dim, classes, _ = _STATS[self.ogb_name]
        n = max(nodes // self._scale, 10 * classes)
        g = synthetic_classification_graph(
            num_nodes=n, num_classes=classes, feat_dim=dim,
            avg_degree=float(deg),
            train_per_class=max(20, n // (20 * classes)),
            num_val=min(5000, n // 10), num_test=min(10000, n // 5),
            seed=hash(self.ogb_name) % (2 ** 31), device=self.device)
        return [g], {}
