"""CSV dataset (the port's ``dgl1_tpu/data/csv_dataset.py``;
``dgl.data.CSVDataset``'s simple mode): a graph from ``nodes.csv``
(``node_id`` [, ``feat``] [, ``label``]) and ``edges.csv`` (``src_id``,
``dst_id`` [, ``feat``] [, ``label``]); a ``feat`` cell is a
``;``-separated float list."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from dgl1_tpu_torch.data.base import to_tensor
from dgl1_tpu_torch.graph import Graph, graph, resolve_device

__all__ = ["CSVDataset"]


def _read_csv(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader]
    return header, rows


class CSVDataset:
    """``CSVDataset(dir)`` reads ``dir/nodes.csv`` and ``dir/edges.csv``
    into one graph on ``device`` (default ``cuda``); node features are
    put in node-id order."""

    def __init__(self, data_path: str, device=None):
        dev = resolve_device(device)
        d = Path(data_path)
        nh, nrows = _read_csv(d / "nodes.csv")
        eh, erows = _read_csv(d / "edges.csv")
        nid_col = nh.index("node_id")
        nids = np.asarray([int(r[nid_col]) for r in nrows])
        n = len(nids)

        src_col, dst_col = eh.index("src_id"), eh.index("dst_id")
        src = np.asarray([int(r[src_col]) for r in erows])
        dst = np.asarray([int(r[dst_col]) for r in erows])
        g = graph((src, dst), num_nodes=n, device=dev)

        def parse_feat(rows, col):
            return np.asarray(
                [[float(x) for x in r[col].split(";")] for r in rows],
                dtype=np.float32)

        if "feat" in nh:
            feats = parse_feat(nrows, nh.index("feat"))
            if not np.array_equal(nids, np.arange(n)):
                feats = feats[np.argsort(nids)]
            g.ndata["feat"] = to_tensor(feats, dev)
        if "label" in nh:
            g.ndata["label"] = to_tensor(np.asarray(
                [int(r[nh.index("label")]) for r in nrows], np.int32), dev)
        if "feat" in eh:
            g.edata["feat"] = to_tensor(parse_feat(erows, eh.index("feat")),
                                        dev)
        if "label" in eh:
            g.edata["label"] = to_tensor(np.asarray(
                [int(r[eh.index("label")]) for r in erows], np.int32), dev)
        self.graphs = [g]

    def __len__(self):
        return 1

    def __getitem__(self, i) -> Graph:
        return self.graphs[i]
