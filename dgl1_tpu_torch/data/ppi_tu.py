"""PPI (multilabel, inductive), TU and GIN graph classification (the
port's ``dgl1_tpu/data/ppi_tu.py``).

Raw files are parsed when present (``raw_dir``); otherwise flagged
fallbacks with the real datasets' shape statistics, from the reference's
seeds: PPI labels correlated with the neighbourhood, TU and GIN graphs
from the MiniGC topology generators.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from dgl1_tpu_torch.data.base import data_dir, host, to_tensor
from dgl1_tpu_torch.data.minigc import _GENERATORS
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph
from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import add_self_loop, to_bidirected

__all__ = ["PPIDataset", "TUDataset", "GINDataset", "load_ppi_raw",
           "load_tu_raw", "load_gin_raw"]


def load_ppi_raw(raw_dir, mode: str, device=None) -> List[Graph]:
    """The GraphSAGE/DGL PPI files (``python/dgl/data/ppi.py``):
    ``{mode}_graph.json`` (networkx node-link), ``{mode}_feats.npy``,
    ``{mode}_labels.npy``, ``{mode}_graph_id.npy``; one graph a graph id,
    edges kept within it."""
    dev = resolve_device(device)
    raw_dir = Path(raw_dir)
    with open(raw_dir / f"{mode}_graph.json") as f:
        nl = json.load(f)
    feats = np.load(raw_dir / f"{mode}_feats.npy")
    labels = np.load(raw_dir / f"{mode}_labels.npy")
    gid = np.load(raw_dir / f"{mode}_graph_id.npy")
    links = nl["links"]
    src = np.asarray([l["source"] for l in links], np.int64)
    dst = np.asarray([l["target"] for l in links], np.int64)
    graphs = []
    for g_id in np.unique(gid):
        nodes = np.nonzero(gid == g_id)[0]
        relabel = np.full(len(gid), -1, np.int64)
        relabel[nodes] = np.arange(len(nodes))
        keep = (gid[src] == g_id) & (gid[dst] == g_id)
        g = graph((relabel[src[keep]], relabel[dst[keep]]),
                  num_nodes=len(nodes), device=dev)
        g.ndata["feat"] = to_tensor(feats[nodes].astype(np.float32), dev)
        g.ndata["label"] = to_tensor(labels[nodes].astype(np.float32), dev)
        graphs.append(g)
    return graphs


class PPIDataset:
    """24 protein-protein interaction graphs, 50 features, 121 binary
    labels (``dgl.data.PPIDataset``; ``mode`` train, valid or test)."""

    def __init__(self, mode: str = "train", scale: int = 4, seed: int = 50,
                 raw_dir: Optional[str] = None, device=None):
        dev = resolve_device(device)
        rd = Path(raw_dir) if raw_dir else data_dir() / "ppi"
        if (rd / f"{mode}_graph.json").exists():
            self.is_synthetic = False
            self.graphs = load_ppi_raw(rd, mode, dev)
            self.labels = []
            return
        self.is_synthetic = True
        counts = {"train": 20, "valid": 2, "test": 2}[mode]
        offset = {"train": 0, "valid": 20, "test": 22}[mode]
        self.graphs: List[Graph] = []
        self.labels = []
        for i in range(counts):
            rng = np.random.default_rng(seed + offset + i)
            n = int(rng.integers(2245 // scale, 3500 // scale))
            g = synthetic_classification_graph(
                num_nodes=n, num_classes=8, feat_dim=50,
                avg_degree=28.0 / scale, seed=seed + offset + i,
                train_per_class=1, num_val=1, num_test=1, device=dev)
            # 121 targets driven by the class, with noise.
            cls = host(g.ndata["label"])
            proto = rng.random((8, 121)) < 0.3
            y = proto[cls] ^ (rng.random((n, 121)) < 0.05)
            g.ndata["label"] = to_tensor(y.astype(np.float32), dev)
            for k in ("train_mask", "val_mask", "test_mask"):
                del g.ndata[k]
            self.graphs.append(g)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Graph:
        return self.graphs[i]


_TU_STATS = {
    # name: (num_graphs, classes, min_nodes, max_nodes, feat_dim)
    "ENZYMES": (600, 6, 10, 60, 18),
    "PROTEINS": (1113, 2, 10, 60, 1),
    "DD": (1178, 2, 60, 200, 1),
    "MUTAG": (188, 2, 10, 28, 7),
}


def load_tu_raw(raw_dir, name: str, device=None
                ) -> Tuple[List[Graph], List[int], int]:
    """The TU Dortmund files (``python/dgl/data/tu.py``): ``{DS}_A.txt``
    (1-based edges), ``{DS}_graph_indicator.txt``,
    ``{DS}_graph_labels.txt`` (remapped to 0..C-1 in sorted order), the
    optional ``{DS}_node_labels.txt`` (``ndata['node_labels']``, one-hot
    in the features) and ``{DS}_node_attributes.txt``
    (``ndata['node_attr']``). Returns (graphs, labels, num_classes)."""
    dev = resolve_device(device)
    pre = Path(raw_dir) / name

    def _p(suffix):
        return Path(f"{pre}_{suffix}.txt")

    edges = np.loadtxt(_p("A"), delimiter=",", dtype=np.int64, ndmin=2) - 1
    indicator = np.loadtxt(_p("graph_indicator"), dtype=np.int64,
                           ndmin=1) - 1
    glabels_raw = np.loadtxt(_p("graph_labels"), dtype=np.int64, ndmin=1)
    uniq = np.unique(glabels_raw)
    glabels = np.searchsorted(uniq, glabels_raw)

    node_labels = None
    if _p("node_labels").exists():
        nl = np.loadtxt(_p("node_labels"), dtype=np.int64, ndmin=1)
        node_labels = nl - nl.min()
    node_attr = None
    if _p("node_attributes").exists():
        node_attr = np.loadtxt(_p("node_attributes"), delimiter=",",
                               dtype=np.float32, ndmin=2)

    num_graphs = int(indicator.max()) + 1
    # Each graph's nodes are contiguous in the TU layout.
    starts = np.searchsorted(indicator, np.arange(num_graphs))
    counts = np.bincount(indicator, minlength=num_graphs)
    edge_gid = indicator[edges[:, 0]]
    order = np.argsort(edge_gid, kind="stable")
    e_sorted = edges[order]
    e_starts = np.searchsorted(edge_gid[order], np.arange(num_graphs))
    e_ends = np.append(e_starts[1:], len(e_sorted))

    graphs, labels = [], []
    for i in range(num_graphs):
        lo = starts[i]
        n = counts[i]
        es = e_sorted[e_starts[i]: e_ends[i]] - lo
        g = graph((es[:, 0], es[:, 1]), num_nodes=int(n), device=dev)
        feat = None
        if node_labels is not None:
            nl_i = node_labels[lo: lo + n]
            onehot = np.zeros((n, int(node_labels.max()) + 1), np.float32)
            onehot[np.arange(n), nl_i] = 1.0
            g.ndata["node_labels"] = to_tensor(nl_i.astype(np.int64), dev)
            feat = onehot
        if node_attr is not None:
            attr = node_attr[lo: lo + n]
            feat = (attr if feat is None
                    else np.concatenate([attr, feat], axis=1))
            g.ndata["node_attr"] = to_tensor(attr, dev)
        if feat is None:
            feat = host(g.in_degrees()).astype(np.float32)[:, None]
        if "node_attr" not in g.ndata:
            g.ndata["node_attr"] = to_tensor(feat, dev)
        graphs.append(g)
        labels.append(int(glabels[i]))
    return graphs, labels, len(uniq)


class TUDataset:
    """TU graph-classification collections (``dgl.data.TUDataset``): the
    ``{DS}_A.txt`` file family in ``raw_dir`` when present, otherwise
    MiniGC topology classes binned into the dataset's class count with
    degree and noise features (``is_synthetic``)."""

    def __init__(self, name: str = "ENZYMES", seed: int = 0,
                 raw_dir: Optional[str] = None, device=None):
        dev = resolve_device(device)
        rd = Path(raw_dir) if raw_dir else data_dir() / "tu" / name
        if (rd / f"{name}_A.txt").exists():
            self.is_synthetic = False
            self.graphs, self.labels, self.num_classes = load_tu_raw(
                rd, name, dev)
            return
        self.is_synthetic = True
        if name not in _TU_STATS:
            raise ValueError(f"unknown TU dataset {name!r}")
        num_graphs, classes, lo, hi, fdim = _TU_STATS[name]
        self.num_classes = classes
        rng = np.random.default_rng(seed + hash(name) % 1000)
        self.graphs: List[Graph] = []
        self.labels: List[int] = []
        for _ in range(num_graphs):
            cls = int(rng.integers(0, classes))
            gen = _GENERATORS[cls % len(_GENERATORS)]
            n = int(rng.integers(lo, hi + 1))
            s, d = gen(n, rng)
            g = to_bidirected(graph((s, d), device=dev))
            deg = host(g.in_degrees()).astype(np.float32)[:, None]
            noise = rng.normal(size=(g.num_nodes(), fdim)).astype(np.float32)
            feat = np.concatenate([deg, noise], axis=1)[:, :max(fdim, 1)]
            g.ndata["node_attr"] = to_tensor(feat, dev)
            self.graphs.append(g)
            self.labels.append(cls)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, int]:
        return self.graphs[i], self.labels[i]


_GIN_STATS = {
    # name: (num_graphs, classes, min_nodes, max_nodes)
    "MUTAG": (188, 2, 10, 28),
    "COLLAB": (5000, 3, 32, 120),
    "IMDBBINARY": (1000, 2, 12, 136),
    "IMDBMULTI": (1500, 3, 7, 89),
    "NCI1": (4110, 2, 10, 111),
    "PROTEINS": (1113, 2, 10, 60),
    "PTC": (344, 2, 6, 64),
    "REDDITBINARY": (2000, 2, 60, 400),
    "REDDITMULTI5K": (5000, 5, 60, 400),
}


def load_gin_raw(path, self_loop: bool = False,
                 degree_as_nlabel: bool = False, device=None):
    """The GIN text format (``python/dgl/data/gindt.py``): the graph
    count, then per graph ``n label`` and ``n`` lines ``tag k nbr...``.
    ``ndata['attr']`` one-hot of the node tag (or degree) over the
    contiguous set of values seen; ``ndata['label']`` its index. Returns
    (graphs, labels, feature width)."""
    dev = resolve_device(device)
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    num_graphs = int(next(it))
    raw, labels = [], []
    for _ in range(num_graphs):
        n = int(next(it))
        labels.append(int(next(it)))
        src, dst, tags = [], [], []
        for v in range(n):
            tags.append(int(next(it)))
            for _ in range(int(next(it))):
                src.append(v)
                dst.append(int(next(it)))
        g = graph((np.asarray(src, np.int64), np.asarray(dst, np.int64)),
                  num_nodes=n, device=dev)
        if self_loop:
            g = add_self_loop(g)
        raw.append((g, np.asarray(tags, np.int64), host(g.in_degrees())))
    universe = np.unique(np.concatenate(
        [(deg if degree_as_nlabel else tags) for _, tags, deg in raw]
        + [np.zeros(0, np.int64)]))
    dim = max(len(universe), 1)
    graphs = []
    for g, tags, deg in raw:
        key = np.searchsorted(universe, deg if degree_as_nlabel else tags)
        onehot = np.zeros((g.num_nodes(), dim), np.float32)
        if g.num_nodes():
            onehot[np.arange(g.num_nodes()), key] = 1.0
        g.ndata["attr"] = to_tensor(onehot, dev)
        g.ndata["label"] = to_tensor(key.astype(np.int64), dev)
        graphs.append(g)
    return graphs, labels, dim


class GINDataset:
    """Graph-kernel datasets with GIN's preprocessing
    (``dgl.data.GINDataset``): one-hot degree (or node tag) features in
    ``ndata['attr']``, optional self-loops. ``{name}.txt`` in ``raw_dir``
    when present; otherwise MiniGC topologies at the dataset's counts
    (``max_graphs`` caps them; ``is_synthetic``)."""

    def __init__(self, name: str = "MUTAG", self_loop: bool = False,
                 degree_as_nlabel: bool = True, max_graphs: int = 512,
                 seed: int = 0, raw_dir: Optional[str] = None, device=None):
        dev = resolve_device(device)
        rd = Path(raw_dir) if raw_dir else data_dir() / "gin"
        if (rd / f"{name}.txt").exists():
            self.is_synthetic = False
            self.graphs, self.labels, self.dim_nfeats = load_gin_raw(
                rd / f"{name}.txt", self_loop=self_loop,
                degree_as_nlabel=degree_as_nlabel, device=dev)
            self.num_classes = self.gclasses = len(set(self.labels))
            return
        self.is_synthetic = True
        if name not in _GIN_STATS:
            raise ValueError(f"unknown GIN dataset {name!r}")
        num_graphs, classes, lo, hi = _GIN_STATS[name]
        num_graphs = min(num_graphs, max_graphs)
        self.num_classes = self.gclasses = classes
        rng = np.random.default_rng(seed + hash(name) % 1000)
        self.graphs: List[Graph] = []
        self.labels: List[int] = []
        max_deg = 0
        raw = []
        for _ in range(num_graphs):
            cls = int(rng.integers(0, classes))
            gen = _GENERATORS[cls % len(_GENERATORS)]
            n = int(rng.integers(lo, min(hi, 64) + 1))
            s, d = gen(n, rng)
            g = to_bidirected(graph((s, d), device=dev))
            if self_loop:
                g = add_self_loop(g)
            deg = host(g.in_degrees())
            max_deg = max(max_deg, int(deg.max()))
            raw.append((g, deg, cls))
        self.dim_nfeats = max_deg + 1
        for g, deg, cls in raw:
            onehot = np.zeros((g.num_nodes(), max_deg + 1), np.float32)
            onehot[np.arange(g.num_nodes()), deg] = 1.0
            g.ndata["attr"] = to_tensor(onehot, dev)
            g.ndata["label"] = to_tensor(deg.astype(np.int64), dev)
            self.graphs.append(g)
            self.labels.append(cls)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, int]:
        return self.graphs[i], self.labels[i]
