"""Deterministic synthetic graph generators (numpy, the same seeds and
draws as ``dgl1_tpu/data/synthetic.py``, so both packages build the same
edges and features)."""

from __future__ import annotations

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import to_bidirected

__all__ = ["synthetic_classification_graph", "powerlaw_graph",
           "minibatch_graph"]


def synthetic_classification_graph(
    num_nodes: int,
    num_classes: int,
    feat_dim: int,
    avg_degree: float = 4.0,
    homophily: float = 0.9,
    feature_noise: float = None,
    train_per_class: int = 20,
    num_val: int = 500,
    num_test: int = 1000,
    seed: int = 0,
    bidirected: bool = True,
    device=None,
) -> Graph:
    """SBM graph + noisy class-centroid features + citation-style splits
    in ``ndata`` (feat, label, train/val/test masks)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if feature_noise is None:
        feature_noise = 0.35 * float(np.sqrt(feat_dim))
    labels = rng.integers(0, num_classes, size=num_nodes)

    num_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, size=num_edges)
    same = rng.random(num_edges) < homophily
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(num_classes))
    class_count = np.bincount(labels, minlength=num_classes)
    rand_same = order[
        class_start[labels[src]]
        + (rng.random(num_edges) * class_count[labels[src]]).astype(np.int64)
    ]
    rand_any = rng.integers(0, num_nodes, size=num_edges)
    dst = np.where(same, rand_same, rand_any)
    keep = src != dst
    g = graph((src[keep], dst[keep]), num_nodes=num_nodes, device=dev)
    if bidirected:
        g = to_bidirected(g)

    centroids = rng.normal(size=(num_classes, feat_dim))
    feats = centroids[labels] + feature_noise * rng.normal(
        size=(num_nodes, feat_dim))

    train_mask = np.zeros(num_nodes, dtype=bool)
    for c in range(num_classes):
        ids = np.nonzero(labels == c)[0]
        train_mask[rng.choice(ids, size=min(train_per_class, len(ids)),
                              replace=False)] = True
    rest = rng.permutation(np.nonzero(~train_mask)[0])
    val_mask = np.zeros(num_nodes, dtype=bool)
    test_mask = np.zeros(num_nodes, dtype=bool)
    val_mask[rest[:num_val]] = True
    test_mask[rest[num_val:num_val + num_test]] = True

    g.ndata["feat"] = torch.from_numpy(feats.astype(np.float32)).to(dev)
    g.ndata["label"] = torch.from_numpy(labels.astype(np.int64)).to(dev)
    g.ndata["train_mask"] = torch.from_numpy(train_mask).to(dev)
    g.ndata["val_mask"] = torch.from_numpy(val_mask).to(dev)
    g.ndata["test_mask"] = torch.from_numpy(test_mask).to(dev)
    return g


def powerlaw_graph(num_nodes: int, avg_degree: int, alpha: float = 2.1,
                   seed: int = 0, **kw) -> Graph:
    """Power-law (Zipf) in-degree graph for kernel benchmarking; ``kw``
    goes to :func:`graph` (``device``, ``hub``, ...)."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    w = ranks ** -alpha
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int64)
    src = rng.integers(0, num_nodes, size=num_edges)
    return graph((src, dst), num_nodes=num_nodes, **kw)


# name -> (nodes, edges, feature width, classes, training seeds, Zipf
# exponent of the in-degrees), as tools/bench_minibatch.py's build_graph.
MINIBATCH_SCALES = {
    "reddit": (232_965, 114_615_892, 602, 41, 153_431, 2.2),
    "smoke": (20_000, 200_000, 32, 7, 4_000, 2.5),
}


def minibatch_graph(scale: str = "reddit", seed: int = 0):
    """The sampled-training graph of ``tools/bench_minibatch.py``
    (``build_graph``, same seeds and draws, so both packages sample the
    same edges): Zipf in-degrees, uniform sources. Returns
    ``(g, feat_dim, num_classes, train_ids)`` with ``g`` a sampling-only
    parent on the host (COO and CSC, ``formats=("csc",)``)."""
    n, e, f, classes, n_train, deg_alpha = MINIBATCH_SCALES[scale]
    rng = np.random.default_rng(seed)
    w = rng.zipf(deg_alpha, size=n).astype(np.float64)
    deg = np.maximum((w * (e / w.sum())).astype(np.int64), 0)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    if len(dst) < e:
        dst = np.concatenate([dst, rng.integers(0, n, size=e - len(dst))])
    dst = dst[:e]
    src = rng.integers(0, n, size=e).astype(np.int64)
    g = graph((src, dst), num_nodes=n, formats=("csc",), device="cpu")
    train_ids = np.random.default_rng(seed + 1).choice(n, size=n_train,
                                                       replace=False)
    return g, f, classes, train_ids
