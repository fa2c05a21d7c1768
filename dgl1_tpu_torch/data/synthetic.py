"""Deterministic synthetic graph generators (numpy, the same seeds and
draws as ``dgl1_tpu/data/synthetic.py``, so both packages build the same
edges and features)."""

from __future__ import annotations

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import to_bidirected

__all__ = ["synthetic_classification_graph", "powerlaw_graph",
           "geometric_graph", "typed_powerlaw_graph", "sort_by_relation",
           "minibatch_graph", "synthetic_mag_heterograph"]


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


def geometric_graph(num_nodes: int, avg_degree: int, seed: int = 0,
                    **kw) -> Graph:
    """Local-band "geometric" graph: node ids are positions along a 1-D
    embedding and edges join nearby ids (Gaussian offsets), the locality
    of meshes and road networks, where no node is a hub. The hub-free
    family of bench.py's matrix; ``kw`` goes to :func:`graph` (pass
    ``formats=(..., "bdense")`` for the block-dense layout)."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=num_edges)
    off = np.rint(rng.normal(0.0, max(avg_degree, 2), num_edges)
                  ).astype(np.int64)
    off = np.where(off == 0, 1, off)
    dst = np.clip(src + off, 0, num_nodes - 1)
    return graph((src, dst), num_nodes=num_nodes, **kw)


def typed_powerlaw_graph(num_nodes: int, avg_degree: int, num_rels: int,
                         seed: int = 0, **kw):
    """The typed graph of ``tools/bench_models.py --model rgcn``:
    ``powerlaw_graph(num_nodes, avg_degree, seed=seed)`` and relation ids
    drawn as that script draws them, ``default_rng(0).integers(0,
    num_rels)`` per edge. Returns ``(g, etypes)``, etypes an int32 numpy
    array of ``num_edges_padded`` entries."""
    g = powerlaw_graph(num_nodes, avg_degree, seed=seed, **kw)
    etypes = np.random.default_rng(0).integers(
        0, num_rels, size=g.num_edges_padded()).astype(np.int32)
    return g, etypes


def sort_by_relation(g: Graph, etypes, num_rels: int):
    """The relation-sorted copy of ``examples/train_rgcn.py`` for the
    grouped-GEMM path: the same edges stably sorted by relation, rebuilt
    on ``g``'s device. Returns ``(g_sorted, etypes_sorted, counts)``, the
    per-relation edge counts as an int32 numpy array."""
    e = g.num_edges()
    etypes = np.asarray(etypes)[:e]
    order = np.argsort(etypes, kind="stable")
    src, dst = (x[:e].cpu().numpy()[order] for x in g.edges())
    g2 = graph((src, dst), num_nodes=g.num_nodes(), device=g.device)
    counts = np.bincount(etypes, minlength=num_rels).astype(np.int32)
    return g2, etypes[order], counts


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


def synthetic_mag_heterograph(scale: int = 10, num_classes: int = 349,
                              feat_dim: int = 128, seed: int = 7,
                              device=None):
    """An ogbn-mag-shaped heterograph, the reference's synthetic stand-in
    (the same draws from ``default_rng(seed)`` in the same order): node
    types paper, author, institution and field_of_study at the real
    counts divided by ``scale`` (institution by ``scale // 4``); relations
    writes (7 a author), cites (10 a paper), affiliated_with (1 a
    author), has_topic (5 a paper), the three non-paper ones with their
    reverses. Authors and fields have a home class that their edges
    prefer (0.8), cites is homophilous the same way. Papers carry
    ``feat`` (float32 noisy class centroids) and ``label`` (int32).
    Returns ``(hg, split)``, ``split`` the train/val/test paper ids
    (60/20/20 of a permutation)."""
    from dgl1_tpu_torch.heterograph import heterograph

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_paper = max(736_389 // scale, num_classes * 10)
    n_author = max(1_134_649 // scale, 100)
    n_inst = max(8_740 // max(scale // 4, 1), 20)
    n_field = max(59_965 // scale, num_classes)

    lab_p = rng.integers(0, num_classes, size=n_paper)
    lab_a = rng.integers(0, num_classes, size=n_author)
    lab_f = np.concatenate([
        np.arange(num_classes),  # every class has at least one field
        rng.integers(0, num_classes, size=n_field - num_classes),
    ])

    def pick_same(lab_dst_pool, want_class, p_same=0.8):
        """Endpoint ids from lab_dst_pool, biased to the wanted class."""
        order = np.argsort(lab_dst_pool, kind="stable")
        start = np.searchsorted(lab_dst_pool[order], np.arange(num_classes))
        count = np.bincount(lab_dst_pool, minlength=num_classes)
        same = rng.random(len(want_class)) < p_same
        r_same = order[start[want_class] + (
            rng.random(len(want_class)) * np.maximum(count[want_class], 1)
        ).astype(np.int64)]
        r_any = rng.integers(0, len(lab_dst_pool), size=len(want_class))
        return np.where(same & (count[want_class] > 0), r_same, r_any)

    a_w = rng.integers(0, n_author, size=n_author * 7)
    p_w = pick_same(lab_p, lab_a[a_w])
    p_c_src = rng.integers(0, n_paper, size=n_paper * 10)
    p_c_dst = pick_same(lab_p, lab_p[p_c_src])
    a_af = rng.integers(0, n_author, size=n_author)
    i_af = rng.integers(0, n_inst, size=n_author)
    p_t = rng.integers(0, n_paper, size=n_paper * 5)
    f_t = pick_same(lab_f, lab_p[p_t])

    counts = {"paper": n_paper, "author": n_author,
              "institution": n_inst, "field_of_study": n_field}
    hg = heterograph({
        ("author", "writes", "paper"): (a_w, p_w),
        ("paper", "rev_writes", "author"): (p_w, a_w),
        ("paper", "cites", "paper"): (p_c_src, p_c_dst),
        ("author", "affiliated_with", "institution"): (a_af, i_af),
        ("institution", "rev_affiliated_with", "author"): (i_af, a_af),
        ("paper", "has_topic", "field_of_study"): (p_t, f_t),
        ("field_of_study", "rev_has_topic", "paper"): (f_t, p_t),
    }, num_nodes_dict=counts, device=dev)

    noise = 0.5 * float(np.sqrt(feat_dim))
    centroids = rng.normal(size=(num_classes, feat_dim))
    feat = centroids[lab_p] + noise * rng.normal(size=(n_paper, feat_dim))
    hg.nodes["paper"].data["feat"] = torch.as_tensor(
        feat.astype(np.float32), device=dev)
    hg.nodes["paper"].data["label"] = torch.as_tensor(
        lab_p.astype(np.int32), device=dev)
    perm = rng.permutation(n_paper)
    n_tr, n_va = int(0.6 * n_paper), int(0.2 * n_paper)
    split = {"train": perm[:n_tr], "val": perm[n_tr:n_tr + n_va],
             "test": perm[n_tr + n_va:]}
    return hg, split
