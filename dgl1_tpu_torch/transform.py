"""Graph transforms (host side, numpy): the port's counterparts of
``dgl1_tpu/transform.py``'s ``add_self_loop``, ``remove_self_loop``,
``to_bidirected``, ``rcm_order``, ``reorder_graph`` (algorithms ``'rcm'``,
``'hub'`` and ``'custom'``), ``edge_subgraph``, ``typed_subgraphs``
(with the identity layouts), ``typed_union_graph``, ``to_homogeneous``,
``to_heterogeneous``, ``metapath_reachable_graph``, ``node_subgraph``,
``compact_graphs``, ``to_block``, ``to_block_hetero``,
``add_reverse_edges``, ``to_simple``, ``khop_graph``, ``line_graph``,
``in_subgraph``, ``out_subgraph``, ``knn_graph``,
``segmented_knn_graph``, ``laplacian_lambda_max``, ``add_edges``,
``remove_edges``, ``add_nodes``, ``remove_nodes``, ``laplacian_pe``,
``random_walk_pe``, ``shortest_dist`` and ``merge``. Each returns a new
graph (or tensor) on the input graph's device."""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import (Graph, _tree_to, block, graph,
                                  resolve_device)

__all__ = ["add_self_loop", "remove_self_loop", "to_bidirected",
           "rcm_order", "reorder_graph", "edge_subgraph", "typed_subgraphs",
           "typed_union_graph", "to_homogeneous", "to_heterogeneous",
           "metapath_reachable_graph", "node_subgraph", "compact_graphs",
           "to_block", "to_block_hetero", "reverse", "add_reverse_edges",
           "to_simple", "khop_graph", "line_graph", "in_subgraph",
           "out_subgraph", "knn_graph", "segmented_knn_graph",
           "laplacian_lambda_max", "add_edges", "remove_edges", "add_nodes",
           "remove_nodes", "laplacian_pe", "random_walk_pe", "shortest_dist",
           "merge"]


def _coo(g: Graph):
    """Real (unpadded) COO as numpy."""
    src, dst = g.edges()
    e = g.num_edges()
    return src[:e].cpu().numpy(), dst[:e].cpu().numpy()


def _slice_rows(data: dict, idx: np.ndarray) -> dict:
    out = {}
    for k, v in data.items():
        i = torch.as_tensor(idx, dtype=torch.int64, device=v.device)
        out[k] = v.index_select(0, i.clamp(0, v.shape[0] - 1))
    return out


def _ids(x) -> np.ndarray:
    """Ids or a bool mask (list, numpy or tensor) as int64 numpy ids."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    return np.nonzero(x)[0] if x.dtype == bool else x.astype(np.int64)


def _unique_pairs(s: np.ndarray, d: np.ndarray, n: int):
    """Sorted distinct (s, d) pairs through one packed int64 key."""
    key = np.unique(s.astype(np.int64) * n + d.astype(np.int64))
    return key // n, key % n


def reverse(g: Graph, copy_edata: bool = True) -> Graph:
    """``dgl.reverse``: every edge reversed (CSR and CSC swap roles)."""
    return g.reverse(copy_edata=copy_edata)


def add_self_loop(g: Graph) -> Graph:
    """Append one (i, i) edge per node; existing self-loops are kept."""
    src, dst = _coo(g)
    n = g.num_nodes()
    loops = np.arange(n, dtype=src.dtype)
    new = graph((np.concatenate([src, loops]), np.concatenate([dst, loops])),
                num_nodes=n, device=g.device)
    new.ndata.update(g.ndata)
    for k, v in g.edata.items():
        pad = v.new_zeros((n,) + tuple(v.shape[1:]))
        new.edata[k] = torch.cat([v[: g.num_edges()], pad], dim=0)
    return new


def remove_self_loop(g: Graph) -> Graph:
    src, dst = _coo(g)
    keep = src != dst
    new = graph((src[keep], dst[keep]), num_nodes=g.num_nodes(),
                device=g.device)
    new.ndata.update(g.ndata)
    new.edata.update(_slice_rows(g.edata, np.nonzero(keep)[0]))
    return new


def to_bidirected(g: Graph) -> Graph:
    """Add reverse edges and deduplicate (packed int64 keys)."""
    src, dst = _coo(g)
    s, d = _unique_pairs(np.concatenate([src, dst]),
                         np.concatenate([dst, src]), g.num_nodes())
    return graph((s, d), num_nodes=g.num_nodes(), device=g.device)


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee node order over the undirected adjacency,
    ``perm[new_id] = old_id``. Per connected component: BFS from a
    minimum-degree seed, neighbours expanded in ascending-degree order,
    then the whole order reversed. After it the adjacency concentrates
    near the diagonal, so the block-dense layout's 128 x 128 blocks fill
    up (``reorder_graph(g, 'rcm', formats=(..., 'bdense'))``)."""
    n = g.num_nodes()
    src, dst = _coo(g)
    us = np.concatenate([src, dst])
    vs = np.concatenate([dst, src])
    order = np.argsort(us, kind="stable")
    us, vs = us[order], vs[order]
    deg = np.bincount(us, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])

    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):  # min-degree seeds first
        if visited[seed]:
            continue
        visited[seed] = True
        out[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = out[head]
            head += 1
            nbr = vs[indptr[u]:indptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if len(nbr):
                nbr = np.unique(nbr)  # sorted + deduped
                nbr = nbr[np.argsort(deg[nbr], kind="stable")]
                visited[nbr] = True
                out[pos:pos + len(nbr)] = nbr
                pos += len(nbr)
    return out[::-1].copy()


def reorder_graph(g: Graph, node_permute_algo: str = "metis",
                  edge_permute_algo: str = "src", store_ids: bool = True,
                  permute_config: Optional[dict] = None,
                  formats=None) -> Graph:
    """Relabel nodes and sort edges for locality (``dgl.reorder_graph``).

    ``node_permute_algo``: ``'rcm'`` (:func:`rcm_order`); ``'hub'``, the
    hub-first identity-expand relabel (:func:`hub_format.hub_order`) with
    the hub layout rebuilt (pass non-default hub floors through
    ``permute_config={'hub': ..., 'hub_dense_floor': ...}``);
    ``'custom'`` with ``permute_config={'nodes_perm': perm}``, ``perm[new]
    = old``; ``'metis'``, nodes ordered by part
    (``parallel.metis_partition_assignment``, ``permute_config={'k':
    parts}``, default 8). ``edge_permute_algo``:
    ``'src'`` or ``'dst'`` (stable sort by the new id) or ``'custom'``
    (``permute_config={'edges_perm': ...}``). ``formats`` goes to
    :func:`graph`: ``('coo', 'csr', 'csc', 'ell', 'bdense')`` builds the
    block-dense layout on the reordered graph. With ``store_ids`` the old
    ids land in ``ndata['_ID']`` and ``edata['_ID']``. The signature is
    the reference's."""
    cfg = permute_config or {}
    n = g.num_nodes()
    if node_permute_algo == "rcm":
        perm = rcm_order(g)
    elif node_permute_algo == "metis":
        from dgl1_tpu_torch.parallel.partition import (
            metis_partition_assignment)

        part = metis_partition_assignment(g, int(cfg.get("k", 8)))
        perm = np.argsort(part, kind="stable").astype(np.int64)
    elif node_permute_algo == "hub":
        from dgl1_tpu_torch.hub_format import hub_order

        if "hub" in cfg or "hub_dense_floor" in cfg:
            # The perm must come from a layout with the floors the rebuild
            # below uses, or identity_expand is lost.
            src0, dst0 = _coo(g)
            tmp = graph((src0, dst0), num_nodes=n, hub=cfg.get("hub"),
                        hub_dense_floor=cfg.get("hub_dense_floor"),
                        device="cpu")
            perm = hub_order(tmp)
        else:
            perm = hub_order(g)
    elif node_permute_algo == "custom":
        perm = np.asarray(cfg["nodes_perm"], np.int64)
        if perm.shape != (n,):
            raise ValueError("nodes_perm must have num_nodes entries")
    else:
        raise ValueError(f"unknown node_permute_algo {node_permute_algo!r}")

    relabel = np.empty(n, np.int64)
    relabel[perm] = np.arange(n)
    src, dst = _coo(g)
    new_src, new_dst = relabel[src], relabel[dst]

    if edge_permute_algo == "src":
        eperm = np.argsort(new_src, kind="stable")
    elif edge_permute_algo == "dst":
        eperm = np.argsort(new_dst, kind="stable")
    elif edge_permute_algo == "custom":
        eperm = np.asarray(cfg["edges_perm"], np.int64)
    else:
        raise ValueError(f"unknown edge_permute_algo {edge_permute_algo!r}")
    new_src, new_dst = new_src[eperm], new_dst[eperm]

    gkw = {k: cfg[k] for k in ("hub", "hub_dense_floor")
           if node_permute_algo == "hub" and k in cfg}
    new = graph((new_src, new_dst), num_nodes=n, formats=formats,
                device=g.device, **gkw)
    if (node_permute_algo == "hub" and new.hub_dst_meta is not None
            and not new.hub_dst_meta.identity_expand):
        warnings.warn(
            "reorder_graph(node_permute_algo='hub') rebuilt a hub layout "
            "WITHOUT identity_expand (pass the graph's hub floors via "
            "permute_config={'hub': ..., 'hub_dense_floor': ...}).",
            stacklevel=2)
    new.ndata.update(_slice_rows(g.ndata, perm))
    new.edata.update(_slice_rows(g.edata, eperm))
    if store_ids:
        new.ndata["_ID"] = torch.as_tensor(perm.astype(np.int32),
                                           device=new.device)
        new.edata["_ID"] = torch.as_tensor(eperm.astype(np.int32),
                                           device=new.device)
    return new


def edge_subgraph(g: Graph, edges, relabel_nodes: bool = True,
                  pad_edges_to: Optional[int] = None,
                  formats=None) -> Graph:
    """Edge-induced subgraph: the edges ``edges`` (ids or a bool mask) in
    the given order. With ``relabel_nodes`` the nodes they touch are
    renumbered in id order (old ids in ``ndata['_ID']``), else the parent's
    node space is kept. Old edge ids land in ``edata['_ID']``.
    ``pad_edges_to`` and ``formats`` go to :func:`graph`; the padded
    edges' rows of every ``edata`` field repeat the parent's row 0 (the
    engines mask them out)."""
    edges = _ids(edges)
    src, dst = _coo(g)
    s, d = src[edges], dst[edges]
    kw = dict(pad_edges_to=pad_edges_to, formats=formats, device=g.device)
    if relabel_nodes:
        nodes = np.unique(np.concatenate([s, d]))
        relabel = np.full((g.num_src_nodes(),), -1, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        new = graph((relabel[s], relabel[d]), num_nodes=len(nodes), **kw)
        new.ndata.update(_slice_rows(g.ndata, nodes))
        new.ndata["_ID"] = torch.as_tensor(nodes.astype(np.int32),
                                           device=new.device)
    else:
        new = graph((s, d), num_nodes=g.num_src_nodes(), **kw)
        new.ndata.update(g.ndata)
    rows = edges
    if pad_edges_to is not None and pad_edges_to > len(edges):
        rows = np.concatenate(
            [edges, np.zeros(pad_edges_to - len(edges), np.int64)])
    new.edata.update(_slice_rows(g.edata, rows))
    new.edata["_ID"] = torch.as_tensor(edges.astype(np.int32),
                                       device=new.device)
    return new


def _typed_tail_meta(m, et2, dst2, num_rels: int):
    """The pinned tail meta of the identity relation layouts: the parent's
    bucket boundaries with each bucket's width shrunk to the largest
    per-relation degree of its rows (ladder rungs), then merged pairwise
    at the least added slots down to ``DGL1_TPU_TYPED_TAIL_BUCKETS``
    buckets (default: no merge), as the reference does."""
    from dgl1_tpu_torch.graph import _ladder_rung

    k_slots0 = m.n_groups * 128
    n_tail_p = int(m.n_tail_rows)
    tail_meta = tuple(m.tail_meta_dst)
    if n_tail_p == 0:
        return tail_meta
    caps = np.zeros((n_tail_p,), np.int64)
    for r in range(int(num_rels)):
        d_r = dst2[et2 == r]
        d_r = d_r[(d_r >= k_slots0) & (d_r < k_slots0 + n_tail_p)]
        np.maximum(caps, np.bincount(d_r - k_slots0, minlength=n_tail_p),
                   out=caps)
    rungs = np.array([_ladder_rung(int(c)) if c else 1 for c in caps],
                     np.int64)
    bounds = np.cumsum([0] + [nb for _, nb in tail_meta])
    segs = [(int(rungs[a:b].max(initial=1)), int(b - a))
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    n_buckets = int(os.environ.get("DGL1_TPU_TYPED_TAIL_BUCKETS",
                                   str(len(segs))))
    while len(segs) > n_buckets:
        costs = [max(segs[i][0], segs[i + 1][0])
                 * (segs[i][1] + segs[i + 1][1])
                 - segs[i][0] * segs[i][1] - segs[i + 1][0] * segs[i + 1][1]
                 for i in range(len(segs) - 1)]
        i = int(np.argmin(costs))
        segs[i: i + 2] = [(max(segs[i][0], segs[i + 1][0]),
                           segs[i][1] + segs[i + 1][1])]
    return tuple(segs)


def typed_subgraphs(g: Graph, etypes, num_rels: int,
                    identity: bool = False):
    """One edge-induced subgraph per relation, all in the parent's node
    space, for ``RelGraphConv(rel_graphs=...)``: relation r holds the
    edges with ``etypes == r`` in edge order, with its own hub layout
    where its in-degrees clear the bar. ``etypes`` is host data (numpy or
    a tensor, read up to ``num_edges``).

    ``identity=True``, the identity typed layouts: the nodes are relabeled
    hub-first by total degree (``reorder_graph(g, 'hub')``), then every
    relation's hub layout is built with the relabeled parent's geometry
    pinned (``build_hub_format(identity_force=)``: hub slots are ids
    ``[0, n_groups*128)``, tail rows follow in id order under the tail
    meta of :func:`_typed_tail_meta`), so every relation claims
    ``identity_expand`` and its forward merge is a concat and a pad.
    Returns ``(rel_graphs, perm)``, ``perm[new] = old``: apply it to every
    node-aligned array, as after :func:`reorder_graph`. A parent whose
    relabel has no identity hub layout gives a warning and the plain
    subgraphs with the identity ``perm``."""
    if isinstance(etypes, torch.Tensor):
        etypes = etypes.cpu().numpy()
    etypes = np.asarray(etypes)[: g.num_edges()]
    if not identity:
        return tuple(edge_subgraph(g, np.nonzero(etypes == r)[0],
                                   relabel_nodes=False)
                     for r in range(int(num_rels)))

    from dgl1_tpu_torch import hub_format as hf
    from dgl1_tpu_torch.graph import _build_ell

    g2 = (reorder_graph(g, node_permute_algo="hub")
          if g.hub_dst is not None else g)
    if g2.hub_dst_meta is None or not g2.hub_dst_meta.identity_expand:
        warnings.warn(
            "typed_subgraphs(identity=True): the parent graph has no "
            "identity hub layout; returning plain per-relation subgraphs "
            "(descriptor expand).", stacklevel=2)
        perm = np.arange(g.num_nodes(), dtype=np.int64)
        return typed_subgraphs(g, etypes, num_rels), perm
    perm = g2.ndata["_ID"].cpu().numpy().astype(np.int64)
    et2 = etypes[g2.edata["_ID"].cpu().numpy().astype(np.int64)]
    m = g2.hub_dst_meta
    n = g2.num_nodes()
    src2, dst2 = _coo(g2)
    ident = {"n_groups": m.n_groups, "n_dense": m.n_dense,
             "tail_meta_dst": _typed_tail_meta(m, et2, dst2, num_rels)}
    out = []
    for r in range(int(num_rels)):
        mask = et2 == r
        gr = graph((src2[mask], dst2[mask]), num_nodes=n, hub=False,
                   formats=("coo", "csr", "csc", "ell"), device="cpu")
        mr, ar = hf.build_hub_format(
            gr.csc_indptr.numpy(), gr.csc_src.numpy(), gr.csc_eid.numpy(),
            gr.csc_dst.numpy(), n, n, gr.num_edges(), gr.num_edges_padded(),
            _build_ell, identity_force=ident)
        assert mr is not None and mr.identity_expand, (
            "identity_force build must give an identity layout")
        gr.hub_dst_meta, gr.hub_dst = mr, _tree_to(ar, "cpu")
        out.append(gr.to(g.device))
    return tuple(out), perm


def typed_union_graph(g: Graph, etypes, num_rels: int, hub=None,
                      hub_dense_floor=None, relabel: bool = True):
    """Typed aggregation as one bipartite g-SpMM: ``out[d] = sum_r
    sum_{(s->d) in r} Z_r[s]`` is a copy_u sum over the relation-stacked
    source space ``etype * N + src`` with the destinations unchanged, so
    one hub layout serves every relation (``RelGraphConv(union_graph=)``
    feeds it ``Z`` of (R*N, F)). With ``relabel`` the nodes are renumbered
    hub-first (:func:`hub_format.hub_order` on the union layout) and the
    layout rebuilt, which then claims ``identity_expand`` (a warning where
    a hub-group tie loses it). ``hub`` and ``hub_dense_floor`` as in
    :func:`graph`. Returns ``(gu, perm)``: a block with ``num_src_nodes =
    num_rels * N`` and ``perm[new] = old`` (apply it to every
    node-aligned array)."""
    from dgl1_tpu_torch.graph import _build_formats

    if isinstance(etypes, torch.Tensor):
        etypes = etypes.cpu().numpy()
    e = g.num_edges()
    etypes = np.asarray(etypes, np.int64)[:e]
    src, dst = (a.astype(np.int64) for a in _coo(g))
    n = g.num_nodes()
    r_n = int(num_rels) * n

    def build(s2, d2):
        arrays = _build_formats(
            s2, d2, r_n, n, e, hub=hub, hub_dense_floor=hub_dense_floor,
            formats=("coo", "csr", "csc", "ell", "hub"))
        return Graph(**arrays, num_src_nodes=r_n, num_dst_nodes=n,
                     num_edges=e, is_block=True, device="cpu")

    perm = np.arange(n, dtype=np.int64)
    gu = build(etypes * n + src, dst)
    if relabel and gu.hub_dst is not None:
        from dgl1_tpu_torch.hub_format import hub_order

        perm = hub_order(gu)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        gu = build(etypes * n + inv[src], inv[dst])
        if (gu.hub_dst_meta is not None
                and not gu.hub_dst_meta.identity_expand):
            warnings.warn(
                "typed_union_graph: the hub-first relabel did not give an "
                "identity layout (a hub-group tie); the descriptor expand "
                "stays, the result is unchanged.", stacklevel=2)
    return gu.to(g.device), perm


def to_homogeneous(hg) -> Graph:
    """One homogeneous graph from a heterograph (``dgl.to_homogeneous``):
    node types in sorted order, each type's ids offset by the counts
    before it; relations in canonical order. ``ndata['_TYPE']`` and
    ``edata['_TYPE']`` hold the type ids and ``'_ID'`` the per-type ids,
    int32."""
    offsets, off = {}, 0
    for nt in hg.ntypes:
        offsets[nt] = off
        off += hg.num_nodes(nt)
    srcs, dsts, etype_ids, eids = [], [], [], []
    for i, c in enumerate(hg.canonical_etypes):
        st, _, dt = c
        s, d = _coo(hg.rel_graphs[c])
        srcs.append(s.astype(np.int64) + offsets[st])
        dsts.append(d.astype(np.int64) + offsets[dt])
        etype_ids.append(np.full(len(s), i, dtype=np.int32))
        eids.append(np.arange(len(s), dtype=np.int32))

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(0, dtype)

    new = graph((cat(srcs, np.int64), cat(dsts, np.int64)), num_nodes=off,
                device=hg.device)
    ntype_arr = cat([np.full(hg.num_nodes(nt), i, dtype=np.int32)
                     for i, nt in enumerate(hg.ntypes)], np.int32)
    nid_arr = cat([np.arange(hg.num_nodes(nt), dtype=np.int32)
                   for nt in hg.ntypes], np.int32)
    for frame, key, arr in ((new.ndata, "_TYPE", ntype_arr),
                            (new.ndata, "_ID", nid_arr),
                            (new.edata, "_TYPE", cat(etype_ids, np.int32)),
                            (new.edata, "_ID", cat(eids, np.int32))):
        frame[key] = torch.as_tensor(arr, device=new.device)
    return new


def to_heterogeneous(g: Graph, ntypes, etypes, metagraph=None):
    """A heterograph from a homogeneous graph carrying ``_TYPE`` and
    ``_ID`` (``dgl.to_heterogeneous``). ``metagraph`` maps an edge-type id
    to ``(srctype, etype, dsttype)``; without it each relation's end
    types are those of its first edge."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    ntype_arr = g.ndata["_TYPE"].cpu().numpy()
    nid_arr = g.ndata["_ID"].cpu().numpy()
    etype_arr = g.edata["_TYPE"].cpu().numpy()[: g.num_edges()]
    src, dst = _coo(g)
    counts = {nt: int((ntype_arr == i).sum()) for i, nt in enumerate(ntypes)}
    rels = {}
    for j, et in enumerate(etypes):
        m = etype_arr == j
        if metagraph is not None:
            c = metagraph[j]
        elif m.any():
            c = (ntypes[int(ntype_arr[src[m][0]])], et,
                 ntypes[int(ntype_arr[dst[m][0]])])
        else:
            c = (ntypes[0], et, ntypes[0])
        rels[c] = block((nid_arr[src[m]], nid_arr[dst[m]]),
                        num_src_nodes=counts[c[0]],
                        num_dst_nodes=counts[c[2]], device=g.device)
    return HeteroGraph(rels, counts)


def metapath_reachable_graph(hg, metapath) -> Graph:
    """The graph from the first to the last node type of ``metapath`` with
    an edge wherever a path runs along its relations
    (``dgl.metapath_reachable_graph``): the product of the relations'
    adjacency matrices on the host (scipy.sparse), each entry one edge,
    in the product's row-major order. Same end types give a graph with
    the type's frame; different ones a block with the source and
    destination types' frames. Path counts are int64 (the reference's
    int8 counts wrap, and a pair reached by a multiple of 256 paths is
    dropped there)."""
    import scipy.sparse as sp

    canon = [hg.to_canonical_etype(et) for et in metapath]
    for a, b in zip(canon[:-1], canon[1:]):
        if a[2] != b[0]:
            raise ValueError(f"metapath breaks between {a} and {b}")
    adj = None
    for c in canon:
        s, d = _coo(hg.rel_graphs[c])
        m = sp.csr_matrix((np.ones(len(s), dtype=np.int64), (s, d)),
                          shape=(hg.num_nodes(c[0]), hg.num_nodes(c[2])))
        adj = m if adj is None else adj @ m
        adj.data[:] = 1  # reachability, not path counts
    coo = adj.tocoo()
    row, col = coo.row.astype(np.int64), coo.col.astype(np.int64)
    srctype, dsttype = canon[0][0], canon[-1][2]
    if srctype == dsttype:
        new = graph((row, col), num_nodes=hg.num_nodes(srctype),
                    device=hg.device)
        new.ndata.update(hg.nodes_data(srctype))
        return new
    new = block((row, col), num_src_nodes=hg.num_nodes(srctype),
                num_dst_nodes=hg.num_nodes(dsttype), device=hg.device)
    new.srcdata.update(hg.nodes_data(srctype))
    new.dstdata.update(hg.nodes_data(dsttype))
    return new


def node_subgraph(g: Graph, nodes) -> Graph:
    """Node-induced subgraph (``dgl.node_subgraph``): the edges with both
    ends in ``nodes`` (ids or a bool mask), nodes renumbered in the order
    given; the old node and edge ids land in ``ndata['_ID']`` and
    ``edata['_ID']``."""
    nodes = _ids(nodes)
    src, dst = _coo(g)
    relabel = np.full((g.num_nodes(),), -1, dtype=np.int64)
    relabel[nodes] = np.arange(len(nodes))
    keep = (relabel[src] >= 0) & (relabel[dst] >= 0)
    eids = np.nonzero(keep)[0]
    new = graph((relabel[src[keep]], relabel[dst[keep]]),
                num_nodes=len(nodes), device=g.device)
    new.ndata.update(_slice_rows(g.ndata, nodes))
    new.ndata["_ID"] = torch.as_tensor(nodes.astype(np.int32),
                                       device=new.device)
    new.edata.update(_slice_rows(g.edata, eids))
    new.edata["_ID"] = torch.as_tensor(eids.astype(np.int32),
                                       device=new.device)
    return new


def compact_graphs(graphs):
    """Drop the nodes isolated in every one of ``graphs`` (one graph or a
    list of graphs on one node space), renumbering them alike
    (``dgl.compact_graphs``); returns the same structure."""
    single = isinstance(graphs, Graph)
    gs = [graphs] if single else list(graphs)
    used = np.zeros((gs[0].num_nodes(),), dtype=bool)
    for g in gs:
        src, dst = _coo(g)
        used[src] = True
        used[dst] = True
    out = [node_subgraph(g, used) for g in gs]
    return out[0] if single else out


# ----------------------------------------------------------------------
# Blocks from sampled frontiers
# ----------------------------------------------------------------------

def _src_numbering(n_parent: int, real_dst: np.ndarray, include_dst: bool):
    """The source side's parent -> local map and id list before any edge:
    the real dst nodes first when ``include_dst``."""
    relabel = np.full((n_parent,), -1, dtype=np.int64)
    if not include_dst:
        return relabel, np.zeros((0,), dtype=np.int64)
    relabel[real_dst] = np.arange(len(real_dst))
    return relabel, real_dst.copy()


def _append_first_seen(relabel: np.ndarray, src_ids: np.ndarray,
                       src: np.ndarray) -> np.ndarray:
    """Give the sources not numbered yet the next local ids in the order
    they first appear in ``src`` (a stable unique)."""
    new_srcs = src[relabel[src] < 0]
    if len(new_srcs):
        _, first = np.unique(new_srcs, return_index=True)
        uniq = new_srcs[np.sort(first)]
        relabel[uniq] = len(src_ids) + np.arange(len(uniq))
        src_ids = np.concatenate([src_ids, uniq])
    return src_ids


def _padded_ids(ids: np.ndarray, n: int) -> torch.Tensor:
    arr = np.zeros((n,), dtype=np.int32)
    arr[: len(ids)] = ids
    return torch.from_numpy(arr)


def _padded_eids(eid, n_padded: int) -> torch.Tensor:
    eid = np.asarray(eid).astype(np.int32)
    if n_padded != len(eid):
        eid = np.concatenate([eid, np.zeros((n_padded - len(eid),),
                                            np.int32)])
    return torch.from_numpy(eid)


def _block_of(src: np.ndarray, dst_local: np.ndarray, dst_nodes: np.ndarray,
              num_real_dst: int, n_parent_src: int, include_dst: bool,
              pad_src_to, pad_edges_to, formats, uniform_k, device,
              eid=None) -> Graph:
    """The block of :func:`to_block` from the sampled edges' parent
    sources ``src`` and local destination rows ``dst_local``: a row per
    entry of ``dst_nodes``, so a seed given twice keeps two rows."""
    real_dst = dst_nodes[:num_real_dst]
    relabel_src, src_ids = _src_numbering(n_parent_src, real_dst,
                                          include_dst)
    src_ids = _append_first_seen(relabel_src, src_ids, src)
    num_src = int(pad_src_to) if pad_src_to is not None else len(src_ids)
    if num_src < len(src_ids):
        raise ValueError(f"pad_src_to={num_src} smaller than actual src "
                         f"count {len(src_ids)}")
    b = block((relabel_src[src], dst_local), num_src_nodes=num_src,
              num_dst_nodes=len(dst_nodes), pad_edges_to=pad_edges_to,
              formats=formats, uniform_ell_k=uniform_k, device=device)
    b.srcdata["_ID"] = _padded_ids(src_ids, num_src).to(b.device)
    b.dstdata["_ID"] = torch.from_numpy(
        dst_nodes.astype(np.int32)).to(b.device)
    if eid is not None:
        b.edata["_ID"] = _padded_eids(eid, b.num_edges_padded()).to(
            b.device)
    b.meta["num_real_src"] = int(len(src_ids))
    b.meta["num_real_dst"] = int(num_real_dst)
    return b


def _hetero_block_of(rel_edges: dict, dst_nodes: dict, num_real_dst: dict,
                     ntypes, n_parent: dict, include_dst: bool, pad_src_to,
                     pad_edges_to, formats, uniform_k, device, eids=None):
    """The hetero block of :func:`to_block_hetero` from each relation's
    parent sources and local destination rows (``rel_edges[c] = (src,
    dst_local)``, relations in canonical order). Sources are numbered per
    source type across relations in that order."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    relabel_src, src_ids = {}, {}
    for nt in ntypes:
        real = (dst_nodes[nt][: num_real_dst[nt]] if nt in dst_nodes
                else np.zeros((0,), np.int64))
        relabel_src[nt], src_ids[nt] = _src_numbering(
            n_parent[nt], real, include_dst and nt in dst_nodes)
    for (st, _, _), (src, _) in rel_edges.items():
        src_ids[st] = _append_first_seen(relabel_src[st], src_ids[st], src)
    num_src = {}
    for nt in ntypes:
        bound = (pad_src_to or {}).get(nt)
        if bound is not None and bound < len(src_ids[nt]):
            raise ValueError(
                f"pad_src_to[{nt!r}]={bound} smaller than actual src count "
                f"{len(src_ids[nt])}")
        num_src[nt] = int(bound) if bound is not None else len(src_ids[nt])
    rels = {}
    for c, (src, dst_local) in rel_edges.items():
        st, _, dt = c
        rels[c] = block(
            (relabel_src[st][src] if len(src) else src, dst_local),
            num_src_nodes=num_src[st],
            num_dst_nodes=len(dst_nodes.get(dt, ())),
            pad_edges_to=(pad_edges_to or {}).get(c), formats=formats,
            uniform_ell_k=(uniform_k or {}).get(c), device=device)
        if eids is not None and eids.get(c) is not None:
            rels[c].edata["_ID"] = _padded_eids(
                eids[c], rels[c].num_edges_padded()).to(rels[c].device)
    dev = resolve_device(device)
    blk = HeteroGraph(
        rels, {nt: len(v) for nt, v in dst_nodes.items()},
        node_frames={nt: {"_ID": torch.from_numpy(
            v.astype(np.int32)).to(dev)} for nt, v in dst_nodes.items()},
        num_src_nodes_dict=num_src,
        src_node_frames={nt: {"_ID": _padded_ids(
            src_ids[nt], num_src[nt]).to(dev)} for nt in ntypes})
    blk.meta["num_real_src"] = {nt: int(len(src_ids[nt])) for nt in ntypes}
    blk.meta["num_real_dst"] = {nt: int(num_real_dst[nt])
                                for nt in dst_nodes}
    return blk


def _frontier_coo(fr: Graph):
    src, dst = _coo(fr)
    return src.astype(np.int64), dst.astype(np.int64)


def _frontier_eid(fr: Graph):
    eid = fr.edata.get("_ID")
    return None if eid is None else eid.cpu().numpy()[: fr.num_edges()]


def to_block_hetero(frontier, dst_nodes, include_dst_in_src: bool = True,
                    num_real_dst: Optional[dict] = None,
                    pad_src_to: Optional[dict] = None,
                    pad_edges_to: Optional[dict] = None, formats=None,
                    uniform_k: Optional[dict] = None):
    """A hetero frontier to a hetero block with local ids per node type
    (``to_bipartite.cc :: ToBlock`` on heterographs): per type, the dst
    nodes get ids [0, len(dst)); the source side is the real dst nodes
    (with ``include_dst_in_src``) and then each new source of that type in
    first-seen order over the relations in canonical order. Every
    relation gets a block, even with no edges. ``dst_nodes`` and
    ``num_real_dst`` are per node type (entries past ``num_real_dst`` are
    padding), ``pad_src_to`` per node type, ``pad_edges_to`` and
    ``uniform_k`` per canonical edge type (:func:`graph.block`'s
    ``uniform_ell_k``). Each relation keeps the frontier's
    ``edata['_ID']``, padded with 0; ``meta['num_real_src'/
    'num_real_dst']`` hold the real prefix lengths. Built on the
    frontier's device."""
    dst_nodes = {nt: np.asarray(v).astype(np.int64)
                 for nt, v in dst_nodes.items()}
    num_real_dst = dict(num_real_dst or {})
    for nt, v in dst_nodes.items():
        num_real_dst.setdefault(nt, len(v))
    relabel_dst = {}
    for nt, v in dst_nodes.items():
        if nt not in frontier.ntypes:
            continue
        r = np.full((frontier.num_nodes(nt),), -1, dtype=np.int64)
        real = v[: num_real_dst[nt]]
        r[real] = np.arange(len(real))
        relabel_dst[nt] = r
    rel_edges, eids = {}, {}
    for c in frontier.canonical_etypes:
        dt = c[2]
        rel = frontier.rel_graphs[c]
        src, dst = _frontier_coo(rel)
        if dt not in relabel_dst:
            if len(src):
                raise ValueError(f"frontier has edges of type {c} but no "
                                 f"dst seeds of type {dt!r}")
            rel_edges[c] = (src, dst)
        else:
            ldst = relabel_dst[dt][dst]
            if len(dst) and np.any(ldst < 0):
                raise ValueError(
                    f"frontier {c} contains an edge to a non-seed dst node")
            rel_edges[c] = (src, ldst)
        eids[c] = _frontier_eid(rel)
    return _hetero_block_of(
        rel_edges, dst_nodes, num_real_dst, frontier.ntypes,
        {nt: frontier.num_nodes(nt) for nt in frontier.ntypes},
        include_dst_in_src, pad_src_to, pad_edges_to, formats, uniform_k,
        frontier.device, eids)


def to_block(frontier, dst_nodes, include_dst_in_src: bool = True,
             num_real_dst=None, pad_src_to=None, pad_edges_to=None,
             formats=None, uniform_k=None) -> Graph:
    """A frontier (edges into seed nodes, in parent ids) to a bipartite
    block with local ids (``to_bipartite.cc :: ToBlock``): the dst nodes
    get ids [0, len(dst)); the source side is the real dst nodes (with
    ``include_dst_in_src``) and then each new source in first-seen order.
    Parent ids land in ``srcdata['_ID']``/``dstdata['_ID']``.
    ``dst_nodes`` may carry a padding tail past ``num_real_dst``;
    ``pad_src_to``, ``pad_edges_to`` and ``uniform_k`` (``block``'s
    ``uniform_ell_k``) give a block of static shape whose real ids are a
    prefix (``meta['num_real_src'/'num_real_dst']``). A frontier in
    parent ids cannot tell two copies of one seed apart: its edges go to
    the last copy, as the reference numbers them (the samplers keep
    copies apart themselves). A heterograph frontier goes to
    :func:`to_block_hetero`. Built on the frontier's device."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if isinstance(frontier, HeteroGraph):
        return to_block_hetero(frontier, dst_nodes, include_dst_in_src,
                               num_real_dst, pad_src_to, pad_edges_to,
                               formats, uniform_k)
    dst_nodes = np.asarray(dst_nodes).astype(np.int64)
    if num_real_dst is None:
        num_real_dst = len(dst_nodes)
    src, dst = _frontier_coo(frontier)
    relabel_dst = np.full((frontier.num_dst_nodes(),), -1, dtype=np.int64)
    relabel_dst[dst_nodes[:num_real_dst]] = np.arange(num_real_dst)
    ldst = relabel_dst[dst]
    if np.any(ldst < 0):
        raise ValueError("frontier contains an edge to a non-seed dst node")
    return _block_of(src, ldst, dst_nodes, num_real_dst,
                     frontier.num_src_nodes(), include_dst_in_src,
                     pad_src_to, pad_edges_to, formats, uniform_k,
                     frontier.device)


# ----------------------------------------------------------------------
# Structure transforms, the point-cloud graphs and the spectral and
# positional encodings (host side, as in the reference)
# ----------------------------------------------------------------------

def add_reverse_edges(g: Graph, copy_ndata: bool = True,
                      copy_edata: bool = False) -> Graph:
    """``dgl.add_reverse_edges``: the reverse of every edge appended after
    the originals (edge ``i``'s reverse is edge ``i + E``), nothing
    deduplicated; ``copy_edata`` repeats each edge row onto its reverse."""
    if g.is_block:
        raise ValueError("add_reverse_edges on a block is ill-defined")
    src, dst = _coo(g)
    new = graph((np.concatenate([src, dst]), np.concatenate([dst, src])),
                num_nodes=g.num_nodes(), device=g.device)
    if copy_ndata:
        new.ndata.update(g.ndata)
    if copy_edata:
        for k, v in g.edata.items():
            e = v[: g.num_edges()]
            new.edata[k] = torch.cat([e, e], dim=0)
    return new


def to_simple(g: Graph) -> Graph:
    """``dgl.to_simple``: duplicate edges removed, the rest sorted by
    (src, dst); node data kept."""
    src, dst = _coo(g)
    s, d = _unique_pairs(src, dst, g.num_nodes())
    new = graph((s, d), num_nodes=g.num_nodes(), device=g.device)
    new.ndata.update(g.ndata)
    return new


def khop_graph(g: Graph, k: int) -> Graph:
    """``dgl.khop_graph``: an edge (u, v) for every walk of exactly ``k``
    steps from u to v (the multiplicity is the walk count), through the
    k-th power of the adjacency (scipy)."""
    import scipy.sparse as sp

    src, dst = _coo(g)
    n = g.num_nodes()
    adj = sp.csr_matrix((np.ones(len(src), dtype=np.int64), (src, dst)),
                        shape=(n, n))
    coo = (adj ** k).tocoo()
    return graph((np.repeat(coo.row, coo.data), np.repeat(coo.col, coo.data)),
                 num_nodes=n, device=g.device)


def line_graph(g: Graph, backtracking: bool = True) -> Graph:
    """``dgl.line_graph``: one node per edge of ``g`` and an edge e1 -> e2
    wherever dst(e1) == src(e2), grouped by e1 and in e2's source order;
    ``backtracking=False`` drops e2 that reverses e1."""
    src, dst = _coo(g)
    e = len(src)
    order = np.argsort(src, kind="stable")
    sorted_src = src[order]
    starts = np.searchsorted(sorted_src, dst, side="left")
    ends = np.searchsorted(sorted_src, dst, side="right")
    e1 = np.repeat(np.arange(e), ends - starts)
    e2 = (np.concatenate([order[s:t] for s, t in zip(starts, ends)])
          if e else np.zeros((0,), dtype=np.int64))
    if not backtracking and e:
        keep = ~((dst[e2] == src[e1]) & (src[e2] == dst[e1]))
        e1, e2 = e1[keep], e2[keep]
    return graph((e1, e2), num_nodes=e, device=g.device)


def _side_subgraph(g: Graph, nodes, side: int) -> Graph:
    mask = np.zeros((g.num_nodes(),), dtype=bool)
    mask[_ids(nodes)] = True
    ends = _coo(g)[side]
    return edge_subgraph(g, np.nonzero(mask[ends])[0], relabel_nodes=False)


def in_subgraph(g: Graph, nodes) -> Graph:
    """``dgl.in_subgraph``: every edge whose destination is in ``nodes``
    (ids or a bool mask), in edge-id order, on the parent's node space
    (old edge ids in ``edata['_ID']``)."""
    return _side_subgraph(g, nodes, 1)


def out_subgraph(g: Graph, nodes) -> Graph:
    """``dgl.out_subgraph``: every edge whose source is in ``nodes``."""
    return _side_subgraph(g, nodes, 0)


def _knn_rows(x, k: int):
    """(n, k) ids of each row's ``k`` nearest rows of ``x`` (itself
    included), by the reference's float32 squared distances
    ``|a|^2 + |b|^2 - 2ab`` over the last two axes; equal distances keep
    the lower id first (a stable sort), where ``top_k`` may take either."""
    sq = (x * x).sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (x @ x.transpose(-1, -2))
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def _points(x, device):
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=dev, dtype=torch.float32), dev


def knn_graph(x, k: int, *, device=None) -> Graph:
    """``dgl.knn_graph``: each point gets an edge from each of its ``k``
    nearest points, itself included (``min(k, n)`` of them); ``x`` (N, D)
    or (B, N, D) point clouds (then each cloud is a segment of
    :func:`segmented_knn_graph`). The distances are computed on ``device``
    (default ``cuda``), where the graph is placed."""
    if (x.ndim if hasattr(x, "ndim") else np.ndim(x)) == 3:
        b, n = x.shape[0], x.shape[1]
        return segmented_knn_graph(x.reshape(b * n, -1), k,
                                   np.full((b,), n, dtype=np.int64),
                                   device=device)
    x, dev = _points(x, device)
    n = x.shape[0]
    kk = min(k, n)
    src = _knn_rows(x, kk).reshape(-1).cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), kk)
    return graph((src, dst), num_nodes=n, device=dev)


def segmented_knn_graph(x, k: int, segs, *, device=None) -> Graph:
    """``dgl.segmented_knn_graph``: the kNN graph within each segment of a
    packed point set (``segs``: the segments' point counts), with
    ``min(k, smallest segment)`` neighbours a point. The reference masks
    one (N, N) distance matrix; here each segment's (n, n) block is
    computed on its own (one batched product when the segments are of one
    size), which gives the same graph in a segment's memory."""
    x, dev = _points(x, device)
    segs = np.asarray(segs, dtype=np.int64)
    n = x.shape[0]
    if int(segs.sum()) != n:
        raise ValueError("segment sizes do not add up to the point count")
    kk = min(k, int(segs.min()))
    offs = np.concatenate([[0], np.cumsum(segs)])
    if len(segs) and np.all(segs == segs[0]):
        nbr = _knn_rows(x.reshape(len(segs), int(segs[0]), -1), kk)
        nbr = nbr + torch.as_tensor(offs[:-1], device=dev)[:, None, None]
    else:
        nbr = torch.cat([_knn_rows(x[a:b], kk) + a
                         for a, b in zip(offs[:-1], offs[1:])]) if n else \
            torch.zeros((0, kk), dtype=torch.int64, device=dev)
    src = nbr.reshape(-1).cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), kk)
    return graph((src, dst), num_nodes=n, device=dev)


def laplacian_lambda_max(g: Graph):
    """``dgl.laplacian_lambda_max``: the largest eigenvalue of each
    batched graph's symmetric normalised Laplacian ``I - D^-1/2 A D^-1/2``
    (D the out-degrees of A, rows = sources), a list of floats; dense
    ``eigvals`` up to 64 nodes, else ``scipy.sparse.linalg.eigs`` at
    ``tol=1e-6`` (its start vector is random, so repeated calls agree to
    that tolerance, not bit for bit)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from dgl1_tpu_torch.batch import unbatch

    graphs = unbatch(g) if "_batch_num_nodes" in g.meta else [g]
    out = []
    for sub in graphs:
        n = sub.num_nodes()
        src, dst = _coo(sub)
        adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
        deg = np.asarray(adj.sum(axis=1)).ravel()
        with np.errstate(divide="ignore"):
            inv_sqrt = np.where(deg > 0, deg ** -0.5, 0.0)
        dmat = sp.diags(inv_sqrt)
        lap = sp.eye(n) - dmat @ adj @ dmat
        if n <= 64:
            val = float(np.linalg.eigvals(lap.toarray()).real.max())
        else:
            val = float(spla.eigs(lap, k=1, which="LM",
                                  return_eigenvectors=False,
                                  tol=1e-6).real[0])
        out.append(val)
    return out


def _append_rows(old, extra, n_old: int, n_new: int):
    """``old``'s first ``n_old`` rows then ``extra`` (zeros of old's row
    shape when None; old is zeros of extra's when None)."""
    if old is None:
        old = extra.new_zeros((n_old,) + tuple(extra.shape[1:]))
    if extra is None:
        extra = old.new_zeros((n_new,) + tuple(old.shape[1:]))
    return torch.cat([old[:n_old], extra.to(old.device)], dim=0)


def add_edges(g: Graph, src, dst, data: Optional[dict] = None) -> Graph:
    """``dgl.add_edges``, functional: a new graph with the edges appended;
    each ``edata`` field gets the rows of ``data`` or zeros, and a field
    only ``data`` has gets zeros for the old edges."""
    s0, d0 = _coo(g)
    src = np.atleast_1d(_ids(src))
    dst = np.atleast_1d(_ids(dst))
    new = graph((np.concatenate([s0, src]), np.concatenate([d0, dst])),
                num_nodes=g.num_nodes(), device=g.device)
    new.ndata.update(g.ndata)
    data = data or {}
    for k in set(g.edata) | set(data):
        extra = (torch.as_tensor(data[k], device=g.device) if k in data
                 else None)
        new.edata[k] = _append_rows(g.edata.get(k), extra, g.num_edges(),
                                    len(src))
    return new


def remove_edges(g: Graph, eids) -> Graph:
    """``dgl.remove_edges``: a new graph without the edges ``eids``, on
    the same nodes, edge data sliced alike."""
    keep = np.ones((g.num_edges(),), dtype=bool)
    keep[np.atleast_1d(_ids(eids))] = False
    src, dst = _coo(g)
    new = graph((src[keep], dst[keep]), num_nodes=g.num_nodes(),
                device=g.device)
    new.ndata.update(g.ndata)
    new.edata.update(_slice_rows(g.edata, np.nonzero(keep)[0]))
    return new


def add_nodes(g: Graph, num: int, data: Optional[dict] = None) -> Graph:
    """``dgl.add_nodes``: ``num`` isolated nodes appended; node data as
    :func:`add_edges` treats edge data."""
    src, dst = _coo(g)
    n = g.num_nodes()
    new = graph((src, dst), num_nodes=n + int(num), device=g.device)
    new.edata.update(g.edata)
    data = data or {}
    for k in set(g.ndata) | set(data):
        extra = (torch.as_tensor(data[k], device=g.device) if k in data
                 else None)
        new.ndata[k] = _append_rows(g.ndata.get(k), extra, n, int(num))
    return new


def remove_nodes(g: Graph, nids) -> Graph:
    """``dgl.remove_nodes``: the subgraph induced by the other nodes, the
    remaining ones renumbered in order (:func:`node_subgraph`)."""
    keep = np.ones((g.num_nodes(),), dtype=bool)
    keep[np.atleast_1d(_ids(nids))] = False
    return node_subgraph(g, np.nonzero(keep)[0])


def laplacian_pe(g: Graph, k: int, padding: bool = False):
    """``dgl.laplacian_pe``: the eigenvectors of the ``k`` smallest
    non-trivial eigenvalues of the symmetric normalised Laplacian of the
    simple undirected graph under ``g`` (N, k) float32, on g's device;
    zero columns past ``n - 1`` with ``padding``. Eigenvectors are defined
    up to sign (and within a repeated eigenvalue, up to a rotation):
    ``eigsh`` starts from a random vector, as in the reference."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = g.num_nodes()
    if not padding and n <= k:
        raise ValueError(f"need num_nodes > k, got {n} <= {k}")
    src, dst = _coo(g)
    a = sp.coo_matrix((np.ones(len(src)), (dst, src)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float64)
    deg = np.asarray(a.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    lap = sp.eye(n) - sp.diags(dinv) @ a @ sp.diags(dinv)
    kk = min(k + 1, n)
    if n < 40 or kk >= n - 1:
        w, v = np.linalg.eigh(lap.toarray())
    else:
        w, v = spla.eigsh(lap.tocsc(), k=kk, which="SM", tol=1e-6)
    v = v[:, np.argsort(w)[1:kk]]
    if v.shape[1] < k:
        v = np.pad(v, ((0, 0), (0, k - v.shape[1])))
    return torch.as_tensor(v[:, :k].astype(np.float32), device=g.device)


def random_walk_pe(g: Graph, k: int, eweight_name: Optional[str] = None):
    """``dgl.random_walk_pe``: ``PE[i, j] = (RW^(j+1))_ii`` for the
    row-normalised walk matrix (weighted by ``edata[eweight_name]``), (N,
    k) float32 on g's device."""
    import scipy.sparse as sp

    n = g.num_nodes()
    src, dst = _coo(g)
    w = (g.edata[eweight_name][: len(src)].detach().cpu().numpy()
         .astype(np.float64) if eweight_name else np.ones(len(src)))
    a = sp.coo_matrix((w.reshape(-1), (src, dst)), shape=(n, n)).tocsr()
    deg = np.asarray(a.sum(1)).ravel()
    rw = sp.diags(np.where(deg > 0, 1.0 / np.where(deg > 0, deg, 1.0),
                           0.0)) @ a
    pe = np.zeros((n, k))
    m = rw.copy()
    for j in range(k):
        pe[:, j] = m.diagonal()
        if j + 1 < k:
            m = m @ rw
    return torch.as_tensor(pe.astype(np.float32), device=g.device)


def shortest_dist(g: Graph, root=None, return_paths: bool = False):
    """``dgl.shortest_dist``: unweighted shortest distances, all pairs (N,
    N) or from ``root`` (N,), int64 on g's device, -1 where unreachable;
    with a root, ``return_paths`` also gives each node's path as edge ids
    (N, longest) padded with -1 (the first edge of each (u, v) pair)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    n, (src, dst) = g.num_nodes(), _coo(g)
    e = len(src)
    adj = csr_matrix((np.ones(e), (src, dst)), shape=(n, n))
    if root is None:
        if return_paths:
            raise NotImplementedError("return_paths requires a root")
        d = shortest_path(adj, method="D", unweighted=True)
        return torch.as_tensor(np.where(np.isinf(d), -1, d).astype(np.int64),
                               device=g.device)
    d, pred = shortest_path(adj, method="D", unweighted=True,
                            indices=int(root), return_predecessors=True)
    dist = np.where(np.isinf(d), -1, d).astype(np.int64)
    if not return_paths:
        return torch.as_tensor(dist, device=g.device)
    eid_of = {}
    for i in range(e):
        eid_of.setdefault((int(src[i]), int(dst[i])), i)
    paths = np.full((n, max(int(dist.max(initial=0)), 1)), -1, np.int64)
    for v in range(n):
        hops, cur = [], v
        while dist[v] > 0 and pred[cur] >= 0:
            hops.append(eid_of[(int(pred[cur]), int(cur))])
            cur = int(pred[cur])
        paths[v, : len(hops)] = hops[::-1]
    return (torch.as_tensor(dist, device=g.device),
            torch.as_tensor(paths, device=g.device))


def merge(graphs):
    """``dgl.merge``: one graph on the largest node space, the edges of
    every graph in order. A node field comes from the first graph that has
    it, zero-filled to the merged node count; an edge field is
    concatenated across graphs, zeros for the graphs without it."""
    n = max(g.num_nodes() for g in graphs)
    coos = [_coo(g) for g in graphs]
    out = graph((np.concatenate([s for s, _ in coos]),
                 np.concatenate([d for _, d in coos])), num_nodes=n,
                device=graphs[0].device)
    for g in graphs:
        for k, v in g.ndata.items():
            if k not in out.ndata:
                out.ndata[k] = (v if v.shape[0] == n
                                else _append_rows(v, None, v.shape[0],
                                                  n - v.shape[0]))
    for k in sorted(set().union(*(g.edata.keys() for g in graphs))):
        ref = next(g.edata[k] for g in graphs if k in g.edata)
        out.edata[k] = torch.cat(
            [g.edata[k][: g.num_edges()].to(ref.device) if k in g.edata
             else ref.new_zeros((g.num_edges(),) + tuple(ref.shape[1:]))
             for g in graphs], dim=0)
    return out
