"""Graph transforms (host side, numpy): the port's counterparts of
``dgl1_tpu/transform.py``'s ``add_self_loop``, ``remove_self_loop``,
``to_bidirected``, ``rcm_order``, ``reorder_graph`` (algorithms ``'rcm'``,
``'hub'`` and ``'custom'``), ``edge_subgraph`` and ``typed_subgraphs``.
Each returns a new graph on the input graph's device."""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph

__all__ = ["add_self_loop", "remove_self_loop", "to_bidirected",
           "rcm_order", "reorder_graph", "edge_subgraph", "typed_subgraphs"]


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
    n = g.num_nodes()
    key = np.unique(np.concatenate([src, dst]).astype(np.int64) * n
                    + np.concatenate([dst, src]).astype(np.int64))
    return graph((key // n, key % n), num_nodes=n, device=g.device)


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
    = old``. ``'metis'`` needs the reference's partitioner, which is not
    ported, and raises NotImplementedError. ``edge_permute_algo``:
    ``'src'`` or ``'dst'`` (stable sort by the new id) or ``'custom'``
    (``permute_config={'edges_perm': ...}``). ``formats`` goes to
    :func:`graph`: ``('coo', 'csr', 'csc', 'ell', 'bdense')`` builds the
    block-dense layout on the reordered graph. With ``store_ids`` the old
    ids land in ``ndata['_ID']`` and ``edata['_ID']``. The signature is
    the reference's, so its default, ``'metis'``, raises here too."""
    cfg = permute_config or {}
    n = g.num_nodes()
    if node_permute_algo == "rcm":
        perm = rcm_order(g)
    elif node_permute_algo == "metis":
        raise NotImplementedError(
            "reorder_graph(node_permute_algo='metis') needs "
            "parallel/partition.py::metis_partition_assignment, which is "
            "not ported yet")
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


def edge_subgraph(g: Graph, edges, relabel_nodes: bool = True) -> Graph:
    """Edge-induced subgraph: the edges ``edges`` (ids or a bool mask) in
    the given order. With ``relabel_nodes`` the nodes they touch are
    renumbered in id order (old ids in ``ndata['_ID']``), else the parent's
    node space is kept. Old edge ids land in ``edata['_ID']``."""
    if isinstance(edges, torch.Tensor):
        edges = edges.cpu().numpy()
    edges = np.asarray(edges)
    if edges.dtype == bool:
        edges = np.nonzero(edges)[0]
    edges = edges.astype(np.int64)
    src, dst = _coo(g)
    s, d = src[edges], dst[edges]
    if relabel_nodes:
        nodes = np.unique(np.concatenate([s, d]))
        relabel = np.full((g.num_src_nodes(),), -1, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        new = graph((relabel[s], relabel[d]), num_nodes=len(nodes),
                    device=g.device)
        new.ndata.update(_slice_rows(g.ndata, nodes))
        new.ndata["_ID"] = torch.as_tensor(nodes.astype(np.int32),
                                           device=new.device)
    else:
        new = graph((s, d), num_nodes=g.num_src_nodes(), device=g.device)
        new.ndata.update(g.ndata)
    new.edata.update(_slice_rows(g.edata, edges))
    new.edata["_ID"] = torch.as_tensor(edges.astype(np.int32),
                                       device=new.device)
    return new


def typed_subgraphs(g: Graph, etypes, num_rels: int,
                    identity: bool = False):
    """One edge-induced subgraph per relation, all in the parent's node
    space, for ``RelGraphConv(rel_graphs=...)``: relation r holds the
    edges with ``etypes == r`` in edge order, with its own hub layout
    where its in-degrees clear the bar. ``etypes`` is host data (numpy or
    a tensor, read up to ``num_edges``). ``identity=True`` needs the
    forced hub geometry of ``build_hub_format(identity_force=)``, which is
    not ported, and raises NotImplementedError."""
    if identity:
        raise NotImplementedError(
            "typed_subgraphs(identity=True) needs build_hub_format's "
            "identity_force geometry, which is not ported yet")
    if isinstance(etypes, torch.Tensor):
        etypes = etypes.cpu().numpy()
    etypes = np.asarray(etypes)[: g.num_edges()]
    return tuple(edge_subgraph(g, np.nonzero(etypes == r)[0],
                               relabel_nodes=False)
                 for r in range(int(num_rels)))
