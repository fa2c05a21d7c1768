"""Heterograph partitioning and sharded typed (R-GCN-style) training.

The port's counterpart of ``dgl1_tpu/parallel/hetero.py``. A heterograph
is homogenized (each node type an offset block of one id space), one
partitioner runs on it and the assignment is split back per node type.
Every node type gets its own halo plan (node types carry different
feature widths) and every relation's edges live on the destination's
part, so aggregation is local: per relation, the combined [owned | halo]
source table is projected, gathered and reduced into owned destination
rows, summed over the relations into each destination type.

The host build (:func:`build_partitioned_hetero`) is the reference's,
array for array: numpy arrays stacked on a leading P axis. One process
runs one partition: :meth:`PartitionedHeteroGraph.local` gives rank p its
tensors (:class:`LocalHeteroPartition`). The exchanges are
``sharded_ops.wire_all_to_all`` (one per source node type and layer, not
one per relation); the local reduces run the hub engine (K1, K2, K3,
K4a/b; the identity layouts skip K3), the tile kernel K9 both ways, or a
gather and ``index_add``. The typed attention is plain torch, as the
reference's is plain jnp.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgl1_tpu_torch.graph import Graph, _tree_to
from dgl1_tpu_torch.heterograph import HeteroGraph
from dgl1_tpu_torch.parallel.graph_partition_book import GraphPartitionBook
from dgl1_tpu_torch.parallel.halo import _slice, hub_layout_graph

__all__ = [
    "homogenize_structure",
    "hetero_partition_assignment",
    "hetero_edge_cut_fraction",
    "PartitionedHeteroGraph",
    "LocalHeteroPartition",
    "build_partitioned_hetero",
    "hetero_halo_exchange",
    "sharded_typed_gspmm",
    "make_sharded_rgcn_layer",
    "init_typed_rgcn_params",
    "make_typed_rgcn_train_step",
    "partition_hetero_graph",
    "load_hetero_partition",
    "sharded_typed_attention",
    "make_sharded_hetero_attention",
]

CanonicalEtype = Tuple[str, str, str]
NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rel_coo(rel: Graph):
    """A relation's real edges as int64 numpy (src, dst)."""
    e = rel.num_edges()
    return (rel.src[:e].cpu().numpy().astype(np.int64),
            rel.dst[:e].cpu().numpy().astype(np.int64))


def _ntype_offsets(hg: HeteroGraph):
    offsets, total = {}, 0
    for nt in hg.ntypes:
        offsets[nt] = total
        total += hg.num_nodes(nt)
    return offsets, total


def homogenize_structure(hg: HeteroGraph):
    """One node space of per-ntype offset blocks: (src, dst, offsets,
    total_nodes), every relation's edges concatenated in canonical-etype
    order."""
    offsets, total = _ntype_offsets(hg)
    srcs, dsts = [], []
    for c in hg.canonical_etypes:
        st, _, dt = c
        s, d = _rel_coo(hg[c])
        srcs.append(s + offsets[st])
        dsts.append(d + offsets[dt])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    return src, dst, offsets, total


def hetero_partition_assignment(
    hg: HeteroGraph, k: int, part_method: str = "metis",
    balance_edges: bool = True, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """``{ntype: int32[num_nodes(ntype)]}``: homogenize, partition
    (``metis``, ``greedy``, ``multilevel`` or ``random``), split back per
    node type, so cross-type communities land on one part."""
    from dgl1_tpu_torch.graph import graph as make_graph
    from dgl1_tpu_torch.parallel.partition import (
        greedy_partition_assignment, metis_partition_assignment,
        multilevel_partition_assignment, random_partition_assignment)

    src, dst, offsets, total = homogenize_structure(hg)
    homo = make_graph((src, dst), num_nodes=total, formats=(),
                      device="cpu")
    fns = {"metis": metis_partition_assignment,
           "greedy": greedy_partition_assignment,
           "multilevel": multilevel_partition_assignment}
    if part_method == "random":
        part = random_partition_assignment(homo, k, seed=seed)
    elif part_method in fns:
        part = fns[part_method](homo, k, seed=seed,
                                balance_edges=balance_edges)
    else:
        raise ValueError(f"unknown part_method {part_method!r}")
    return {nt: part[offsets[nt]: offsets[nt] + hg.num_nodes(nt)].astype(
        np.int32) for nt in hg.ntypes}


def hetero_edge_cut_fraction(hg: HeteroGraph,
                             part: Dict[str, np.ndarray]) -> float:
    cut = tot = 0
    for c in hg.canonical_etypes:
        st, _, dt = c
        s, d = _rel_coo(hg[c])
        cut += int(np.sum(part[st][s] != part[dt][d]))
        tot += len(s)
    return cut / max(tot, 1)


# ----------------------------------------------------------------------
# The partitioned heterograph
# ----------------------------------------------------------------------

_PHG_NT_FIELDS = ("send_idx", "node_mask", "orig_ids", "in_deg")


class PartitionedHeteroGraph:
    """The stacked typed host build; every array has leading axis P.

    Per ntype ``nt``: ``send_idx[nt]`` (P, P, m_halo[nt]) int32, [q][p] =
    local ids q sends to p; ``node_mask[nt]`` (P, n_loc[nt]) bool;
    ``orig_ids[nt]`` (P, n_loc[nt]) int32 per-ntype global id;
    ``in_deg[nt]`` (P, n_loc[nt]) float32, the in-degree over all
    relations into nt (the 'right' norm).

    Per canonical etype ``c = (st, et, dt)``: ``esrc[c]`` (P, e_loc[c])
    int32 combined srctype index (owned [0, n_loc[st]), then halo slot
    n_loc[st] + q*m_halo[st] + j); ``edst[c]`` (P, e_loc[c]) int32 local
    dst id, n_loc[dt] on padded slots; optional ``tiles_fwd[c]`` /
    ``tiles_rev[c]`` (K9) and ``hub[c]`` with ``hub_meta[c]`` and
    ``hub_rows[c]`` (per-relation hub layouts of one forced geometry,
    None where no part clears the hub bar).

    Static: num_parts, n_loc, m_halo, e_loc, num_nodes, ntypes, etypes.
    """

    def __init__(self, *, send_idx, node_mask, orig_ids, in_deg, esrc,
                 edst, tiles_fwd, tiles_rev, num_parts, n_loc, m_halo,
                 e_loc, num_nodes, ntypes, etypes, hub=None,
                 hub_meta=None, hub_rows=None):
        self.send_idx = send_idx
        self.node_mask = node_mask
        self.orig_ids = orig_ids
        self.in_deg = in_deg
        self.esrc = esrc
        self.edst = edst
        self.tiles_fwd = tiles_fwd
        self.tiles_rev = tiles_rev
        self.hub = hub
        self.hub_meta = hub_meta
        self.hub_rows = dict(hub_rows) if hub_rows else None
        self.num_parts = int(num_parts)
        self.n_loc = dict(n_loc)
        self.m_halo = dict(m_halo)
        self.e_loc = dict(e_loc)
        self.num_nodes = dict(num_nodes)
        self.ntypes = tuple(ntypes)
        self.etypes = tuple(etypes)

    def n_comb(self, ntype: str) -> int:
        return self.n_loc[ntype] + self.num_parts * self.m_halo[ntype]

    def local(self, rank: int, device=None) -> "LocalHeteroPartition":
        """Part ``rank``'s arrays as tensors on ``device`` (None: cuda),
        its tile layouts without the cross-part padding tiles and its hub
        layouts without the forced geometry's trailing no-op chunks (one
        process a part needs no common shape)."""
        from dgl1_tpu_torch.graph import resolve_device
        from dgl1_tpu_torch.parallel.halo import _trim_pad_tiles
        from dgl1_tpu_torch.parallel.hub_shard import trim_forced_chunks

        dev = resolve_device(device)
        kw = {}
        for f in _PHG_NT_FIELDS:
            kw[f] = {nt: _tree_to(getattr(self, f)[nt][rank], dev)
                     for nt in self.ntypes}
        for f in ("esrc", "edst"):
            kw[f] = {c: _tree_to(getattr(self, f)[c][rank], dev)
                     for c in self.etypes}
        for f in ("tiles_fwd", "tiles_rev"):
            tab = getattr(self, f)
            kw[f] = (None if tab is None else
                     {c: _tree_to(_trim_pad_tiles(_slice(tab[c], rank)), dev)
                      for c in self.etypes})
        hub = None
        if self.hub is not None:
            hub = {}
            for c in self.etypes:
                if self.hub[c] is None:
                    hub[c] = None
                    continue
                hub[c] = _tree_to(trim_forced_chunks(
                    self.hub_meta[c], _slice(self.hub[c], rank)), dev)
        return LocalHeteroPartition(
            rank=int(rank), device=dev, hub=hub, hub_meta=self.hub_meta,
            hub_rows=self.hub_rows, num_parts=self.num_parts,
            n_loc=self.n_loc, m_halo=self.m_halo, e_loc=self.e_loc,
            num_nodes=self.num_nodes, ntypes=self.ntypes,
            etypes=self.etypes, **kw)

    # -- data movement --------------------------------------------------
    def shard_node_data(self, ntype: str, data, rank: Optional[int] = None):
        """(N_nt, *f) global per-ntype data -> (P, n_loc[nt], *f), or part
        ``rank``'s (n_loc[nt], *f); phantom rows are zero (float data)."""
        data = torch.as_tensor(data)
        ids = self.orig_ids[ntype]
        mask = self.node_mask[ntype]
        if rank is not None:
            ids, mask = ids[rank], mask[rank]
        out = data.index_select(0, torch.as_tensor(
            ids.reshape(-1).astype(np.int64), device=data.device))
        if out.is_floating_point():
            m = torch.as_tensor(mask.reshape(-1), device=data.device)
            out = out * m.reshape((-1,) + (1,) * (data.dim() - 1)).to(
                out.dtype)
        return out.reshape(ids.shape + tuple(data.shape[1:]))

    def unshard_node_data(self, ntype: str, data):
        """(P, n_loc[nt], *f) -> (N_nt, *f), phantom rows dropped."""
        data = torch.as_tensor(data)
        flat = data.reshape((-1,) + tuple(data.shape[2:]))
        mask = torch.as_tensor(self.node_mask[ntype].reshape(-1),
                               device=data.device)
        ids = torch.as_tensor(self.orig_ids[ntype].reshape(-1).astype(
            np.int64), device=data.device)
        out = data.new_zeros((self.num_nodes[ntype],)
                             + tuple(data.shape[2:]))
        out[ids[mask]] = flat[mask]
        return out

    def combined_from_global(self, ntype: str, data, rank: int):
        """Part ``rank``'s combined (n_comb[nt], *f) table of ``ntype``
        filled from the global rows on the host's side: what
        :func:`hetero_halo_exchange` gives that rank."""
        x = [self.shard_node_data(ntype, data, q)
             for q in range(self.num_parts)]
        if self.m_halo[ntype] == 0:
            return x[rank]
        halo = [x[q].index_select(0, torch.as_tensor(
            self.send_idx[ntype][q, rank].astype(np.int64),
            device=x[q].device)) for q in range(self.num_parts)]
        return torch.cat([x[rank]] + halo, dim=0)


class LocalHeteroPartition:
    """One part of a :class:`PartitionedHeteroGraph` as tensors on one
    device: per ntype its (P, m_halo) send table, node mask, ids and
    in-degrees; per relation its edges and layouts; the static fields."""

    def __init__(self, *, rank, device, **kw):
        self.rank = rank
        self.device = device
        for k, v in kw.items():
            setattr(self, k, v)
        self._hub_graphs = {}

    def n_comb(self, ntype: str) -> int:
        return self.n_loc[ntype] + self.num_parts * self.m_halo[ntype]

    def hub_graph(self, c) -> Graph:
        """Relation ``c``'s hub layout as a :class:`Graph` of R sources and
        R destinations (R = ``hub_rows[c]``), the hub engine's input."""
        if self.hub is None or self.hub.get(c) is None:
            raise ValueError(f"relation {c} has no hub layout")
        if c not in self._hub_graphs:
            self._hub_graphs[c] = hub_layout_graph(
                self.esrc[c], self.edst[c], self.hub[c], self.hub_meta[c],
                self.hub_rows[c], self.n_loc[c[2]], self.device)
        return self._hub_graphs[c]


def _pinned_typed_geometry(hub_edges_all, etypes, dt, n_loc_dt,
                           num_parts, max_buckets: int = 4,
                           min_group_edges=None, dense_floor=None):
    """One (NG, ND, tail bucket meta) shared by every relation into ``dt``
    and every part, for the typed identity layouts: the books order local
    ids hub-first by total in-degree, so hub slots are local ids [0,
    NG*128) and the tail stack local ids [NG*128, NG*128 + n_tail) in id
    order; per-position bucket widths come from the max over (relation,
    part) degree. None when no part clears a hub group, or when the union
    tail's slots pass half of n_loc (every relation would gather the whole
    union tail, costing more than the expand it saves)."""
    from dgl1_tpu_torch.graph import _ladder_rung
    from dgl1_tpu_torch.hub_format import (BLK, CHUNK, MAX_DENSE_GROUPS,
                                           MAX_GROUPS)

    rels = [c for c in etypes if c[2] == dt and c in hub_edges_all]
    if not rels:
        return None
    tot = np.zeros((num_parts, n_loc_dt), np.int64)
    per_rel = []
    for c in rels:
        lists, _ = hub_edges_all[c]
        cnts = np.zeros((num_parts, n_loc_dt), np.int64)
        for p, (_, ldst) in enumerate(lists):
            if len(ldst):
                cnts[p] = np.bincount(np.asarray(ldst, np.int64),
                                      minlength=n_loc_dt)
        per_rel.append(cnts)
        tot += cnts
    floor = (int(min_group_edges) if min_group_edges is not None
             else max(4 * CHUNK, 1))
    if dense_floor is None:
        dense_floor = max(n_loc_dt // 2, 4 * CHUNK)
    dense_floor = int(dense_floor)
    nd_u = nc_u = 0
    for p in range(num_parts):
        deg = tot[p]
        order = np.argsort(-deg, kind="stable")
        ng = 0
        gcounts = []
        while ng < MAX_GROUPS:
            rows = order[ng * BLK: (ng + 1) * BLK]
            if rows.size == 0:
                break
            ge = int(deg[rows].sum())
            if ge < floor:
                break
            gcounts.append(ge)
            ng += 1
        nd = 0
        while nd < min(ng, MAX_DENSE_GROUPS) and gcounts[nd] >= dense_floor:
            nd += 1
        nd_u = max(nd_u, nd)
        nc_u = max(nc_u, ng - nd)
    ng_u = nd_u + nc_u
    if ng_u == 0:
        return None
    k_slots = ng_u * BLK
    nnz = (tot > 0).sum(axis=1)
    n_tail = int(max(int(nnz.max(initial=0)) - k_slots, 0))
    if n_tail == 0:
        return {"n_groups": ng_u, "n_dense": nd_u, "tail_meta_dst": ()}
    caps = np.zeros((n_tail,), np.int64)
    for cnts in per_rel:
        seg = cnts[:, k_slots: k_slots + n_tail]
        np.maximum(caps, seg.max(axis=0), out=caps)
    rungs = np.array([_ladder_rung(int(x)) if x else 1 for x in caps],
                     np.int64)
    # Run-length buckets over the rungs, merged (fewest added slots) down
    # to max_buckets.
    segs = []
    for r in rungs:
        if segs and segs[-1][0] == r:
            segs[-1][1] += 1
        else:
            segs.append([int(r), 1])
    segs = [(w, nb) for w, nb in segs]
    while len(segs) > max_buckets:
        costs = [max(segs[i][0], segs[i + 1][0])
                 * (segs[i][1] + segs[i + 1][1])
                 - segs[i][0] * segs[i][1] - segs[i + 1][0] * segs[i + 1][1]
                 for i in range(len(segs) - 1)]
        i = int(np.argmin(costs))
        segs[i: i + 2] = [(max(segs[i][0], segs[i + 1][0]),
                           segs[i][1] + segs[i + 1][1])]
    slots = sum(w * nb for w, nb in segs)
    if slots > n_loc_dt // 2:
        return None
    return {"n_groups": ng_u, "n_dense": nd_u,
            "tail_meta_dst": tuple(segs)}


def build_partitioned_hetero(
    hg: HeteroGraph,
    part: Dict[str, np.ndarray],
    num_parts: int,
    pad_nodes_multiple: int = 8,
    pad_edges_multiple: int = 128,
    pad_halo_multiple: int = 8,
    tiles: bool = False,
    hub=False,
    hub_dense_floor: Optional[int] = None,
    hub_identity: bool = False,
) -> PartitionedHeteroGraph:
    """The typed halo plan from a per-ntype assignment (the reference's
    arguments and arrays).

    Each relation's edges live on the destination's part; each source
    type's remote rows become that ntype's halo slots, shared by every
    relation that reads the type. ``tiles``: per-relation tile layouts of
    both directions (K9). ``hub`` (True, or an int group floor) with
    ``hub_dense_floor``: per-relation hub layouts of one forced geometry.
    ``hub_identity`` (with ``hub``): each ntype's local ids ordered
    hub-first by total in-degree and every relation's layouts pinned to
    that numbering, so each claims ``identity_expand``; where the
    post-build predicate fails, ``identity_expand`` silently stays False
    (the layout keeps its expand)."""
    part = {nt: np.asarray(v).astype(np.int32) for nt, v in part.items()}
    in_deg_g = {nt: np.zeros(hg.num_nodes(nt), np.int64)
                for nt in hg.ntypes}
    coo = {c: _rel_coo(hg[c]) for c in hg.canonical_etypes}
    for c in hg.canonical_etypes:
        np.add.at(in_deg_g[c[2]], coo[c][1], 1)

    books = {nt: GraphPartitionBook(
        part[nt], num_parts,
        order_key=(-in_deg_g[nt] if hub_identity else None))
        for nt in hg.ntypes}
    n_loc = {nt: _round_up(
        max(max(books[nt].num_nodes(p) for p in range(num_parts)), 1),
        pad_nodes_multiple) for nt in hg.ntypes}

    # Halo request sets per (src ntype, consumer p, owner q).
    halo_sets = {nt: {p: {q: np.zeros(0, np.int64)
                          for q in range(num_parts)}
                      for p in range(num_parts)} for nt in hg.ntypes}
    part_edges = {}
    for c in hg.canonical_etypes:
        st, _, dt = c
        src, dst = coo[c]
        eo = part[dt][dst]
        per_part = []
        for p in range(num_parts):
            eids = np.nonzero(eo == p)[0]
            per_part.append(eids)
            remote = part[st][src[eids]] != p
            rsrc = np.unique(src[eids][remote])
            for q in range(num_parts):
                halo_sets[st][p][q] = np.union1d(
                    halo_sets[st][p][q], rsrc[part[st][rsrc] == q])
        part_edges[c] = per_part

    m_halo = {}
    for nt in hg.ntypes:
        m = max((len(halo_sets[nt][p][q]) for p in range(num_parts)
                 for q in range(num_parts)), default=0)
        m_halo[nt] = 0 if m == 0 else _round_up(m, pad_halo_multiple)
    e_loc = {c: _round_up(max(max(len(pe) for pe in part_edges[c]), 1),
                          pad_edges_multiple)
             for c in hg.canonical_etypes}

    send_idx = {nt: np.zeros((num_parts, num_parts, max(m_halo[nt], 1)),
                             np.int32) for nt in hg.ntypes}
    node_mask = {nt: np.zeros((num_parts, n_loc[nt]), bool)
                 for nt in hg.ntypes}
    orig_ids = {nt: np.zeros((num_parts, n_loc[nt]), np.int32)
                for nt in hg.ntypes}
    in_deg = {nt: np.zeros((num_parts, n_loc[nt]), np.float32)
              for nt in hg.ntypes}
    halo_pos = {nt: [dict() for _ in range(num_parts)] for nt in hg.ntypes}
    for nt in hg.ntypes:
        book = books[nt]
        for p in range(num_parts):
            own = book.partid2nids(p)
            node_mask[nt][p, : len(own)] = True
            orig_ids[nt][p, : len(own)] = own
            in_deg[nt][p, : len(own)] = in_deg_g[nt][own]
            for q in range(num_parts):
                nodes_q = halo_sets[nt][p][q]
                send_idx[nt][q, p, : len(nodes_q)] = book.nid2localnid(
                    nodes_q)
                base = n_loc[nt] + q * m_halo[nt]
                for j, nd in enumerate(nodes_q):
                    halo_pos[nt][p][int(nd)] = base + j

    from dgl1_tpu_torch.graph import _build_tiles
    from dgl1_tpu_torch.parallel.halo import _pad_tiles

    esrc, edst = {}, {}
    tiles_fwd = {} if tiles else None
    tiles_rev = {} if tiles else None
    hub_edges_all = {}
    for c in hg.canonical_etypes:
        st, _, dt = c
        src, dst = coo[c]
        es = np.zeros((num_parts, e_loc[c]), np.int32)
        ed = np.full((num_parts, e_loc[c]), n_loc[dt], np.int32)
        tf_list, tr_list, hub_edges_list = [], [], []
        n_comb = n_loc[st] + num_parts * m_halo[st]
        for p in range(num_parts):
            eids = part_edges[c][p]
            ldst = books[dt].nid2localnid(dst[eids])
            s = src[eids]
            local_src = part[st][s] == p
            esrc_p = np.empty(len(eids), dtype=np.int64)
            esrc_p[local_src] = books[st].nid2localnid(s[local_src])
            hp = halo_pos[st][p]
            esrc_p[~local_src] = np.array(
                [hp[int(x)] for x in s[~local_src]], dtype=np.int64)
            order = np.argsort(ldst, kind="stable")
            ed[p, : len(eids)] = ldst[order]
            es[p, : len(eids)] = esrc_p[order]
            if hub:
                hub_edges_list.append((esrc_p.copy(),
                                       ldst.astype(np.int64).copy()))
            if tiles:
                dummy_eid = np.zeros(len(eids), np.int32)
                tf_list.append(_build_tiles(
                    ldst[order].astype(np.int32),
                    esrc_p[order].astype(np.int32), dummy_eid, len(eids),
                    n_loc[dt]))
                rev = np.argsort(esrc_p, kind="stable")
                tr_list.append(_build_tiles(
                    esrc_p[rev].astype(np.int32),
                    ldst[rev].astype(np.int32), dummy_eid, len(eids),
                    n_comb))
        esrc[c], edst[c] = es, ed
        if tiles:
            tiles_fwd[c] = _pad_tiles(tf_list, n_loc[dt])
            tiles_rev[c] = _pad_tiles(tr_list, n_comb)
        if hub:
            hub_edges_all[c] = (hub_edges_list, n_comb)

    hub_layouts = hub_metas = hub_rows = None
    if hub:
        from dgl1_tpu_torch.hub_format import DENSE_RB
        from dgl1_tpu_torch.parallel.hub_shard import build_partitioned_hub

        floor = None if hub is True else int(hub)
        pinned_by_dt = ({dt: _pinned_typed_geometry(
            hub_edges_all, hg.canonical_etypes, dt, n_loc[dt], num_parts,
            min_group_edges=floor, dense_floor=hub_dense_floor)
            for dt in {c[2] for c in hg.canonical_etypes}}
            if hub_identity else {})
        hub_layouts, hub_metas, hub_rows = {}, {}, {}
        for c in hg.canonical_etypes:
            st, _, dt = c
            lists, n_comb = hub_edges_all[c]
            # One row space per relation: R sources and R destinations, so
            # the hub engine maps (R, F) -> (R, F); the reduce pads the
            # combined table in and slices the owned rows out.
            r_c = _round_up(max(n_comb, n_loc[dt]), DENSE_RB)
            m_c, a_c = build_partitioned_hub(
                lists, r_c, r_c, e_loc[c], min_group_edges=floor,
                dense_floor=hub_dense_floor,
                identity_pinned=pinned_by_dt.get(dt))
            hub_layouts[c] = a_c
            hub_metas[c] = m_c
            hub_rows[c] = r_c if m_c is not None else 0

    return PartitionedHeteroGraph(
        hub=hub_layouts, hub_meta=hub_metas, hub_rows=hub_rows,
        send_idx=send_idx, node_mask=node_mask, orig_ids=orig_ids,
        in_deg=in_deg, esrc=esrc, edst=edst, tiles_fwd=tiles_fwd,
        tiles_rev=tiles_rev, num_parts=num_parts, n_loc=n_loc,
        m_halo=m_halo, e_loc=e_loc,
        num_nodes={nt: hg.num_nodes(nt) for nt in hg.ntypes},
        ntypes=tuple(hg.ntypes), etypes=tuple(hg.canonical_etypes))


# ----------------------------------------------------------------------
# Sharded typed ops (one part a process)
# ----------------------------------------------------------------------

def _check_world(pl: LocalHeteroPartition, group=None):
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world != pl.num_parts:
        raise ValueError(
            f"the process group has world size {world} but the plan has "
            f"{pl.num_parts} parts: run one process a part "
            f"(parallel.initialize)")


def hetero_halo_exchange(pl: LocalHeteroPartition, ntype: str,
                         feat_local: torch.Tensor,
                         group=None) -> torch.Tensor:
    """One ntype's halo exchange: (n_loc, *f) owned rows -> the combined
    (n_loc + P*m_halo, *f) table the relations' ``esrc`` index. No
    exchange where the ntype has no halo on any part (m_halo == 0)."""
    from dgl1_tpu_torch.parallel.sharded_ops import wire_all_to_all

    if pl.m_halo[ntype] == 0:
        return feat_local
    send_idx = pl.send_idx[ntype]
    feat = tuple(feat_local.shape[1:])
    sbuf = feat_local.index_select(0, send_idx.reshape(-1).long()).reshape(
        tuple(send_idx.shape) + feat)
    rbuf = wire_all_to_all("f32", sbuf, group)
    return torch.cat([feat_local, rbuf.reshape((-1,) + feat)], dim=0)


def _local_rel_reduce(pl: LocalHeteroPartition, c, msg_combined):
    """Sum of relation ``c``'s combined source rows into its owned
    destination rows: the hub engine, the tile kernel K9 both ways, or a
    gather and ``index_add`` (padded slots land on a dropped row)."""
    from dgl1_tpu_torch.parallel.sharded_ops import (hub_local_spmm,
                                                     make_local_spmm,
                                                     segment_local_spmm)

    st, _, dt = c
    n_dst = pl.n_loc[dt]
    if pl.hub is not None and pl.hub.get(c) is not None:
        return hub_local_spmm(pl.hub_graph(c), msg_combined, n_dst)
    if pl.tiles_fwd is not None:
        fn = make_local_spmm(n_dst, pl.n_comb(st))
        return fn(pl.tiles_fwd[c], pl.tiles_rev[c], msg_combined)
    return segment_local_spmm(pl.esrc[c], pl.edst[c], msg_combined, n_dst)


def sharded_typed_gspmm(pl: LocalHeteroPartition,
                        feats: Dict[str, torch.Tensor],
                        weights: Optional[Dict[CanonicalEtype,
                                               torch.Tensor]] = None,
                        group=None) -> Dict[str, torch.Tensor]:
    """Typed copy_u + sum over this part: ``feats`` {ntype: (n_loc[nt],
    F_nt)} owned rows; with ``weights`` {canonical etype: (F_st, F_out)}
    each relation projects its combined source table by its own weight
    first (the R-GCN message ``h[src] @ W_r`` as one dense matmul a
    relation). Returns {dsttype: (n_loc[dt], F_out)} summed over the
    incoming relations. One exchange a source ntype: the combined tables
    are shared by the relations that read the type."""
    combined = {}
    for nt in sorted({c[0] for c in pl.etypes}):
        if nt in feats:
            combined[nt] = hetero_halo_exchange(pl, nt, feats[nt], group)
    out: Dict[str, torch.Tensor] = {}
    for c in pl.etypes:
        st, _, dt = c
        if st not in combined:
            continue
        h = combined[st]
        if weights is not None:
            h = h @ weights[c]
        agg = _local_rel_reduce(pl, c, h)
        out[dt] = agg if dt not in out else out[dt] + agg
    return out


def make_sharded_rgcn_layer(pl: LocalHeteroPartition, norm: str = "right",
                            group=None):
    """``fn(feats, weights, self_weights=None)``, the sharded typed layer
    on this part's rows: ``out[nt] = (1/deg) * sum_r A_r @ (x[src_r] @
    W_r) + x[nt] @ W_self`` with 'right' normalization (1/total in-degree
    over every relation) or norm='none'. A destination type with no
    incoming relation gets no key. The per-relation and self weights are
    replicated: sum their gradients over the ranks after backward
    (``sharded_ops.allreduce_grads``); the rows of ``feats`` are this
    part's, and their gradients come back through the exchanges."""
    _check_world(pl, group)
    if norm not in ("right", "none"):
        raise ValueError(f"norm must be 'right' or 'none', not {norm!r}")

    def fn(feats, weights, self_weights=None):
        self_weights = {} if self_weights is None else self_weights
        agg = sharded_typed_gspmm(pl, feats, weights, group)
        out = {}
        for nt, y in agg.items():
            if norm == "right":
                y = y / pl.in_deg[nt].clamp_min(1.0)[:, None]
            if nt in self_weights:
                y = y + feats[nt] @ self_weights[nt]
            out[nt] = y
        return out

    return fn


def init_typed_rgcn_params(pl: LocalHeteroPartition, in_feats: int,
                           hidden: int, classes: int, out_type: str,
                           proj_from: Optional[int] = None,
                           featureless=(), device=None, generator=None,
                           emb_scale: float = 0.1):
    """Dry run leg 9's parameters for this part: replicated ``w1`` {c:
    (in_feats, hidden)}, ``s1`` {nt: (in_feats, hidden)}, ``w2`` {c:
    (hidden, classes)}, ``s2`` {out_type: (hidden, classes)}, with
    ``proj_from`` a ``w_in`` (proj_from, in_feats) that projects the
    featured types' inputs, and ``emb`` {nt: (n_loc[nt], in_feats)}, this
    part's rows of a sharded embedding table for each ``featureless``
    type. Dense weights are normal * sqrt(2 / (fan_in + fan_out)), the
    embeddings normal * ``emb_scale``; drawn on the CPU from
    ``generator``, then placed on ``device`` (None: cuda) as leaves that
    require grad."""
    from dgl1_tpu_torch.graph import resolve_device

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator()

    def dense(i, o):
        return torch.randn(i, o, generator=gen) * (2.0 / (i + o)) ** 0.5

    params = {
        "w1": {c: dense(in_feats, hidden) for c in pl.etypes},
        "s1": {nt: dense(in_feats, hidden) for nt in pl.ntypes},
        "w2": {c: dense(hidden, classes) for c in pl.etypes},
        "s2": {out_type: dense(hidden, classes)},
        "emb": {nt: torch.randn(pl.n_loc[nt], in_feats, generator=gen)
                * emb_scale for nt in featureless},
    }
    if proj_from is not None:
        params["w_in"] = dense(proj_from, in_feats)
    return _tree_leaves_to(params, dev)


def _tree_leaves_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_leaves_to(v, dev) for k, v in tree.items()}
    return tree.to(dev).requires_grad_(True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def make_typed_rgcn_train_step(pl: LocalHeteroPartition, opt, classes: int,
                               out_type: str = "paper", group=None):
    """``step(params, feats, labels, mask) -> loss``: dry run leg 9's
    train step on this part. ``feats`` {nt: (n_loc, F)} are the featured
    types' rows (projected by ``params['w_in']`` when it is there), the
    embedding rows ``params['emb']`` stand for the others; two typed
    layers ('right' norm, relu between), softmax cross entropy of
    ``out_type``'s logits over the masked rows of every part. The
    replicated weights' gradients are summed over the ranks; the
    embeddings' come back to their owners through the exchanges' backward
    and are not. Returns the global loss (a host float)."""
    from dgl1_tpu_torch.parallel.sharded_ops import (all_reduce_sum,
                                                     allreduce_grads)

    layer = make_sharded_rgcn_layer(pl, group=group)

    def step(params, feats, labels, mask):
        opt.zero_grad()
        w_in = params.get("w_in")
        h0 = {nt: (x if w_in is None else x @ w_in)
              for nt, x in feats.items()}
        h0.update(params.get("emb", {}))
        h1 = {nt: torch.relu(v) for nt, v in
              layer(h0, params["w1"], params["s1"]).items()}
        logits = layer(h1, params["w2"], params["s2"])[out_type]
        ce = torch.nn.functional.cross_entropy(
            logits, labels.long().clamp(0, classes - 1), reduction="none")
        m = mask.to(ce.dtype)
        total = all_reduce_sum(m.sum().detach(), group).clamp_min(1.0)
        loss = (ce * m).sum() / total
        loss.backward()
        allreduce_grads([p for k, v in params.items() if k != "emb"
                         for p in _leaves(v)], group)
        opt.step()
        return float(all_reduce_sum(loss.detach(), group))

    return step


# ----------------------------------------------------------------------
# On-disk contract (graph.npz, node_feat.npz, node_part.npz, the book)
# ----------------------------------------------------------------------

def partition_hetero_graph(
    hg: HeteroGraph,
    graph_name: str,
    num_parts: int,
    out_path: str,
    part_method: str = "metis",
    balance_edges: bool = True,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Partition and persist a heterograph (``dgl.distributed.
    partition_graph`` on a heterograph). Per part p: each node type's
    local space is [owned | 1-hop halo] with ``inner_`` flags and original
    per-ntype ids; each relation keeps its destination-owned edges with
    locally relabeled endpoints and original edge ids; node features are
    the owned rows. Returns the per-ntype assignment."""
    from dgl1_tpu_torch.parallel.partition import _host

    part = hetero_partition_assignment(
        hg, num_parts, part_method=part_method,
        balance_edges=balance_edges, seed=seed)
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    etypes = hg.canonical_etypes
    coo = {c: _rel_coo(hg[c]) for c in etypes}

    for p in range(num_parts):
        pdir = out / f"part{p}"
        pdir.mkdir(exist_ok=True)
        own_edges = {}
        halo_needed = {nt: [] for nt in hg.ntypes}
        for c in etypes:
            st, _, dt = c
            src, dst = coo[c]
            eids = np.nonzero(part[dt][dst] == p)[0]
            own_edges[c] = (src[eids], dst[eids], eids)
            remote = part[st][src[eids]] != p
            halo_needed[st].append(np.unique(src[eids][remote]))
        local_nodes, relabel = {}, {}
        for nt in hg.ntypes:
            own = np.nonzero(part[nt] == p)[0]
            halo = (np.setdiff1d(np.unique(np.concatenate(halo_needed[nt])),
                                 own)
                    if halo_needed[nt] else np.zeros(0, np.int64))
            loc = np.concatenate([own, halo])
            local_nodes[nt] = (loc, len(own))
            r = np.full(hg.num_nodes(nt), -1, dtype=np.int64)
            r[loc] = np.arange(len(loc))
            relabel[nt] = r
        arrays = {}
        for i, c in enumerate(etypes):
            st, _, dt = c
            src, dst, eids = own_edges[c]
            arrays[f"src_{i}"] = relabel[st][src].astype(np.int32)
            arrays[f"dst_{i}"] = relabel[dt][dst].astype(np.int32)
            arrays[f"eid_{i}"] = eids.astype(np.int64)
        for nt in hg.ntypes:
            loc, n_own = local_nodes[nt]
            arrays[f"nid_{nt}"] = loc.astype(np.int64)
            arrays[f"inner_{nt}"] = np.arange(len(loc)) < n_own
        np.savez_compressed(pdir / "graph.npz", **arrays)
        feats = {}
        for nt in hg.ntypes:
            own = local_nodes[nt][0][: local_nodes[nt][1]]
            for k, v in hg.nframes[nt].items():
                feats[f"{nt}__{k}"] = _host(v)[own]
        np.savez_compressed(pdir / "node_feat.npz", **feats)

    book = {
        "graph_name": graph_name,
        "num_parts": num_parts,
        "hetero": True,
        "ntypes": list(hg.ntypes),
        "etypes": [list(c) for c in etypes],
        "num_nodes": {nt: hg.num_nodes(nt) for nt in hg.ntypes},
        "num_edges": {"/".join(c): hg[c].num_edges() for c in etypes},
        "part_method": part_method,
        "edge_cut_fraction": hetero_edge_cut_fraction(hg, part),
    }
    np.savez(out / "node_part.npz", **{nt: part[nt] for nt in hg.ntypes})
    with open(out / f"{graph_name}.json", "w") as f:
        json.dump(book, f)
    return part


def load_hetero_partition(out_path: str, graph_name: str, part_id: int,
                          device=None):
    """One hetero partition -> (local HeteroGraph on ``device`` (None:
    cuda), feats, book). The local node spaces are [owned | halo] per
    ntype; the frames hold ``orig_id`` and ``inner_node`` per ntype,
    ``edata['orig_id']`` the original edge ids per relation;
    ``book['part_assignment']`` the per-ntype assignment."""
    from dgl1_tpu_torch.graph import block as make_block
    from dgl1_tpu_torch.graph import resolve_device

    dev = resolve_device(device)
    out = Path(out_path)
    with open(out / f"{graph_name}.json") as f:
        book = json.load(f)
    etypes = [tuple(c) for c in book["etypes"]]
    with np.load(out / f"part{part_id}" / "graph.npz") as z:
        nids = {nt: z[f"nid_{nt}"] for nt in book["ntypes"]}
        inner = {nt: z[f"inner_{nt}"] for nt in book["ntypes"]}
        rels, eids = {}, {}
        for i, c in enumerate(etypes):
            st, _, dt = c
            rels[c] = make_block((z[f"src_{i}"], z[f"dst_{i}"]),
                                 num_src_nodes=len(nids[st]),
                                 num_dst_nodes=len(nids[dt]), device=dev)
            eids[c] = z[f"eid_{i}"]
    lg = HeteroGraph(rels, {nt: len(nids[nt]) for nt in book["ntypes"]})
    for nt in book["ntypes"]:
        lg.nframes[nt]["orig_id"] = torch.as_tensor(nids[nt], device=dev)
        lg.nframes[nt]["inner_node"] = torch.as_tensor(inner[nt],
                                                       device=dev)
    for c in etypes:
        lg[c].edata["orig_id"] = torch.as_tensor(eids[c], device=dev)
    feats = {nt: {} for nt in book["ntypes"]}
    with np.load(out / f"part{part_id}" / "node_feat.npz") as z:
        for key in z.files:
            nt, k = key.split("__", 1)
            feats[nt][k] = np.array(z[key])
    with np.load(out / "node_part.npz") as z:
        book["part_assignment"] = {nt: np.array(z[nt])
                                   for nt in book["ntypes"]}
    return lg, feats, book


# ----------------------------------------------------------------------
# Typed attention
# ----------------------------------------------------------------------

def sharded_typed_attention(pl: LocalHeteroPartition,
                            el: Dict[CanonicalEtype, torch.Tensor],
                            er: Dict[str, torch.Tensor],
                            ft: Dict[CanonicalEtype, torch.Tensor],
                            negative_slope: float = 0.2,
                            group=None) -> Dict[str, torch.Tensor]:
    """Typed edge-softmax attention over this part:

        out[d] = sum_{c, e in c: dst=d} softmax_d(z_e) * ft_c[src_e]
        z_e    = leaky_relu(el_c[src_e] + er[ntype(d)][d])

    with one softmax a destination across all its relations (the HGT
    convention). Every relation's edges live on the destination's part,
    so the softmax is exact and local; el and ft of a relation ride one
    packed exchange. The max shift carries no gradient. Shapes: el[c]
    (n_loc[st], H), er[nt] (n_loc[nt], H), ft[c] (n_loc[st], H, D);
    returns {dsttype: (n_loc, H, D)}."""
    from dgl1_tpu_torch.parallel.sharded_ops import _segment_max, _segment_sum

    packed = {}
    for c in pl.etypes:
        if c not in el:
            continue
        h, d = ft[c].shape[1], ft[c].shape[2]
        pack = torch.cat([el[c], ft[c].reshape(ft[c].shape[0], h * d)],
                         dim=1)
        packed[c] = hetero_halo_exchange(pl, c[0], pack, group)

    # Pass 1: per-destination max across every relation (no gradient).
    m, z_c = {}, {}
    for c, pack in packed.items():
        dt = c[2]
        h = el[c].shape[1]
        n_dst = pl.n_loc[dt]
        esrc, edst = pl.esrc[c].long(), pl.edst[c].long()
        valid = (edst < n_dst)[:, None]
        er_pad = torch.cat([er[dt], er[dt].new_zeros((1, h))], dim=0)
        z = torch.nn.functional.leaky_relu(
            pack[:, :h].index_select(0, esrc) + er_pad.index_select(0, edst),
            negative_slope)
        z = torch.where(valid, z, torch.full_like(z, NEG))
        z_c[c] = z
        m_rel = _segment_max(z.detach(), edst, n_dst + 1)[:n_dst]
        m[dt] = m_rel if dt not in m else torch.maximum(m[dt], m_rel)
    m = {nt: v.clamp_min(NEG) for nt, v in m.items()}

    # Pass 2: numerators and denominators summed across the relations.
    num, den = {}, {}
    for c, pack in packed.items():
        dt = c[2]
        h, d = ft[c].shape[1], ft[c].shape[2]
        n_dst = pl.n_loc[dt]
        esrc, edst = pl.esrc[c].long(), pl.edst[c].long()
        valid = (edst < n_dst)[:, None]
        m_pad = torch.cat([m[dt], m[dt].new_zeros((1, h))], dim=0)
        p = torch.where(valid, torch.exp(z_c[c] - m_pad.index_select(0, edst)),
                        torch.zeros_like(z_c[c]))
        ft_e = pack[:, h:].index_select(0, esrc).reshape(-1, h, d)
        n_rel = _segment_sum(p[:, :, None] * ft_e, edst, n_dst + 1)[:n_dst]
        d_rel = _segment_sum(p, edst, n_dst + 1)[:n_dst]
        num[dt] = n_rel if dt not in num else num[dt] + n_rel
        den[dt] = d_rel if dt not in den else den[dt] + d_rel
    return {nt: num[nt] / den[nt].clamp_min(1e-30)[:, :, None]
            for nt in num}


def make_sharded_hetero_attention(pl: LocalHeteroPartition,
                                  negative_slope: float = 0.2, group=None):
    """``fn(el, er, ft) -> {dsttype: (n_loc, H, D)}``: the typed attention
    of :func:`sharded_typed_attention` on this part's rows."""
    _check_world(pl, group)

    def fn(el, er, ft):
        return sharded_typed_attention(pl, el, er, ft, negative_slope,
                                       group)

    return fn
