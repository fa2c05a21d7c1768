"""Partitioned graph with a static halo-exchange plan (host build).

The port's counterpart of ``dgl1_tpu/parallel/halo.py``. The partitioner
fixes, for every (owner q -> consumer p) pair, which owned nodes q sends
to p; at every layer those rows move in one ``all_to_all`` and land in
fixed halo slots that p's local edge arrays already index. Every array is
padded to the largest part, so each rank runs the same shapes.

The host build is the reference's, array for array: numpy arrays stacked
on a leading P axis (the block-dense and hub count matrices are torch
tensors, numpy having no bfloat16). One process runs one partition:
:meth:`PartitionedGraph.local` gives rank p its slice as tensors on its
device (:class:`LocalPartition`), which ``parallel/sharded_ops.py`` takes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, _tree_to
from dgl1_tpu_torch.parallel.graph_partition_book import GraphPartitionBook

__all__ = ["PartitionedGraph", "LocalPartition", "build_partitioned_graph",
           "vertex_cut_edge_owner"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_tiles(tiles_list, num_target):
    """Stack per-part tile dicts, padding tile counts to the max with
    no-op tiles aimed at a scratch row block past the real ones."""
    from dgl1_tpu_torch.graph import TILE_EDGES, TILE_ROWS

    scratch_block = (num_target + TILE_ROWS - 1) // TILE_ROWS
    n_tiles = max(t["rows"].shape[0] for t in tiles_list)
    out = {k: [] for k in ("rows", "first", "lid", "gather",
                           "block_mask")}
    for t in tiles_list:
        pad = n_tiles - t["rows"].shape[0]
        out["rows"].append(np.concatenate(
            [t["rows"], np.full(pad, scratch_block, np.int32)]))
        out["first"].append(np.concatenate(
            [t["first"], np.ones(pad, np.int32)]))
        out["lid"].append(np.concatenate(
            [t["lid"], np.full((pad, TILE_EDGES), -1, np.int32)]))
        out["gather"].append(np.concatenate(
            [t["gather"], np.zeros(pad * TILE_EDGES, np.int32)]))
        out["block_mask"].append(t["block_mask"])
    return {k: np.stack(v) for k, v in out.items()}


def _trim_pad_tiles(tiles):
    """One part's tile layout without the cross-part padding tiles (the
    trailing tiles aimed at the scratch row block past the real ones).
    K9 walks a row block's tiles in one thread block, so the padding of
    a part with fewer tiles than the largest would all fall on one block
    and cost a serial walk of empty tiles."""
    if tiles is None:
        return None
    n_blocks = tiles["block_mask"].shape[0]
    real = np.flatnonzero(tiles["rows"] < n_blocks)
    keep = int(real[-1]) + 1 if len(real) else 0
    if keep == tiles["rows"].shape[0]:
        return tiles
    from dgl1_tpu_torch.graph import TILE_EDGES

    out = dict(tiles)
    for k in ("rows", "first", "lid"):
        out[k] = tiles[k][:keep]
    out["gather"] = tiles["gather"][: keep * TILE_EDGES]
    return out


def _stack_counts(blocks):
    """Stack count-block tensors (bf16 or float32) of equal shape; float32
    when any part needs it."""
    dt = (torch.float32 if any(b.dtype == torch.float32 for b in blocks)
          else torch.bfloat16)
    return torch.stack([b.to(dt) for b in blocks])


_PG_ARRAY_FIELDS = (
    "edst", "esrc", "send_idx", "in_deg", "out_deg", "node_mask", "orig_ids",
    "tiles_fwd", "tiles_rev", "recv_pos", "slot_node", "bdense", "hub",
    "halo_out_deg",
)
_PG_STATIC_FIELDS = ("num_parts", "n_loc", "e_loc", "m_halo", "num_nodes",
                     "m_part", "hub_meta", "hub_rows", "halo_dtype")


def _slice(tree, p):
    """Part p of a stacked array, tensor or dict of them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _slice(v, p) for k, v in tree.items()}
    return tree[p]


class PartitionedGraph:
    """The stacked host build; every array has leading axis P.

    Combined per-part feature index space: [0, n_loc) owned nodes,
    [n_loc + q*m_halo, n_loc + (q+1)*m_halo) halo slots from owner q.

      edst      (P, e_loc)     int32 local dst ids, sorted; padding holds
                               n_loc + P*m_part
      esrc      (P, e_loc)     int32 combined src index
      send_idx  (P, P, m_halo) int32: [q][p] = local ids q sends to p
      in_deg    (P, n_loc)     float32 global in-degree
      out_deg   (P, n_loc)     float32 global out-degree
      node_mask (P, n_loc)     bool, a real owned node
      orig_ids  (P, n_loc)     int32 global id (0 on phantom rows)
      halo_out_deg (P, P*m_halo) float32 global out-degree of the node
                               each halo slot carries (1 where unused)

    Vertex-cut extras (``m_part`` > 0): ``recv_pos`` (P, n_loc, P), the
    receive-buffer position of the partial each sender holds for an owned
    node (P*m_part where none); ``slot_node`` (P, P*m_part), the owned
    local id a receive slot feeds (n_loc where none). Optional layouts:
    ``tiles_fwd`` / ``tiles_rev`` (the tile engine's descriptors, K9),
    ``bdense`` (per-part block-dense descriptors, K11), ``hub`` with
    ``hub_meta`` (per-part hub layouts of one forced geometry,
    ``parallel/hub_shard.py``) and ``hub_rows`` R, the row count of the
    combined [owned | halo | pad] layout the hub layouts are built in.
    ``halo_dtype``: the halo wire, "f32", "bf16" or "int8".
    """

    __slots__ = _PG_ARRAY_FIELDS + _PG_STATIC_FIELDS

    def __init__(self, *, edst, esrc, send_idx, in_deg, out_deg, node_mask,
                 orig_ids, num_parts, n_loc, e_loc, m_halo, num_nodes,
                 tiles_fwd=None, tiles_rev=None, recv_pos=None,
                 slot_node=None, m_part=0, bdense=None, hub=None,
                 hub_meta=None, hub_rows=0, halo_dtype="f32",
                 halo_out_deg=None):
        self.edst = edst
        self.esrc = esrc
        self.send_idx = send_idx
        self.in_deg = in_deg
        self.out_deg = out_deg
        self.halo_out_deg = halo_out_deg
        self.node_mask = node_mask
        self.orig_ids = orig_ids
        self.tiles_fwd = tiles_fwd
        self.tiles_rev = tiles_rev
        self.bdense = bdense
        self.hub = hub
        self.hub_meta = hub_meta
        self.hub_rows = int(hub_rows)
        self.halo_dtype = str(halo_dtype)
        self.recv_pos = recv_pos
        self.slot_node = slot_node
        self.m_part = int(m_part)
        self.num_parts = int(num_parts)
        self.n_loc = int(n_loc)
        self.e_loc = int(e_loc)
        self.m_halo = int(m_halo)
        self.num_nodes = int(num_nodes)

    @property
    def n_comb(self) -> int:
        return self.n_loc + self.num_parts * self.m_halo

    @property
    def n_out(self) -> int:
        return self.n_loc + self.num_parts * self.m_part

    # ------------------------------------------------------------------
    def local(self, rank: int, device=None) -> "LocalPartition":
        """Part ``rank``'s arrays as tensors on ``device`` (None: cuda),
        without the padding that makes every part's shapes the same (one
        process a part needs none, and the port's kernels would walk it):
        its tile layouts without the scratch-block tiles
        (:func:`_trim_pad_tiles`), its hub layout without the forced
        geometry's trailing no-op chunks (``hub_shard.
        trim_forced_chunks``)."""
        from dgl1_tpu_torch.graph import resolve_device

        dev = resolve_device(device)
        parts = {f: _slice(getattr(self, f), rank) for f in _PG_ARRAY_FIELDS}
        for f in ("tiles_fwd", "tiles_rev"):
            parts[f] = _trim_pad_tiles(parts[f])
        if parts["hub"] is not None:
            from dgl1_tpu_torch.parallel.hub_shard import trim_forced_chunks

            parts["hub"] = trim_forced_chunks(self.hub_meta, parts["hub"])
        kw = {f: _tree_to(v, dev) for f, v in parts.items()}
        kw.update({f: getattr(self, f) for f in _PG_STATIC_FIELDS})
        return LocalPartition(rank=int(rank), device=dev, **kw)

    def _gather_rows(self, data, ids, mask):
        data = torch.as_tensor(data)
        out = data.index_select(0, torch.as_tensor(
            ids.reshape(-1).astype(np.int64), device=data.device))
        if out.is_floating_point():
            # Zero phantom rows so padded nodes carry no values.
            m = torch.as_tensor(mask.reshape(-1), device=data.device)
            out = out * m.reshape((-1,) + (1,) * (data.dim() - 1)).to(
                out.dtype)
        return out.reshape(ids.shape + tuple(data.shape[1:]))

    def shard_node_data(self, data, rank: Optional[int] = None):
        """(N, *f) global node data -> (P, n_loc, *f), or part ``rank``'s
        (n_loc, *f); phantom rows are zero (float data)."""
        if rank is None:
            return self._gather_rows(data, self.orig_ids, self.node_mask)
        return self._gather_rows(data, self.orig_ids[rank],
                                 self.node_mask[rank])

    def shard_node_data_combined(self, data, rank: Optional[int] = None):
        """(N, *f) -> (P, R, *f) combined-layout blocks (or part
        ``rank``'s (R, *f)), halo and pad rows zero: the first halo update
        fills the slots. Needs a hub build (R = hub_rows)."""
        if not self.hub_rows:
            raise ValueError("combined layout requires hub=... at build")
        x = self.shard_node_data(data, rank)
        pad = self.hub_rows - self.n_loc
        ax = 0 if rank is not None else 1
        widths = [0, 0] * (x.dim() - ax - 1) + [0, pad]
        return torch.nn.functional.pad(x, widths)

    def unshard_node_data(self, data):
        """(P, n_loc, *f) -> (N, *f) global layout (phantom rows dropped)."""
        data = torch.as_tensor(data)
        flat = data.reshape((-1,) + tuple(data.shape[2:]))
        mask = torch.as_tensor(self.node_mask.reshape(-1),
                               device=data.device)
        ids = torch.as_tensor(self.orig_ids.reshape(-1).astype(np.int64),
                              device=data.device)
        out = data.new_zeros((self.num_nodes,) + tuple(data.shape[2:]))
        out[ids[mask]] = flat[mask]
        return out

    def unshard_node_data_combined(self, data):
        """(P, R, *f) combined-layout -> (N, *f) (owned rows)."""
        return self.unshard_node_data(data[:, : self.n_loc])

    # ------------------------------------------------------------------
    def combined_ids(self, rank: int) -> np.ndarray:
        """Global id of every row of part ``rank``'s combined table
        (n_comb,): owned rows, then each halo slot's node; -1 on phantom
        rows and unused halo slots."""
        own = np.where(self.node_mask[rank], self.orig_ids[rank], -1)
        halo = np.full((self.num_parts, self.m_halo), -1, np.int64)
        for q in range(self.num_parts):
            sid = self.send_idx[q, rank]
            halo[q] = np.where(self.node_mask[q][sid],
                               self.orig_ids[q][sid], -1)
        used = (self.esrc[rank] >= self.n_loc) & (
            self.edst[rank] < self.n_out)
        live = np.zeros((self.num_parts * self.m_halo,), bool)
        live[self.esrc[rank][used] - self.n_loc] = True
        halo = np.where(live, halo.reshape(-1), -1)
        return np.concatenate([own.astype(np.int64), halo])

    def output_ids(self, rank: int) -> np.ndarray:
        """Global id of every output row of part ``rank``'s local reduce
        (n_out,): owned rows, then each vertex-cut partial slot's
        destination; -1 on phantom rows and unused slots."""
        own = np.where(self.node_mask[rank], self.orig_ids[rank], -1)
        parts = [own.astype(np.int64)]
        for q in range(self.num_parts):
            if not self.m_part:
                break
            sn = self.slot_node[q, rank * self.m_part:
                                (rank + 1) * self.m_part]
            ok = sn < self.n_loc
            ids = np.where(ok, self.orig_ids[q][np.minimum(
                sn, self.n_loc - 1)], -1)
            parts.append(ids.astype(np.int64))
        return np.concatenate(parts)

    def combined_from_global(self, data, rank: int):
        """Part ``rank``'s combined table (n_comb, *f) filled from the
        global rows on the host's side: what :func:`sharded_ops.
        halo_exchange` gives that rank over an exact (f32) wire, send
        rows of unused slots included."""
        x = [self.shard_node_data(data, q) for q in range(self.num_parts)]
        halo = [x[q].index_select(0, torch.as_tensor(
            self.send_idx[q, rank].astype(np.int64), device=x[q].device))
            for q in range(self.num_parts)]
        return torch.cat([x[rank]] + halo, dim=0)


class LocalPartition:
    """One part of a :class:`PartitionedGraph` as tensors on one device:
    the array fields of the host build without their P axis (``send_idx``
    is this part's (P, m_halo) send table), the static fields, ``rank``
    and ``device``."""

    def __init__(self, *, rank, device, **kw):
        self.rank = rank
        self.device = device
        for k, v in kw.items():
            setattr(self, k, v)
        self._hub_graph = None

    @property
    def n_comb(self) -> int:
        return self.n_loc + self.num_parts * self.m_halo

    @property
    def n_out(self) -> int:
        return self.n_loc + self.num_parts * self.m_part

    def hub_graph(self) -> Graph:
        """The part's hub layout as a :class:`Graph` of R sources and R
        destinations, the engines' input (``ops/engine_hub.py``,
        ``ops/attention.py``)."""
        if self.hub is None:
            raise ValueError("no hub layout: build with hub=...")
        if self._hub_graph is None:
            self._hub_graph = hub_layout_graph(
                self.esrc, self.edst, self.hub, self.hub_meta,
                self.hub_rows, self.n_out, self.device)
        return self._hub_graph


def hub_layout_graph(esrc, edst, hub, hub_meta, rows: int, n_out: int,
                     device) -> Graph:
    """A part's hub layout as a :class:`Graph` of ``rows`` sources and
    ``rows`` destinations, the engines' input (``ops/engine_hub.py``,
    ``ops/attention.py``). Edges into a destination at or past ``n_out``
    are padding and not counted."""
    return Graph(
        src=esrc, dst=edst, csr_indptr=None, csr_dst=None, csr_eid=None,
        csr_src=None, csc_indptr=None, csc_src=None, csc_eid=None,
        csc_dst=None, num_src_nodes=rows, num_dst_nodes=rows,
        num_edges=int((edst < n_out).sum()), hub_dst=hub,
        hub_dst_meta=hub_meta, device=device)


def vertex_cut_edge_owner(g: Graph, part: np.ndarray, num_parts: int,
                          threshold: Optional[int] = None) -> np.ndarray:
    """PowerGraph-style split-destination edge ownership.

    Destinations of in-degree up to ``threshold`` keep their edges on
    their own part; above it, a destination's in-edges are dealt
    round-robin across all parts, so a mega-hub's aggregation spreads
    evenly and finishes with at most P-1 partial rows exchanged.
    """
    from dgl1_tpu_torch.parallel.partition import _coo

    part = np.asarray(part).astype(np.int32)
    e = g.num_edges()
    _, dst = _coo(g)
    in_deg = np.bincount(dst, minlength=g.num_nodes())
    if threshold is None:
        threshold = max(int(e / (num_parts * 16)), 64)
    owner = part[dst].astype(np.int32)
    hub_mask = in_deg > threshold
    hub_edges = np.nonzero(hub_mask[dst])[0]
    if len(hub_edges):
        # Rank within a hub = position in the dst-grouped order.
        hd = dst[hub_edges]
        order = np.argsort(hd, kind="stable")
        sorted_hd = hd[order]
        first_pos = np.searchsorted(sorted_hd, sorted_hd)
        rank = np.arange(len(sorted_hd)) - first_pos
        owner[hub_edges[order]] = (
            part[sorted_hd].astype(np.int64) + rank
        ) % num_parts
    return owner


def _slot_of(ids, sets, owner, base: int, width: int):
    """Slot ``base + q*width + j`` of each id, where ``sets[q]`` (sorted,
    unique) holds the id at position j and q = owner[id]."""
    out = np.empty(len(ids), dtype=np.int64)
    q_of = owner[ids]
    for q, members in sets.items():
        sel = q_of == q
        if sel.any():
            out[sel] = base + q * width + np.searchsorted(members, ids[sel])
    return out


def build_partitioned_graph(
    g: Graph,
    part: np.ndarray,
    num_parts: int,
    pad_nodes_multiple: int = 8,
    pad_edges_multiple: int = 128,
    pad_halo_multiple: int = 8,
    edge_owner: Optional[np.ndarray] = None,
    tiles: bool = True,
    bdense: bool = False,
    hub=False,
    hub_dense_floor: Optional[int] = None,
    halo_dtype: str = "f32",
    hub_identity: bool = False,
) -> PartitionedGraph:
    """Build the partitioned structure from an assignment (the reference's
    arguments and arrays).

    Default (``edge_owner=None``): edges live on their destination's
    part; remote sources become halo slots. With ``edge_owner`` (e.g.
    :func:`vertex_cut_edge_owner`) an edge may live on another part: it
    reduces into a partial slot there and one more ``all_to_all`` returns
    the partials to the destination's owner (vertex cut). ``tiles``:
    the tile descriptors of both directions (K9); ``bdense``: per-part
    block-dense descriptors (K11) with the tiles covering the tail;
    ``hub`` (True, or an int group floor) with ``hub_dense_floor``: per-
    part hub layouts of one forced geometry; ``hub_identity``: renumber
    each part's owned nodes hub-first against that geometry
    (``hub_shard.plan_identity_order``) so every part's layout has
    ``identity_expand``; the relabel is internal (``orig_ids``,
    ``shard_node_data`` and ``unshard_node_data`` compose it away).
    """
    from dgl1_tpu_torch.parallel.partition import _coo

    part = np.asarray(part).astype(np.int32)
    book = GraphPartitionBook(part, num_parts)
    src, dst = _coo(g)
    n = g.num_nodes()
    in_deg_g = np.bincount(dst, minlength=n).astype(np.int64)
    out_deg_g = np.bincount(src, minlength=n).astype(np.int64)

    eo = part[dst] if edge_owner is None else \
        np.asarray(edge_owner).astype(np.int32)
    vertex_cut = edge_owner is not None and bool(np.any(eo != part[dst]))

    own_nodes = [book.partid2nids(p) for p in range(num_parts)]
    n_loc = _round_up(max(len(o) for o in own_nodes), pad_nodes_multiple)

    # Per-part edge sets, halo (src side) and partial (dst side) sets.
    halo_sets: Dict[int, Dict[int, np.ndarray]] = {}
    partial_sets: Dict[int, Dict[int, np.ndarray]] = {}
    part_edges = []
    for p in range(num_parts):
        eids = np.nonzero(eo == p)[0]
        part_edges.append(eids)
        remote = part[src[eids]] != p
        rsrc = np.unique(src[eids][remote])
        halo_sets[p] = {q: rsrc[part[rsrc] == q] for q in range(num_parts)}
        if vertex_cut:
            fdst = np.unique(dst[eids][part[dst[eids]] != p])
            partial_sets[p] = {q: fdst[part[fdst] == q]
                               for q in range(num_parts)}
        else:
            partial_sets[p] = {q: np.zeros(0, np.int64)
                               for q in range(num_parts)}

    m_halo = max((len(halo_sets[p][q]) for p in range(num_parts)
                  for q in range(num_parts)), default=0)
    m_halo = max(_round_up(max(m_halo, 1), pad_halo_multiple),
                 pad_halo_multiple)
    e_loc = _round_up(max(len(pe) for pe in part_edges), pad_edges_multiple)
    m_part = 0
    if vertex_cut:
        m_part = max(len(partial_sets[p][q]) for p in range(num_parts)
                     for q in range(num_parts))
        m_part = max(_round_up(max(m_part, 1), pad_halo_multiple),
                     pad_halo_multiple)

    # Per-part hub-first renumbering (identity expand at any P).
    relabels = None
    hub_mge = None if hub is True or not hub else int(hub)
    hub_df = hub_dense_floor
    if hub_identity:
        if not hub:
            raise ValueError("hub_identity requires hub=... at build")
        if vertex_cut:
            raise ValueError(
                "hub_identity: vertex-cut placement unsupported "
                "(partial-slot destinations pin their own numbering); "
                "use the default destination-owner placement")
        from dgl1_tpu_torch.hub_format import BLK, CHUNK, DENSE_RB
        from dgl1_tpu_torch.parallel.hub_shard import plan_identity_order

        # Resolve the hub floors against the natural geometry once, so
        # this plan and the final (relabeled, larger-R) build select the
        # same hub groups.
        r_nat = _round_up(max(n_loc + num_parts * m_halo, n_loc), DENSE_RB)
        if hub_mge is None:
            hub_mge = max(4 * CHUNK, ((-(-r_nat // BLK)) * CHUNK) // 4)
        if hub_df is None:
            hub_df = max(r_nat // 2, 4 * CHUNK)
        plan_parts = []
        for p in range(num_parts):
            eids = part_edges[p]
            plan_parts.append((
                book.nid2localnid(dst[eids]).astype(np.int64),
                src[eids] == dst[eids],
                len(own_nodes[p]),
            ))
        relabels, _n_merge, max_used = plan_identity_order(
            plan_parts, n_loc, hub_mge, hub_df)
        if relabels is not None:
            n_loc = _round_up(max(max_used, 1), pad_nodes_multiple)

    from dgl1_tpu_torch.graph import _build_tiles

    n_comb = n_loc + num_parts * m_halo
    # Output space: owned rows, then per-owner partial-slot blocks.
    n_out = n_loc + num_parts * m_part

    tiles_fwd_list, tiles_rev_list = [], []
    bdense_list = []
    hub_edges_list = []
    if bdense and not tiles:
        raise ValueError("bdense=True requires tiles=True (the tail path)")

    edst = np.full((num_parts, e_loc), n_out, dtype=np.int32)
    esrc = np.zeros((num_parts, e_loc), dtype=np.int32)
    send_idx = np.zeros((num_parts, num_parts, m_halo), dtype=np.int32)
    halo_outdeg = np.ones((num_parts, num_parts * m_halo), dtype=np.float32)
    in_deg = np.zeros((num_parts, n_loc), dtype=np.float32)
    out_deg = np.zeros((num_parts, n_loc), dtype=np.float32)
    node_mask = np.zeros((num_parts, n_loc), dtype=bool)
    orig_ids = np.zeros((num_parts, n_loc), dtype=np.int32)
    recv_pos = slot_node = None
    if vertex_cut:
        recv_pos = np.full((num_parts, n_loc, num_parts),
                           num_parts * m_part, dtype=np.int32)
        slot_node = np.full((num_parts, num_parts * m_part), n_loc,
                            dtype=np.int32)

    def _local(p, nids):
        """Global ids -> part p's local ids (identity relabel aware)."""
        lid = book.nid2localnid(nids)
        return lid if relabels is None else relabels[p][lid]

    for p in range(num_parts):
        own = own_nodes[p]
        lids = (np.arange(len(own), dtype=np.int64) if relabels is None
                else relabels[p])
        node_mask[p, lids] = True
        orig_ids[p, lids] = own
        in_deg[p, lids] = in_deg_g[own]
        out_deg[p, lids] = out_deg_g[own]

        for q in range(num_parts):
            nodes_q = halo_sets[p][q]
            send_idx[q, p, : len(nodes_q)] = _local(q, nodes_q)
            halo_outdeg[p, q * m_halo: q * m_halo + len(nodes_q)] = \
                out_deg_g[nodes_q]
            if vertex_cut:
                # Owner q's receive buffer block from p holds p's partials
                # in partial_sets[p][q] order.
                nodes_q = partial_sets[p][q]
                lq = _local(q, nodes_q)
                j = np.arange(len(nodes_q))
                recv_pos[q, lq, p] = p * m_part + j
                slot_node[q, p * m_part + j] = lq

        eids = part_edges[p]
        dst_e = dst[eids]
        owned_dst = part[dst_e] == p
        ldst = np.empty(len(eids), dtype=np.int64)
        ldst[owned_dst] = _local(p, dst_e[owned_dst])
        if vertex_cut and (~owned_dst).any():
            ldst[~owned_dst] = _slot_of(dst_e[~owned_dst], partial_sets[p],
                                        part, n_loc, m_part)
        esrc_p = np.empty(len(eids), dtype=np.int64)
        local_src = part[src[eids]] == p
        esrc_p[local_src] = _local(p, src[eids][local_src])
        esrc_p[~local_src] = _slot_of(src[eids][~local_src], halo_sets[p],
                                      part, n_loc, m_halo)
        order = np.argsort(ldst, kind="stable")
        edst[p, : len(eids)] = ldst[order]
        esrc[p, : len(eids)] = esrc_p[order]
        if hub:
            hub_edges_list.append((esrc_p.copy(), ldst.copy()))

        t_src, t_dst = esrc_p, ldst
        if bdense:
            # Dense tier over (combined src space, output dst space); the
            # tiles below cover the tail only.
            from dgl1_tpu_torch.bdense_format import plan_blocks

            _, bdp, tail_eids = plan_blocks(
                esrc_p.astype(np.int64), ldst.astype(np.int64),
                n_comb, n_out)
            bdense_list.append(bdp)
            t_src, t_dst = esrc_p[tail_eids], ldst[tail_eids]
        if tiles:
            dummy_eid = np.zeros(len(t_src), np.int32)
            t_order = np.argsort(t_dst, kind="stable")
            tiles_fwd_list.append(_build_tiles(
                t_dst[t_order].astype(np.int32),
                t_src[t_order].astype(np.int32),
                dummy_eid, len(t_src), n_out,
            ))
            rev_order = np.argsort(t_src, kind="stable")
            tiles_rev_list.append(_build_tiles(
                t_src[rev_order].astype(np.int32),
                t_dst[rev_order].astype(np.int32),
                dummy_eid, len(t_src), n_comb,
            ))

    tiles_fwd = _pad_tiles(tiles_fwd_list, n_out) if tiles else None
    tiles_rev = _pad_tiles(tiles_rev_list, n_comb) if tiles else None

    bdense_stacked = None
    if bdense:
        bdense_stacked = _stack_bdense(bdense_list, n_out, n_comb)

    hub_meta = hub_stacked = None
    hub_rows = 0
    if hub:
        from dgl1_tpu_torch.hub_format import DENSE_RB
        from dgl1_tpu_torch.parallel.hub_shard import build_partitioned_hub

        hub_rows = _round_up(max(n_comb, n_out), DENSE_RB)
        hub_meta, hub_stacked = build_partitioned_hub(
            hub_edges_list, hub_rows, hub_rows, e_loc,
            min_group_edges=hub_mge, dense_floor=hub_df,
            identity=bool(hub_identity and relabels is not None))

    return PartitionedGraph(
        hub=hub_stacked, hub_meta=hub_meta,
        hub_rows=hub_rows if hub_stacked is not None else 0,
        halo_dtype=halo_dtype, bdense=bdense_stacked,
        tiles_fwd=tiles_fwd, tiles_rev=tiles_rev,
        edst=edst, esrc=esrc, send_idx=send_idx, halo_out_deg=halo_outdeg,
        in_deg=in_deg, out_deg=out_deg, node_mask=node_mask,
        orig_ids=orig_ids, recv_pos=recv_pos, slot_node=slot_node,
        m_part=m_part, num_parts=num_parts, n_loc=n_loc, e_loc=e_loc,
        m_halo=m_halo, num_nodes=n,
    )


def _stack_bdense(bdense_list, n_out: int, n_comb: int):
    """Stack per-part block-dense descriptors, the block count padded to
    the largest part with all-zero blocks aimed at a scratch output block
    (n_rb forward, n_cb transpose), past every real row; the run pointers
    cover the real blocks only."""
    from dgl1_tpu_torch.bdense_format import BLK

    n_rb = (n_out + BLK - 1) // BLK
    n_cb = (n_comb + BLK - 1) // BLK
    k_max = max(b["rb"].shape[0] for b in bdense_list)
    out = {k: [] for k in bdense_list[0]}
    for b in bdense_list:
        pad = k_max - b["rb"].shape[0]
        for k in ("a", "ab"):
            out[k].append(torch.cat(
                [b[k], torch.zeros((pad * BLK, BLK), dtype=b[k].dtype)]))
        out["rb"].append(np.concatenate([b["rb"], np.full(pad, n_rb,
                                                          np.int32)]))
        out["cb"].append(np.concatenate([b["cb"], np.zeros(pad, np.int32)]))
        out["first_f"].append(np.concatenate([b["first_f"],
                                              np.ones(pad, np.int32)]))
        out["rbb"].append(np.concatenate([b["rbb"],
                                          np.zeros(pad, np.int32)]))
        out["cbb"].append(np.concatenate([b["cbb"], np.full(pad, n_cb,
                                                            np.int32)]))
        out["first_b"].append(np.concatenate([b["first_b"],
                                              np.ones(pad, np.int32)]))
        for k in ("rb_mask", "cb_mask", "row_ptr", "col_ptr"):
            out[k].append(b[k])
    return {k: (_stack_counts(v) if k in ("a", "ab") else np.stack(v))
            for k, v in out.items()}
