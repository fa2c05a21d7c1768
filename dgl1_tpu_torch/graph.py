"""Graph container and its host-side layout builders.

The port's counterpart of ``dgl1_tpu/graph.py``: a (possibly bipartite)
multigraph whose structure is built once on the host with numpy (or the
C++ builder in ``_native``) and held as ``torch`` tensors:

``src, dst``            COO endpoints in user edge order; on a padded
                        block the tail holds the sentinels
                        ``num_src_nodes`` / ``num_dst_nodes``.
``edge_mask``           bool, True for real edges; None when every edge
                        is real.
``csr_indptr``          (num_src_nodes+1,) out-edge row pointers;
``csr_dst, csr_eid``    dst / user edge id sorted by src; ``csr_src``.
``csc_indptr``          (num_dst_nodes+1,) in-edge row pointers;
``csc_src, csc_eid``    src / user edge id sorted by dst; ``csc_dst``.
``tdst, tsrc``          edge-tile layouts of the tile engine
                        (:func:`_build_tiles`), reduce-by-dst and by-src.
``ell_dst, ell_src``    degree-bucketed ELL layouts with static metas.
``hub_dst``             the hub-dense layout (``hub_format.py``) and meta.
``bdense``              the block-dense layout (``bdense_format.py``) and
                        ``bdense_meta``; built only when ``formats`` names
                        ``"bdense"``.

``graph(formats=...)`` restricts what is built: ``("csc",)`` gives a
sampling-only parent (COO and CSC, no CSR, tiles, ELL or hub). Blocks
(``is_block``) come from the fused sampler (``sampling/fused.py``) or
:func:`block` and carry ``srcdata``/``dstdata`` and host bookkeeping in
``meta``.
``Graph.to(device)`` moves every tensor; entry points build on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# The ELL bucket fill and the fixed-row stack live with the hub builder,
# which pins its tail stacks with them; the ELL builders here reuse them.
from dgl1_tpu_torch.hub_format import (  # noqa: F401
    _build_ell_fixed_rows, _ell_bucket)

__all__ = ["Graph", "graph", "block", "create_block", "rand_graph",
           "resolve_device", "TILE_EDGES", "TILE_ROWS"]

ID_DTYPE = np.int32

# Edge-tile geometry of the tile engine (as ``dgl1_tpu/graph.py``): T edge
# slots per tile, R output rows per row block.
TILE_EDGES = 1024
TILE_ROWS = 128


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA without a card raises:
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dgl1_tpu_torch: CUDA was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _as_numpy_ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype not in (np.int32, np.int64):
        arr = arr.astype(np.int64)
    return arr.astype(ID_DTYPE)


def _tree_to(x, device):
    """Move every array leaf of a nested dict to ``device`` as a tensor."""
    if isinstance(x, dict):
        return {k: _tree_to(v, device) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


_ARRAY_FIELDS = ("src", "dst", "edge_mask", "csr_indptr", "csr_dst",
                 "csr_eid", "csr_src", "csc_indptr", "csc_src", "csc_eid",
                 "csc_dst", "tdst", "tsrc", "ell_dst", "ell_src", "hub_dst",
                 "bdense")


class Graph:
    """Static-shape graph; see the module docstring for the fields.
    ``num_edges`` is the count of real edges; the edge arrays may be
    longer (``num_edges_padded``)."""

    def __init__(self, *, src, dst, csr_indptr, csr_dst, csr_eid,
                 csr_src, csc_indptr, csc_src, csc_eid, csc_dst,
                 num_src_nodes: int, num_dst_nodes: int, num_edges: int,
                 edge_mask=None, is_block: bool = False,
                 tdst: Optional[Dict[str, Any]] = None,
                 tsrc: Optional[Dict[str, Any]] = None,
                 ell_dst: Optional[Dict[str, Any]] = None,
                 ell_src: Optional[Dict[str, Any]] = None,
                 ell_dst_meta: Optional[Tuple] = None,
                 ell_src_meta: Optional[Tuple] = None,
                 hub_dst: Optional[Dict[str, Any]] = None,
                 hub_dst_meta=None,
                 bdense: Optional[Dict[str, Any]] = None, bdense_meta=None,
                 device="cpu"):
        dev = torch.device(device)
        for k, v in (("src", src), ("dst", dst), ("edge_mask", edge_mask),
                     ("csr_indptr", csr_indptr), ("csr_dst", csr_dst),
                     ("csr_eid", csr_eid), ("csr_src", csr_src),
                     ("csc_indptr", csc_indptr), ("csc_src", csc_src),
                     ("csc_eid", csc_eid), ("csc_dst", csc_dst),
                     ("tdst", tdst), ("tsrc", tsrc), ("ell_dst", ell_dst),
                     ("ell_src", ell_src), ("hub_dst", hub_dst),
                     ("bdense", bdense)):
            setattr(self, k, _tree_to(v, dev))
        self.ell_dst_meta = ell_dst_meta
        self.ell_src_meta = ell_src_meta
        self.hub_dst_meta = hub_dst_meta
        self.bdense_meta = bdense_meta
        self._num_src_nodes = int(num_src_nodes)
        self._num_dst_nodes = int(num_dst_nodes)
        self._num_edges = int(num_edges)
        self._is_block = bool(is_block)
        # Host-side bookkeeping (real src/dst counts of a sampled block).
        self.meta: Dict[str, Any] = {}
        self.ndata: Dict[str, torch.Tensor] = {}
        self.edata: Dict[str, torch.Tensor] = {}
        if is_block:
            self.srcdata: Dict[str, torch.Tensor] = {}
            self.dstdata: Dict[str, torch.Tensor] = {}
        else:
            # Homogeneous graph: srcdata/dstdata alias ndata.
            self.srcdata = self.dstdata = self.ndata

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def is_block(self) -> bool:
        return self._is_block

    def num_nodes(self) -> int:
        if self._is_block:
            raise ValueError("num_nodes() is ambiguous on a block; use "
                             "num_src_nodes() / num_dst_nodes()")
        return self._num_src_nodes

    def num_src_nodes(self) -> int:
        return self._num_src_nodes

    def num_dst_nodes(self) -> int:
        return self._num_dst_nodes

    def num_edges(self) -> int:
        """Number of real (unpadded) edges."""
        return self._num_edges

    def num_edges_padded(self) -> int:
        """Length of the edge arrays (>= num_edges)."""
        return int(self.src.shape[0])

    def in_degrees(self, v=None):
        deg = torch.diff(self.csc_indptr)
        return deg if v is None else deg[v]

    def out_degrees(self, u=None):
        if self.csr_indptr is None:
            raise ValueError("this graph was built without CSR "
                             "(formats=); out_degrees needs it")
        deg = torch.diff(self.csr_indptr)
        return deg if u is None else deg[u]

    def edges(self):
        """(src, dst) in user edge order (padded length)."""
        return self.src, self.dst

    def to(self, device) -> "Graph":
        """A new Graph with every tensor on ``device`` (same metadata)."""
        dev = resolve_device(device)
        new = Graph(
            **{k: getattr(self, k) for k in _ARRAY_FIELDS},
            ell_dst_meta=self.ell_dst_meta, ell_src_meta=self.ell_src_meta,
            hub_dst_meta=self.hub_dst_meta, bdense_meta=self.bdense_meta,
            is_block=self._is_block, num_src_nodes=self._num_src_nodes,
            num_dst_nodes=self._num_dst_nodes, num_edges=self._num_edges,
            device=dev)
        new.meta = dict(self.meta)
        new.ndata.update(_tree_to(self.ndata, dev))
        new.edata.update(_tree_to(self.edata, dev))
        if self._is_block:
            new.srcdata.update(_tree_to(self.srcdata, dev))
            new.dstdata.update(_tree_to(self.dstdata, dev))
        return new

    def reverse(self, copy_edata: bool = True) -> "Graph":
        """Every edge reversed: CSR and CSC, the tile and the ELL
        directions swap roles, no data moves. The hub and block-dense
        layouts are of the destination side only, so the reverse has
        neither (its g-SpMM goes to ELL)."""
        g = Graph(
            src=self.dst, dst=self.src, edge_mask=self.edge_mask,
            csr_indptr=self.csc_indptr, csr_dst=self.csc_src,
            csr_eid=self.csc_eid, csr_src=self.csc_dst,
            csc_indptr=self.csr_indptr, csc_src=self.csr_dst,
            csc_eid=self.csr_eid, csc_dst=self.csr_src,
            tdst=self.tsrc, tsrc=self.tdst, ell_dst=self.ell_src,
            ell_src=self.ell_dst, ell_dst_meta=self.ell_src_meta,
            ell_src_meta=self.ell_dst_meta,
            num_src_nodes=self._num_dst_nodes,
            num_dst_nodes=self._num_src_nodes, num_edges=self._num_edges,
            is_block=self._is_block, device=self.device)
        g.meta = dict(self.meta)
        if copy_edata:
            g.edata.update(self.edata)
        if self._is_block:
            g.srcdata.update(self.dstdata)
            g.dstdata.update(self.srcdata)
        else:
            g.ndata.update(self.ndata)
        return g

    def __repr__(self):
        kind = "Block" if self._is_block else "Graph"
        return (f"{kind}(num_src_nodes={self._num_src_nodes}, "
                f"num_dst_nodes={self._num_dst_nodes}, "
                f"num_edges={self._num_edges}, device={self.device}, "
                f"hub={self.hub_dst_meta is not None}, "
                f"bdense={self.bdense_meta is not None}, "
                f"tiles={self.tdst is not None})")


# ----------------------------------------------------------------------
# Construction (host side, numpy)
# ----------------------------------------------------------------------

def _build_formats(src: np.ndarray, dst: np.ndarray, num_src: int,
                   num_dst: int, num_edges: int, hub=None,
                   hub_dense_floor: Optional[int] = None,
                   formats: Optional[Tuple[str, ...]] = None,
                   num_padded: Optional[int] = None):
    """COO + CSC (+ CSR), and the tile, ELL and hub layouts that
    ``formats`` asks for (None: all of these). The block-dense layout is
    built only when ``formats`` names ``"bdense"``, as in the reference:
    ``None`` does not include it. CSR is built whenever ``formats``
    names it or a derived layout. Stable sorts keep edge-id order within
    a row. With ``num_padded`` > ``num_edges`` the edge arrays get a tail
    of padded edges (the reference's sentinels: node ``num_src`` /
    ``num_dst``, edge id 0) and an ``edge_mask``; every layout holds the
    real edges only."""
    want = (lambda k: True) if formats is None else (
        lambda k: k in formats)
    need_csr = any(want(k) for k in ("csr", "tile", "ell", "hub"))
    coo_src = src.astype(ID_DTYPE)
    coo_dst = dst.astype(ID_DTYPE)
    csr_indptr = csr_dst = csr_eid = csr_src = None

    from dgl1_tpu_torch import _native

    native = _native.lib()
    if native is not None:
        src32 = np.ascontiguousarray(src, dtype=ID_DTYPE)
        dst32 = np.ascontiguousarray(dst, dtype=ID_DTYPE)

        def adj(key, other, num_keys):
            indptr = np.zeros((num_keys + 1,), dtype=ID_DTYPE)
            s_other, s_eid, s_key = (np.empty((num_edges,), dtype=ID_DTYPE)
                                     for _ in range(3))
            native.build_adj(key, other, num_edges, num_keys, indptr,
                             s_other, s_eid, s_key)
            return indptr, s_other, s_eid, s_key

        if need_csr:
            csr_indptr, csr_dst, csr_eid, csr_src = adj(src32, dst32, num_src)
        csc_indptr, csc_src, csc_eid, csc_dst = adj(dst32, src32, num_dst)
    else:
        eid = np.arange(num_edges, dtype=ID_DTYPE)

        def adj(key, other, num_keys):
            order = np.argsort(key, kind="stable").astype(ID_DTYPE)
            counts = np.bincount(key, minlength=num_keys) if num_edges \
                else np.zeros(num_keys, dtype=np.int64)
            indptr = np.zeros((num_keys + 1,), dtype=ID_DTYPE)
            np.cumsum(counts, out=indptr[1:])
            return (indptr, other[order].astype(ID_DTYPE), eid[order],
                    key[order].astype(ID_DTYPE))

        if need_csr:
            csr_indptr, csr_dst, csr_eid, csr_src = adj(src, dst, num_src)
        csc_indptr, csc_src, csc_eid, csc_dst = adj(dst, src, num_dst)

    ell_dst_meta = ell_dst = ell_src_meta = ell_src = None
    if want("ell"):
        ell_dst_meta, ell_dst = _build_ell(
            csc_indptr, csc_src, csc_eid, num_dst, num_edges)
        ell_src_meta, ell_src = _build_ell(
            csr_indptr, csr_dst, csr_eid, num_src, num_edges)
    tdst = tsrc = None
    if want("tile"):
        tdst = _build_tiles(csc_dst, csc_src, csc_eid, num_edges, num_dst)
        tsrc = _build_tiles(csr_src, csr_dst, csr_eid, num_edges, num_src)
    # Hub layout: auto-built only when the head of the in-degree
    # distribution clears the density bar. hub=True forces it, an int sets
    # the per-group edge floor, hub=False skips.
    hub_dst_meta = hub_dst = None
    if want("hub") and hub is not False and num_edges > 0:
        from dgl1_tpu_torch import hub_format

        if hub is None:
            floor = None
        elif hub is True:
            floor = 1
        else:
            floor = int(hub)
        hub_dst_meta, hub_dst = hub_format.build_hub_format(
            csc_indptr, csc_src, csc_eid, csc_dst, num_src, num_dst,
            num_edges, num_padded or num_edges, _build_ell,
            min_group_edges=floor, dense_floor=hub_dense_floor,
        )
    bdense_meta = bdense = None
    if formats is not None and "bdense" in formats and num_edges > 0:
        from dgl1_tpu_torch.bdense_format import build_block_dense

        bdense_meta, bdense = build_block_dense(
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            num_src, num_dst, _build_ell)
    pad = (num_padded or num_edges) - num_edges
    edge_mask = None
    if pad:
        def padded(a, sentinel):
            return None if a is None else np.concatenate(
                [a, np.full((pad,), sentinel, dtype=ID_DTYPE)])

        coo_src, coo_dst = padded(coo_src, num_src), padded(coo_dst, num_dst)
        csr_src, csr_dst = padded(csr_src, num_src), padded(csr_dst, num_dst)
        csc_src, csc_dst = padded(csc_src, num_src), padded(csc_dst, num_dst)
        csr_eid, csc_eid = padded(csr_eid, 0), padded(csc_eid, 0)
        edge_mask = np.arange(num_edges + pad) < num_edges
    return dict(
        src=coo_src, dst=coo_dst, edge_mask=edge_mask,
        csr_indptr=csr_indptr, csr_dst=csr_dst, csr_eid=csr_eid,
        csr_src=csr_src,
        csc_indptr=csc_indptr, csc_src=csc_src, csc_eid=csc_eid,
        csc_dst=csc_dst, tdst=tdst, tsrc=tsrc,
        ell_dst_meta=ell_dst_meta, ell_dst=ell_dst,
        ell_src_meta=ell_src_meta, ell_src=ell_src,
        hub_dst_meta=hub_dst_meta, hub_dst=hub_dst,
        bdense_meta=bdense_meta, bdense=bdense,
    )


# ELL bucket ladder: degrees round up to the nearest rung 1,2,3,4,6,8,12,
# ... (alternating x1.5 / x1.33 doublings) up to 2^24.
def _make_ell_ladder():
    ladder = [1, 2, 3]
    while ladder[-1] < (1 << 24):
        ladder.append(ladder[-2] * 2)
    return ladder


_ELL_LADDER = _make_ell_ladder()


def _ladder_rung(k: int) -> int:
    """Smallest ELL ladder rung >= k."""
    for r in _ELL_LADDER:
        if r >= k:
            return r
    raise ValueError(f"degree {k} above the ELL ladder")


def _build_ell(indptr: np.ndarray, nbr_sorted: np.ndarray,
               eid_sorted: np.ndarray, num_target: int, num_edges: int,
               min_slots: Optional[int] = None):
    """Degree-bucketed ELL layout for scatter-free segment reduction.

    Rows are grouped by padded degree k; a bucket stores exactly k slots
    per row (sentinel ``1 << 30`` marks padding). ``inv_perm`` maps a row
    id to its bucket-sorted position (``num_rows_nonzero`` for zero-degree
    rows). Returns (meta, {idx, eid, inv_perm}), meta = ((k, n_rows), ...).
    """
    if num_edges > 0 and num_target > 0:
        from dgl1_tpu_torch import _native

        native = _native.lib()
        if native is not None:
            ip32 = np.ascontiguousarray(indptr[: num_target + 1], ID_DTYPE)
            nbr32 = np.ascontiguousarray(nbr_sorted, ID_DTYPE)
            eid32 = np.ascontiguousarray(eid_sorted, ID_DTYPE)
            meta_k = np.zeros((64,), np.int64)
            meta_nb = np.zeros((64,), np.int64)
            n_out = np.zeros((2,), np.int64)
            ms = -1 if min_slots is None else int(min_slots)
            nb = native.plan_ell(ip32, num_target, num_edges, ms, meta_k,
                                 meta_nb, n_out)
            idx = np.empty((int(n_out[0]),), ID_DTYPE)
            eid = np.empty((int(n_out[0]),), ID_DTYPE)
            inv_perm = np.empty((num_target,), ID_DTYPE)
            native.fill_ell(ip32, nbr32, eid32, num_target, num_edges, ms,
                            idx, eid, inv_perm)
            meta = tuple(
                (int(meta_k[i]), int(meta_nb[i])) for i in range(nb))
            return meta, {"idx": idx, "eid": eid, "inv_perm": inv_perm}

    deg = np.diff(indptr[: num_target + 1]).astype(np.int64)
    ladder = np.asarray(_ELL_LADDER, dtype=np.int64)
    kidx = np.searchsorted(ladder, deg, side="left")
    kidx = np.minimum(kidx, len(ladder) - 1)

    # Coalesce small buckets upward (each bucket is one gather launch).
    MIN_SLOTS = min(1 << 16, max(num_edges // 4, 1)) \
        if min_slots is None else min_slots
    counts = np.bincount(kidx[deg > 0], minlength=len(ladder))
    for r in range(len(ladder) - 1):
        if counts[r] and counts[r] * ladder[r] < MIN_SLOTS:
            counts[r + 1] += counts[r]
            counts[r] = 0
            kidx = np.where((kidx == r) & (deg > 0), r + 1, kidx)
    kpad = ladder[kidx]
    kpad = np.where(deg == 0, 0, kpad)

    order = np.argsort(np.where(deg == 0, np.int64(1 << 60), kpad),
                       kind="stable")
    nz = order[: int((deg > 0).sum())]

    inv_perm = np.full((num_target,), len(nz), dtype=ID_DTYPE)
    inv_perm[nz] = np.arange(len(nz), dtype=ID_DTYPE)

    meta = []
    idx_parts = []
    eid_parts = []
    pos = 0
    while pos < len(nz):
        k = int(kpad[nz[pos]])
        end = pos
        while end < len(nz) and kpad[nz[end]] == k:
            end += 1
        rows = nz[pos:end]
        idx_b, eid_b = _ell_bucket(indptr, nbr_sorted, eid_sorted, rows,
                                   len(rows), k)
        meta.append((k, len(rows)))
        idx_parts.append(idx_b)
        eid_parts.append(eid_b)
        pos = end

    idx = (np.concatenate(idx_parts) if idx_parts else
           np.zeros(0, np.int64))
    eid = (np.concatenate(eid_parts) if eid_parts else
           np.zeros(0, np.int64))
    return tuple(meta), {
        "idx": idx.astype(ID_DTYPE),
        "eid": eid.astype(ID_DTYPE),
        "inv_perm": inv_perm,
    }


def _build_ell_uniform(indptr: np.ndarray, nbr_sorted: np.ndarray,
                       eid_sorted: np.ndarray, num_target: int, k: int):
    """Uniform single-rung ELL: every row (zero-degree included) gets
    exactly ``rung(k)`` slots, so the bucket metadata is a function of
    (num_target, k) alone, the same for every sampled block of an epoch.
    Returns (meta, arrays) like :func:`_build_ell`; ``inv_perm`` is empty,
    the engine's marker for "rows already in order"."""
    k_pad = _ladder_rung(max(int(k), 1))
    deg = np.diff(indptr[: num_target + 1]).astype(np.int64)
    if deg.size and int(deg.max(initial=0)) > k_pad:
        raise ValueError(
            f"row degree {int(deg.max())} exceeds uniform ELL width {k_pad}")
    idx, eid = _ell_bucket(indptr, nbr_sorted, eid_sorted,
                           np.arange(num_target), num_target, k_pad)
    meta = ((k_pad, num_target),)
    return meta, {
        "idx": idx.astype(ID_DTYPE),
        "eid": eid.astype(ID_DTYPE),
        "inv_perm": np.zeros((0,), ID_DTYPE),
    }


def static_tile_bound(num_edges_padded: int, num_target: int) -> int:
    """Static upper bound on the tile count of :func:`_build_tiles`:
    every row block adds at most one partial tile on top of the
    edge-count floor."""
    T, R = TILE_EDGES, TILE_ROWS
    return max((num_edges_padded + T - 1) // T + (num_target + R - 1) // R,
               1)


def _pad_tiles(tiles: dict, pad_to: int, num_target: int) -> dict:
    """Pad the tile arrays to a static tile count with no-op tiles (lid =
    -1 everywhere, ``first`` = 0, row block = the last one), so every
    sampled block of an epoch has the same layout shapes."""
    T = TILE_EDGES
    n = tiles["lid"].shape[0]
    if n > pad_to:
        raise ValueError(f"actual tile count {n} exceeds static bound "
                         f"{pad_to}")
    if n == pad_to:
        return tiles
    extra = pad_to - n
    n_blocks = max((num_target + TILE_ROWS - 1) // TILE_ROWS, 1)
    return dict(
        rows=np.concatenate([tiles["rows"],
                             np.full((extra,), n_blocks - 1, ID_DTYPE)]),
        first=np.concatenate([tiles["first"], np.zeros((extra,), ID_DTYPE)]),
        lid=np.concatenate([tiles["lid"], np.full((extra, T), -1, ID_DTYPE)],
                           axis=0),
        gather=np.concatenate([tiles["gather"],
                               np.zeros((extra * T,), ID_DTYPE)]),
        eid=np.concatenate([tiles["eid"], np.zeros((extra * T,), ID_DTYPE)]),
        block_mask=tiles["block_mask"],
    )


def _empty_tiles(block_mask: np.ndarray) -> dict:
    T = TILE_EDGES
    return dict(rows=np.zeros((1,), ID_DTYPE), first=np.ones((1,), ID_DTYPE),
                lid=np.full((1, T), -1, ID_DTYPE),
                gather=np.zeros((T,), ID_DTYPE), eid=np.zeros((T,), ID_DTYPE),
                block_mask=block_mask)


def _build_tiles(target_sorted: np.ndarray, gather_sorted: np.ndarray,
                 eid_sorted: np.ndarray, num_edges: int, num_target: int):
    """Edge-tile layout of the tile engine (``ops/engine_tile.py``).

    Inputs are in target-sorted order (CSC for reduce-by-dst, CSR for
    reduce-by-src); entries past ``num_edges`` are ignored. Output rows
    are grouped into blocks of TILE_ROWS; each block's edges fill whole
    tiles of TILE_EDGES slots, padded with lid = -1, so within a tile lid
    is sorted and each row's slots are one run. Row blocks with no edges
    get no tiles (``block_mask`` False; consumers mask their rows).

    Returns dict of numpy arrays:
      rows   (n_tiles,)       int32 row-block index of each tile
      first  (n_tiles,)       int32 1 if tile is the first of its block
      lid    (n_tiles, T)     int32 target id within block, -1 padding
      gather (n_tiles*T,)     int32 source-side node id per slot (0 pad)
      eid    (n_tiles*T,)     int32 user edge id per slot (0 pad)
      block_mask (n_blocks,)  bool, True where the row block has edges
    """
    T, R = TILE_EDGES, TILE_ROWS
    n_blocks = max((num_target + R - 1) // R, 1)

    from dgl1_tpu_torch import _native

    native = _native.lib()
    if native is not None:
        tgt32 = np.ascontiguousarray(target_sorted[:num_edges], ID_DTYPE)
        gat32 = np.ascontiguousarray(gather_sorted[:num_edges], ID_DTYPE)
        eid32 = np.ascontiguousarray(eid_sorted[:num_edges], ID_DTYPE)
        n_tiles = int(native.plan_tiles(tgt32, num_edges, num_target, T, R))
        block_mask = np.bincount(tgt32 // R,
                                 minlength=n_blocks).astype(np.int64) > 0
        if n_tiles == 0:
            return _empty_tiles(block_mask)
        rows = np.zeros((n_tiles,), ID_DTYPE)
        first = np.zeros((n_tiles,), ID_DTYPE)
        lid = np.full((n_tiles * T,), -1, ID_DTYPE)
        gather = np.zeros((n_tiles * T,), ID_DTYPE)
        eid_out = np.zeros((n_tiles * T,), ID_DTYPE)
        native.build_tiles(tgt32, gat32, eid32, num_edges, num_target, T, R,
                           rows, first, lid, gather, eid_out)
        return dict(rows=rows, first=first, lid=lid.reshape(n_tiles, T),
                    gather=gather, eid=eid_out, block_mask=block_mask)

    tgt = target_sorted[:num_edges].astype(np.int64)
    gat = gather_sorted[:num_edges].astype(np.int64)
    eid = eid_sorted[:num_edges].astype(np.int64)
    blk = tgt // R
    cnt = np.bincount(blk, minlength=n_blocks) if num_edges else np.zeros(
        n_blocks, dtype=np.int64)
    tiles_per_block = (cnt + T - 1) // T
    n_tiles = int(tiles_per_block.sum())
    if n_tiles == 0:
        return _empty_tiles(np.zeros((n_blocks,), bool))

    rows = np.repeat(np.arange(n_blocks), tiles_per_block).astype(ID_DTYPE)
    first = np.zeros((n_tiles,), ID_DTYPE)
    starts = np.concatenate([[0], np.cumsum(tiles_per_block)[:-1]])
    # Trailing empty blocks alias past the end; empty blocks elsewhere
    # alias the next block's start, which is a first tile anyway.
    first[starts[starts < n_tiles]] = 1

    # Edges of block b fill slots from slot_start[b] on, in edge order.
    slot_start = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(tiles_per_block[:-1] * T, out=slot_start[1:])
    edge_start = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(cnt[:-1], out=edge_start[1:])
    slot = slot_start[blk] + np.arange(num_edges) - edge_start[blk]

    n_slots = n_tiles * T
    lid = np.full((n_slots,), -1, dtype=ID_DTYPE)
    gather = np.zeros((n_slots,), dtype=ID_DTYPE)
    eid_out = np.zeros((n_slots,), dtype=ID_DTYPE)
    lid[slot] = (tgt - blk * R).astype(ID_DTYPE)
    gather[slot] = gat.astype(ID_DTYPE)
    eid_out[slot] = eid.astype(ID_DTYPE)
    return dict(rows=rows, first=first, lid=lid.reshape(n_tiles, T),
                gather=gather, eid=eid_out, block_mask=cnt > 0)


def graph(data: Tuple, num_nodes: Optional[int] = None,
          pad_edges_to: Optional[int] = None,
          pad_edges_multiple: Optional[int] = None,
          device_arrays: bool = False, hub=None,
          hub_dense_floor: Optional[int] = None,
          formats: Optional[Tuple[str, ...]] = None, *,
          device=None) -> Graph:
    """Homogeneous graph from an edge list ``(src, dst)`` (numpy arrays or
    tensors), built on the host and placed on ``device`` (default
    ``cuda``). The positional order is the reference's. ``formats``
    restricts the layouts built (see :func:`_build_formats`);
    ``("csc",)`` is the sampling-only parent. ``pad_edges_to`` pads the
    edge arrays to that length with masked edges (``edge_mask``), or else
    ``pad_edges_multiple`` to the next multiple of it (at least one), as
    the reference's ``graph(pad_edges_to=, pad_edges_multiple=)``.
    ``device_arrays`` is accepted for the reference's signature: the
    port's arrays always live on ``device``."""
    del device_arrays
    dev = resolve_device(device)
    src, dst = data
    src = _as_numpy_ids(src)
    dst = _as_numpy_ids(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be 1-D arrays of equal length")
    num_edges = int(src.shape[0])
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if num_edges and (src.min() < 0 or dst.min() < 0 or
                      src.max() >= num_nodes or dst.max() >= num_nodes):
        raise ValueError("edge endpoint out of range")
    if isinstance(formats, str):
        formats = (formats,)
    num_padded = num_edges
    if pad_edges_to is not None:
        if pad_edges_to < num_edges:
            raise ValueError("pad_edges_to < num_edges")
        num_padded = int(pad_edges_to)
    elif pad_edges_multiple:
        m = int(pad_edges_multiple)
        num_padded = max(-(-num_edges // m) * m, m)
    arrays = _build_formats(src, dst, num_nodes, num_nodes, num_edges,
                            hub=hub, hub_dense_floor=hub_dense_floor,
                            formats=formats, num_padded=num_padded)
    return Graph(**arrays, num_src_nodes=num_nodes, num_dst_nodes=num_nodes,
                 num_edges=num_edges, device=dev)


def block(data: Tuple, num_src_nodes: Optional[int] = None,
          num_dst_nodes: Optional[int] = None,
          pad_edges_to: Optional[int] = None,
          formats: Optional[Tuple[str, ...]] = None,
          uniform_ell_k: Optional[int] = None, *, device=None) -> Graph:
    """Bipartite message-flow block from ``(src, dst)`` (``dgl.create_block``),
    built on the host and placed on ``device`` (default ``cuda``). The
    node counts default to the largest id + 1 of each side; ``formats``
    and ``pad_edges_to`` as in :func:`graph` (the hub layout where the
    destination in-degrees clear its bar).

    ``uniform_ell_k``: the static-shape mode of sampled blocks whose
    in-degree is at most ``k``. It builds COO, CSC and CSR, a uniform
    single-rung dst-ELL (:func:`_build_ell_uniform`) and both tile
    directions padded to :func:`static_tile_bound` of ``pad_edges_to``,
    and nothing else, so every block of an epoch has the same layout
    shapes; ``meta['num_real_edges']`` holds the real edge count (which
    is also ``num_edges()`` in the port)."""
    dev = resolve_device(device)
    src, dst = data
    src = _as_numpy_ids(src)
    dst = _as_numpy_ids(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be 1-D arrays of equal length")
    num_edges = int(src.shape[0])
    if num_src_nodes is None:
        num_src_nodes = int(src.max(initial=-1) + 1)
    if num_dst_nodes is None:
        num_dst_nodes = int(dst.max(initial=-1) + 1)
    if num_edges and (src.min() < 0 or dst.min() < 0
                      or src.max() >= num_src_nodes
                      or dst.max() >= num_dst_nodes):
        raise ValueError("edge endpoint out of range")
    if isinstance(formats, str):
        formats = (formats,)
    num_padded = int(pad_edges_to) if pad_edges_to is not None else num_edges
    if num_padded < num_edges:
        raise ValueError("pad_edges_to < num_edges")
    if uniform_ell_k is None:
        arrays = _build_formats(src, dst, num_src_nodes, num_dst_nodes,
                                num_edges, formats=formats,
                                num_padded=num_padded)
        return Graph(**arrays, num_src_nodes=num_src_nodes,
                     num_dst_nodes=num_dst_nodes, num_edges=num_edges,
                     is_block=True, device=dev)
    arrays = _build_formats(src, dst, num_src_nodes, num_dst_nodes,
                            num_edges, formats=("csr",),
                            num_padded=num_padded)
    arrays["ell_dst_meta"], arrays["ell_dst"] = _build_ell_uniform(
        arrays["csc_indptr"], arrays["csc_src"], arrays["csc_eid"],
        num_dst_nodes, uniform_ell_k)
    arrays["tdst"] = _pad_tiles(
        _build_tiles(arrays["csc_dst"], arrays["csc_src"], arrays["csc_eid"],
                     num_edges, num_dst_nodes),
        static_tile_bound(num_padded, num_dst_nodes), num_dst_nodes)
    arrays["tsrc"] = _pad_tiles(
        _build_tiles(arrays["csr_src"], arrays["csr_dst"], arrays["csr_eid"],
                     num_edges, num_src_nodes),
        static_tile_bound(num_padded, num_src_nodes), num_src_nodes)
    g = Graph(**arrays, num_src_nodes=num_src_nodes,
              num_dst_nodes=num_dst_nodes, num_edges=num_edges,
              is_block=True, device=dev)
    g.meta["num_real_edges"] = num_edges
    return g


create_block = block


def rand_graph(num_nodes: int, num_edges: int, seed: int = 0, **kw) -> Graph:
    """Uniform random multigraph (``dgl.rand_graph``): ``num_edges`` edges
    with both ends drawn from ``default_rng(seed)``, as the reference draws
    them; ``kw`` goes to :func:`graph`."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges)
    dst = rng.integers(0, num_nodes, size=num_edges)
    return graph((src, dst), num_nodes=num_nodes, **kw)
