"""Hub-dense HYB layout builder (host side, numpy).

The port's copy of ``dgl1_tpu/hub_format.py`` (the single-device build
and the typed identity mode, ``identity_force``; the forced cross-part
geometry of the distributed layer is not ported). It splits a graph's
edges by destination in-degree into three tiers for
``ops/engine_hub.py``:

* **dense**: groups of BLK hub rows whose edge count clears
  ``dense_floor`` (about num_src/2), stored as a static count matrix ``C``
  of shape (rows_pad, BLK * n_dense), so the whole reduce is ``C^T @ U``;
* **chunked**: the remaining hub groups, with edges sorted by (group,
  source window) and cut into CHUNK-slot chunks of slot-local ids;
* **ELL tail**: every other edge, on the degree-bucketed ELL layout.

The arrays and ``HubMeta`` equal those of ``dgl1_tpu/hub_format.py``
for the same edges. One difference: counts in 128..256 are kept as
float32 in numpy and cast to ``torch.bfloat16`` when the tensor is made
(numpy has no bf16).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

ID_DTYPE = np.int32
BLK = 128          # group rows / window rows
DENSE_RB = 1024    # source-row block of the dense-tier descriptors
CHUNK = 1024       # edge slots per chunk
MAX_GROUPS = 32    # cap on hub rows: 32*128 = 4096 hubs
MAX_DENSE_GROUPS = 8   # cap on dense count-matrix columns (memory)
SENT = np.int32(1 << 30)  # out-of-bounds gather index -> fill value
EXPAND_RB = 512        # output rows per expand-merge block
EXPAND_PACK = 1 << 20  # descriptor packing base (local_row*PACK + m_row)


class HubMeta(NamedTuple):
    """Static descriptor of a hub layout (field for field the reference's)."""
    n_full_f: int        # full-layout fwd chunks (all hub edges)
    n_full_b: int        # full-layout bwd chunks
    n_part_f: int        # chunked-tier-only fwd chunks
    n_part_b: int        # chunked-tier-only bwd chunks
    n_win: int           # source windows
    n_groups: int        # total hub groups (dense + chunked)
    n_dense: int         # leading groups on the dense count-matrix tier
    tail_meta_dst: Tuple  # ELL bucket meta, reduce-by-dst (tail)
    tail_meta_src: Tuple  # ELL bucket meta, reduce-by-src (tail reverse)
    n_tail_rows: int     # nonzero rows in the tail ELL stack
    covered: int         # hub edges (dense + chunked tiers)
    # Single self-loop tail edges extracted to node-level diagonal arrays
    # (add_self_loop graphs would otherwise give every node a tail row).
    has_diag: bool = False
    # Destination ids already in merge order (hub slots, then the tail
    # stack, then zero-degree rows): the expand is a concat plus pad.
    identity_expand: bool = False


def hub_order(g) -> np.ndarray:
    """Hub-first node permutation ``perm[new_id] = old_id``: hub slots
    first, tail stack rows next, zero-degree rows last, so that a rebuild
    on the relabeled graph has ``identity_expand``. Feed it to
    :func:`dgl1_tpu_torch.reorder_graph` with ``node_permute_algo='custom'``
    (or use ``'hub'``, which does both)."""
    if g.hub_dst is None or g.hub_dst_meta is None:
        raise ValueError("hub_order needs a graph with a hub layout")
    t_inv = g.hub_dst["t_inv"].cpu().numpy().astype(np.int64)
    m = g.hub_dst_meta
    k_slots = m.n_groups * BLK
    # Hubs first: the hub selection breaks degree ties by id (stable
    # argsort), so hubs must precede equal-degree tail rows or the rebuild
    # would swap boundary rows and lose the identity.
    is_hub_row = (t_inv >= m.n_tail_rows) & (t_inv < SENT)
    key = np.where(
        is_hub_row, t_inv - m.n_tail_rows,
        np.where(t_inv >= SENT, np.int64(1) << 40, k_slots + t_inv))
    return np.argsort(key, kind="stable")


def _pad_runs(order: np.ndarray, run_ids: np.ndarray,
              values: Tuple, chunk: int):
    """Sort ``values`` by ``order``, split at ``run_ids`` boundaries and pad
    every run to a multiple of ``chunk``."""
    e = order.shape[0]
    if e == 0:
        return [np.zeros((0,), ID_DTYPE) for _ in values], np.zeros(
            (0,), np.int64), np.zeros((0,), np.int64)
    keys = run_ids
    change = np.empty((e,), dtype=bool)
    change[0] = True
    np.not_equal(keys[1:], keys[:-1], out=change[1:])
    run_starts = np.flatnonzero(change)
    run_lens = np.diff(np.append(run_starts, e))
    padded_lens = -(-run_lens // chunk) * chunk
    offsets = np.concatenate([[0], np.cumsum(padded_lens)[:-1]])
    total = int(padded_lens.sum())

    within = np.arange(e, dtype=np.int64) - np.repeat(run_starts, run_lens)
    dest = np.repeat(offsets, run_lens) + within

    out = []
    for v, fill in values:
        buf = np.full((total,), fill, dtype=ID_DTYPE)
        buf[dest] = v[order]
        out.append(buf)
    return out, padded_lens // chunk, run_starts


def _chunk_descriptors(n_chunks_per_run: np.ndarray, run_starts: np.ndarray,
                       out_key: np.ndarray, in_key: np.ndarray,
                       order: np.ndarray):
    """Per-chunk (out_id, in_id, first-of-out-block flag)."""
    if len(run_starts) == 0:
        z = np.zeros((0,), ID_DTYPE)
        return z, z.copy(), z.copy()
    run_out = out_key[order[run_starts]].astype(ID_DTYPE)
    run_in = in_key[order[run_starts]].astype(ID_DTYPE)
    chunk_out = np.repeat(run_out, n_chunks_per_run)
    chunk_in = np.repeat(run_in, n_chunks_per_run)
    first = np.zeros((len(chunk_out),), dtype=ID_DTYPE)
    if len(first):
        first[0] = 1
        first[1:] = (chunk_out[1:] != chunk_out[:-1]).astype(ID_DTYPE)
    return chunk_out, chunk_in, first


def _chunk_layouts(h_src, h_slot, h_eid, n_win: int, group_offset: int):
    """Forward (group-major) and backward (window-major) chunk layouts for
    one edge subset; output group ids shift by ``group_offset``."""
    group = h_slot // BLK - group_offset
    window = h_src // BLK
    a_local = (h_src % BLK).astype(ID_DTYPE)
    b_local = (h_slot % BLK).astype(ID_DTYPE)

    f_order = np.lexsort((window, group))
    f_key = (group * n_win + window)[f_order]
    (fa, fb, fe), f_nchunks, f_starts = _pad_runs(
        f_order, f_key, ((a_local, -1), (b_local, -1), (h_eid, 0)), CHUNK
    )
    f_out, f_in, f_first = _chunk_descriptors(
        f_nchunks, f_starts, group, window, f_order
    )
    fwd = {"a": fa, "b": fb, "eid": fe, "in_id": f_in, "out_id": f_out,
           "first": f_first}

    # Backward: the selector roles swap; ``a`` picks rows of the compact
    # hub cotangent block, ``b`` scatters into the source window.
    b_order = np.lexsort((group, window))
    b_key = (window * (group.max(initial=0) + 1) + group)[b_order]
    (ba, bb, be), b_nchunks, b_starts = _pad_runs(
        b_order, b_key, ((b_local, -1), (a_local, -1), (h_eid, 0)), CHUNK
    )
    b_out, b_in, b_first = _chunk_descriptors(
        b_nchunks, b_starts, window, group, b_order
    )
    bwd = {"a": ba, "b": bb, "eid": be, "in_id": b_in, "out_id": b_out,
           "first": b_first}
    # Group-gather descriptors (used by the fused attention backward).
    gperm = np.argsort(b_in, kind="stable").astype(ID_DTYPE)
    gout = b_in[gperm].astype(ID_DTYPE)
    gfirst = np.zeros((len(gout),), dtype=ID_DTYPE)
    if len(gfirst):
        gfirst[0] = 1
        gfirst[1:] = (gout[1:] != gout[:-1]).astype(ID_DTYPE)
    bwd["gperm"], bwd["gout"], bwd["gfirst"] = gperm, gout, gfirst

    win_mask = np.zeros((n_win,), dtype=bool)
    win_mask[b_out] = True
    return fwd, bwd, win_mask, fe, fa


def _dense_counts(h_src, h_slot, num_src: int, n_src_pad: int, kd: int):
    """Dense-tier count matrix ``C[s, k]`` = multiplicity of edge s -> hub
    slot k, as a torch tensor: int8 for counts <= 127, bf16 up to 256
    (exact there), float32 beyond."""
    if not kd:
        return torch.zeros((n_src_pad, 0), dtype=torch.float32)
    flat = h_src * kd + h_slot
    dense_c = np.zeros((n_src_pad, kd), dtype=np.float32)
    dense_c[:num_src] = np.bincount(
        flat, minlength=num_src * kd).astype(np.float32).reshape(num_src, kd)
    cmax = dense_c.max(initial=0.0)
    if cmax <= 127:
        return torch.from_numpy(dense_c.astype(np.int8))
    t = torch.from_numpy(dense_c)
    return t.to(torch.bfloat16) if cmax <= 256 else t


def build_hub_format(csc_indptr: np.ndarray, csc_src: np.ndarray,
                     csc_eid: np.ndarray, csc_dst: np.ndarray,
                     num_src: int, num_dst: int, num_edges: int, build_ell,
                     min_group_edges: Optional[int] = None,
                     dense_floor: Optional[int] = None,
                     num_padded: Optional[int] = None,
                     identity_force: Optional[dict] = None):
    """Build the three-tier hub layout. Returns (HubMeta, arrays) or
    (None, None) when no hub group clears the density bar (the engine then
    declines and dispatch falls through to ELL). ``build_ell`` is
    ``graph._build_ell``, reused for the tail in both directions. The
    per-edge maps (``edge_to_fslot``, ``edge_to_tslot``,
    ``diag_edge_dst``) cover ``num_padded`` edges (default
    ``num_edges``), the padded ones holding the sentinel.

    ``identity_force`` (keys ``n_groups``, ``n_dense``,
    ``tail_meta_dst``, ``build_ell_fixed``), the typed identity mode: hub
    slots are pinned to ids ``[0, n_groups*128)`` and the dst tail stack
    to the following ids in id order under the caller's bucket meta
    (``build_ell_fixed`` is ``graph._build_ell_fixed_rows``), whatever
    this edge set's own degrees are.
    Every relation built on one superset graph's geometry then shares
    its merge order, the node order, and claims ``identity_expand``;
    slots and rows this edge set does not touch read zeros (empty count
    columns, all-sentinel ELL rows). A tail edge to a row past the pinned
    range raises ValueError."""
    num_padded = num_edges if num_padded is None else int(num_padded)
    deg = np.diff(csc_indptr[: num_dst + 1]).astype(np.int64)
    n_win = -(-num_src // BLK)
    if min_group_edges is None:
        # Below n_win*CHUNK/4 edges a group is mostly padding.
        min_group_edges = max(4 * CHUNK, (n_win * CHUNK) // 4)
    if dense_floor is None:
        dense_floor = max(num_src // 2, 4 * CHUNK)

    if identity_force is not None:
        n_groups = int(identity_force["n_groups"])
        n_dense = int(identity_force["n_dense"])
        k_slots = n_groups * BLK
        rows_all = np.arange(min(k_slots, num_dst), dtype=np.int64)
    else:
        order_by_deg = np.argsort(-deg, kind="stable")
        group_edge_counts = []
        n_groups = 0
        while n_groups < MAX_GROUPS:
            rows = order_by_deg[n_groups * BLK: (n_groups + 1) * BLK]
            if rows.size == 0:
                break
            group_edges = int(deg[rows].sum())
            if group_edges < min_group_edges:
                break
            group_edge_counts.append(group_edges)
            n_groups += 1
        if n_groups == 0:
            return None, None
        n_dense = 0
        while (n_dense < min(n_groups, MAX_DENSE_GROUPS)
               and group_edge_counts[n_dense] >= dense_floor):
            n_dense += 1
        k_slots = n_groups * BLK
        rows_all = order_by_deg[:k_slots]
    rows_d = rows_all[: n_dense * BLK]
    rows_c = rows_all[n_dense * BLK:]
    hub_ids = np.full((k_slots,), SENT, dtype=ID_DTYPE)
    hub_ids[: rows_d.size] = rows_d
    hub_ids[n_dense * BLK: n_dense * BLK + rows_c.size] = rows_c
    slot_of_row = np.full((num_dst,), SENT, dtype=ID_DTYPE)
    slot_of_row[rows_d] = np.arange(rows_d.size, dtype=ID_DTYPE)
    slot_of_row[rows_c] = n_dense * BLK + np.arange(rows_c.size,
                                                    dtype=ID_DTYPE)

    # Split edges: hub set (dense/chunked) vs tail (ELL); the csc arrays
    # are dst-sorted.
    dst_e, src_e, eid_e = csc_dst, csc_src, csc_eid
    slot_e = slot_of_row[dst_e]
    is_hub = slot_e != SENT

    h_src = src_e[is_hub].astype(np.int64)
    h_slot = slot_e[is_hub].astype(np.int64)
    h_eid = eid_e[is_hub]

    # Full layouts over all hub edges (weighted ops and grad_e).
    full_fwd, full_bwd, win_mask_full, full_fe, full_fa = _chunk_layouts(
        h_src, h_slot, h_eid, n_win, group_offset=0
    )
    # Chunked-tier-only layouts (dense groups go through C).
    in_part = h_slot >= n_dense * BLK
    part_fwd, part_bwd, win_mask_part, _, _ = _chunk_layouts(
        h_src[in_part], h_slot[in_part], h_eid[in_part], n_win,
        group_offset=n_dense,
    )

    # Rows padded to DENSE_RB: padding rows are zero and contribute nothing.
    kd = n_dense * BLK
    n_src_pad = -(-max(num_src, 1) // DENSE_RB) * DENSE_RB
    dense_c = _dense_counts(h_src[~in_part], h_slot[~in_part], num_src,
                            n_src_pad, kd)

    # Edge-id -> full-layout fwd slot (for grad_e extraction).
    edge_to_fslot = np.full((num_padded,), SENT, dtype=ID_DTYPE)
    real = full_fa >= 0
    edge_to_fslot[full_fe[real]] = np.flatnonzero(real).astype(ID_DTYPE)

    def _build_tail(t_dst, t_src, t_eid):
        """dst/src ELL stacks, merge permutation and compact-slot arrays
        for the tail edge subset (dst-sorted)."""
        n_tail = int(t_dst.shape[0])
        tail_min_slots = min(1 << 14, max(n_tail // 2, 1))
        t_counts = np.bincount(t_dst, minlength=num_dst) if n_tail else \
            np.zeros((num_dst,), np.int64)
        t_indptr = np.zeros((num_dst + 1,), dtype=np.int64)
        np.cumsum(t_counts, out=t_indptr[1:])
        if identity_force is not None:
            meta_fx = identity_force["tail_meta_dst"]
            n_fx = int(sum(nb for _, nb in meta_fx))
            if n_tail and int(t_dst.max(initial=0)) >= k_slots + n_fx:
                raise ValueError(
                    "identity_force: tail edge to a row outside the "
                    "superset tail range (meta not from a superset "
                    "graph?)")
            tail_meta_dst, tail_dst_ell = identity_force["build_ell_fixed"](
                t_indptr, t_src, t_eid, meta_fx, k_slots, num_dst)
        else:
            tail_meta_dst, tail_dst_ell = build_ell(
                t_indptr, t_src, t_eid, num_dst, n_tail,
                min_slots=tail_min_slots)

        r_order = np.argsort(t_src, kind="stable")
        r_counts = np.bincount(t_src, minlength=num_src) if n_tail else \
            np.zeros((num_src,), np.int64)
        r_indptr = np.zeros((num_src + 1,), dtype=np.int64)
        np.cumsum(r_counts, out=r_indptr[1:])
        tail_meta_src, tail_src_ell = build_ell(
            r_indptr, t_dst[r_order], t_eid[r_order], num_src, n_tail,
            min_slots=tail_min_slots,
        )

        # Merge permutation: non-hub rows read the tail stack, hub rows
        # the dense/chunked block appended after it, empty rows the OOB
        # sentinel (fill 0).
        n_tail_rows = int(sum(n for _, n in tail_meta_dst))
        t_inv = tail_dst_ell["inv_perm"].astype(np.int64)
        t_inv = np.where(t_inv >= n_tail_rows, np.int64(SENT), t_inv)
        hub_mask_rows = slot_of_row != SENT
        t_inv[hub_mask_rows] = n_tail_rows + slot_of_row[hub_mask_rows]
        t_inv = t_inv.astype(ID_DTYPE)

        # Compact tail edge endpoints (grad_e without full-E gathers).
        t_pad = max(-(-max(n_tail, 1) // CHUNK) * CHUNK, CHUNK)
        tail_src_c = np.full((t_pad,), SENT, dtype=ID_DTYPE)
        tail_dst_c = np.full((t_pad,), SENT, dtype=ID_DTYPE)
        tail_src_c[:n_tail] = t_src
        tail_dst_c[:n_tail] = t_dst
        tail_eid_c = np.zeros((t_pad,), dtype=ID_DTYPE)
        tail_eid_c[:n_tail] = t_eid
        edge_to_tslot = np.full((num_padded,), SENT, dtype=ID_DTYPE)
        edge_to_tslot[t_eid] = np.arange(n_tail, dtype=ID_DTYPE)

        def to_compact(eids):
            c = edge_to_tslot[np.clip(eids, 0, num_padded - 1)]
            return np.where(c == SENT, 0, c).astype(ID_DTYPE)

        return dict(
            meta_dst=tuple(tail_meta_dst), meta_src=tuple(tail_meta_src),
            n_rows=n_tail_rows,
            t_idx=tail_dst_ell["idx"], t_eid=tail_dst_ell["eid"],
            t_eid_c=to_compact(tail_dst_ell["eid"]),
            t_inv=t_inv,
            r_idx=tail_src_ell["idx"], r_eid=tail_src_ell["eid"],
            r_eid_c=to_compact(tail_src_ell["eid"]),
            r_inv=tail_src_ell["inv_perm"],
            tail_src=tail_src_c, tail_dst=tail_dst_c, tail_eid=tail_eid_c,
            edge_to_tslot=edge_to_tslot,
        )

    t_dst = dst_e[~is_hub]
    t_src = src_e[~is_hub]
    t_eid = eid_e[~is_hub]

    # Single self-loop tail edges become a node-level diagonal; nodes with
    # several self-loops keep them in the tail (exact multigraph sums).
    is_diag = t_src == t_dst
    dcnt = np.bincount(t_dst[is_diag], minlength=num_dst) if len(t_dst) \
        else np.zeros((num_dst,), np.int64)
    take = is_diag & (dcnt[t_dst] == 1)
    has_diag = bool(take.any())
    diag = np.zeros((num_dst,), np.float32)
    diag_eid = np.zeros((num_dst,), ID_DTYPE)
    diag_edge_dst = np.full((num_padded,), SENT, dtype=ID_DTYPE)
    if has_diag:
        diag[t_dst[take]] = 1.0
        diag_eid[t_dst[take]] = t_eid[take]
        diag_edge_dst[t_eid[take]] = t_dst[take].astype(ID_DTYPE)
        keep = ~take
        t_dst, t_src, t_eid = t_dst[keep], t_src[keep], t_eid[keep]
    full_tail = _build_tail(t_dst, t_src, t_eid)
    tail_meta_dst = list(full_tail["meta_dst"])
    tail_meta_src = list(full_tail["meta_src"])
    n_tail_rows = full_tail["n_rows"]

    # Expand descriptors for out[v] = merged[t_inv[v]]: packed
    # p = (v % EXPAND_RB) * EXPAND_PACK + merged_row, sorted by v, with
    # per-EXPAND_RB-block start offsets. Each v appears at most once.
    n_merge_rows = n_tail_rows + k_slots
    if n_merge_rows < EXPAND_PACK:
        ft_inv = full_tail["t_inv"]
        valid = np.flatnonzero(ft_inv != SENT).astype(np.int64)
        m_of_valid = ft_inv[valid].astype(np.int64)
        x_blocks = -(-num_dst // EXPAND_RB)
        x_starts = np.zeros((x_blocks + 1,), dtype=ID_DTYPE)
        np.cumsum(np.bincount((valid // EXPAND_RB).astype(np.int64),
                              minlength=x_blocks), out=x_starts[1:])
        x_desc = ((valid % EXPAND_RB) * EXPAND_PACK
                  + m_of_valid).astype(ID_DTYPE)
        x_desc = np.pad(x_desc, (0, -len(x_desc) % CHUNK))
        x_starts_p = np.pad(x_starts, (0, -len(x_starts) % CHUNK))
    else:  # packing would overflow; the engine uses the fill-gather
        x_desc = np.zeros((0,), dtype=ID_DTYPE)
        x_starts_p = np.zeros((0,), dtype=ID_DTYPE)

    # Fused-backward descriptors (src direction): grad_u's dense-tier
    # kernel adds the compact tail-src stack rows in its own output pass.
    # Packed p = (src_row % DENSE_RB) * EXPAND_PACK + stacked_row, sorted
    # by src row, per-DENSE_RB-block start offsets; each src row at most
    # once.
    n_src_rows_tail = int(sum(n for _, n in tail_meta_src))
    if 0 < n_src_rows_tail < EXPAND_PACK and kd:
        rv = full_tail["r_inv"].astype(np.int64)[:num_src]
        gvalid = np.flatnonzero(rv < n_src_rows_tail)
        gm = rv[gvalid]
        g_blocks = n_src_pad // DENSE_RB
        gb_starts = np.zeros((g_blocks + 1,), dtype=ID_DTYPE)
        np.cumsum(np.bincount((gvalid // DENSE_RB).astype(np.int64),
                              minlength=g_blocks), out=gb_starts[1:])
        gb_desc = ((gvalid % DENSE_RB) * EXPAND_PACK + gm).astype(ID_DTYPE)
        gb_desc = np.pad(gb_desc, (0, -len(gb_desc) % CHUNK))
        gb_starts = np.pad(gb_starts, (0, -len(gb_starts) % CHUNK))
    else:
        gb_desc = np.zeros((0,), dtype=ID_DTYPE)
        gb_starts = np.zeros((0,), dtype=ID_DTYPE)

    # Identity expand (hub_order relabel): destinations [0, k_slots) are
    # the hub slots in order and [k_slots, k_slots + n_tail_rows) the tail
    # stack in order.
    ft_inv = full_tail["t_inv"].astype(np.int64)
    n_merge = n_tail_rows + k_slots
    identity_expand = bool(
        n_merge <= num_dst
        and np.array_equal(
            ft_inv[:k_slots],
            n_tail_rows + np.arange(k_slots, dtype=np.int64))
        and np.array_equal(
            ft_inv[k_slots:n_merge],
            np.arange(n_tail_rows, dtype=np.int64))
        and (ft_inv[n_merge:] == SENT).all()
    )
    meta = HubMeta(
        n_full_f=len(full_fwd["in_id"]),
        n_full_b=len(full_bwd["in_id"]),
        n_part_f=len(part_fwd["in_id"]),
        n_part_b=len(part_bwd["in_id"]),
        n_win=int(n_win),
        n_groups=int(n_groups),
        n_dense=int(n_dense),
        tail_meta_dst=tuple(tail_meta_dst),
        tail_meta_src=tuple(tail_meta_src),
        n_tail_rows=n_tail_rows,
        covered=int(is_hub.sum()),
        has_diag=has_diag,
        identity_expand=identity_expand,
    )
    arrays = {
        "full_fwd": full_fwd,
        "full_bwd": full_bwd,
        "part_fwd": part_fwd,
        "part_bwd": part_bwd,
        "dense_c": dense_c,
        "hub_ids": hub_ids,
        "win_mask_full": win_mask_full,
        "win_mask_part": win_mask_part,
        "t_idx": full_tail["t_idx"], "t_eid": full_tail["t_eid"],
        "t_eid_c": full_tail["t_eid_c"],
        "t_inv": full_tail["t_inv"],
        "r_idx": full_tail["r_idx"], "r_eid": full_tail["r_eid"],
        "r_eid_c": full_tail["r_eid_c"],
        "r_inv": full_tail["r_inv"],
        "tail_src": full_tail["tail_src"], "tail_dst": full_tail["tail_dst"],
        "tail_eid": full_tail["tail_eid"],
        "edge_to_fslot": edge_to_fslot,
        "edge_to_tslot": full_tail["edge_to_tslot"],
        "diag": diag, "diag_eid": diag_eid,
        "diag_edge_dst": diag_edge_dst,
        "x_desc": x_desc, "x_starts": x_starts_p,
        "gb_desc": gb_desc, "gb_starts": gb_starts,
    }
    return meta, arrays
