"""Hub-dense HYB layout builder (host side, numpy).

The port's copy of ``dgl1_tpu/hub_format.py``: the single-device build,
the typed identity mode (``identity_force``) and the forced cross-part
geometry of the distributed layer (``force``, ``allow_empty``,
``gb_always``; ``parallel/hub_shard.py``). It splits a graph's edges by
destination in-degree into three tiers for ``ops/engine_hub.py``:

* **dense**: groups of BLK hub rows whose edge count clears
  ``dense_floor`` (about num_src/2), stored as a static count matrix ``C``
  of shape (rows_pad, BLK * n_dense), so the whole reduce is ``C^T @ U``;
* **chunked**: the remaining hub groups, with edges sorted by (group,
  source window) and cut into CHUNK-slot chunks of slot-local ids;
* **ELL tail**: every other edge, on the degree-bucketed ELL layout.

The arrays and ``HubMeta`` equal those of ``dgl1_tpu/hub_format.py``
for the same edges. One difference: ``dense_c`` is a torch tensor and
counts in 128..256 are kept as float32 in numpy and cast to
``torch.bfloat16`` when the tensor is made (numpy has no bf16); a forced
``dense_dtype`` is a torch dtype.
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


def _ell_bucket(indptr, nbr_sorted, eid_sorted, rows, n_b: int, k: int):
    """One ELL bucket of ``n_b`` rows of ``k`` slots, flattened: its first
    ``len(rows)`` rows hold the edges of ``rows`` (their neighbour and
    edge id, in sorted order), every other slot the sentinel ``1 << 30``
    and edge id 0."""
    deg = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    mat = np.full((n_b, k), np.int64(1 << 30), dtype=np.int64)
    emat = np.zeros((n_b, k), dtype=np.int64)
    total = int(deg.sum())
    if total:
        flat_rows = np.repeat(np.arange(len(rows)), deg)
        flat_cols = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
        src_pos = np.repeat(indptr[rows].astype(np.int64), deg) + flat_cols
        mat[flat_rows, flat_cols] = nbr_sorted[src_pos]
        emat[flat_rows, flat_cols] = eid_sorted[src_pos]
    return mat.reshape(-1), emat.reshape(-1)


def _build_ell_fixed_rows(indptr: np.ndarray, nbr_sorted: np.ndarray,
                          eid_sorted: np.ndarray, meta_fixed,
                          row_base: int, num_target: int):
    """ELL stack with its rows pinned to id order: bucket b of
    ``meta_fixed`` ((k, n), ...) holds rows ``[row_base + off, row_base +
    off + n)`` in id order, so a covered row's stack position is ``id -
    row_base`` whatever this edge set's own degrees are. Rows of degree 0
    here are all-sentinel phantom rows. Per-relation tail stacks built
    on one superset meta share one merge order (the typed identity
    layouts of ``transform.typed_subgraphs(identity=True)``). Raises
    ValueError when a row's degree exceeds its bucket width. Returns
    (meta, arrays) like ``graph._build_ell``."""
    n_rows = int(sum(n for _, n in meta_fixed))
    deg = np.diff(indptr[: num_target + 1]).astype(np.int64)
    idx_parts, eid_parts = [], []
    off = 0
    for k, n_b in meta_fixed:
        rows = np.arange(row_base + off, row_base + off + n_b,
                         dtype=np.int64)
        rows = rows[rows < num_target]
        if int(deg[rows].max(initial=0)) > k:
            raise ValueError(
                f"fixed-row ELL: degree {int(deg[rows].max())} exceeds "
                f"bucket width {k}")
        idx_b, eid_b = _ell_bucket(indptr, nbr_sorted, eid_sorted, rows,
                                   n_b, k)
        idx_parts.append(idx_b)
        eid_parts.append(eid_b)
        off += n_b
    inv_perm = np.full((num_target,), n_rows, dtype=ID_DTYPE)
    covered = np.arange(row_base, min(row_base + n_rows, num_target),
                        dtype=np.int64)
    inv_perm[covered] = (covered - row_base).astype(ID_DTYPE)
    idx = (np.concatenate(idx_parts) if idx_parts
           else np.zeros(0, np.int64))
    eid = (np.concatenate(eid_parts) if eid_parts
           else np.zeros(0, np.int64))
    return tuple(meta_fixed), {
        "idx": idx.astype(ID_DTYPE),
        "eid": eid.astype(ID_DTYPE),
        "inv_perm": inv_perm,
    }


def _inflate_ell(meta, arrays, forced_meta):
    """Pad an ELL layout to a forced bucket structure (the cross-part
    geometry of the partitioned hub layouts): in each forced bucket (k,
    N_k) the part's own rows at rung k come first, then empty rows (idx =
    SENT). ``inv_perm`` is remapped to the inflated positions; rows past
    the natural stack (zero degree) map to the inflated total."""
    forced_meta = tuple(forced_meta)
    if tuple(meta) == forced_meta:
        return tuple(meta), arrays
    nat = {int(k): int(n) for k, n in meta}
    forced = {int(k): int(n) for k, n in forced_meta}
    for k, n in nat.items():
        if forced.get(k, 0) < n:
            raise ValueError(
                f"forced ELL meta {forced_meta} cannot hold natural "
                f"bucket ({k}, {n})")
    old_total = sum(n for _, n in meta)
    new_total = sum(n for _, n in forced_meta)
    idx_parts, eid_parts = [], []
    # Old stacked row -> new stacked row; buckets differ in width, so the
    # flat slot offsets are cumulative n_l * k_l.
    pos_map = np.full((old_total + 1,), new_total, dtype=np.int64)
    old_row_start, old_flat_start = {}, {}
    rs = fs = 0
    for k, n in meta:
        old_row_start[int(k)] = rs
        old_flat_start[int(k)] = fs
        rs += n
        fs += n * int(k)
    new_s = 0
    for k, n_forced in forced_meta:
        k = int(k)
        n_nat = nat.get(k, 0)
        if n_nat:
            ofs = old_flat_start[k]
            ors = old_row_start[k]
            idx_parts.append(arrays["idx"][ofs: ofs + n_nat * k])
            eid_parts.append(arrays["eid"][ofs: ofs + n_nat * k])
            pos_map[ors: ors + n_nat] = new_s + np.arange(n_nat)
        pad_rows = n_forced - n_nat
        if pad_rows:
            idx_parts.append(np.full((pad_rows * k,), SENT, ID_DTYPE))
            eid_parts.append(np.zeros((pad_rows * k,), ID_DTYPE))
        new_s += n_forced
    inv = np.minimum(arrays["inv_perm"].astype(np.int64), old_total)
    out = dict(arrays)
    out["idx"] = (np.concatenate(idx_parts) if idx_parts
                  else np.zeros((0,), ID_DTYPE))
    out["eid"] = (np.concatenate(eid_parts) if eid_parts
                  else np.zeros((0,), ID_DTYPE))
    out["inv_perm"] = pos_map[inv].astype(ID_DTYPE)
    return forced_meta, out


def union_ell_meta(metas):
    """Smallest common forced bucket structure: per rung k, the most rows
    any part has at exactly k (rows only pad wider, never move rungs)."""
    ks = sorted({int(k) for m in metas for k, _ in m})
    return tuple(
        (k, max((int(n) for m in metas for kk, n in m if int(kk) == k),
                default=0))
        for k in ks)


def ell_pos_map(meta_nat, meta_forced) -> np.ndarray:
    """Natural stacked row -> forced (inflated) stacked row, by the rule
    of :func:`_inflate_ell`; the identity-relabel planner
    (``parallel/hub_shard.plan_identity_order``) assigns local ids with
    it."""
    nat = {int(k): int(n) for k, n in meta_nat}
    old_total = sum(int(n) for _, n in meta_nat)
    pos_map = np.full((old_total,), -1, dtype=np.int64)
    old_start = {}
    rs = 0
    for k, n in meta_nat:
        old_start[int(k)] = rs
        rs += int(n)
    new_s = 0
    for k, n_forced in meta_forced:
        k = int(k)
        n_nat = nat.get(k, 0)
        if n_nat:
            ors = old_start[k]
            pos_map[ors: ors + n_nat] = new_s + np.arange(n_nat)
        new_s += int(n_forced)
    return pos_map


def _pad_chunk_layout(lay, target: int, bwd: bool, init_blocks: int = 0):
    """Pad a chunk layout to ``target`` chunks with no-op chunks (empty
    slots; first=0, out_id=0: they add nothing to block 0). With
    ``init_blocks=n`` the no-op chunks are aimed (first=1) at the output
    blocks in [0, n) that no real chunk starts, so the identity layouts,
    whose forward copies the whole hub block, find every block written
    (an all-empty chunk writes zeros)."""
    n = lay["in_id"].shape[0]
    if n > target:
        raise ValueError(f"chunk count {n} exceeds forced target {target}")
    if n == target and not init_blocks:
        return lay
    pad = target - n
    out = dict(lay)
    for k, fill in (("a", -1), ("b", -1), ("eid", 0)):
        out[k] = np.concatenate(
            [lay[k], np.full((pad * CHUNK,), fill, ID_DTYPE)])
    for k in ("in_id", "out_id", "first"):
        out[k] = np.concatenate([lay[k], np.zeros((pad,), ID_DTYPE)])
    if init_blocks:
        have = set(lay["out_id"][lay["first"] == 1].tolist())
        missing = [g for g in range(int(init_blocks)) if g not in have]
        if len(missing) > pad:
            raise ValueError(
                f"{len(missing)} uninitialized output blocks but only "
                f"{pad} padded chunks (raise the forced chunk target)")
        if missing:
            out["out_id"][n: n + len(missing)] = np.asarray(
                missing, ID_DTYPE)
            out["first"][n: n + len(missing)] = 1
    if bwd and "gperm" in lay:
        out["gperm"] = np.concatenate(
            [lay["gperm"], np.arange(n, target, dtype=ID_DTYPE)])
        out["gout"] = np.concatenate(
            [lay["gout"], np.zeros((pad,), ID_DTYPE)])
        out["gfirst"] = np.concatenate(
            [lay["gfirst"], np.zeros((pad,), ID_DTYPE)])
    return out


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


def _dense_counts(h_src, h_slot, num_src: int, n_src_pad: int, kd: int,
                  dtype=None):
    """Dense-tier count matrix ``C[s, k]`` = multiplicity of edge s -> hub
    slot k, as a torch tensor: ``dtype`` when given (a forced geometry),
    else int8 for counts <= 127, bf16 up to 256 (exact there), float32
    beyond."""
    if not kd:
        return torch.zeros((n_src_pad, 0),
                           dtype=torch.float32 if dtype is None else dtype)
    flat = h_src * kd + h_slot
    dense_c = np.zeros((n_src_pad, kd), dtype=np.float32)
    dense_c[:num_src] = np.bincount(
        flat, minlength=num_src * kd).astype(np.float32).reshape(num_src, kd)
    if dtype is not None:
        return torch.from_numpy(dense_c).to(dtype)
    cmax = dense_c.max(initial=0.0)
    if cmax <= 127:
        return torch.from_numpy(dense_c.astype(np.int8))
    t = torch.from_numpy(dense_c)
    return t.to(torch.bfloat16) if cmax <= 256 else t


def build_hub_format(csc_indptr: np.ndarray, csc_src: np.ndarray,
                     csc_eid: np.ndarray, csc_dst: np.ndarray,
                     num_src: int, num_dst: int, num_edges: int,
                     num_padded: int, build_ell,
                     min_group_edges: Optional[int] = None,
                     dense_floor: Optional[int] = None,
                     force: Optional[dict] = None,
                     allow_empty: bool = False,
                     gb_always: bool = False,
                     identity_force: Optional[dict] = None):
    """Build the three-tier hub layout (the reference's signature and
    argument order). Returns (HubMeta, arrays) or (None, None) when no
    hub group clears the density bar (the engine then declines and
    dispatch falls through to ELL). The csc arrays are dst-sorted; entries
    past ``num_edges`` are ignored. ``build_ell`` is ``graph._build_ell``,
    reused for the tail in both directions. The per-edge maps
    (``edge_to_fslot``, ``edge_to_tslot``, ``diag_edge_dst``) cover
    ``num_padded`` edges, the padded ones holding the sentinel.

    ``force`` pins the static geometry to the cross-part union of the
    partitioned hub layouts (``parallel/hub_shard.py``): ``n_groups`` /
    ``n_dense`` (this part's dense groups keep slots [0, own_nd*128), its
    chunked groups move up to start at n_dense*128, SENT slots between),
    ``tail_meta_dst`` / ``tail_meta_src`` (buckets inflated by
    :func:`_inflate_ell`), ``n_full_f`` / ``n_full_b`` / ``n_part_f`` /
    ``n_part_b`` (no-op chunks), ``t_pad``, ``x_desc_len``,
    ``gb_desc_len``, ``dense_dtype`` (a torch dtype), ``has_diag``,
    ``covered``, ``identity_expand`` and optionally ``init_fwd_blocks``.
    ``allow_empty`` builds an all-tail layout instead of returning None
    (a part with no hub of its own). ``gb_always`` builds the fused
    backward's descriptors without a dense tier (the measuring pass).

    ``identity_force`` (keys ``n_groups``, ``n_dense``,
    ``tail_meta_dst``), the typed identity mode: hub slots are pinned to
    ids ``[0, n_groups*128)`` and the dst tail stack to the following ids
    in id order under the caller's bucket meta
    (:func:`_build_ell_fixed_rows`), whatever this edge set's own degrees
    are. Every relation built on one superset graph's geometry then
    shares its merge order, the node order, and claims
    ``identity_expand``; slots and rows this edge set does not touch read
    zeros (empty count columns, all-sentinel ELL rows). A tail edge to a
    row past the pinned range raises ValueError."""
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
        NG, ND = n_groups, n_dense
        k_slots = n_groups * BLK
        rows_all = np.arange(min(k_slots, num_dst), dtype=np.int64)
        rows_d = rows_all[: n_dense * BLK]
        rows_c = rows_all[n_dense * BLK:]
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
        if n_groups == 0 and not (allow_empty or force is not None):
            return None, None
        n_dense = 0
        while (n_dense < min(n_groups, MAX_DENSE_GROUPS)
               and group_edge_counts[n_dense] >= dense_floor):
            n_dense += 1
        # The static geometry: this part's own counts or the forced union.
        own_nd, own_ng = n_dense, n_groups
        if force is not None:
            NG, ND = int(force["n_groups"]), int(force["n_dense"])
            if own_nd > ND or own_ng - own_nd > NG - ND:
                raise ValueError(
                    "forced group geometry smaller than natural")
        else:
            NG, ND = own_ng, own_nd
        n_groups, n_dense = NG, ND
        k_slots = NG * BLK
        rows_all = order_by_deg[: own_ng * BLK]
        rows_d = rows_all[: own_nd * BLK]
        rows_c = rows_all[own_nd * BLK:]
    hub_ids = np.full((k_slots,), SENT, dtype=ID_DTYPE)
    hub_ids[: rows_d.size] = rows_d
    hub_ids[ND * BLK: ND * BLK + rows_c.size] = rows_c
    slot_of_row = np.full((num_dst,), SENT, dtype=ID_DTYPE)
    slot_of_row[rows_d] = np.arange(rows_d.size, dtype=ID_DTYPE)
    slot_of_row[rows_c] = ND * BLK + np.arange(rows_c.size, dtype=ID_DTYPE)

    # Split edges: hub set (dense/chunked) vs tail (ELL).
    dst_e = csc_dst[:num_edges]
    src_e = csc_src[:num_edges]
    eid_e = csc_eid[:num_edges]
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
    if force is not None:
        init = bool(force.get("init_fwd_blocks", False))
        full_fwd = _pad_chunk_layout(full_fwd, force["n_full_f"], False,
                                     init_blocks=NG if init else 0)
        full_bwd = _pad_chunk_layout(full_bwd, force["n_full_b"], True)
        part_fwd = _pad_chunk_layout(part_fwd, force["n_part_f"], False,
                                     init_blocks=(NG - ND) if init else 0)
        part_bwd = _pad_chunk_layout(part_bwd, force["n_part_b"], True)

    # Rows padded to DENSE_RB: padding rows are zero and contribute nothing.
    kd = n_dense * BLK
    n_src_pad = -(-max(num_src, 1) // DENSE_RB) * DENSE_RB
    dense_c = _dense_counts(
        h_src[~in_part], h_slot[~in_part], num_src, n_src_pad, kd,
        None if force is None else force.get("dense_dtype"))

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
            tail_meta_dst, tail_dst_ell = _build_ell_fixed_rows(
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
        if force is not None:
            if identity_force is None:
                # Pinned dst stacks are uniform across parts already;
                # inflating would move their id-order positions.
                tail_meta_dst, tail_dst_ell = _inflate_ell(
                    tail_meta_dst, tail_dst_ell, force["tail_meta_dst"])
            tail_meta_src, tail_src_ell = _inflate_ell(
                tail_meta_src, tail_src_ell, force["tail_meta_src"])

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
        if force is not None:
            if force["t_pad"] < t_pad:
                raise ValueError("forced t_pad smaller than natural")
            t_pad = force["t_pad"]
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
    if force is not None and n_merge_rows < EXPAND_PACK:
        if force["x_desc_len"] < len(x_desc):
            raise ValueError("forced x_desc_len smaller than natural")
        # Entries past the final x_starts value are never read.
        x_desc = np.pad(x_desc, (0, force["x_desc_len"] - len(x_desc)))

    # Fused-backward descriptors (src direction): grad_u's dense-tier
    # kernel adds the compact tail-src stack rows in its own output pass.
    # Packed p = (src_row % DENSE_RB) * EXPAND_PACK + stacked_row, sorted
    # by src row, per-DENSE_RB-block start offsets; each src row at most
    # once.
    n_src_rows_tail = int(sum(n for _, n in tail_meta_src))
    if 0 < n_src_rows_tail < EXPAND_PACK and (kd or gb_always):
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
    if force is not None and len(gb_starts):
        if force["gb_desc_len"] < len(gb_desc):
            raise ValueError("forced gb_desc_len smaller than natural")
        gb_desc = np.pad(gb_desc, (0, force["gb_desc_len"] - len(gb_desc)))
    if force is not None:
        has_diag = bool(force.get("has_diag", has_diag))

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
    if force is not None:
        # The meta is one for every part: the forced value.
        identity_expand = bool(force.get("identity_expand", False))
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
        covered=(int(force["covered"]) if force is not None
                 else int(is_hub.sum())),
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
