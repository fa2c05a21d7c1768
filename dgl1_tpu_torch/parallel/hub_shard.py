"""Per-partition hub layouts sharing one forced geometry.

The port's copy of ``dgl1_tpu/parallel/hub_shard.py``. Each partition's
local edge set (sources in the combined [owned | halo] space,
destinations in [owned | partial]) is a bipartite graph the hub planner
takes as it is. The reference traces one program for every device, so
every part's layout must have the same static geometry (group counts,
chunk counts, ELL bucket metas, descriptor lengths); the port keeps that
contract, so every rank runs the same shapes and launches. A two-pass
build gives it: pass 1 builds each part on its own and measures its
geometry, and the union of those is forced into pass 2
(``hub_format.build_hub_format``'s ``force``), which pads every part to
the shared shape with no-op chunks, SENT slots and empty ELL rows.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dgl1_tpu_torch import hub_format as hf

__all__ = ["build_partitioned_hub", "plan_identity_order",
           "trim_forced_chunks"]


def plan_identity_order(parts, num_dst: int, min_group_edges: int,
                        dense_floor: int):
    """Per-part hub-first local renumbering (identity expand at P > 1).

    At P = 1 a hub_order-relabeled graph keeps the identity (concat and
    pad) forward because its single part is naturally in merge order; at
    P > 1 the cross-part union geometry pads every part (empty hub
    slots, inflated ELL buckets), shifting stack positions — no global
    relabel can satisfy every part at once. This planner instead picks
    a PER-PART local numbering aligned with the FORCED layout: the hub
    in forced slot s gets local id s, the tail row at forced stack
    position t gets id ``NG*BLK + t``, phantom ids absorb the union's
    slot gaps (no real node maps to them), zero-degree rows go last.
    The engine's identity path then emits ``pad(concat([hub_block,
    stacked]))`` per part, phantom rows reading exact zeros (zero
    count-matrix columns, init-padded chunk blocks, SENT ELL rows).

    ``parts``: per part ``(ldst, selfloop_mask, cnt)`` — natural local
    dst ids of the REAL local edges, a same-length bool mask marking
    self-loop edges (the diag-extraction rule must be replicated), and
    the part's real owned-node count. ``min_group_edges`` /
    ``dense_floor`` must be CONCRETE (the caller resolves defaults
    once so this plan and the final larger-R build select identical
    hubs).

    Returns ``(relabels, n_merge, max_used)`` — per-part arrays with
    ``relabels[p][old_local_id] = new_local_id``, the forced merge-row
    count, and the max new-id bound across parts (the caller's new
    ``n_loc``) — or ``(None, 0, 0)`` when no part has a hub group.
    Pathological tie cases (a hub group crossing into zero-degree
    rows) may produce a plan the rebuild cannot reproduce; the
    post-build predicate in :func:`build_partitioned_hub` catches
    those and falls back to the non-identity layout.
    """
    from dgl1_tpu_torch.graph import _build_ell

    infos = []
    for ldst, selfloop, cnt in parts:
        ldst = np.asarray(ldst, np.int64)
        selfloop = np.asarray(selfloop, bool)
        deg = (np.bincount(ldst, minlength=num_dst).astype(np.int64)
               if len(ldst) else np.zeros((num_dst,), np.int64))
        order = np.argsort(-deg, kind="stable")
        gcounts = []
        ng = 0
        while ng < hf.MAX_GROUPS:
            rows = order[ng * hf.BLK: (ng + 1) * hf.BLK]
            if rows.size == 0:
                break
            ge = int(deg[rows].sum())
            if ge < min_group_edges:
                break
            gcounts.append(ge)
            ng += 1
        nd = 0
        while (nd < min(ng, hf.MAX_DENSE_GROUPS)
               and gcounts[nd] >= dense_floor):
            nd += 1
        is_hub = np.zeros((num_dst,), bool)
        is_hub[order[: ng * hf.BLK]] = True
        tmask = ~is_hub[ldst] if len(ldst) else np.zeros((0,), bool)
        td, tsl = ldst[tmask], selfloop[tmask]
        dcnt = (np.bincount(td[tsl], minlength=num_dst)
                if tsl.any() else np.zeros((num_dst,), np.int64))
        take = tsl & (dcnt[td] == 1) if len(td) else tsl
        td2 = td[~take]
        n_tail = int(len(td2))
        tail_min_slots = min(1 << 14, max(n_tail // 2, 1))
        tc = (np.bincount(td2, minlength=num_dst) if n_tail
              else np.zeros((num_dst,), np.int64))
        indptr = np.zeros((num_dst + 1,), np.int64)
        np.cumsum(tc, out=indptr[1:])
        # Only the bucket meta + row->stack-position map matter here;
        # neighbor/eid contents are irrelevant to the plan.
        meta, ell = _build_ell(
            indptr, np.zeros((n_tail,), np.int64),
            np.zeros((n_tail,), np.int64), num_dst, n_tail,
            min_slots=tail_min_slots)
        infos.append(dict(order=order, ng=ng, nd=nd, meta=meta,
                          inv=np.asarray(ell["inv_perm"], np.int64),
                          cnt=int(cnt)))

    nd_u = max(i["nd"] for i in infos)
    nc_u = max(i["ng"] - i["nd"] for i in infos)
    ng_u = nd_u + nc_u
    if ng_u == 0:
        return None, 0, 0
    fmeta = hf.union_ell_meta([i["meta"] for i in infos])
    n_tail_f = int(sum(n for _, n in fmeta))
    n_merge = ng_u * hf.BLK + n_tail_f

    relabels = []
    max_used = n_merge
    for i in infos:
        cnt = i["cnt"]
        new = np.full((cnt,), -1, np.int64)
        sel = i["order"][: i["ng"] * hf.BLK]
        slots = np.arange(len(sel), dtype=np.int64)
        slots[i["nd"] * hf.BLK:] += (nd_u - i["nd"]) * hf.BLK
        real = sel < cnt
        new[sel[real]] = slots[real]
        pos = hf.ell_pos_map(i["meta"], fmeta)
        n_tail_nat = pos.shape[0]
        inv = i["inv"][:cnt]
        isrow = (new == -1) & (inv >= 0) & (inv < n_tail_nat)
        vv = np.flatnonzero(isrow)
        new[vv] = ng_u * hf.BLK + pos[inv[vv]]
        rest = np.flatnonzero(new == -1)
        new[rest] = n_merge + np.arange(len(rest), dtype=np.int64)
        relabels.append(new)
        max_used = max(max_used, n_merge + len(rest))
    return relabels, n_merge, max_used


def _identity_ok(meta: hf.HubMeta, arrays: dict, num_dst: int) -> bool:
    """Phantom-identity predicate on one part's FORCED layout: every
    local dst id either sits exactly at its merge-order position (hub
    slot v -> merged row n_tail+v; id NG*BLK+t -> stacked row t) or is
    a phantom/zero-degree row (SENT). When this holds for every part,
    the engine's fused-pad identity forward is exact — phantom rows
    read zeros from the zeroed count-matrix columns, the init-padded
    chunk blocks and the SENT ELL gathers."""
    k_slots = meta.n_groups * hf.BLK
    nt = meta.n_tail_rows
    n_merge = k_slots + nt
    if n_merge > num_dst:
        return False
    ti = np.asarray(arrays["t_inv"], np.int64)[:num_dst]
    sent = ti >= hf.SENT
    v = np.arange(num_dst, dtype=np.int64)
    ok_hub = bool(np.all(sent[:k_slots]
                         | (ti[:k_slots] == nt + v[:k_slots])))
    ok_tail = bool(np.all(
        sent[k_slots:n_merge]
        | (ti[k_slots:n_merge] == v[k_slots:n_merge] - k_slots)))
    ok_rest = bool(np.all(sent[n_merge:]))
    return ok_hub and ok_tail and ok_rest

_DT_RANK = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _widest_dtype(dtypes):
    """The widest count dtype of the parts (int8 < bfloat16 < float32)."""
    best = torch.int8
    for dt in dtypes:
        if _DT_RANK.get(dt, 2) > _DT_RANK[best]:
            best = dt if dt in _DT_RANK else torch.float32
    return best


def _stack_tree(dicts: List[dict]):
    """Stack structurally identical (nested) dicts of numpy arrays (and
    the count matrix tensor) on a leading P axis.

    Zero-size leaves (an empty tail or descriptor array when every local
    edge is hub-covered) are padded to a small nonzero size first, as
    the reference does (its sharded layouts cannot hold a 0-size array);
    the engines key nothing on these paddings."""
    out = {}
    for k in dicts[0]:
        vals = [d[k] for d in dicts]
        if isinstance(vals[0], dict):
            out[k] = _stack_tree(vals)
            continue
        shapes = {tuple(v.shape) for v in vals}
        if len(shapes) != 1:
            raise ValueError(
                f"hub layout field {k!r} has non-uniform shapes "
                f"{shapes} across parts (geometry unification bug)")
        torch_leaf = isinstance(vals[0], torch.Tensor)
        if (vals[0].numel() if torch_leaf else vals[0].size) == 0:
            shp = tuple(vals[0].shape)
            new_shp = tuple(max(s, hf.CHUNK if len(shp) == 1 else 8)
                            for s in shp)
            vals = [torch.zeros(new_shp, dtype=v.dtype) if torch_leaf
                    else np.zeros(new_shp, v.dtype) for v in vals]
        out[k] = torch.stack(vals) if torch_leaf else np.stack(vals)
    return out


def build_partitioned_hub(
    edges_per_part: List[Tuple[np.ndarray, np.ndarray]],
    num_src: int,
    num_dst: int,
    num_padded: int,
    min_group_edges: Optional[int] = None,
    dense_floor: Optional[int] = None,
    identity: bool = False,
    identity_pinned: Optional[dict] = None,
) -> Tuple[Optional[hf.HubMeta], Optional[dict]]:
    """Build per-part hub layouts sharing ONE static geometry.

    ``edges_per_part``: per part, (esrc, ldst) int arrays of the REAL
    local edges — esrc in the combined [owned | halo] source space
    (``num_src`` ids), ldst in the output [owned | partial] space
    (``num_dst`` ids). ``num_padded``: the static per-part edge-slot
    count (``e_loc``) the edge-indexed descriptor arrays are sized to.

    Returns (meta, stacked) where ``stacked`` holds every layout array
    with a leading P axis, or (None, None) when no part's local degree
    distribution clears the hub bar (the caller falls back to tiles or
    block-dense).
    """
    from dgl1_tpu_torch.graph import _build_ell

    csc = []
    naturals = []
    for esrc, ldst in edges_per_part:
        esrc = np.asarray(esrc, np.int64)
        ldst = np.asarray(ldst, np.int64)
        order = np.argsort(ldst, kind="stable")
        s, d = esrc[order], ldst[order]
        eid = order.astype(np.int64)
        cnt = (np.bincount(d, minlength=num_dst) if len(d)
               else np.zeros((num_dst,), np.int64))
        indptr = np.zeros((num_dst + 1,), np.int64)
        np.cumsum(cnt, out=indptr[1:])
        csc.append((indptr, s, eid, d))
        m, a = hf.build_hub_format(
            indptr, s, eid, d, num_src, num_dst, len(s), num_padded,
            _build_ell, min_group_edges=min_group_edges,
            dense_floor=dense_floor, allow_empty=True, gb_always=True,
            identity_force=identity_pinned)
        naturals.append((m, a))

    if all(m.n_groups == 0 for m, _ in naturals):
        return None, None

    # Group geometry: dense groups occupy slots [0, ND*BLK), chunked
    # groups [ND*BLK, NG*BLK) — so NG must hold the widest CHUNKED span
    # on top of the widest dense span (a part with 1 chunked + 0 dense
    # groups and a part with 0 chunked + 1 dense need NG=2, ND=1).
    nd = max(m.n_dense for m, _ in naturals)
    nc = max(m.n_groups - m.n_dense for m, _ in naturals)
    force = {
        "n_groups": nd + nc,
        "n_dense": nd,
        "n_full_f": max(m.n_full_f for m, _ in naturals),
        "n_full_b": max(m.n_full_b for m, _ in naturals),
        "n_part_f": max(m.n_part_f for m, _ in naturals),
        "n_part_b": max(m.n_part_b for m, _ in naturals),
        "tail_meta_dst": hf.union_ell_meta(
            [m.tail_meta_dst for m, _ in naturals]),
        "tail_meta_src": hf.union_ell_meta(
            [m.tail_meta_src for m, _ in naturals]),
        "t_pad": max(a["tail_src"].shape[0] for _, a in naturals),
        "x_desc_len": max(a["x_desc"].shape[0] for _, a in naturals),
        "gb_desc_len": max(a["gb_desc"].shape[0] for _, a in naturals),
        "dense_dtype": _widest_dtype(
            [a["dense_c"].dtype for m, a in naturals if m.n_dense > 0]),
        "has_diag": any(m.has_diag for m, _ in naturals),
        "covered": sum(m.covered for m, _ in naturals),
    }
    if identity or identity_pinned is not None:
        # Identity-relabel mode (P > 1): the caller renumbered each
        # part's local dst space against THIS forced geometry
        # (:func:`plan_identity_order`) — or pinned it a priori
        # (``identity_pinned``, the typed sharded path: hub slots =
        # local ids [0, NG*BLK), tail stack in id order, shared across
        # relations AND parts). The fused-pad forward copies the whole
        # hub block, so every chunk-tier output block must be
        # initialized — extra no-op chunks (worst case one per group)
        # write zeros into blocks no real chunk touches.
        force["n_full_f"] += force["n_groups"]
        force["n_part_f"] += force["n_groups"] - force["n_dense"]
        force["init_fwd_blocks"] = True
        force["identity_expand"] = False  # decided post-build (below)
    else:
        # Identity expand survives sharding without a relabel only
        # when EVERY part's natural layout is already in merge order
        # AND the forced union changes no part's geometry (padding
        # shifts stack positions) — true at P = 1 on a
        # hub_order-relabeled graph, which then keeps the single-device
        # identity forward.
        geom_keys = ("n_groups", "n_dense", "n_full_f", "n_full_b",
                     "n_part_f", "n_part_b", "tail_meta_dst",
                     "tail_meta_src", "n_tail_rows")
        uniform = all(
            getattr(m, k) == getattr(naturals[0][0], k)
            for m, _ in naturals for k in geom_keys)
        force["identity_expand"] = (
            uniform and all(m.identity_expand for m, _ in naturals))

    metas, arrays = [], []
    for (indptr, s, eid, d), _ in zip(csc, naturals):
        m, a = hf.build_hub_format(
            indptr, s, eid, d, num_src, num_dst, len(s), num_padded,
            _build_ell, min_group_edges=min_group_edges,
            dense_floor=dense_floor, force=force,
            identity_force=identity_pinned)
        metas.append(m)
        arrays.append(a)
    if any(m != metas[0] for m in metas[1:]):
        raise AssertionError(
            "forced hub metas diverged across parts: "
            + "; ".join(repr(m) for m in metas))
    meta0 = metas[0]
    if identity or identity_pinned is not None:
        # Verify the phantom-identity predicate on every part's forced
        # layout; a pathological plan (hub-group tie crossing into
        # zero-degree rows) fails it and the layout safely keeps the
        # descriptor/gather expand instead.
        ok = all(_identity_ok(meta0, a, num_dst) for a in arrays)
        meta0 = meta0._replace(identity_expand=bool(ok))
    return meta0, _stack_tree(arrays)


_CHUNK_KEYS = ("full_fwd", "full_bwd", "part_fwd", "part_bwd")


def trim_forced_chunks(meta: hf.HubMeta, arrays: dict) -> dict:
    """One part's layout without the no-op chunks the forced geometry
    appended to its chunk layouts (all slots empty, after every real
    chunk). The reference pads them so every device traces one program;
    one process a partition needs no common shape, and the port's chunk
    kernels (K2, K6, K7) take a layout whose chunks are sorted by output
    block, which the appended chunks (aimed at block 0, or at blocks no
    real chunk starts, for the reference's uninitialised outputs) break.
    Every output they would touch is zero without them: the kernels
    write zeros where no chunk lands. A chunked-tier layout of a geometry
    without chunked groups is left as it is (the engines do not read
    it)."""
    out = dict(arrays)
    for key in _CHUNK_KEYS:
        if key.startswith("part") and meta.n_groups == meta.n_dense:
            continue
        lay = arrays[key]
        n_chunks = lay["in_id"].shape[0]
        if n_chunks == 0:
            continue
        a = np.asarray(lay["a"]).reshape(n_chunks, -1)
        real = np.flatnonzero((a >= 0).any(axis=1))
        keep = int(real[-1]) + 1 if len(real) else 0
        if keep == n_chunks:
            continue
        chunk = a.shape[1]
        new = dict(lay)
        for k in ("a", "b", "eid"):
            new[k] = lay[k][: keep * chunk]
        for k in ("in_id", "out_id", "first", "gperm", "gout", "gfirst"):
            if k in lay:
                new[k] = lay[k][:keep]
        out[key] = new
    return out
