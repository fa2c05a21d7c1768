"""Clustered block-dense adjacency layout ("bdense"), host side (numpy).

The port's copy of ``dgl1_tpu/bdense_format.py``. On graphs with locality
(meshes, road networks, kNN graphs, or any graph after
``reorder_graph(..., 'rcm')``) the adjacency concentrates in few
BLK x BLK blocks. Each block holding at least ``min_edges`` edges is
stored as a dense count matrix and the aggregation becomes
``out[rb] += A_block @ u[cb]`` (K11, ``ops/bdense_kernels.py``); the
backward walks the same blocks transposed. The other edges go to an ELL
tail in both directions, so coverage is exact.

The arrays and ``BDenseMeta`` equal those of the reference for the same
edges. One difference: the counts are float32 in numpy and become a
``torch.bfloat16`` tensor when their maximum is at most 256 (exact there;
numpy has no bf16), else stay float32, as ``hub_format.py`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["BLK", "BDenseMeta", "plan_blocks", "build_block_dense"]

BLK = 128  # block edge length


class BDenseMeta(NamedTuple):
    """Static descriptor of a block-dense layout (field for field the
    reference's)."""

    n_blocks: int          # dense blocks kept
    n_rb: int              # ceil(num_dst / BLK)
    n_cb: int              # ceil(num_src / BLK)
    tail_meta_dst: Tuple   # ELL meta for leftover edges, reduce-by-dst
    tail_meta_src: Tuple   # ELL meta for leftover edges, reduce-by-src
    covered: int           # edges on the dense tier
    max_row_blocks: int = 1  # max dense blocks in one rb row
    max_col_blocks: int = 1  # max dense blocks in one cb column


def _counts_tensor(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if a.max(initial=0.0) <= 256 else t


def plan_blocks(src: np.ndarray, dst: np.ndarray, num_src: int,
                num_dst: int, min_edges: Optional[int] = None):
    """Dense-tier planner. Returns ``(K, arrays, tail_eids)`` where
    ``arrays`` holds:

      a        (max(K,1)*BLK, BLK) bf16/f32 count blocks, rb-sorted;
               block k is rows [k*BLK, (k+1)*BLK), (dst, src) local ids
      ab       the same blocks in cb (backward-iteration) order
      rb, cb   (K,) int32 dst/src block ids (rb-sorted)
      first_f  (K,) 1 if first block of its rb run
      rbb, cbb (K,) rb/cb in backward order
      first_b  (K,) 1 if first block of its cb run
      rb_mask  (n_rb,) bool: dst block rows touched by the dense tier
      cb_mask  (n_cb,) bool: src block rows touched
      row_ptr  (n_rb+1,) int32: rb row r's blocks are a[row_ptr[r]:...]
      col_ptr  (n_cb+1,) int32: cb column c's blocks are ab[col_ptr[c]:...]

    and ``tail_eids`` indexes the edges NOT covered by the dense tier.
    ``min_edges`` defaults to BLK // 4.
    """
    if min_edges is None:
        min_edges = BLK // 4
    n_rb = max((num_dst + BLK - 1) // BLK, 1)
    n_cb = max((num_src + BLK - 1) // BLK, 1)
    rb_e = dst.astype(np.int64) // BLK
    cb_e = src.astype(np.int64) // BLK
    key = rb_e * n_cb + cb_e
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    inv = inv.reshape(-1)
    keep = counts >= min_edges
    dense_block_of_edge = keep[inv]
    kept_keys = uniq[keep]
    K = len(kept_keys)

    a = np.zeros((max(K, 1) * BLK, BLK), np.float32)
    if K:
        block_pos = np.full(len(uniq), -1, np.int64)
        block_pos[np.nonzero(keep)[0]] = np.arange(K)
        de = np.nonzero(dense_block_of_edge)[0]
        k_of_e = block_pos[inv[de]]
        lr = dst[de].astype(np.int64) % BLK
        lc = src[de].astype(np.int64) % BLK
        np.add.at(a, (k_of_e * BLK + lr, lc), 1.0)
    rb = (kept_keys // n_cb).astype(np.int32)
    cb = (kept_keys % n_cb).astype(np.int32)
    # kept_keys is sorted by key = rb-major: rb runs are contiguous.
    first_f = np.ones((max(K, 1),), np.int32)
    if K:
        first_f[1:] = (rb[1:] != rb[:-1]).astype(np.int32)
    perm_b = (np.argsort(cb, kind="stable").astype(np.int32)
              if K else np.zeros((1,), np.int32))
    rbb = rb[perm_b] if K else np.zeros((1,), np.int32)
    cbb = cb[perm_b] if K else np.zeros((1,), np.int32)
    first_b = np.ones((max(K, 1),), np.int32)
    if K:
        first_b[1:] = (cbb[1:] != cbb[:-1]).astype(np.int32)
    rb_mask = np.zeros((n_rb,), bool)
    cb_mask = np.zeros((n_cb,), bool)
    if K:
        rb_mask[rb] = True
        cb_mask[cb] = True
    row_ptr = np.searchsorted(rb[:K], np.arange(n_rb + 1)).astype(np.int32)
    col_ptr = np.searchsorted(cbb[:K], np.arange(n_cb + 1)).astype(np.int32)
    if K == 0:
        rb = np.zeros((1,), np.int32)
        cb = np.zeros((1,), np.int32)
    # Block k of `ab` is block perm_b[k] of `a`: both directions stream
    # their A operand in iteration order.
    ab = (a.reshape(K, BLK, BLK)[perm_b].reshape(-1, BLK) if K else a)
    arrays = {
        "a": _counts_tensor(a), "ab": _counts_tensor(ab),
        "rb": rb, "cb": cb, "first_f": first_f,
        "rbb": rbb, "cbb": cbb, "first_b": first_b,
        "rb_mask": rb_mask, "cb_mask": cb_mask,
        "row_ptr": row_ptr, "col_ptr": col_ptr,
    }
    return K, arrays, np.nonzero(~dense_block_of_edge)[0]


def build_block_dense(src: np.ndarray, dst: np.ndarray, num_src: int,
                      num_dst: int, build_ell,
                      min_edges: Optional[int] = None):
    """The full block-dense layout (dense tier + ELL tails) from the real
    edge list: :func:`plan_blocks`' arrays plus the ``t_*`` (reduce by
    dst) and ``r_*`` (reduce by src) ELL tails, whose edge ids index the
    tail list, and the tail's endpoints ``t_src``/``t_dst`` in tail-list
    order. ``build_ell`` is ``graph._build_ell``. Returns
    ``(BDenseMeta, arrays)``."""
    e = len(src)
    n_rb = max((num_dst + BLK - 1) // BLK, 1)
    n_cb = max((num_src + BLK - 1) // BLK, 1)
    K, arrays, te = plan_blocks(src, dst, num_src, num_dst, min_edges)

    t_src, t_dst = src[te], dst[te]
    n_tail = len(te)

    def ell_dir(tgt, other, n_tgt):
        order = np.argsort(tgt, kind="stable")
        indptr = np.zeros((n_tgt + 1,), np.int64)
        np.cumsum(np.bincount(tgt, minlength=n_tgt), out=indptr[1:])
        eid = np.arange(n_tail, dtype=np.int64)[order]
        return build_ell(indptr, other[order].astype(np.int32),
                         eid.astype(np.int32), n_tgt, n_tail)

    tail_meta_dst, tail_dst = ell_dir(t_dst, t_src, num_dst)
    tail_meta_src, tail_src = ell_dir(t_src, t_dst, num_src)

    meta = BDenseMeta(
        n_blocks=K, n_rb=n_rb, n_cb=n_cb,
        tail_meta_dst=tail_meta_dst, tail_meta_src=tail_meta_src,
        covered=int(e - n_tail),
        max_row_blocks=int(np.diff(arrays["row_ptr"]).max(initial=0)) or 1,
        max_col_blocks=int(np.diff(arrays["col_ptr"]).max(initial=0)) or 1,
    )
    arrays.update({
        "t_idx": tail_dst["idx"], "t_eid": tail_dst["eid"],
        "t_inv": tail_dst["inv_perm"],
        "r_idx": tail_src["idx"], "r_eid": tail_src["eid"],
        "r_inv": tail_src["inv_perm"],
        "t_src": t_src.astype(np.int32), "t_dst": t_dst.astype(np.int32),
    })
    return meta, arrays
