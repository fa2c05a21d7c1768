"""Fused native sampling: neighbor sample + relabel in one C++ pass (the
port's ``dgl1_tpu/sampling/fused.py``).

One native call (``_native`` ``sample_block``) emits the sampled edges
already relabeled and dst-major; the static-shape padded block (COO, CSC,
CSR, a uniform dst-ELL and both tile directions padded to a static tile
count) is assembled from them with no sort. Given the same
``np.random.Generator`` the block is bit-identical to the reference's.
The parent graph stays on the host: the sampler reads its CSC with numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch import _native
from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import (ID_DTYPE, Graph, _build_ell_uniform,
                                  _build_tiles, _pad_tiles,
                                  static_tile_bound)

__all__ = ["sample_block_fused", "supports_fused"]


def supports_fused(g, fanout: int, prob, replace: bool) -> bool:
    if _native.lib() is None:
        return False
    if prob is not None or replace or fanout <= 0 or fanout > 4096:
        return False
    return not g.is_block


def _host(x) -> np.ndarray:
    return np.ascontiguousarray(x.numpy(), ID_DTYPE)


def sample_block_fused(g: Graph, seeds: np.ndarray, num_real_dst: int,
                       fanout: int, pad_src_to: int, pad_edges_to: int,
                       rng: Optional[np.random.Generator] = None) -> Graph:
    """Sample ``fanout`` in-edges per real seed and return the padded
    bipartite block on the CPU (dst nodes first on the src side).

    ``seeds`` may carry a padding tail: only the first ``num_real_dst``
    are sampled. The block carries ``meta['num_real_src'/'num_real_dst']``,
    parent node ids in ``srcdata['_ID']`` / ``dstdata['_ID']`` and parent
    edge ids (zero past the real edges) in ``edata['_ID']``; padded edges
    hold the sentinel source ``pad_src_to`` and dst ``len(seeds)``.
    """
    if g.device.type != "cpu":
        raise ValueError("the sampling parent must live on the host: build "
                         "it with device='cpu'")
    native = _native.lib()
    if native is None:
        raise NotImplementedError(
            "the fused sampler needs the native library, which could not "
            "be built; the numpy sampler is not ported yet")
    rng = rng or dgl_random.default_rng()
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    P = len(seeds)

    cap_e = int(pad_edges_to)
    cap_s = int(pad_src_to)
    out_deg = np.zeros((P,), ID_DTYPE)
    lsrc = np.full((cap_e,), cap_s, dtype=ID_DTYPE)  # sentinel = num_src
    peid = np.zeros((cap_e,), ID_DTYPE)
    src_ids = np.zeros((cap_s,), np.int64)
    counts = np.zeros((2,), np.int64)
    seed64 = np.uint64(rng.integers(0, np.iinfo(np.uint64).max,
                                    dtype=np.uint64))
    rc = native.sample_block(
        _host(g.csc_indptr), _host(g.csc_src), _host(g.csc_eid), 1, seeds,
        P, int(num_real_dst), int(fanout), seed64, cap_e, cap_s, out_deg,
        lsrc, peid, src_ids, counts)
    if rc != 0:
        raise ValueError(
            f"sample_block capacity overflow (pad_src_to={pad_src_to}, "
            f"pad_edges_to={pad_edges_to}, fanout={fanout})")
    n_edges = int(counts[0])
    n_src = int(counts[1])

    # User edge order := dst-major sampled order, so COO == CSC and
    # csc_eid is the identity on the real prefix.
    csc_indptr = np.zeros((P + 1,), ID_DTYPE)
    np.cumsum(out_deg, out=csc_indptr[1:])
    csc_eid = np.arange(cap_e, dtype=ID_DTYPE)
    csc_eid[n_edges:] = 0
    csc_dst = np.full((cap_e,), P, dtype=ID_DTYPE)
    csc_dst[:n_edges] = np.repeat(np.arange(P, dtype=ID_DTYPE), out_deg)
    mask = np.zeros((cap_e,), bool)
    mask[:n_edges] = True

    # CSR (reduce-by-src, the backward's direction) via counting sort.
    csr_indptr = np.zeros((cap_s + 1,), ID_DTYPE)
    csr_dst = np.full((cap_e,), P, dtype=ID_DTYPE)
    csr_eid = np.zeros((cap_e,), ID_DTYPE)
    csr_src = np.full((cap_e,), cap_s, dtype=ID_DTYPE)
    native.build_adj(lsrc[:n_edges], csc_dst[:n_edges], n_edges, cap_s,
                     csr_indptr, csr_dst, csr_eid, csr_src)

    # Static-shape layouts: a uniform single-rung dst-ELL and both tile
    # directions padded to their static bounds.
    ell_dst_meta, ell_dst = _build_ell_uniform(csc_indptr, lsrc, csc_eid, P,
                                               fanout)
    tdst = _pad_tiles(_build_tiles(csc_dst, lsrc, csc_eid, n_edges, P),
                      static_tile_bound(cap_e, P), P)
    tsrc = _pad_tiles(_build_tiles(csr_src, csr_dst, csr_eid, n_edges, cap_s),
                      static_tile_bound(cap_e, cap_s), cap_s)

    b = Graph(src=lsrc, dst=csc_dst, edge_mask=mask, csr_indptr=csr_indptr,
              csr_dst=csr_dst, csr_eid=csr_eid, csr_src=csr_src,
              csc_indptr=csc_indptr, csc_src=lsrc, csc_eid=csc_eid,
              csc_dst=csc_dst, num_src_nodes=cap_s, num_dst_nodes=P,
              num_edges=n_edges, is_block=True, tdst=tdst, tsrc=tsrc,
              ell_dst=ell_dst, ell_dst_meta=ell_dst_meta, device="cpu")
    src_id_arr = np.zeros((cap_s,), dtype=ID_DTYPE)
    src_id_arr[:n_src] = src_ids[:n_src]
    b.srcdata["_ID"] = torch.from_numpy(src_id_arr)
    b.dstdata["_ID"] = torch.from_numpy(seeds.astype(ID_DTYPE))
    peid[n_edges:] = 0
    b.edata["_ID"] = torch.from_numpy(peid)
    b.meta["num_real_src"] = n_src
    b.meta["num_real_dst"] = int(num_real_dst)
    return b
