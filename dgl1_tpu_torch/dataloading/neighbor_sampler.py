"""Multi-layer neighbor samplers producing blocks (the port's
``dgl1_tpu/dataloading/neighbor_sampler.py``).

Per layer, innermost first: sample each seed's in-edges, then turn them
into a block whose dst nodes are the seeds. With ``static_shapes`` (the
default) every block is padded to a bound that depends only on (batch
size, fanouts): src count <= dst * (fanout + 1), edge count <= dst *
fanout, so every batch of an epoch has the same shapes. Two paths, chosen
by the reference's condition: the fused native sampler
(``sampling/fused.py``) for a static bound without edge exclusion when
:func:`supports_fused` holds, else the numpy sampler
(``sampling/neighbor.py``) and the block builders of ``transform``. Both
keep a seed given twice as two dst rows, each with its own samples.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.sampling.fused import sample_block_fused, supports_fused
from dgl1_tpu_torch.sampling.neighbor import (_csc_arrays, _etype_fanout,
                                              _sample_hetero_arrays,
                                              sample_neighbors_arrays)
from dgl1_tpu_torch.transform import _block_of, _hetero_block_of

__all__ = ["NeighborSampler", "MultiLayerNeighborSampler",
           "MultiLayerFullNeighborSampler"]


def _kept(eids, exc):
    """Mask of the sampled edges whose parent id is not in ``exc``."""
    return ~np.isin(np.asarray(eids).astype(np.int32), np.asarray(exc))


class NeighborSampler:
    """Samples ``len(fanouts)`` layers of blocks for a seed batch. A
    fanout is an int (negative: every neighbor) or, on a heterograph, a
    per-edge-type dict. ``replace`` samples with replacement; ``prob``
    names an edge feature of sampling weights. ``static_shapes=False``
    gives unpadded blocks (ELL layouts only), as a negative fanout does
    for its layer and every layer outside it."""

    def __init__(self, fanouts: Sequence, replace: bool = False,
                 prob: Optional[str] = None, static_shapes: bool = True):
        self.fanouts = list(fanouts)
        self.replace = replace
        self.prob = prob
        self.static_shapes = static_shapes

    def _layer_bounds(self, batch_size: int) -> List[Optional[dict]]:
        """(src, edge) bounds per layer, outermost first; None from a
        negative fanout outward."""
        bounds = []
        dst = batch_size
        for fanout in reversed(self.fanouts):
            if fanout < 0 or dst is None:
                bounds.append(None)
                dst = None
            else:
                src = dst * (fanout + 1)
                bounds.append({"src": src, "edges": dst * fanout})
                dst = src
        return list(reversed(bounds))

    def _layer_bounds_hetero(self, g, seed_counts: dict) -> List[dict]:
        """Per layer, outermost first: the src bound of each node type (its
        dst nodes plus every relation's edges into it), the edge bound and
        the fanout of each relation. ``seed_counts``: {ntype: padded seed
        count} of the output layer."""
        bounds = []
        dst = dict(seed_counts)
        for fanout in reversed(self.fanouts):
            edges, ks = {}, {}
            src = dict(dst)
            for c in g.canonical_etypes:
                st, _, dt = c
                k = _etype_fanout(fanout, c)
                if k < 0:
                    raise ValueError(
                        "full-neighborhood fanout has no static bound; use "
                        "static_shapes=False")
                e = dst.get(dt, 0) * k
                edges[c] = e
                ks[c] = k
                src[st] = src.get(st, 0) + e
            bounds.append({"src": src, "edges": edges, "k": ks})
            dst = src
        return list(reversed(bounds))

    def sample_blocks_hetero(self, g, seed_nodes: dict,
                             rng: Optional[np.random.Generator] = None,
                             num_real: Optional[dict] = None,
                             exclude_eids=None):
        """:meth:`sample_blocks` on a heterograph: ``seed_nodes`` is a
        ``{ntype: ids}`` dict, ``num_real`` the count of real seeds per
        type (the rest is padding, never sampled), ``exclude_eids`` a dict
        of parent edge ids per relation (keyed by canonical or edge type;
        a bare array applies to every relation). Returns ``(input_nodes,
        output_nodes, blocks)`` with ``{ntype: ids}`` dicts and host hetero
        blocks, input side first. Every relation gets a block in every
        layer, with no edges where its dst type has no seeds."""
        seed_nodes = {nt: np.asarray(v, dtype=np.int64)
                      for nt, v in seed_nodes.items()}
        bounds = (self._layer_bounds_hetero(
            g, {nt: len(v) for nt, v in seed_nodes.items()})
            if self.static_shapes else [None] * len(self.fanouts))
        n_parent = {nt: g.num_nodes(nt) for nt in g.ntypes}
        empty = np.zeros((0,), np.int64)
        blocks = []
        seeds = dict(seed_nodes)
        num_real = ({nt: len(v) for nt, v in seeds.items()}
                    if num_real is None else dict(num_real))
        for layer in reversed(range(len(self.fanouts))):
            b = bounds[layer]
            sampled = _sample_hetero_arrays(
                g, {nt: v[: num_real[nt]] for nt, v in seeds.items()},
                self.fanouts[layer], self.prob, self.replace, rng)
            rel_edges, eids = {}, {}
            for c, got in sampled.items():
                src, dst_local, _, eid = (got if got is not None
                                          else (empty,) * 4)
                exc = (exclude_eids.get(c, exclude_eids.get(c[1]))
                       if isinstance(exclude_eids, dict) else exclude_eids)
                if exc is not None and len(src):
                    keep = _kept(eid, exc)
                    src, dst_local, eid = src[keep], dst_local[keep], \
                        eid[keep]
                rel_edges[c], eids[c] = (src, dst_local), eid
            blk = _hetero_block_of(
                rel_edges, seeds, num_real, g.ntypes, n_parent, True,
                b["src"] if b else None, b["edges"] if b else None, None,
                b["k"] if b else None, "cpu", eids)
            blocks.insert(0, blk)
            seeds = {nt: blk.srcframes[nt]["_ID"].numpy().astype(np.int64)
                     for nt in blk.srctypes}
            num_real = dict(blk.meta["num_real_src"])
        return seeds, seed_nodes, blocks

    def sample_blocks(self, g, seed_nodes,
                      rng: Optional[np.random.Generator] = None,
                      exclude_eids=None, num_real: Optional[int] = None):
        """Returns ``(input_nodes, output_nodes, blocks)``: numpy ids and
        host blocks, input side first. ``num_real`` is the number of real
        seeds; the tail beyond it is padding and is never sampled.
        ``exclude_eids``: parent edge ids never sampled into any block
        (link prediction's guard against leaking the edges it scores);
        it takes the numpy sampler. A heterograph goes to
        :meth:`sample_blocks_hetero`."""
        from dgl1_tpu_torch.heterograph import HeteroGraph

        if isinstance(g, HeteroGraph):
            nr = (None if num_real is None
                  else {nt: num_real for nt in seed_nodes})
            return self.sample_blocks_hetero(g, seed_nodes, rng=rng,
                                             num_real=nr,
                                             exclude_eids=exclude_eids)
        seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
        bounds = (self._layer_bounds(len(seed_nodes)) if self.static_shapes
                  else [None] * len(self.fanouts))
        blocks = []
        seeds = seed_nodes
        num_real = len(seed_nodes) if num_real is None else int(num_real)
        for layer in reversed(range(len(self.fanouts))):
            fanout = self.fanouts[layer]
            b = bounds[layer]
            if (b is not None and exclude_eids is None
                    and supports_fused(g, fanout, self.prob, self.replace)):
                blk = sample_block_fused(g, seeds, num_real, fanout,
                                         pad_src_to=b["src"],
                                         pad_edges_to=b["edges"], rng=rng)
            else:
                blk = self._numpy_block(g, seeds, num_real, fanout, b, rng,
                                        exclude_eids)
            blocks.insert(0, blk)
            seeds = blk.srcdata["_ID"].numpy().astype(np.int64)
            num_real = blk.meta["num_real_src"]
        return seeds, seed_nodes, blocks

    def _numpy_block(self, g: Graph, seeds, num_real: int, fanout: int,
                     b: Optional[dict], rng, exclude_eids):
        """One layer through the numpy sampler: the sampled edges of the
        real seeds (less the excluded ids), each into its seed's row, as a
        block padded to ``b`` with a uniform ELL, or an unpadded block with
        ELL layouts only."""
        p = (None if self.prob is None
             else g.edata[self.prob].detach().cpu().numpy().reshape(-1))
        nbr, seed_idx, eids = sample_neighbors_arrays(
            *_csc_arrays(g), seeds[:num_real], fanout, self.replace, rng, p)
        if exclude_eids is not None:
            keep = _kept(eids, exclude_eids)
            nbr, seed_idx, eids = nbr[keep], seed_idx[keep], eids[keep]
        return _block_of(
            nbr.astype(np.int64), seed_idx, seeds, num_real,
            g.num_src_nodes(), True, b["src"] if b else None,
            b["edges"] if b else None, None if b else ("ell",),
            fanout if b and fanout > 0 else None, "cpu", eid=eids)


MultiLayerNeighborSampler = NeighborSampler


class MultiLayerFullNeighborSampler(NeighborSampler):
    """Every neighbor at every layer (``dgl.dataloading.
    MultiLayerFullNeighborSampler``): unpadded blocks."""

    def __init__(self, num_layers: int):
        super().__init__([-1] * num_layers, static_shapes=False)
