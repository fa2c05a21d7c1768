"""Edge (link prediction) loader (the port's
``dgl1_tpu/dataloading/edge_dataloader.py``): a batch of edges gives
``(input_nodes, positive pair graph, negative pair graph, blocks)``, the
blocks sampled from the unique endpoints of both pair graphs."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.dataloading.dataloader import _ids_to
from dgl1_tpu_torch.graph import block, resolve_device

__all__ = ["EdgeDataLoader", "as_edge_prediction_sampler"]


class as_edge_prediction_sampler:
    """Wraps a block sampler for edge batches. ``exclude``: None, ``'self'``
    (the batch's own edges are never sampled into its blocks),
    ``'reverse_id'`` (and their reverses, ``reverse_eids[e]``) or
    ``'reverse_types'`` (on a heterograph: and the same ids of the
    reverse edge type, ``reverse_etypes[etype]``). :meth:`sample` returns
    host objects: numpy ids, pair graphs and blocks on the CPU."""

    def __init__(self, sampler, negative_sampler=None, exclude=None,
                 reverse_eids=None, reverse_etypes=None):
        if exclude not in (None, "self", "reverse_id", "reverse_types"):
            raise ValueError(f"unsupported exclude mode {exclude!r}")
        if exclude == "reverse_id" and reverse_eids is None:
            raise ValueError("exclude='reverse_id' needs reverse_eids")
        if exclude == "reverse_types" and reverse_etypes is None:
            raise ValueError("exclude='reverse_types' needs reverse_etypes")
        self.sampler = sampler
        self.negative_sampler = negative_sampler
        self.exclude = exclude
        self.reverse_eids = (None if reverse_eids is None
                             else np.asarray(reverse_eids, dtype=np.int64))
        self.reverse_etypes = reverse_etypes

    def sample_hetero(self, g, eids: dict,
                      rng: Optional[np.random.Generator] = None):
        """A hetero edge batch (``eids`` an ``{etype: ids}`` dict): pair
        heterographs over each node type's unique endpoints (their parent
        ids in ``nframes[nt]['_ID']``), negatives drawn per relation in its
        own dst space, and ``'reverse_types'`` excluding the same ids in
        the paired reverse relation."""
        from dgl1_tpu_torch.heterograph import heterograph

        rng = rng or dgl_random.default_rng()
        targets = {g.to_canonical_etype(et): np.asarray(v, np.int64)
                   for et, v in eids.items()}
        pos, neg, nt_nodes = {}, {}, {}
        for c, ids in targets.items():
            rel = g.rel_graphs[c]
            src = rel.src.cpu().numpy()[ids].astype(np.int64)
            dst = rel.dst.cpu().numpy()[ids].astype(np.int64)
            pos[c] = (src, dst)
            if self.negative_sampler is not None:
                ns, nd = self.negative_sampler(rel, ids, rng=rng)
            else:
                ns = nd = np.zeros((0,), np.int64)
            neg[c] = (ns, nd)
            nt_nodes.setdefault(c[0], []).extend([src, ns])
            nt_nodes.setdefault(c[2], []).extend([dst, nd])
        uniq = {nt: np.unique(np.concatenate(v))
                for nt, v in nt_nodes.items()}

        def pair_graph(pairs):
            hg = heterograph(
                {c: (np.searchsorted(uniq[c[0]], s),
                     np.searchsorted(uniq[c[2]], d))
                 for c, (s, d) in pairs.items()},
                num_nodes_dict={nt: len(v) for nt, v in uniq.items()},
                device="cpu")
            for nt, v in uniq.items():
                hg.nframes[nt]["_ID"] = torch.from_numpy(v.astype(np.int32))
            return hg

        exc = None
        if self.exclude == "self":
            exc = dict(targets)
        elif self.exclude == "reverse_types":
            exc = dict(targets)
            for c, ids in targets.items():
                rc = g.to_canonical_etype(self.reverse_etypes[c[1]])
                # Edge i of a type and edge i of its reverse type are one
                # pair (the reference's convention).
                exc[rc] = np.concatenate(
                    [exc.get(rc, np.zeros(0, np.int64)), ids])
        pos_graph, neg_graph = pair_graph(pos), pair_graph(neg)
        input_nodes, _, blocks = self.sampler.sample_blocks(
            g, uniq, rng=rng, exclude_eids=exc)
        return input_nodes, pos_graph, neg_graph, blocks

    def sample(self, g, eids, rng: Optional[np.random.Generator] = None):
        """An edge batch: the pair graphs over the sorted unique endpoints
        of the positive and negative pairs (their parent ids in
        ``srcdata['_ID']``) and the blocks sampled for those endpoints."""
        from dgl1_tpu_torch.heterograph import HeteroGraph

        if isinstance(g, HeteroGraph):
            if not isinstance(eids, dict):
                if len(g.canonical_etypes) != 1:
                    raise ValueError("hetero edge batches need an "
                                     "{etype: ids} dict")
                eids = {g.canonical_etypes[0][1]: eids}
            return self.sample_hetero(g, eids, rng=rng)
        rng = rng or dgl_random.default_rng()
        eids = np.asarray(eids, dtype=np.int64)
        src = g.src.cpu().numpy()[eids].astype(np.int64)
        dst = g.dst.cpu().numpy()[eids].astype(np.int64)
        if self.negative_sampler is not None:
            neg_src, neg_dst = self.negative_sampler(g, eids, rng=rng)
        else:
            neg_src = neg_dst = np.zeros((0,), dtype=np.int64)
        uniq, inv = np.unique(np.concatenate([src, dst, neg_src, neg_dst]),
                              return_inverse=True)
        n, k = len(src), len(neg_src)
        pos_graph = block((inv[:n], inv[n:2 * n]), num_src_nodes=len(uniq),
                          num_dst_nodes=len(uniq), device="cpu")
        neg_graph = block((inv[2 * n:2 * n + k], inv[2 * n + k:]),
                          num_src_nodes=len(uniq), num_dst_nodes=len(uniq),
                          device="cpu")
        exc = None
        if self.exclude == "self":
            exc = eids
        elif self.exclude == "reverse_id":
            exc = np.concatenate([eids, self.reverse_eids[eids]])
        input_nodes, _, blocks = self.sampler.sample_blocks(
            g, uniq, rng=rng, exclude_eids=exc)
        ids = torch.from_numpy(uniq.astype(np.int32))
        pos_graph.srcdata["_ID"] = ids
        neg_graph.srcdata["_ID"] = ids
        return input_nodes, pos_graph, neg_graph, blocks


class EdgeDataLoader:
    """Iterates link-prediction batches ``(input_nodes, pos_graph,
    neg_graph, blocks)`` over the edges ``eids`` (an ``{etype: ids}``
    dict on a heterograph), all on ``device`` (default ``cuda``). Pair
    graphs have as many nodes as the batch has unique endpoints; the
    blocks are padded as the sampler pads them. Batches come from one
    ``default_rng(seed)`` stream, drawn in the reference's order."""

    def __init__(self, g, eids, sampler, batch_size: int = 1024,
                 shuffle: bool = True, negative_sampler=None,
                 drop_last: bool = True, seed: Optional[int] = None,
                 exclude=None, reverse_eids=None, reverse_etypes=None,
                 device=None):
        self.g = g
        if isinstance(eids, dict):
            # (etype, eid) pairs, regrouped per edge type in each batch.
            self._etypes = list(eids.keys())
            parts = [np.asarray(v, np.int64) for v in eids.values()]
            self.eids = np.concatenate(parts)
            self._eid_type = np.concatenate([
                np.full(len(v), i, np.int64) for i, v in enumerate(parts)])
        else:
            self._etypes = None
            self.eids = np.asarray(eids, dtype=np.int64)
            self._eid_type = None
        self.wrapped = as_edge_prediction_sampler(
            sampler, negative_sampler, exclude=exclude,
            reverse_eids=reverse_eids, reverse_etypes=reverse_etypes)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def __len__(self):
        n = len(self.eids)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = (self.rng.permutation(len(self.eids)) if self.shuffle
                 else np.arange(len(self.eids)))
        eids = self.eids[order]
        types = self._eid_type[order] if self._eid_type is not None else None
        dev = self.device
        for i in range(len(self)):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            batch = eids[sl]
            if types is not None:
                t = types[sl]
                batch = {self._etypes[j]: batch[t == j] for j in np.unique(t)}
            inp, pos, neg, blocks = self.wrapped.sample(self.g, batch,
                                                        rng=self.rng)
            yield (_ids_to(inp, dev), pos.to(dev), neg.to(dev),
                   [b.to(dev) for b in blocks])
