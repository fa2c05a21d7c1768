"""Batched graph-classification loading (the port's
``dgl1_tpu/dataloading/graph_dataloader.py``): ``GraphDataLoader``.

Each batch is the disjoint union (:func:`dgl1_tpu_torch.batch.batch`) of
``batch_size`` dataset graphs and, with ``pad``, one padding graph that
rounds the node and edge counts up to ``node_pad_multiple`` /
``edge_pad_multiple`` (isolated nodes and self-loops on its node 0, zero
features), so a run sees a few batch shapes. The padding graph is an
extra segment: a readout gives ``batch_size + 1`` rows, and callers keep
the first ``batch_size``; ``mask`` also flags the graphs that repeat the
last one to fill a partial batch. Its self-loops give node 0 a large
in-degree, which may earn the batch a hub layout: the engine a layer
takes follows from the layouts, as for any graph.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from dgl1_tpu_torch.batch import batch
from dgl1_tpu_torch.graph import Graph, graph, resolve_device

__all__ = ["GraphDataLoader"]


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


def _pad_graph(n_nodes: int, n_edges: int, like: Graph) -> Graph:
    """``n_nodes`` nodes (at least one) and ``n_edges`` self-loops on node
    0, on the host with zero features of ``like``'s fields."""
    s = np.zeros((n_edges,), dtype=np.int64)
    g = graph((s, s), num_nodes=max(n_nodes, 1), formats=("csc",),
              device="cpu")
    for k, v in like.ndata.items():
        g.ndata[k] = v.new_zeros((g.num_nodes(),) + tuple(v.shape[1:]),
                                 device="cpu")
    for k, v in like.edata.items():
        g.edata[k] = v.new_zeros((n_edges,) + tuple(v.shape[1:]),
                                 device="cpu")
    return g


class GraphDataLoader:
    """Iterate ``(batched_graph, labels, mask)`` over a dataset of
    ``(graph, label)`` items, each batch built on ``device`` (default
    ``cuda``). With ``prefetch`` > 0 a producer thread builds up to that
    many batches ahead, and an error there is raised in the consumer
    after the batches before it. ``seed`` seeds the shuffle
    (``default_rng(seed).permutation`` once an epoch, as the reference
    draws it)."""

    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = False,
                 drop_last: bool = False, pad: bool = True,
                 node_pad_multiple: int = 256, edge_pad_multiple: int = 512,
                 prefetch: int = 2, seed: Optional[int] = None, *,
                 device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle, self.drop_last, self.pad = shuffle, drop_last, pad
        self.node_pad_multiple = node_pad_multiple
        self.edge_pad_multiple = edge_pad_multiple
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs: np.ndarray):
        n_real = len(idxs)
        if n_real < self.batch_size:
            idxs = np.concatenate([idxs, np.full(
                (self.batch_size - n_real,), idxs[-1], dtype=idxs.dtype)])
        items = [self.dataset[int(i)] for i in idxs]
        graphs = [it[0] for it in items]
        mask = np.zeros((self.batch_size,), dtype=bool)
        mask[:n_real] = True
        if self.pad:
            tot_n = sum(g.num_nodes() for g in graphs)
            tot_e = sum(g.num_edges() for g in graphs)
            pad_n = _round_up(tot_n + 1, self.node_pad_multiple) - tot_n
            pad_e = _round_up(tot_e + 1, self.edge_pad_multiple) - tot_e
            graphs = graphs + [_pad_graph(pad_n, pad_e, graphs[0])]
        dev = self.device
        labels = torch.stack([torch.as_tensor(it[1]) for it in items])
        return (batch(graphs, device=dev), labels.to(dev),
                torch.as_tensor(mask, device=dev))

    def _batches(self):
        order = (self.rng.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            for idxs in self._batches():
                yield self._make_batch(idxs)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: list = []

        def producer():
            try:
                for idxs in self._batches():
                    q.put(self._make_batch(idxs))
            except BaseException as exc:  # raised in the consumer
                err.append(exc)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            t.join(timeout=1.0)
