"""Cluster-GCN batches (the port's ``dgl1_tpu/dataloading/cluster.py``;
DGL's ``ClusterGCNSampler``): partition the graph once, train on the
node-induced subgraphs of random unions of ``parts_per_batch`` parts.

Each batch is padded to multiples of ``node_pad_multiple`` nodes and
``edge_pad_multiple`` edges as the reference pads it. The partitioner is
the distributed layer's edge-cut one
(:func:`~dgl1_tpu_torch.parallel.partition.greedy_partition_assignment`)
unless ``partition_assignment`` gives one. A producer thread builds up to
``prefetch`` batches ahead; its exception is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import _coo

__all__ = ["ClusterGCNDataLoader"]


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


class ClusterGCNDataLoader:
    """Iterate ``(subgraph, node_mask)``: the subgraph on ``device``
    (default ``cuda``), real nodes first; the parent's ndata rows are
    gathered on the parent's device, padded rows zero; ``ndata['_ID']``
    the parent ids (0 on padding). Parts are shuffled from
    ``np.random.default_rng(seed)``, as the reference's."""

    def __init__(self, g: Graph, num_parts: int, parts_per_batch: int = 1,
                 shuffle: bool = True, seed: Optional[int] = None,
                 node_pad_multiple: int = 256,
                 edge_pad_multiple: int = 1024, prefetch: int = 2,
                 partition_assignment: Optional[np.ndarray] = None,
                 device=None):
        from dgl1_tpu_torch.parallel.partition import (
            greedy_partition_assignment)

        self.device = resolve_device(device)
        self.g = g
        self.parts_per_batch = parts_per_batch
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.node_pad_multiple = node_pad_multiple
        self.edge_pad_multiple = edge_pad_multiple
        self.prefetch = prefetch
        if partition_assignment is None:
            partition_assignment = greedy_partition_assignment(g, num_parts)
        if isinstance(partition_assignment, torch.Tensor):
            partition_assignment = partition_assignment.cpu().numpy()
        assignment = np.asarray(partition_assignment)
        order = np.argsort(assignment, kind="stable")
        bounds = np.searchsorted(assignment[order], np.arange(num_parts + 1))
        self.clusters: List[np.ndarray] = [
            order[bounds[p]:bounds[p + 1]].astype(np.int64)
            for p in range(num_parts)]
        self._src, self._dst = (a.astype(np.int64) for a in _coo(g))

    def __len__(self):
        return -(-len(self.clusters) // self.parts_per_batch)

    def _make_batch(self, nodes: np.ndarray):
        dev = self.device
        relabel = np.full((self.g.num_nodes(),), -1, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        keep = (relabel[self._src] >= 0) & (relabel[self._dst] >= 0)
        s = relabel[self._src[keep]]
        d = relabel[self._dst[keep]]
        n_pad = _round_up(len(nodes), self.node_pad_multiple)
        e_pad = _round_up(len(s), self.edge_pad_multiple)
        sg = graph((s, d), num_nodes=n_pad, pad_edges_to=e_pad, device=dev)
        ids = np.zeros((n_pad,), dtype=np.int64)
        ids[: len(nodes)] = nodes
        for k, v in self.g.ndata.items():
            rows = v.index_select(0, torch.from_numpy(ids).to(v.device))
            rows[len(nodes):] = 0
            sg.ndata[k] = rows.to(dev)
        sg.ndata["_ID"] = torch.from_numpy(ids.astype(np.int32)).to(dev)
        mask = torch.zeros(n_pad, dtype=torch.bool)
        mask[: len(nodes)] = True
        return sg, mask.to(dev)

    def _groups(self):
        order = (self.rng.permutation(len(self.clusters)) if self.shuffle
                 else np.arange(len(self.clusters)))
        q = self.parts_per_batch
        for i in range(len(self)):
            parts = order[i * q:(i + 1) * q]
            yield np.concatenate([self.clusters[p] for p in parts])

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            for nodes in self._groups():
                yield self._make_batch(nodes)
            return
        qu: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: list = []

        def producer():
            try:
                for nodes in self._groups():
                    qu.put(self._make_batch(nodes))
            except BaseException as exc:  # raised in the consumer
                err.append(exc)
            finally:
                qu.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = qu.get()
                if item is stop:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            t.join(timeout=1.0)
