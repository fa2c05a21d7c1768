"""DistGraph / DistTensor facade (homogeneous graphs).

The port's counterpart of ``dgl1_tpu/parallel/dist_graph.py`` (parity:
``python/dgl/distributed/dist_graph.py`` / ``dist_tensor.py``), with no
servers and no RPC: each process owns its partitions' shards, global-id
reads are host gathers against the partition layout, and device-side
access goes through :class:`~dgl1_tpu_torch.parallel.halo.
PartitionedGraph`'s static halo plan. Heterographs (the reference's typed
facade) come with ``parallel/hetero.py`` in the next slice and raise
NotImplementedError here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.parallel.graph_partition_book import GraphPartitionBook
from dgl1_tpu_torch.parallel.halo import (PartitionedGraph,
                                          build_partitioned_graph)
from dgl1_tpu_torch.parallel.partition import _host

__all__ = ["DistGraph", "DistTensor"]


class DistTensor:
    """Global-indexed view over distributed node features (host side),
    ``tensor[nids]`` -> numpy rows, with one of two backings:

    * ``shards``: per-partition in-process arrays;
    * ``store``: a replicated mmap ``HostFeatureStore``
      (:func:`~dgl1_tpu_torch.parallel.partition.load_global_feats`),
      from which any process pulls any node's rows.
    """

    def __init__(self, book: GraphPartitionBook,
                 shards: Optional[Dict[int, np.ndarray]] = None,
                 name: str = "", store=None):
        if (shards is None) == (store is None):
            raise ValueError("DistTensor takes exactly one of shards/store")
        self.book = book
        self.shards = (None if shards is None else
                       {p: _host(v) for p, v in shards.items()})
        self.store = store
        self.name = name

    @property
    def shape(self):
        if self.store is not None:
            return tuple(self.store.shape)
        first = next(iter(self.shards.values()))
        return (self.book.num_nodes(),) + first.shape[1:]

    def __getitem__(self, nids) -> np.ndarray:
        nids = _host(nids)
        if self.store is not None:
            return self.store.pull(nids)
        from dgl1_tpu_torch._native import gather_rows

        parts = self.book.nid2partid(nids)
        local = self.book.nid2localnid(nids)
        owners = np.unique(parts)
        if len(owners) == 1:  # one owner: a threaded row gather
            return gather_rows(self.shards[int(owners[0])], local)
        first = next(iter(self.shards.values()))
        out = np.zeros((len(nids),) + first.shape[1:], dtype=first.dtype)
        for p in owners:
            m = parts == p
            out[m] = gather_rows(self.shards[int(p)], local[m])
        return out

    def __setitem__(self, nids, value):
        if self.store is not None:
            raise TypeError(
                "store-backed DistTensor is read-only (the replicated mmap "
                "is shared across hosts); write via the partition artifacts")
        nids = _host(nids)
        value = _host(value)
        parts = self.book.nid2partid(nids)
        local = self.book.nid2localnid(nids)
        for p in np.unique(parts):
            m = parts == p
            self.shards[int(p)][local[m]] = value[m]


class DistGraph:
    """Partitioned-graph facade with DGL-like accessors: from a full
    graph and a partition count (one process sees every part), or from
    :func:`~dgl1_tpu_torch.parallel.partition.partition_graph` artifacts
    per process (:meth:`from_partition`)."""

    def __init__(self, g, num_parts: int,
                 part: Optional[np.ndarray] = None,
                 part_method: Optional[str] = None):
        from dgl1_tpu_torch.heterograph import HeteroGraph
        from dgl1_tpu_torch.parallel.partition import (
            greedy_partition_assignment, metis_partition_assignment,
            random_partition_assignment)

        if isinstance(g, HeteroGraph):
            raise NotImplementedError(
                "DistGraph over a heterograph needs parallel/hetero.py, "
                "which the next slice of the port brings")
        self.hetero = False
        if part is None:
            if part_method == "random":
                part = random_partition_assignment(g, num_parts)
            elif part_method == "metis":
                part = metis_partition_assignment(g, num_parts)
            elif part_method in (None, "greedy"):
                part = greedy_partition_assignment(g, num_parts)
            else:
                raise ValueError(f"unknown part_method {part_method!r}")
        self.g = g
        self.book = GraphPartitionBook(part, num_parts)
        self.part = np.asarray(part)
        self.num_parts = num_parts
        self.part_id: Optional[int] = None
        self._pg: Optional[PartitionedGraph] = None
        self.ndata: Dict[str, DistTensor] = {}
        for k, v in g.ndata.items():
            arr = _host(v)
            shards = {p: arr[self.book.partid2nids(p)]
                      for p in range(num_parts)}
            self.ndata[k] = DistTensor(self.book, shards, name=k)

    @classmethod
    def from_partition(cls, out_path: str, graph_name: str, part_id: int,
                       formats=("csc",), device=None) -> "DistGraph":
        """One process's view of :func:`partition_graph` artifacts: the
        full structure (replicated, for sampling any seed) on ``device``
        (None: cuda), the partition book, and ndata as read-only
        replicated-mmap DistTensors. ``part_id`` is this process's
        partition; its train shard is ``book.partid2nids(part_id)``."""
        import json
        from pathlib import Path

        from dgl1_tpu_torch.graph import graph as make_graph
        from dgl1_tpu_torch.parallel.partition import load_global_feats

        out = Path(out_path)
        with open(out / f"{graph_name}.json") as f:
            meta = json.load(f)
        with np.load(out / f"{graph_name}_structure.npz") as z:
            g = make_graph((z["src"], z["dst"]),
                           num_nodes=int(z["num_nodes"][0]),
                           formats=formats, device=device)
        part = np.load(out / "node_part.npy")
        obj = cls.__new__(cls)
        obj.hetero = False
        obj.g = g
        obj.book = GraphPartitionBook(part, int(meta["num_parts"]))
        obj.part = part
        obj.num_parts = int(meta["num_parts"])
        obj.part_id = int(part_id)
        obj._pg = None
        obj.ndata = {
            k: DistTensor(obj.book, store=st, name=k)
            for k, st in load_global_feats(out_path, graph_name,
                                           device=device).items()
        }
        return obj

    def num_nodes(self) -> int:
        return self.g.num_nodes()

    def num_edges(self) -> int:
        return self.g.num_edges()

    def get_partition_book(self):
        return self.book

    def partitioned(self, **kw) -> PartitionedGraph:
        """The halo-plan build (cached; ``build_partitioned_graph``'s
        keywords)."""
        if self._pg is None:
            self._pg = build_partitioned_graph(self.g, self.part,
                                               self.num_parts, **kw)
        return self._pg

    def local_graph(self, part_id: int) -> Graph:
        """The destination-owned subgraph of one partition, in global
        ids."""
        from dgl1_tpu_torch.parallel.partition import _coo
        from dgl1_tpu_torch.transform import edge_subgraph

        _, dst = _coo(self.g)
        eids = np.nonzero(self.part[dst] == part_id)[0]
        return edge_subgraph(self.g, eids, relabel_nodes=False)
