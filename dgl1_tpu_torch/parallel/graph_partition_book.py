"""GraphPartitionBook: global id <-> (partition, local id) mapping.

The port's copy of ``dgl1_tpu/parallel/graph_partition_book.py`` (numpy):
the assignment array is kept explicitly, with vectorized lookups; local
ids follow global id order within a part (or ascending ``order_key``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["GraphPartitionBook", "node_split", "edge_split"]


class GraphPartitionBook:
    def __init__(self, part_assignment: np.ndarray, num_parts: int,
                 order_key=None):
        """``order_key``: optional per-node sort key — local ids within
        each part follow ASCENDING key instead of global-id order (pass
        ``-total_in_degree`` for the hub-first local numbering the
        typed identity layouts pin to; ties break by global id)."""
        self.part = np.asarray(part_assignment).astype(np.int32)
        self.num_parts = int(num_parts)
        # local id = rank of the node among its part's nodes (sorted order).
        if order_key is not None:
            order = np.lexsort((np.asarray(order_key), self.part))
        else:
            order = np.argsort(self.part, kind="stable")
        self._local = np.zeros_like(self.part, dtype=np.int64)
        counts = np.bincount(self.part, minlength=num_parts)
        starts = np.zeros(num_parts, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        self._local[order] = np.arange(len(self.part)) - starts[self.part[order]]
        self._part_nodes = [order[starts[p]:starts[p] + counts[p]]
                            for p in range(num_parts)]

    def nid2partid(self, nids) -> np.ndarray:
        return self.part[np.asarray(nids)]

    def nid2localnid(self, nids) -> np.ndarray:
        return self._local[np.asarray(nids)]

    def partid2nids(self, part_id: int) -> np.ndarray:
        return self._part_nodes[part_id]

    def num_nodes(self, part_id: int = None) -> int:
        if part_id is None:
            return len(self.part)
        return len(self._part_nodes[part_id])

    def map_to_global(self, part_id: int, local_ids) -> np.ndarray:
        return self._part_nodes[part_id][np.asarray(local_ids)]


def _masked_ids(nodes) -> np.ndarray:
    arr = np.asarray(nodes)
    if arr.dtype == bool:
        return np.nonzero(arr)[0].astype(np.int64)
    return arr.astype(np.int64)


def node_split(nodes, partition_book: "GraphPartitionBook" = None,
               rank: int = 0, num_parts: int = None,
               force_even: bool = False) -> np.ndarray:
    """This worker's share of a node set (parity:
    ``dgl.distributed.node_split``). ``nodes`` is a boolean mask or an id
    array. With a partition book (and not ``force_even``), returns the
    ids OWNED by partition ``rank`` — each trainer works its own
    partition's seeds. Without a book (or with ``force_even``), stripes
    the ids round-robin across ``num_parts`` workers."""
    ids = _masked_ids(nodes)
    if partition_book is not None and not force_even:
        return ids[partition_book.nid2partid(ids) == rank]
    k = num_parts if num_parts is not None else (
        partition_book.num_parts if partition_book is not None else 1)
    return ids[rank::k]


def edge_split(edges, owner: np.ndarray = None, rank: int = 0,
               num_parts: int = None) -> np.ndarray:
    """This worker's share of an edge set (parity:
    ``dgl.distributed.edge_split``). ``owner`` is a per-edge part id
    (e.g. the destination's partition, or ``vertex_cut_edge_owner``);
    without it, edges are striped round-robin across ``num_parts``."""
    ids = _masked_ids(edges)
    if owner is not None:
        return ids[np.asarray(owner)[ids] == rank]
    k = num_parts if num_parts is not None else 1
    return ids[rank::k]
