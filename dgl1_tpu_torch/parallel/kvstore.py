"""KVStore-parity sharded node-feature store with remote pull.

The port's copy of ``dgl1_tpu/parallel/kvstore.py`` (numpy and sockets;
parity: ``python/dgl/distributed/kvstore.py``). The replicated mmap store
(``partition.load_global_feats``) is the fast path when features fit
every host's disk; this module is for features larger than one host's
storage: each process opens only its own partition's feature shard (raw
``.bin`` written by :func:`partition_graph` with ``save_part_feats=True``)
and serves row pulls to peers over a host-side TCP service. It feeds the
host sampling pipeline; the device-side exchange is the collectives'.
Pulled rows come back as tensors on the store's device.

Protocol (one request per (owner, batch)): client sends
``[u32 field_len][field utf8][u64 n][n x i64 local_row_ids]``, server
responds ``[u64 nbytes][rows bytes]`` — rows are the server's local
shard gathered host-side, dtype/shape known to both ends from the book.
"""

from __future__ import annotations

import socket
import struct
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ShardedFeatureStore", "write_part_feature_shards",
           "load_part_feature_meta"]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed during recv")
        got += r
    return bytes(buf)


def write_part_feature_shards(out_path, graph_name: str, part_id: int,
                              feats: Dict[str, np.ndarray]) -> dict:
    """Write one part's owned-row features as raw mmap-able ``.bin``
    shards under ``part{p}/feat/``; returns the meta dict recorded in
    the partition book."""
    pdir = Path(out_path) / f"part{part_id}" / "feat"
    pdir.mkdir(parents=True, exist_ok=True)
    meta = {}
    for k, v in feats.items():
        arr = np.ascontiguousarray(np.asarray(v))
        arr.tofile(pdir / f"{k}.bin")
        # Part-independent meta: row counts differ per part (derived
        # from the assignment at open time); only the row shape and
        # dtype are shared.
        meta[k] = {"row_shape": list(arr.shape[1:]),
                   "dtype": str(arr.dtype)}
    return meta


def load_part_feature_meta(out_path, graph_name: str) -> dict:
    import json

    with open(Path(out_path) / f"{graph_name}.json") as f:
        book = json.load(f)
    return book.get("part_feats", {})


class ShardedFeatureStore:
    """Pull-based distributed feature access where NO process holds the
    full matrix.

    Each process constructs one instance with its ``part_id``; the
    instance mmaps only that part's shards and (optionally) serves them
    at ``addrs[part_id]``. :meth:`pull` takes global node ids, splits
    them by the partition assignment, gathers owned rows from the local
    mmap and fetches the rest from the owning peers: the DistDGL kvstore
    pull, with the server side a socket loop in every process (each is
    both trainer and feature owner). ``device`` (None: cuda) is where
    :meth:`pull` puts the rows.
    """

    def __init__(self, out_path, graph_name: str, part_id: int,
                 part: np.ndarray,
                 addrs: Optional[Sequence[Tuple[str, int]]] = None,
                 serve: bool = True, device=None):
        from dgl1_tpu_torch.graph import resolve_device

        self.device = resolve_device(device)
        self.out_path = Path(out_path)
        self.graph_name = graph_name
        self.part_id = int(part_id)
        self.part = np.asarray(part)
        self.num_parts = int(self.part.max()) + 1 if len(self.part) else 1
        self.addrs = list(addrs) if addrs is not None else None
        # Global -> within-owner local row id for EVERY node (shard row
        # order is ascending global id within each part, exactly how
        # partition_graph writes the per-part feature files).
        self._local_vec = np.empty(len(self.part), np.int64)
        for p in range(self.num_parts):
            own_p = np.nonzero(self.part == p)[0]
            self._local_vec[own_p] = np.arange(len(own_p))
        own = np.nonzero(self.part == self.part_id)[0]
        self._own_nodes = own
        self.meta = load_part_feature_meta(out_path, graph_name)
        if not self.meta:
            raise ValueError(
                "partition artifacts carry no sharded feature meta — "
                "re-run partition_graph(save_part_feats=True)")
        self._mm = {}
        fdir = self.out_path / f"part{self.part_id}" / "feat"
        for k, m in self.meta.items():
            shape = (len(own),) + tuple(m["row_shape"])
            mm = np.memmap(fdir / f"{k}.bin", mode="r",
                           dtype=np.dtype(m["dtype"]), shape=shape)
            self._mm[k] = mm
        self._srv_sock = None
        self._srv_thread = None
        self._stats = {"local_rows": 0, "remote_rows": 0, "requests": 0}
        if serve and self.addrs is not None:
            self._start_server()

    # ------------------------------------------------------------------
    @property
    def local_rows(self) -> int:
        return len(self._own_nodes)

    def stats(self) -> dict:
        return dict(self._stats)

    # ------------------------------------------------------------------
    def _start_server(self):
        host, port = self.addrs[self.part_id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        self._srv_sock = srv

        def serve_loop():
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return  # closed
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        self._srv_thread = threading.Thread(target=serve_loop, daemon=True)
        self._srv_thread.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while True:
                head = conn.recv(4)
                if not head:
                    return
                if len(head) < 4:
                    head += _recv_exact(conn, 4 - len(head))
                (flen,) = struct.unpack("<I", head)
                field = _recv_exact(conn, flen).decode()
                (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
                ids = np.frombuffer(_recv_exact(conn, 8 * n), np.int64)
                rows = np.ascontiguousarray(self._mm[field][ids])
                conn.sendall(struct.pack("<Q", rows.nbytes))
                conn.sendall(rows.tobytes())
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        if self._srv_sock is not None:
            try:
                self._srv_sock.close()
            except OSError:
                pass
            self._srv_sock = None

    # ------------------------------------------------------------------
    def _pull_remote(self, owner: int, field: str,
                     local_ids: np.ndarray) -> np.ndarray:
        host, port = self.addrs[owner]
        with socket.create_connection((host, port), timeout=60) as sock:
            f = field.encode()
            sock.sendall(struct.pack("<I", len(f)) + f
                         + struct.pack("<Q", len(local_ids))
                         + np.ascontiguousarray(local_ids, np.int64)
                         .tobytes())
            (nbytes,) = struct.unpack("<Q", _recv_exact(sock, 8))
            raw = _recv_exact(sock, nbytes)
        m = self.meta[field]
        return np.frombuffer(raw, np.dtype(m["dtype"])).reshape(
            (len(local_ids),) + tuple(m["row_shape"])).copy()

    def pull(self, field: str, nids) -> torch.Tensor:
        """Rows for global node ids, any owner (the kvstore pull), as a
        tensor on the store's device."""
        return torch.from_numpy(self._pull_rows(field, nids)).to(
            self.device)

    def _pull_rows(self, field: str, nids) -> np.ndarray:
        nids = np.asarray(nids, np.int64)
        m = self.meta[field]
        out = np.empty((len(nids),) + tuple(m["row_shape"]),
                       np.dtype(m["dtype"]))
        owners = self.part[nids]
        local = self._local_vec[nids]
        self._stats["requests"] += 1
        for p in np.unique(owners):
            mask = owners == p
            lids = local[mask]
            if int(p) == self.part_id:
                out[mask] = self._mm[field][lids]
                self._stats["local_rows"] += int(mask.sum())
            else:
                if self.addrs is None:
                    raise ValueError(
                        "remote pull needs peer addresses (addrs=)")
                out[mask] = self._pull_remote(int(p), field, lids)
                self._stats["remote_rows"] += int(mask.sum())
        return out

    def __getitem__(self, nids) -> torch.Tensor:
        """Single-field sugar when exactly one field exists
        (DistTensor-style indexing)."""
        if len(self.meta) != 1:
            raise ValueError("multiple fields; use pull(field, nids)")
        return self.pull(next(iter(self.meta)), nids)
