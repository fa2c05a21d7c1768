"""Host-resident feature store (the port's
``dgl1_tpu/data/feature_store.py``).

Node features too large for the card stay in host memory or on disk
(``np.memmap``); a mini-batch gathers only the rows its blocks read, with
the native threaded row copy (``_native.gather_rows``), straight into a
pinned staging buffer when the store's device is a card, and copies them
over without blocking the host. The file format is the reference's: a
raw ``.bin`` of the rows beside a ``.meta.npz`` holding ``shape`` and
``dtype``, so either package opens the other's store.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np
import torch

from dgl1_tpu_torch import _native
from dgl1_tpu_torch.graph import resolve_device

__all__ = ["HostFeatureStore", "prefetch_to_device"]


class HostFeatureStore:
    """An (N, ...) feature matrix in host memory or on disk, with a fast
    row pull. Built from an array, or from a ``.npy`` path (``mmap=True``
    maps it instead of reading it) or a ``.bin`` path with ``shape=`` and
    ``dtype=`` (always mapped). ``device`` (default ``cuda``) is where
    :meth:`pull_to_device` puts the rows."""

    def __init__(self, data: Union[np.ndarray, str, Path], shape=None,
                 dtype=None, mmap: bool = False, num_threads: int = 8,
                 device=None):
        if isinstance(data, (str, Path)):
            path = Path(data)
            if path.suffix == ".npy":
                self._data = np.load(path, mmap_mode="r" if mmap else None)
            else:
                if shape is None or dtype is None:
                    raise ValueError(".bin stores need shape= and dtype=")
                self._data = np.memmap(path, dtype=dtype, mode="r",
                                       shape=tuple(shape))
        else:
            self._data = np.asarray(data)
        self.num_threads = num_threads
        self.device = resolve_device(device)

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __len__(self):
        return self._data.shape[0]

    def pull(self, ids) -> np.ndarray:
        """The rows of ``ids`` (global ids) as a host array."""
        return _native.gather_rows(self._data, _host_ids(ids),
                                   num_threads=self.num_threads)

    def pull_to_device(self, ids) -> torch.Tensor:
        """The rows of ``ids`` as a tensor on the store's device. On a card
        they are gathered into pinned memory and copied without blocking
        the host (the copy is ordered on the current stream)."""
        ids = _host_ids(ids)
        shape = (len(ids),) + self._data.shape[1:]
        dt = torch.from_numpy(np.empty((0,), self._data.dtype)).dtype
        if self.device.type != "cuda":
            return torch.from_numpy(self.pull(ids)).to(self.device)
        staged = torch.empty(shape, dtype=dt, pin_memory=True)
        _native.gather_rows(self._data, ids, num_threads=self.num_threads,
                            out=staged.numpy())
        return staged.to(self.device, non_blocking=True)

    @staticmethod
    def save(path: Union[str, Path], array: np.ndarray,
             device=None) -> "HostFeatureStore":
        """Write ``array`` as a raw ``.bin`` at ``path`` beside a
        ``.meta.npz`` header (the reference's format) and return a store
        mapped over it."""
        path = Path(path)
        array = np.asarray(array)
        mm = np.memmap(path, dtype=array.dtype, mode="w+", shape=array.shape)
        mm[:] = array
        mm.flush()
        del mm
        np.savez(path.with_suffix(".meta.npz"), shape=np.asarray(array.shape),
                 dtype=str(array.dtype))
        return HostFeatureStore(path, shape=array.shape, dtype=array.dtype,
                                mmap=True, device=device)

    @staticmethod
    def load(path: Union[str, Path], device=None) -> "HostFeatureStore":
        """Open a store written by :meth:`save` (of either package)."""
        path = Path(path)
        meta = np.load(path.with_suffix(".meta.npz"))
        return HostFeatureStore(path, shape=tuple(meta["shape"]),
                                dtype=np.dtype(str(meta["dtype"])),
                                mmap=True, device=device)


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.ascontiguousarray(ids, dtype=np.int64)


def prefetch_to_device(loader: Iterable, store: HostFeatureStore,
                       labels: Optional[np.ndarray] = None,
                       depth: int = 2):
    """Wrap a node loader: a thread pulls each batch's input rows from
    ``store`` onto its device, ``depth`` batches ahead of the consumer.
    Yields ``(input_nodes, output_nodes, blocks, mask, x)``, with ``y``,
    the rows of ``labels`` (a host array) for the output nodes, appended
    when given. The loader's own items are passed on as they are (a
    ``NodeDataLoader`` already puts them on its device)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in loader:
                input_nodes, output_nodes, blocks, mask = item[:4]
                out = [input_nodes, output_nodes, blocks, mask,
                       store.pull_to_device(input_nodes)]
                if labels is not None:
                    ids = _host_ids(output_nodes)
                    y = _native.gather_rows(labels.reshape(len(labels), -1),
                                            ids)
                    out.append(torch.from_numpy(
                        y.reshape((len(ids),) + labels.shape[1:])).to(
                        store.device))
                if not put(tuple(out)):
                    return
        except BaseException as exc:  # re-raised in the consumer
            put(exc)
            return
        put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        while not q.empty():
            q.get_nowait()
        t.join(timeout=5.0)
