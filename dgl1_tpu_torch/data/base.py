"""Dataset base class (the port's ``dgl1_tpu/data/base.py``)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dgl1_tpu_torch.data.serialize import load_graphs, save_graphs
from dgl1_tpu_torch.graph import resolve_device

__all__ = ["GraphDataset", "data_dir"]


def data_dir() -> Path:
    """``DGL1_TPU_DATA_DIR``, or ``~/.dgl1_tpu``: the reference's data
    directory, so both packages share raw files and caches."""
    return Path(os.environ.get("DGL1_TPU_DATA_DIR",
                               os.path.expanduser("~/.dgl1_tpu")))


def to_tensor(arr, device) -> torch.Tensor:
    """A host array as a tensor of its dtype on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class GraphDataset:
    """Load-or-generate dataset base.

    Subclasses implement ``_generate() -> (graphs, labels_dict)`` (the
    synthetic fallback) and may implement ``_has_raw()``/``_load_raw()``
    to parse real raw files. The processed graphs are cached in
    ``raw_dir/{name}_processed.npz`` with :func:`save_graphs` (the
    reference's file, so either package loads the other's cache), with
    ``labels['__synthetic__']`` flagging a fallback. Graphs are placed on
    ``device`` (default ``cuda``)."""

    name: str = "dataset"

    def __init__(self, raw_dir: Optional[str] = None,
                 force_reload: bool = False, verbose: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.raw_dir = Path(raw_dir) if raw_dir else data_dir() / self.name
        self.verbose = verbose
        self.is_synthetic = False
        cache = self.raw_dir / f"{self.name}_processed.npz"
        if cache.exists() and not force_reload:
            self.graphs, self.labels = load_graphs(str(cache),
                                                   device=self.device)
            flag = self.labels.get("__synthetic__")
            self.is_synthetic = bool(flag[0]) if flag is not None else False
            return
        if self._has_raw():
            self.graphs, self.labels = self._load_raw()
        else:
            self.graphs, self.labels = self._generate()
            self.is_synthetic = True
        try:
            self.raw_dir.mkdir(parents=True, exist_ok=True)
            labels = dict(self.labels)
            labels["__synthetic__"] = np.asarray([int(self.is_synthetic)])
            save_graphs(str(cache), self.graphs, labels)
        except OSError:
            pass  # the cache is best-effort

    def _has_raw(self) -> bool:
        return False

    def _load_raw(self):
        raise NotImplementedError

    def _generate(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]
