"""Dataset utilities (the port's ``dgl1_tpu/data/utils.py``):
``split_dataset`` and ``Subset``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["Subset", "split_dataset"]


class Subset:
    """A view of ``dataset`` at ``indices`` (``dgl.data.utils.Subset``)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def split_dataset(dataset, frac_list=(0.8, 0.1, 0.1), shuffle: bool = False,
                  random_state: int = 0):
    """Train/val/test ``Subset``s (``dgl.data.utils.split_dataset``): the
    fractions' floors, the last part taking the rest; with ``shuffle`` the
    order is ``default_rng(random_state)``'s shuffle."""
    frac = np.asarray(frac_list, dtype=np.float64)
    if not np.isclose(frac.sum(), 1.0):
        raise ValueError(f"frac_list must sum to 1, got {frac_list}")
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(random_state).shuffle(idx)
    lengths = (frac * n).astype(np.int64)
    lengths[-1] = n - lengths[:-1].sum()
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, idx[start:start + ln].tolist()))
        start += ln
    return out
