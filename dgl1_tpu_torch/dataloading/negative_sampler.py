"""Negative samplers for link prediction (the port's
``dgl1_tpu/dataloading/negative_sampler.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import Graph

__all__ = ["Uniform", "PerSourceUniform"]


class Uniform:
    """For each positive edge, ``k`` negatives that keep its source and
    draw a destination uniformly (``negative_sampler.Uniform``). Returns
    int64 numpy ``(neg_src, neg_dst)``."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, g: Graph, eids,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or dgl_random.default_rng()
        eids = np.asarray(eids, dtype=np.int64)
        src = g.src.cpu().numpy()[eids]
        neg_src = np.repeat(src, self.k)
        neg_dst = rng.integers(0, g.num_dst_nodes(), size=len(neg_src),
                               dtype=np.int64)
        return neg_src, neg_dst


# The reference's Uniform is per source.
PerSourceUniform = Uniform
