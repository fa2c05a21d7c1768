"""Negative edge sampling (the port's ``dgl1_tpu/sampling/negative.py``):
``global_uniform_negative_sampling``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import Graph

__all__ = ["global_uniform_negative_sampling"]


def global_uniform_negative_sampling(
        g: Graph, num_samples: int, exclude_self_loops: bool = True,
        max_trials: int = 8, rng: Optional[np.random.Generator] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Up to ``num_samples`` (src, dst) pairs that are not edges of ``g``,
    by rejection (``dgl.sampling.global_uniform_negative_sampling``): each
    trial draws twice the pairs still needed, uniform over the source and
    destination nodes, and keeps them in order. Returns int64 numpy
    arrays."""
    rng = rng or dgl_random.default_rng()
    n = g.num_src_nodes()
    e = g.num_edges()
    src, dst = g.edges()
    existing = set(zip(src[:e].tolist(), dst[:e].tolist()))
    out_s, out_d = [], []
    need = num_samples
    for _ in range(max_trials):
        if need <= 0:
            break
        s = rng.integers(0, n, size=2 * need)
        d = rng.integers(0, g.num_dst_nodes(), size=2 * need)
        for a, b in zip(s.tolist(), d.tolist()):
            if need <= 0:
                break
            if exclude_self_loops and a == b:
                continue
            if (a, b) in existing:
                continue
            out_s.append(a)
            out_d.append(b)
            need -= 1
    return (np.asarray(out_s, dtype=np.int64),
            np.asarray(out_d, dtype=np.int64))
