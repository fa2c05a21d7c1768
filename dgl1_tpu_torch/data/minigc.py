"""MiniGC, the synthetic graph-classification dataset (the port's
``dgl1_tpu/data/minigc.py``): 8 topology classes (cycle, star, wheel,
lollipop, hypercube, grid, clique, circular ladder), synthetic upstream
too, so both packages build the same graphs from one seed."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from dgl1_tpu_torch.data.base import host, to_tensor
from dgl1_tpu_torch.graph import Graph, graph, resolve_device
from dgl1_tpu_torch.transform import to_bidirected

__all__ = ["MiniGCDataset"]


def _cycle(n, rng):
    s = np.arange(n)
    return s, (s + 1) % n


def _star(n, rng):
    return np.zeros(n - 1, np.int64), np.arange(1, n)


def _wheel(n, rng):
    hub_s, hub_d = _star(n, rng)
    rim = np.arange(1, n)
    rim_d = np.concatenate([np.arange(2, n), [1]])
    return np.concatenate([hub_s, rim]), np.concatenate([hub_d, rim_d])


def _lollipop(n, rng):
    m = n // 2  # the clique's size
    cs, cd = np.meshgrid(np.arange(m), np.arange(m))
    mask = cs < cd
    s = list(cs[mask])
    d = list(cd[mask])
    for i in range(m - 1, n - 1):  # the path
        s.append(i)
        d.append(i + 1)
    return np.asarray(s), np.asarray(d)


def _hypercube(n, rng):
    dim = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    s, d = [], []
    for v in range(2 ** dim):
        for b in range(dim):
            u = v ^ (1 << b)
            if u > v:
                s.append(v)
                d.append(u)
    return np.asarray(s), np.asarray(d)


def _grid(n, rng):
    side = max(int(np.sqrt(n)), 2)
    s, d = [], []
    for i in range(side):
        for j in range(side):
            v = i * side + j
            if j + 1 < side:
                s.append(v)
                d.append(v + 1)
            if i + 1 < side:
                s.append(v)
                d.append(v + side)
    return np.asarray(s), np.asarray(d)


def _clique(n, rng):
    cs, cd = np.meshgrid(np.arange(n), np.arange(n))
    mask = cs < cd
    return cs[mask], cd[mask]


def _circular_ladder(n, rng):
    m = max(n // 2, 3)
    s = list(np.arange(m)) + list(np.arange(m) + m) + list(np.arange(m))
    d = (list((np.arange(m) + 1) % m) + list((np.arange(m) + 1) % m + m)
         + list(np.arange(m) + m))
    return np.asarray(s), np.asarray(d)


_GENERATORS = [_cycle, _star, _wheel, _lollipop, _hypercube, _grid, _clique,
               _circular_ladder]


class MiniGCDataset:
    """``MiniGCDataset(num_graphs, min_nv, max_nv, seed)``: (graph, label)
    pairs over the 8 classes, ``ndata['attr']`` each node's in-degree,
    graphs on ``device`` (default ``cuda``)."""

    num_classes = 8

    def __init__(self, num_graphs: int, min_nv: int = 10, max_nv: int = 20,
                 seed: int = 0, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.graphs: List[Graph] = []
        self.labels: List[int] = []
        for _ in range(num_graphs):
            cls = int(rng.integers(0, len(_GENERATORS)))
            n = int(rng.integers(min_nv, max_nv + 1))
            s, d = _GENERATORS[cls](n, rng)
            g = to_bidirected(graph((s, d), device=dev))
            g.ndata["attr"] = to_tensor(
                host(g.in_degrees()).astype(np.float32)[:, None], dev)
            self.graphs.append(g)
            self.labels.append(cls)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, int]:
        return self.graphs[i], self.labels[i]
