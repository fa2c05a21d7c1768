"""Point-cloud graph builders as modules (the port's
``dgl1_tpu/nn/factory.py``): ``KNNGraph`` and ``SegmentedKNNGraph`` over
:func:`dgl1_tpu_torch.transform.knn_graph`."""

from __future__ import annotations

from dgl1_tpu_torch.graph import resolve_device
from dgl1_tpu_torch.transform import knn_graph, segmented_knn_graph

__all__ = ["KNNGraph", "SegmentedKNNGraph"]


class KNNGraph:
    """``KNNGraph(k)(x)``: the kNN graph of (N, D) points or of each cloud
    of (B, N, D), built on ``device`` (default ``cuda``)."""

    def __init__(self, k: int, device=None):
        self.k, self.device = k, resolve_device(device)

    def __call__(self, x):
        return knn_graph(x, self.k, device=self.device)


class SegmentedKNNGraph:
    """``SegmentedKNNGraph(k)(x, segs)``: kNN graphs within the segments of
    a packed point set."""

    def __init__(self, k: int, device=None):
        self.k, self.device = k, resolve_device(device)

    def __call__(self, x, segs):
        return segmented_knn_graph(x, self.k, segs, device=self.device)
