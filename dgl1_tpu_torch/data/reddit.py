"""Reddit (the port's ``dgl1_tpu/data/reddit.py``).

The reference's raw files (``reddit_data.npz``: feature, label and
node_types arrays; ``reddit_graph.npz``: the scipy CSR adjacency) are
parsed when present; otherwise a flagged synthetic SBM from the
reference's seed. The real Reddit has 232,965 nodes, 114M edges, 602
features and 41 classes; ``full_scale=True`` gives a synthetic of that
node count (average degree 50 before the reverse edges).
"""

from __future__ import annotations

import numpy as np

from dgl1_tpu_torch.data.base import GraphDataset, to_tensor
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph

__all__ = ["RedditDataset"]


class RedditDataset(GraphDataset):
    name = "reddit"
    num_classes = 41

    def __init__(self, full_scale: bool = False, **kw):
        self.full_scale = full_scale
        if full_scale:
            self.name = "reddit_full"
        super().__init__(**kw)

    def _has_raw(self) -> bool:
        return ((self.raw_dir / "reddit_data.npz").exists()
                and (self.raw_dir / "reddit_graph.npz").exists())

    def _load_raw(self):
        """``RedditDataset.process``: node_types 1/2/3 are the train, val
        and test splits."""
        from scipy import sparse as sp

        from dgl1_tpu_torch.graph import from_scipy

        data = np.load(self.raw_dir / "reddit_data.npz")
        adj = sp.load_npz(self.raw_dir / "reddit_graph.npz")
        g = from_scipy(adj, device=self.device)
        dev = g.device
        types = data["node_types"]
        g.ndata["feat"] = to_tensor(data["feature"].astype(np.float32), dev)
        g.ndata["label"] = to_tensor(data["label"].astype(np.int32), dev)
        g.ndata["train_mask"] = to_tensor(types == 1, dev)
        g.ndata["val_mask"] = to_tensor(types == 2, dev)
        g.ndata["test_mask"] = to_tensor(types == 3, dev)
        return [g], {}

    def _generate(self):
        scale = 1 if self.full_scale else 10
        g = synthetic_classification_graph(
            num_nodes=232965 // scale, num_classes=41, feat_dim=602,
            avg_degree=50.0 if self.full_scale else 25.0,
            train_per_class=2000 // scale or 20, num_val=2000,
            num_test=5000, seed=41, device=self.device)
        return [g], {}
