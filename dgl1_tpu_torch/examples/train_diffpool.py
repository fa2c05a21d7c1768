"""DiffPool graph classification on MiniGC (the reference's
``examples/train_diffpool.py``): a ``DenseSAGEConv`` embed branch and an
assignment branch; the soft assignment S coarsens each graph (A' = SᵀAS,
X' = SᵀZ) before a second embed and a mean-and-max readout. Graphs are
dense adjacencies padded to the largest graph, with a node mask; every
step is one batch of all the training graphs. Usage:

    python -m dgl1_tpu_torch.examples.train_diffpool [--epochs 300] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import Stepper, run

# The reference's flax names -> the port's.
REFERENCE_NAMES = {"Dense_0": "fc", "Dense_1": "out"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-graphs", type=int, default=400)
    p.add_argument("--min-nv", type=int, default=10)
    p.add_argument("--max-nv", type=int, default=20)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--clusters", type=int, default=6)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class DiffPool(nn.Module):
    """The script's model (``examples/train_diffpool.py:64-77``), batched
    over the leading axis of ``adj`` (B, N, N), ``x`` (B, N, 2) and
    ``mask`` (B, N)."""

    def __init__(self, hidden: int, clusters: int, classes: int,
                 device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import DenseSAGEConv
        from dgl1_tpu_torch.nn.conv import dense

        kw = dict(device=device, generator=generator)
        self.embed1 = DenseSAGEConv(2, hidden, **kw)
        self.assign1 = DenseSAGEConv(2, clusters, **kw)
        self.embed2 = DenseSAGEConv(hidden, hidden, **kw)
        self.fc = dense(2 * hidden, hidden, True, **kw)
        self.out = dense(hidden, classes, True, **kw)

    def forward(self, adj, x, mask):
        z = torch.relu(self.embed1(adj, x))
        # Padded nodes must not contribute to any cluster.
        s = torch.softmax(self.assign1(adj, x), dim=-1) * mask[..., None]
        a2 = torch.einsum("bnk,bnm,bml->bkl", s, adj, s)
        x2 = torch.einsum("bnk,bnf->bkf", s, z)
        z2 = torch.relu(self.embed2(a2, x2))
        h = torch.cat([z2.mean(dim=1), z2.amax(dim=1)], dim=-1)
        return self.out(torch.relu(self.fc(h)))


def dense_arrays(ds, max_nv: int):
    """Every graph as a dense (N, N) adjacency (row = destination), its
    features [in-degree / (max_nv - 1), 1] and node mask, padded to the
    largest graph N."""
    n_max = max(ds[i][0].num_nodes() for i in range(len(ds)))
    adjs = np.zeros((len(ds), n_max, n_max), np.float32)
    feats = np.zeros((len(ds), n_max, 2), np.float32)
    masks = np.zeros((len(ds), n_max), np.float32)
    labels = np.zeros((len(ds),), np.int64)
    for i in range(len(ds)):
        g, y = ds[i]
        n = g.num_nodes()
        src, dst = (t.cpu().numpy() for t in g.edges())
        adjs[i, dst, src] = 1.0
        feats[i, :n, 0] = g.in_degrees().cpu().numpy() / max(max_nv - 1, 1)
        feats[i, :n, 1] = 1.0
        masks[i, :n] = 1.0
        labels[i] = y
    return adjs, feats, masks, labels


def build(args, device):
    from dgl1_tpu_torch.data import MiniGCDataset

    ds = MiniGCDataset(args.num_graphs, args.min_nv, args.max_nv, seed=0,
                       device="cpu")
    adjs, feats, masks, labels = dense_arrays(ds, args.max_nv)
    perm = np.random.default_rng(0).permutation(len(ds))
    n_train = int(0.8 * len(ds))
    model = DiffPool(args.hidden, args.clusters, ds.num_classes,
                     device=device,
                     generator=torch.Generator().manual_seed(0))
    data = {k: torch.as_tensor(v, device=device) for k, v in
            dict(adj=adjs, x=feats, m=masks, y=labels).items()}
    data["tr"] = torch.as_tensor(perm[:n_train], device=device)
    data["te"] = torch.as_tensor(perm[n_train:], device=device)
    return data, model


def logits(data, model, ix):
    return model(data["adj"][ix], data["x"][ix], data["m"][ix])


def step_loss(args, data, model, batch=None):
    """The mean cross entropy over every training graph."""
    return torch.nn.functional.cross_entropy(
        logits(data, model, data["tr"]), data["y"][data["tr"]])


@torch.no_grad()
def accuracy(data, model, ix) -> float:
    pred = logits(data, model, ix).argmax(dim=1)
    return float((pred == data["y"][ix]).float().mean())


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 50 == 0 or epoch == 0:
            print(f"epoch {epoch + 1:4d} loss {loss:.4f} train acc "
                  f"{accuracy(data, model, data['tr']):.3f} test acc "
                  f"{accuracy(data, model, data['te']):.3f}")
    acc = accuracy(data, model, data["te"])
    print(f"done in {time.perf_counter() - t0:.1f}s; test acc {acc:.3f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    """8 classes, chance 0.125: the test accuracy must reach 0.5."""
    if metrics["test"] < 0.5:
        raise SystemExit(f"SIGNAL GATE FAILED: DiffPool test acc "
                         f"{metrics['test']:.3f}")
    return "signal gate passed"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
