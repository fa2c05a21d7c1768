"""Point-cloud classification with DGCNN, EdgeConv on kNN graphs (the
reference's ``examples/train_pointcloud.py``): synthetic clouds of four
shape families (sphere, cube surface, disk, helix), randomly rotated;
each step batches 24 clouds' kNN graphs with ``batch``. Usage:

    python -m dgl1_tpu_torch.examples.train_pointcloud [--epochs 30]
        [--cpu]
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
REFERENCE_NAMES = {"EdgeConv_0": "conv1", "EdgeConv_1": "conv2",
                   "Dense_0": "fc", "Dense_1": "out"}
N_CLASSES = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--clouds", type=int, default=240)
    p.add_argument("--points", type=int, default=96)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--min-acc", type=float, default=0.85)
    return p.parse_args(argv)


def make_cloud(kind: int, n: int, rng):
    """``n`` points of shape family ``kind``, randomly rotated (the
    script's draws, in its order)."""
    if kind == 0:  # sphere surface
        v = rng.normal(size=(n, 3))
        pts = v / np.linalg.norm(v, axis=1, keepdims=True)
    elif kind == 1:  # cube surface
        pts = rng.uniform(-1, 1, size=(n, 3))
        ax = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), ax] = sign
    elif kind == 2:  # flat disk
        r = np.sqrt(rng.uniform(0, 1, n))
        th = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack([r * np.cos(th), r * np.sin(th),
                        0.05 * rng.normal(size=n)], axis=1)
    else:  # helix
        t = rng.uniform(0, 4 * np.pi, n)
        pts = np.stack([np.cos(t), np.sin(t), t / (2 * np.pi) - 1],
                       axis=1) + 0.05 * rng.normal(size=(n, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (pts @ q).astype(np.float32)


class DGCNN(nn.Module):
    """The script's model (``examples/train_pointcloud.py:87-100``): two
    EdgeConvs, a max readout, an MLP."""

    def __init__(self, hidden: int, classes: int, device=None,
                 generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import EdgeConv
        from dgl1_tpu_torch.nn.conv import dense

        kw = dict(device=device, generator=generator)
        self.conv1 = EdgeConv(3, hidden, **kw)
        self.conv2 = EdgeConv(hidden, hidden, **kw)
        self.fc = dense(hidden, hidden, True, **kw)
        self.out = dense(hidden, classes, True, **kw)

    def forward(self, g, pos):
        from dgl1_tpu_torch.readout import readout_nodes

        h = torch.relu(self.conv2(g, torch.relu(self.conv1(g, pos))))
        hg = torch.relu(self.fc(readout_nodes(g, h, op="max")))
        return self.out(hg)


def build(args, device):
    import dgl1_tpu_torch as dgl

    rng = np.random.default_rng(0)
    clouds = [make_cloud(i % N_CLASSES, args.points, rng)
              for i in range(args.clouds)]
    labels = np.arange(args.clouds) % N_CLASSES
    graphs = [dgl.knn_graph(c, args.k, device=device) for c in clouds]
    n_train = int(0.75 * args.clouds)
    perm = rng.permutation(args.clouds)
    model = DGCNN(args.hidden, N_CLASSES, device=device,
                  generator=torch.Generator().manual_seed(0))
    return dict(clouds=clouds, labels=labels, graphs=graphs, rng=rng,
                train_ids=perm[:n_train], test_ids=perm[n_train:],
                device=device), model


def make_batch(data, ids):
    """The clouds ``ids`` as one batched graph, their points and labels."""
    import dgl1_tpu_torch as dgl

    dev = data["device"]
    bg = dgl.batch([data["graphs"][i] for i in ids], device=dev)
    pos = torch.as_tensor(np.concatenate([data["clouds"][i] for i in ids]),
                          device=dev)
    return bg, pos, torch.as_tensor(data["labels"][ids], device=dev)


def first_batch(args, data, device):
    return make_batch(data, data["train_ids"][: args.batch_size])


def step_loss(args, data, model, batch):
    g, pos, y = batch
    return torch.nn.functional.cross_entropy(model(g, pos), y)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    rng, train_ids = data["rng"], data["train_ids"]
    bs = args.batch_size
    steps = max(len(train_ids) // bs, 1)
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        ep_perm = rng.permutation(train_ids)
        tot = 0.0
        for s in range(steps):
            ids = ep_perm[s * bs:(s + 1) * bs]
            if len(ids) < bs:
                continue
            batch = make_batch(data, ids)
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            tot += st.done(loss)
        if epoch % 5 == 0 or epoch == 1:
            print(f"epoch {epoch:3d} loss {tot / steps:.4f}")
    dt = time.perf_counter() - t0
    hits = total = 0
    test_ids = data["test_ids"]
    with torch.no_grad():
        for s in range(0, len(test_ids), bs):
            g, pos, y = make_batch(data, test_ids[s: s + bs])
            hits += int((model(g, pos).argmax(dim=-1) == y).sum())
            total += len(y)
    acc = hits / total
    print(f"done in {dt:.1f}s; test acc {acc:.4f} ({total} clouds)")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    if metrics["test"] < args.min_acc:
        raise SystemExit(f"gate failed: {metrics['test']:.4f} < "
                         f"{args.min_acc}")
    return f"gate passed: test acc {metrics['test']:.4f} >= {args.min_acc}"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
