"""GGNN on a bAbI-style reachability task (the reference's
``examples/train_ggnn.py``): random directed graphs with two edge types
and a marked source; every node is labelled reachable or not over type-0
edges. ``GatedGraphConv`` routes the annotation along typed edges (its
per-type weights through ``gather_mm``); one graph a step. Usage:

    python -m dgl1_tpu_torch.examples.train_ggnn [--epochs 60] [--cpu]
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
REFERENCE_NAMES = {"GatedGraphConv_0": "ggc", "Dense_0": "fc",
                   "Dense_1": "out"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-graphs", type=int, default=256)
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--edges", type=int, default=28)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def gen_task(rng, n_graphs, n_nodes, n_edges, n_steps):
    """Directed random graphs, 2 edge types; label = reachability from a
    random source within ``n_steps`` hops over type-0 edges (the
    script's draws, in its order)."""
    srcs = rng.integers(0, n_nodes, size=(n_graphs, n_edges))
    dsts = rng.integers(0, n_nodes, size=(n_graphs, n_edges))
    etypes = rng.integers(0, 2, size=(n_graphs, n_edges))
    roots = rng.integers(0, n_nodes, size=n_graphs)
    labels = np.zeros((n_graphs, n_nodes), np.int64)
    for i in range(n_graphs):
        reach = np.zeros(n_nodes, bool)
        reach[roots[i]] = True
        s, d = srcs[i], dsts[i]
        keep = etypes[i] == 0
        for _ in range(n_steps):
            reach[d[reach[s] & keep]] = True
        labels[i] = reach
    return srcs, dsts, etypes, roots, labels


class GGNN(nn.Module):
    """The script's model (``examples/train_ggnn.py:91-101``): the gated
    conv, then an MLP over ``[h, annotation]`` (Li et al. eq. 7)."""

    def __init__(self, hidden: int, n_steps: int, device=None,
                 generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import GatedGraphConv
        from dgl1_tpu_torch.nn.conv import dense

        kw = dict(device=device, generator=generator)
        self.ggc = GatedGraphConv(1, hidden, n_steps=n_steps, n_etypes=2,
                                  **kw)
        self.fc = dense(hidden + 1, hidden, True, **kw)
        self.out = dense(hidden, 2, True, **kw)

    def forward(self, g, feat, et):
        h = torch.cat([self.ggc(g, feat, et), feat], dim=-1)
        return self.out(torch.relu(self.fc(h)))


def build(args, device):
    import dgl1_tpu_torch as dgl

    rng = np.random.default_rng(0)
    srcs, dsts, etypes, roots, labels = gen_task(
        rng, args.num_graphs, args.nodes, args.edges, args.steps)
    print(f"[data] bAbI-style reachability: {args.num_graphs} graphs, "
          f"{args.nodes} nodes, {args.edges} typed edges, "
          f"positive rate {labels.mean():.2f}")
    graphs = [dgl.graph((srcs[i], dsts[i]), num_nodes=args.nodes,
                        device=device) for i in range(args.num_graphs)]
    x = np.zeros((args.num_graphs, args.nodes, 1), np.float32)
    x[np.arange(args.num_graphs), roots, 0] = 1.0
    model = GGNN(args.hidden, args.steps + 1, device=device,
                 generator=torch.Generator().manual_seed(0))
    return dict(graphs=graphs, n_train=int(0.8 * args.num_graphs),
                x=torch.as_tensor(x, device=device),
                et=torch.as_tensor(etypes, device=device),
                y=torch.as_tensor(labels, device=device)), model


def first_batch(args, data, device):
    return 0


def step_loss(args, data, model, batch):
    """The mean cross entropy over the nodes of graph ``batch``."""
    i = batch
    logits = model(data["graphs"][i], data["x"][i], data["et"][i])
    return torch.nn.functional.cross_entropy(logits, data["y"][i])


@torch.no_grad()
def accuracy(data, model, i) -> float:
    logits = model(data["graphs"][i], data["x"][i], data["et"][i])
    return float((logits.argmax(-1) == data["y"][i]).float().mean())


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    n_train = data["n_train"]
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        tot = 0.0
        for i in range(n_train):
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, i)
            loss.backward()
            opt.step()
            tot += st.done(loss)
        if epoch % 10 == 0 or epoch == 1:
            print(f"epoch {epoch:3d} loss {tot / n_train:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    acc = float(np.mean([accuracy(data, model, i)
                         for i in range(n_train, args.num_graphs)]))
    print(f"[ggnn] test node accuracy {acc:.3f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    if not metrics["test"] > 0.9:
        raise SystemExit(f"gate failed: acc {metrics['test']:.3f} <= 0.9")
    return "gate passed: accuracy > 0.9"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
