"""GraphSAINT training (the reference's ``examples/train_saint.py``): a
subgraph-sampled GCN with the paper's loss normalisation. Usage:

    python -m dgl1_tpu_torch.examples.train_saint [--mode node|edge|walk]
        [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import NO_GATE, Stepper, first_of, run
from dgl1_tpu_torch.examples.train_gcn import (citation_graph, evaluate,
                                               node_data)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--mode", default="node", choices=["node", "edge", "walk"])
    p.add_argument("--budget", type=int, default=512)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batches-per-epoch", type=int, default=8)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class Net(nn.Module):
    """``l0`` (GraphConv) -> relu -> ``l1`` (GraphConv)."""

    def __init__(self, in_f, hidden, classes, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import GraphConv

        self.l0 = GraphConv(in_f, hidden, device=device, generator=generator)
        self.l1 = GraphConv(hidden, classes, device=device,
                            generator=generator)

    def forward(self, g, x, generator=None):
        return self.l1(g, torch.relu(self.l0(g, x)))


def build(args, device):
    from dgl1_tpu_torch.dataloading import SAINTSampler

    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    budget = ((args.budget // 8, 4) if args.mode == "walk"
              else args.budget)
    data["sampler"] = SAINTSampler(g, args.mode, budget,
                                   num_batches=args.batches_per_epoch,
                                   seed=0, device=device)
    # The script takes its first batch to give its model shapes; the draw
    # advances the sampler's stream, so it is made here too.
    first_of(data["sampler"])
    model = Net(data["feat"].shape[1], args.hidden, data["num_classes"],
                device=device, generator=torch.Generator().manual_seed(0))
    return data, model


def first_batch(args, data, device):
    return first_of(data["sampler"])


def step_loss(args, data, model, batch):
    """Cross entropy weighted by ``loss_norm`` over the batch's real
    training nodes."""
    sg, mask = batch
    logp = torch.log_softmax(model(sg, sg.ndata["feat"]), dim=1)
    ce = -logp.gather(1, sg.ndata["label"].long()[:, None])[:, 0]
    n = data["g"].num_nodes()
    tm = data["masks"]["train"][sg.ndata["_ID"].long().clamp(0, n - 1)]
    w = sg.ndata["loss_norm"] * mask * tm
    return (ce * w).sum() / w.sum().clamp_min(1e-6)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    best_val = best_test = 0.0
    for epoch in range(args.epochs):
        losses = []
        for batch in data["sampler"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            losses.append(st.done(loss))
        if (epoch + 1) % 5 == 0 or epoch == 0:
            _, va, te = evaluate(model, data)
            model.train()
            if va > best_val:
                best_val, best_test = va, te
            print(f"epoch {epoch + 1:3d} loss {np.mean(losses):.4f} "
                  f"val {va:.4f} test {te:.4f}")
    print(f"done in {sum(st.step_ms) / 1e3:.1f}s; best val {best_val:.4f} "
          f"test@best-val {best_test:.4f}")
    return st.metrics(val=best_val, test=best_test)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
