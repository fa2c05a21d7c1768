"""Graph classification with GIN over ``GraphDataLoader`` (the
reference's ``examples/train_graph_classification.py``: 400 MiniGC
graphs, 8 classes, padded batches). Usage:

    python -m dgl1_tpu_torch.examples.train_graph_classification
        [--epochs 20] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dgl1_tpu_torch.examples import (NO_GATE, Stepper, first_of, masked_ce,
                                     run)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-graphs", type=int, default=400)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def build(args, device):
    from dgl1_tpu_torch.data import MiniGCDataset, split_dataset
    from dgl1_tpu_torch.dataloading import GraphDataLoader
    from dgl1_tpu_torch.models import GIN

    ds = MiniGCDataset(args.num_graphs, 10, 20, device="cpu")
    train_ds, test_ds = split_dataset(ds, (0.8, 0.2), shuffle=True,
                                      random_state=0)
    print(f"[data] MiniGC: {len(ds)} graphs, 8 classes")
    loader = GraphDataLoader(train_ds, batch_size=args.batch_size,
                             shuffle=True, seed=0, device=device)
    test_loader = GraphDataLoader(test_ds, batch_size=args.batch_size,
                                  shuffle=False, device=device)
    # The script draws one batch to initialise its model: that advances
    # the loader's shuffle stream by one epoch's permutation.
    first_of(loader)
    model = GIN(1, args.hidden, 8, num_layers=4, device=device,
                generator=torch.Generator().manual_seed(0))
    return dict(loader=loader, test_loader=test_loader), model


def logits(model, bg):
    """The logits of every graph of the batch, the padding graph's
    included (the degree feature scaled into unit range)."""
    return model(bg, bg.ndata["attr"] / 10.0)


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    """The cross entropy over the batch's real graphs."""
    bg, y, mask = batch
    return masked_ce(logits(model, bg)[: y.shape[0]], y, mask, floor=1.0)


@torch.no_grad()
def test_accuracy(args, data, model) -> float:
    correct = total = 0
    for bg, y, mask in data["test_loader"]:
        pred = logits(model, bg)[: args.batch_size].argmax(dim=1)
        correct += int(((pred == y) & mask).sum())
        total += int(mask.sum())
    return correct / max(total, 1)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    model.eval()  # the script applies GIN deterministically
    acc = None
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tot = nb = 0
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            tot += st.done(loss)
            nb += 1
        dt = time.perf_counter() - t0
        if (epoch + 1) % 5 == 0 or epoch == 0:
            acc = test_accuracy(args, data, model)
            print(f"epoch {epoch + 1:3d} loss {tot / max(nb, 1):.4f} "
                  f"test acc {acc:.4f} ({dt:.2f}s)")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
