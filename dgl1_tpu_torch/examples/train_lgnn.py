"""LGNN community detection on SBM mixtures (the reference's
``examples/train_lgnn.py``): a line-graph GNN, one graph a step, the loss
the minimum over the relabelings of the communities. Usage:

    python -m dgl1_tpu_torch.examples.train_lgnn [--epochs 30] [--cpu]
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np
import torch

from dgl1_tpu_torch.examples import NO_GATE, Stepper, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--graphs", type=int, default=60)
    p.add_argument("--nodes", type=int, default=60)
    p.add_argument("--communities", type=int, default=2)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def build(args, device):
    from dgl1_tpu_torch.data import SBMMixtureDataset
    from dgl1_tpu_torch.models import LGNN

    ds = SBMMixtureDataset(args.graphs, args.nodes, args.communities,
                           avg_deg=8.0, pq=2.0, seed=0, device=device)
    print(f"[data] SBM mixture: {len(ds)} graphs, {args.nodes} nodes, "
          f"{args.communities} communities")
    model = LGNN(hidden=args.hidden, communities=args.communities,
                 device=device, generator=torch.Generator().manual_seed(0))
    perms = torch.as_tensor(np.asarray(list(itertools.permutations(
        range(args.communities)))), device=device)
    labels = [torch.as_tensor(ds.labels[i].astype(np.int64), device=device)
              for i in range(len(ds))]
    return dict(ds=ds, perms=perms, labels=labels,
                n_train=max(len(ds) - max(len(ds) // 6, 1), 1)), model


def first_batch(args, data, device):
    return 0


def step_loss(args, data, model, batch):
    """The mean cross entropy under the best relabeling of the
    communities (the minimum over the permutations)."""
    i = batch
    logp = torch.log_softmax(model(*data["ds"][i]), dim=-1)
    relabeled = data["perms"][:, data["labels"][i]]  # (P, N)
    ce = -logp.gather(1, relabeled.T).mean(dim=0)  # (P,)
    return ce.min()


@torch.no_grad()
def overlap(data, model, i) -> float:
    """The share of nodes right under the best relabeling."""
    pred = model(*data["ds"][i]).argmax(dim=1)
    hits = (data["perms"][:, pred] == data["labels"][i][None]).float()
    return float(hits.mean(dim=1).max())


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    n_train = data["n_train"]
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        total = 0.0
        for i in range(n_train):
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, i)
            loss.backward()
            opt.step()
            total += st.done(loss)
        print(f"epoch {epoch} loss {total / n_train:.4f} "
              f"({time.perf_counter() - t0:.2f}s)")
    acc = float(np.mean([overlap(data, model, i)
                         for i in range(n_train, len(data["ds"]))]))
    print(f"held-out community overlap: {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
