"""Heterogeneous node classification with ``HeteroGraphConv`` (the
reference's ``examples/train_hetero.py``): a synthetic user-item
bipartite graph whose user labels follow the items they interact with.
Usage:

    python -m dgl1_tpu_torch.examples.train_hetero [--epochs 100] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import NO_GATE, Stepper, masked_ce, run

N_USERS, N_ITEMS, N_CLASSES, N_INTER = 1000, 200, 4, 8000


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class HeteroGCN(nn.Module):
    """Two ``HeteroGraphConv`` layers of ``GraphConv(norm='right')``
    (``l1``, ``l2``), relu between them; the users' logits."""

    def __init__(self, in_feats: dict, hidden, classes, device=None,
                 generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import GraphConv, HeteroGraphConv

        def conv(i, o):
            return GraphConv(i, o, norm="right", device=device,
                             generator=generator)

        self.l1 = HeteroGraphConv({
            "clicks": conv(in_feats["user"], hidden),
            "clicked_by": conv(in_feats["item"], hidden)})
        self.l2 = HeteroGraphConv({"clicks": conv(hidden, hidden),
                                   "clicked_by": conv(hidden, classes)})

    def forward(self, hg, x):
        h = {k: torch.relu(v) for k, v in self.l1(hg, x).items()}
        return self.l2(hg, h)["user"]


def build(args, device):
    import dgl1_tpu_torch as dgl

    rng = np.random.default_rng(0)
    item_class = rng.integers(0, N_CLASSES, size=N_ITEMS)
    # Each user prefers one class of items.
    user_label = rng.integers(0, N_CLASSES, size=N_USERS)
    u = rng.integers(0, N_USERS, size=N_INTER)
    prefer = rng.random(N_INTER) < 0.8
    own = np.asarray([rng.choice(np.nonzero(item_class == c)[0])
                      for c in user_label[u]])
    it = np.where(prefer, own, rng.integers(0, N_ITEMS, size=N_INTER))
    hg = dgl.heterograph({
        ("user", "clicks", "item"): (u, it),
        ("item", "clicked_by", "user"): (it, u),
    }, num_nodes_dict={"user": N_USERS, "item": N_ITEMS}, device=device)
    feats = {
        "user": rng.normal(size=(N_USERS, 16)).astype(np.float32),
        "item": (np.eye(N_CLASSES)[item_class] + 0.5 * rng.normal(
            size=(N_ITEMS, N_CLASSES))).astype(np.float32),
    }
    train_mask = np.zeros(N_USERS, dtype=bool)
    train_mask[rng.choice(N_USERS, size=200, replace=False)] = True
    data = dict(hg=hg, feats={k: torch.as_tensor(v, device=device)
                              for k, v in feats.items()},
                labels=torch.as_tensor(user_label, device=device),
                train_mask=torch.as_tensor(train_mask, device=device))
    model = HeteroGCN({k: v.shape[1] for k, v in feats.items()},
                      args.hidden, N_CLASSES, device=device,
                      generator=torch.Generator().manual_seed(0))
    return data, model


def step_loss(args, data, model, batch=None):
    return masked_ce(model(data["hg"], data["feats"]), data["labels"],
                     data["train_mask"])


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    acc = None
    test = ~data["train_mask"]
    for epoch in range(args.epochs):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 20 == 0 or epoch == 0:
            with torch.no_grad():
                pred = model(data["hg"], data["feats"]).argmax(dim=1)
            acc = float((pred[test] == data["labels"][test]).float().mean())
            print(f"epoch {epoch + 1:3d} loss {loss:.4f} "
                  f"test acc {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
