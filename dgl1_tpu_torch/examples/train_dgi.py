"""Deep Graph Infomax pretraining and a linear probe (the reference's
``examples/train_dgi.py``): DGI on Cora, then a logistic regression on
the frozen embeddings. Usage:

    python -m dgl1_tpu_torch.examples.train_dgi [--epochs 150] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dgl1_tpu_torch.examples import NO_GATE, Stepper, masked_ce, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--probe-epochs", type=int, default=150)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models.dgi import DGI

    ds = dgl.data.CoraGraphDataset(device=device)
    g = dgl.add_self_loop(ds[0])
    print(f"[data] cora{'(synthetic)' if ds.is_synthetic else ''}: "
          f"{g.num_nodes()} nodes")
    rng = np.random.default_rng(0)
    rng.permutation(g.num_nodes())  # the script's init permutation
    feat = g.ndata["feat"]
    model = DGI(feat.shape[1], args.hidden, device=device,
                generator=torch.Generator().manual_seed(0))
    return dict(g=g, feat=feat, labels=g.ndata["label"], rng=rng,
                train_mask=g.ndata["train_mask"],
                test_mask=g.ndata["test_mask"]), model


def first_batch(args, data, device):
    """The corruption's permutation, the next of the data's stream."""
    return torch.as_tensor(data["rng"].permutation(data["g"].num_nodes()),
                           device=device)


def step_loss(args, data, model, batch):
    return model(data["g"], data["feat"], batch)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    for epoch in range(args.epochs):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model,
                         first_batch(args, data, device))
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 50 == 0:
            print(f"epoch {epoch + 1} dgi loss {loss:.4f}")

    # Linear probe on the frozen embeddings: zero-initialised weights,
    # Adam 1e-2, full batch over the train mask.
    with torch.no_grad():
        emb = model.embed(data["g"], data["feat"])
    classes = int(data["labels"].max()) + 1
    w = torch.zeros(emb.shape[1], classes, device=device, requires_grad=True)
    b = torch.zeros(classes, device=device, requires_grad=True)
    popt = torch.optim.Adam([w, b], lr=1e-2)
    for _ in range(args.probe_epochs):
        popt.zero_grad(set_to_none=True)
        masked_ce(emb @ w + b, data["labels"], data["train_mask"]).backward()
        popt.step()
    with torch.no_grad():
        pred = (emb @ w + b).argmax(dim=1)
    m = data["test_mask"]
    acc = float((pred[m] == data["labels"][m].long()).float().mean())
    print(f"linear-probe test acc on DGI embeddings: {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
