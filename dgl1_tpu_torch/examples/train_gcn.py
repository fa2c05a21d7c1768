"""Full-graph GCN training (the reference's ``examples/train_gcn.py``:
a 2-layer GCN on Cora). Usage:

    python -m dgl1_tpu_torch.examples.train_gcn [--dataset cora]
        [--epochs 200] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from dgl1_tpu_torch.examples import (Stepper, accuracy, literature_gate,
                                     masked_ce, run)

# Kipf & Welling 2017: Cora 81.5 / Citeseer 70.3 / Pubmed 79.0, less 0.01.
GATES = {"cora": 0.815, "citeseer": 0.703, "pubmed": 0.790}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--metrics", default=None, help="jsonl metrics path")
    return p.parse_args(argv)


def citation_graph(args, device):
    """The dataset and its graph with self-loops made exactly one a
    node, as the citation scripts take it."""
    import dgl1_tpu_torch as dgl

    ds = {"cora": dgl.data.CoraGraphDataset,
          "citeseer": dgl.data.CiteseerGraphDataset,
          "pubmed": dgl.data.PubmedGraphDataset}[args.dataset](device=device)
    g = ds[0]
    if ds.is_synthetic:
        print(f"[data] {args.dataset}: synthetic fallback "
              f"({g.num_nodes()} nodes, {g.num_edges()} edges)")
    return ds, dgl.add_self_loop(dgl.remove_self_loop(g))


def node_data(ds, g) -> dict:
    labels = g.ndata["label"]
    return dict(ds=ds, g=g, feat=g.ndata["feat"], labels=labels,
                masks={k: g.ndata[f"{k}_mask"]
                       for k in ("train", "val", "test")},
                num_classes=int(labels.max()) + 1)


def build(args, device):
    from dgl1_tpu_torch.models import GCN

    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    model = GCN(data["feat"].shape[1], args.hidden, data["num_classes"],
                dropout=args.dropout, device=device,
                generator=torch.Generator().manual_seed(0))
    return data, model


def forward(data, model, generator=None):
    """The logits of the whole graph."""
    return model(data["g"], data["feat"], generator=generator)


def step_loss(args, data, model, batch=None, generator=None,
              forward=forward):
    """One step's loss: the train-mask cross entropy of ``forward``."""
    return masked_ce(forward(data, model, generator), data["labels"],
                     data["masks"]["train"])


@torch.no_grad()
def evaluate(model, data, forward=forward):
    """Accuracies on the three masks, model in eval mode."""
    model.eval()
    pred = forward(data, model).argmax(dim=1)
    return [accuracy(pred, data["labels"], data["masks"][k])
            for k in ("train", "val", "test")]


def fit(args, data, model, device, every: int, forward=forward,
        logger=None, tag: str = "") -> dict:
    """The citation scripts' loop: ``args.epochs`` full-graph steps of
    :func:`step_loss` with AdamW (``lr``, weight decay 5e-4), dropout
    masks from a generator seeded 1; accuracies at the first epoch and
    every ``every``; the test accuracy at the best validation
    accuracy."""
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            weight_decay=5e-4)
    gen = torch.Generator(device=device).manual_seed(1)
    st = Stepper()
    best_val = best_test = 0.0
    for epoch in range(args.epochs):
        st.start()
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, generator=gen, forward=forward)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % every == 0 or epoch == 0:
            tr, va, te = evaluate(model, data, forward)
            if va > best_val:
                best_val, best_test = va, te
            print(f"{tag}epoch {epoch + 1:4d} loss {loss:.4f} "
                  f"train {tr:.4f} val {va:.4f} test {te:.4f}")
            if logger:
                logger.log(loss=loss, val_acc=va, test_acc=te)
    secs = sum(st.step_ms) / 1e3
    print(f"done in {secs:.1f}s ({args.epochs / max(secs, 1e-9):.1f} "
          f"epochs/s); best val {best_val:.4f} "
          f"test@best-val {best_test:.4f}")
    return st.metrics(val=best_val, test=best_test)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.utils import MetricsLogger

    logger = MetricsLogger(args.metrics) if args.metrics else None
    return fit(args, data, model, device, every=20, logger=logger)


def gate(args, data, metrics) -> str:
    g = GATES[args.dataset] - 0.01
    return literature_gate(metrics["test"], g, data["ds"].is_synthetic,
                           args.dataset)


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
