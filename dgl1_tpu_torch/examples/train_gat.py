"""Full-graph GAT training (the reference's ``examples/train_gat.py``:
an 8-head GAT on Pubmed). Usage:

    python -m dgl1_tpu_torch.examples.train_gat [--dataset pubmed] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from dgl1_tpu_torch.examples import literature_gate, run
from dgl1_tpu_torch.examples.train_gcn import (  # noqa: F401
    citation_graph, fit, node_data, step_loss)

# Velickovic et al. 2018: Cora 83.0 / Citeseer 72.5 / Pubmed 79.0, less
# 0.01.
GATES = {"cora": 0.830, "citeseer": 0.725, "pubmed": 0.790}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="pubmed",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--hidden", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def build(args, device):
    from dgl1_tpu_torch.models import GAT

    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    model = GAT(data["feat"].shape[1], args.hidden, data["num_classes"],
                heads=args.heads, device=device,
                generator=torch.Generator().manual_seed(0))
    return data, model


def train(args, data, model, device) -> dict:
    return fit(args, data, model, device, every=20)


def gate(args, data, metrics) -> str:
    g = GATES[args.dataset] - 0.01
    return literature_gate(metrics["test"], g, data["ds"].is_synthetic,
                           args.dataset)


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
