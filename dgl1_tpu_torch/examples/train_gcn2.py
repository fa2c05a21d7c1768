"""Deep GCNII training (the reference's ``examples/train_gcn2.py``):
stacked ``GCN2Conv`` layers with the initial residual and the identity
map. Usage:

    python -m dgl1_tpu_torch.examples.train_gcn2 [--dataset cora]
        [--layers 16] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch import nn

from dgl1_tpu_torch.examples import literature_gate, run
from dgl1_tpu_torch.examples.train_gcn import (  # noqa: F401
    citation_graph, fit, node_data, step_loss)
from dgl1_tpu_torch.nn.conv import _maybe_drop, dense

# Chen et al. 2020: Cora 85.5 / Citeseer 73.4 / Pubmed 80.3, less 0.015.
GATES = {"cora": 0.855, "citeseer": 0.734, "pubmed": 0.803}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--lambda-", dest="lambda_", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class GCNII(nn.Module):
    """``fc_in`` -> relu, then ``layers`` of ``GCN2Conv(layer=l + 1,
    project_initial_features=True)`` -> relu (``conv_{l}``), then
    ``fc_out``, with dropout before each (the script's flax names)."""

    def __init__(self, in_feats, hidden, classes, layers, alpha, lambda_,
                 p, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import GCN2Conv

        self.fc_in = dense(in_feats, hidden, device=device,
                           generator=generator)
        self.layers = layers
        for l in range(layers):
            setattr(self, f"conv_{l}", GCN2Conv(
                hidden, layer=l + 1, alpha=alpha, lambda_=lambda_,
                project_initial_features=True, device=device,
                generator=generator))
        self.fc_out = dense(hidden, classes, device=device,
                            generator=generator)
        self.p = p

    def forward(self, g, x, generator=None):
        def drop(h):
            return _maybe_drop(h, self.p, self.training, generator)

        h0 = torch.relu(self.fc_in(drop(x)))
        h = h0
        for l in range(self.layers):
            h = torch.relu(getattr(self, f"conv_{l}")(g, drop(h), h0))
        return self.fc_out(drop(h))


def build(args, device):
    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    model = GCNII(data["feat"].shape[1], args.hidden, data["num_classes"],
                  args.layers, args.alpha, args.lambda_, args.dropout,
                  device=device, generator=torch.Generator().manual_seed(0))
    return data, model


def train(args, data, model, device) -> dict:
    return fit(args, data, model, device, every=25)


def gate(args, data, metrics) -> str:
    g = GATES[args.dataset] - 0.015
    return literature_gate(metrics["test"], g, data["ds"].is_synthetic,
                           args.dataset)


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
