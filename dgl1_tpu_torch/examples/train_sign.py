"""SIGN, scalable inception graph networks (the reference's
``examples/train_sign.py``): the graph propagation is precomputed once,
``hops`` applications of the symmetric-normalised adjacency to the
features (``copy_u_sum``), and training is an MLP over the hop features
concatenated, with no graph in the step. Usage:

    python -m dgl1_tpu_torch.examples.train_sign [--dataset cora]
        [--hops 3] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch import nn

from dgl1_tpu_torch.examples import literature_gate, run
from dgl1_tpu_torch.examples import train_gcn
from dgl1_tpu_torch.examples.train_gcn import citation_graph, fit, node_data
from dgl1_tpu_torch.nn.conv import _maybe_drop, dense

# SIGN reports about GCN's citation accuracy; less 0.015, real data only.
GATES = {"cora": 0.810, "citeseer": 0.703, "pubmed": 0.789}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--hops", type=int, default=3)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def propagate(g, x, hops: int):
    """``[X, A X, ..., A^hops X]`` concatenated, ``A = D^-1/2 (A) D^-1/2``
    with in-degrees clamped at 1."""
    from dgl1_tpu_torch.ops import copy_u_sum

    deg = g.in_degrees().to(x.dtype).clamp_min(1.0)
    norm = torch.rsqrt(deg)[:, None]
    out, h = [x], x
    for _ in range(hops):
        h = copy_u_sum(g, h * norm) * norm
        out.append(h)
    return torch.cat(out, dim=-1)


class SignMLP(nn.Module):
    """Dropout, ``Dense_0`` -> relu, dropout, ``Dense_1``."""

    def __init__(self, in_f, hidden, classes, p, device=None,
                 generator=None):
        super().__init__()
        self.Dense_0 = dense(in_f, hidden, device=device,
                             generator=generator)
        self.Dense_1 = dense(hidden, classes, device=device,
                             generator=generator)
        self.p = p

    def forward(self, x, generator=None):
        x = _maybe_drop(x, self.p, self.training, generator)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(_maybe_drop(x, self.p, self.training, generator))


def build(args, device):
    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    t0 = time.perf_counter()
    with torch.no_grad():
        data["hops"] = propagate(g, data["feat"], args.hops)
    if data["hops"].is_cuda:
        torch.cuda.synchronize(data["hops"].device)
    print(f"precomputed {args.hops}-hop features "
          f"{tuple(data['hops'].shape)} in {time.perf_counter() - t0:.2f}s")
    model = SignMLP(data["hops"].shape[1], args.hidden, data["num_classes"],
                    args.dropout, device=device,
                    generator=torch.Generator().manual_seed(0))
    return data, model


def forward(data, model, generator=None):
    """The MLP's logits on the precomputed hop features."""
    return model(data["hops"], generator=generator)


def step_loss(args, data, model, batch=None, generator=None):
    return train_gcn.step_loss(args, data, model, batch, generator,
                               forward=forward)


def train(args, data, model, device) -> dict:
    return fit(args, data, model, device, every=20, forward=forward)


def gate(args, data, metrics) -> str:
    g = GATES[args.dataset] - 0.015
    return literature_gate(metrics["test"], g, data["ds"].is_synthetic,
                           args.dataset)


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
