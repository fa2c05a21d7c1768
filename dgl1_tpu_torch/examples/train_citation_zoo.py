"""Citation-graph model zoo (the reference's
``examples/train_citation_zoo.py``): APPNP, SGC, TAGCN, ChebNet, AGNN,
GATv2, DotGAT, JKNet and MoNet over the port's convs, with the citation
scripts' loop, evaluation and gates. Usage:

    python -m dgl1_tpu_torch.examples.train_citation_zoo --model appnp
        [--dataset cora] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F
from torch import nn

from dgl1_tpu_torch.examples import literature_gate, run
from dgl1_tpu_torch.examples.train_gcn import (  # noqa: F401
    citation_graph, fit, node_data, step_loss)
from dgl1_tpu_torch.nn.conv import _maybe_drop, dense

# Literature test accuracies, less 0.015 at the gate; real data only.
GATES = {
    "appnp": {"cora": 0.833, "citeseer": 0.718, "pubmed": 0.801},
    "sgc": {"cora": 0.810, "citeseer": 0.719, "pubmed": 0.789},
    "tagcn": {"cora": 0.833, "citeseer": 0.714, "pubmed": 0.790},
    "chebnet": {"cora": 0.812},
    "agnn": {"cora": 0.831, "citeseer": 0.717, "pubmed": 0.799},
    "gatv2": {"cora": 0.835},
    "jknet": {},
    "dotgat": {},
    "monet": {"cora": 0.817},
}


class _Zoo(nn.Module):
    """Holds the dropout rate; ``forward(g, x, generator)`` as the
    trainers call it. Submodules carry the script's flax names."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def drop(self, x, generator):
        return _maybe_drop(x, self.p, self.training, generator)


class APPNP(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import APPNPConv

        self.Dense_0 = dense(in_f, hidden, device=dev, generator=gen)
        self.Dense_1 = dense(hidden, classes, device=dev, generator=gen)
        self.APPNPConv_0 = APPNPConv(k=10, alpha=0.1, device=dev)

    def forward(self, g, x, generator=None):
        x = torch.relu(self.Dense_0(self.drop(x, generator)))
        x = self.Dense_1(self.drop(x, generator))
        return self.APPNPConv_0(g, x)


class SGC(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import SGConv

        self.SGConv_0 = SGConv(in_f, classes, k=2, device=dev, generator=gen)

    def forward(self, g, x, generator=None):
        return self.SGConv_0(g, x)


class TAGCN(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import TAGConv

        self.TAGConv_0 = TAGConv(in_f, hidden, k=2, activation=torch.relu,
                                 device=dev, generator=gen)
        self.TAGConv_1 = TAGConv(hidden, classes, k=2, device=dev,
                                 generator=gen)

    def forward(self, g, x, generator=None):
        x = self.drop(self.TAGConv_0(g, x), generator)
        return self.TAGConv_1(g, x)


class Cheb(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import ChebConv

        self.ChebConv_0 = ChebConv(in_f, hidden, k=3, device=dev,
                                   generator=gen)
        self.ChebConv_1 = ChebConv(hidden, classes, k=3, device=dev,
                                   generator=gen)

    def forward(self, g, x, generator=None):
        x = self.drop(torch.relu(self.ChebConv_0(g, x)), generator)
        return self.ChebConv_1(g, x)


class AGNN(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import AGNNConv

        self.Dense_0 = dense(in_f, hidden, device=dev, generator=gen)
        self.AGNNConv_0 = AGNNConv(device=dev)
        self.AGNNConv_1 = AGNNConv(device=dev)
        self.Dense_1 = dense(hidden, classes, device=dev, generator=gen)

    def forward(self, g, x, generator=None):
        x = torch.relu(self.Dense_0(x))
        x = self.AGNNConv_1(g, self.AGNNConv_0(g, x))
        return self.Dense_1(self.drop(x, generator))


class GATv2(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import GATv2Conv

        self.GATv2Conv_0 = GATv2Conv(in_f, 8, num_heads=8, feat_drop=p,
                                     attn_drop=p, device=dev, generator=gen)
        self.GATv2Conv_1 = GATv2Conv(64, classes, num_heads=1, feat_drop=p,
                                     attn_drop=p, device=dev, generator=gen)

    def forward(self, g, x, generator=None):
        h = self.GATv2Conv_0(g, x, generator=generator)
        h = F.elu(h.reshape(h.shape[0], -1))
        h = self.GATv2Conv_1(g, h, generator=generator)
        return h.reshape(h.shape[0], -1)


class DotGAT(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import DotGatConv

        self.DotGatConv_0 = DotGatConv(in_f, hidden, num_heads=4,
                                       device=dev, generator=gen)
        self.DotGatConv_1 = DotGatConv(4 * hidden, classes, num_heads=1,
                                       device=dev, generator=gen)

    def forward(self, g, x, generator=None):
        h = self.DotGatConv_0(g, x)
        h = self.drop(F.elu(h.reshape(h.shape[0], -1)), generator)
        h = self.DotGatConv_1(g, h)
        return h.reshape(h.shape[0], -1)


class JKNet(_Zoo):
    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import GraphConv, JumpingKnowledge

        for i in range(3):
            setattr(self, f"GraphConv_{i}", GraphConv(
                in_f if i == 0 else hidden, hidden, device=dev,
                generator=gen))
        self.JumpingKnowledge_0 = JumpingKnowledge("cat", device=dev)
        self.Dense_0 = dense(3 * hidden, classes, device=dev,
                             generator=gen)

    def forward(self, g, x, generator=None):
        outs, h = [], x
        for i in range(3):
            h = torch.relu(getattr(self, f"GraphConv_{i}")(g, h))
            h = self.drop(h, generator)
            outs.append(h)
        return self.Dense_0(self.JumpingKnowledge_0(outs))


class MoNet(_Zoo):
    """Degree pseudo-coordinates: ``tanh(pseudo_proj([1/sqrt(deg_s + 1),
    1/sqrt(deg_d + 1)]))`` per edge slot, ``deg`` the in-degree and the
    slot's ends clamped to the last node (padding)."""

    def __init__(self, in_f, hidden, classes, p, dev, gen):
        super().__init__(p)
        from dgl1_tpu_torch.nn import GMMConv

        self.pseudo_proj = dense(2, 2, device=dev, generator=gen)
        self.GMMConv_0 = GMMConv(in_f, hidden, dim=2, n_kernels=3,
                                 device=dev, generator=gen)
        self.GMMConv_1 = GMMConv(hidden, classes, dim=2, n_kernels=3,
                                 device=dev, generator=gen)

    def forward(self, g, x, generator=None):
        deg = g.in_degrees().to(x.dtype)
        n = deg.shape[0] - 1
        s = g.src.long().clamp(0, n)
        d = g.dst.long().clamp(0, n)
        pseudo = torch.tanh(self.pseudo_proj(torch.stack(
            [torch.rsqrt(deg[s] + 1.0), torch.rsqrt(deg[d] + 1.0)],
            dim=-1)))
        h = torch.relu(self.GMMConv_0(g, x, pseudo))
        return self.GMMConv_1(g, self.drop(h, generator), pseudo)


MODELS = {"appnp": APPNP, "sgc": SGC, "tagcn": TAGCN, "chebnet": Cheb,
          "agnn": AGNN, "gatv2": GATv2, "dotgat": DotGAT, "jknet": JKNet,
          "monet": MoNet}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="appnp", choices=sorted(GATES))
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def build(args, device):
    ds, g = citation_graph(args, device)
    data = node_data(ds, g)
    model = MODELS[args.model](data["feat"].shape[1], args.hidden,
                               data["num_classes"], args.dropout, device,
                               torch.Generator().manual_seed(0))
    return data, model


def train(args, data, model, device) -> dict:
    return fit(args, data, model, device, every=20, tag=f"[{args.model}] ")


def gate(args, data, metrics) -> str:
    g = GATES[args.model].get(args.dataset)
    return literature_gate(metrics["test"], None if g is None else g - 0.015,
                           data["ds"].is_synthetic,
                           f"{args.model} on {args.dataset}")


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
