"""R-GCN on a heterograph through the program's ``models.HeteroRGCN``, the
whole heterograph in place of both sampled blocks, with learnt
``nn.HeteroEmbedding`` rows for every node type but the target: what a
configuration of model ``hetero_rgcn`` runs, as a user script writes it.
The five names as in ``gat.py``."""

from __future__ import annotations

import torch

REFERENCE = "hetero_rgcn"


class FullGraphRGCN(torch.nn.Module):
    """Embeddings for the featureless types, the target's features, and
    ``HeteroRGCN`` over ``[hg, hg]``; returns the target's logits."""

    def __init__(self, cfg: dict, hg, device, gen):
        super().__init__()
        from dgl1_tpu_torch.models import HeteroRGCN
        from dgl1_tpu_torch.nn import HeteroEmbedding

        t = cfg["target"]
        self.target = t
        self.emb = HeteroEmbedding(
            {nt: hg.num_nodes(nt) for nt in hg.ntypes if nt != t},
            cfg["embed_dim"], device=device, generator=gen)
        in_feats = {nt: cfg["in_feats"] if nt == t else cfg["embed_dim"]
                    for nt in hg.ntypes}
        self.rgcn = HeteroRGCN(hg.canonical_etypes, in_feats,
                               cfg["hidden_feats"], cfg["out_feats"],
                               out_ntype=t, device=device, generator=gen)

    def forward(self, hg, feat, generator=None):
        x = dict(self.emb.weights())
        x[self.target] = feat
        return self.rgcn([hg, hg], x)


def build(cfg: dict, graph, device, gen: torch.Generator):
    """The model; ``gen`` as in ``gat.build``."""
    if cfg["num_layers"] != 2 or cfg["norm"] != "both":
        raise ValueError("HeteroRGCN has two layers of GraphConv(norm='both')")
    return FullGraphRGCN(cfg, graph, device, gen)


def _width(cfg, ntype):
    return cfg["in_feats"] if ntype == cfg["target"] else cfg["embed_dim"]


def params(cfg: dict, coo: dict):
    """(name, shape, std) in the program's names: embeddings N(0, 1/dim)
    as DGL's, GraphConv weights lecun normal, zero biases."""
    t, hid, out = cfg["target"], cfg["hidden_feats"], cfg["out_feats"]
    res = [(f"emb.emb_{nt}.weight", (n, cfg["embed_dim"]),
            cfg["embed_dim"] ** -0.5)
           for nt, n in coo["num_nodes"].items() if nt != t]
    for st, et, _ in coo["relations"]:
        din = _width(cfg, st)
        res += [(f"rgcn.l0.mods.{et}.weight.weight", (hid, din), din ** -0.5),
                (f"rgcn.l0.mods.{et}.bias", (hid,), 0.0)]
    for _, et, _ in coo["relations"]:
        res += [(f"rgcn.l1.mods.{et}.weight.weight", (out, hid), hid ** -0.5),
                (f"rgcn.l1.mods.{et}.bias", (out,), 0.0)]
    return res


def inputs(cfg: dict, coo: dict, gen: torch.Generator, device) -> dict:
    """Standard normal target features and uniform target labels."""
    n = coo["num_nodes"][cfg["target"]]
    feat = torch.randn(n, cfg["in_feats"], generator=gen, device=device)
    labels = torch.randint(0, cfg["out_feats"], (n,), generator=gen,
                           device=device)
    return {"feat": feat, "labels": labels}


def useful_relations(cfg: dict, rels) -> list:
    """For each layer, the relations whose output reaches the loss: the
    last layer's into the target, an earlier layer's into a type that a
    later useful relation reads."""
    want = {cfg["target"]}
    out = []
    for _ in range(cfg["num_layers"]):
        use = [c for c in rels if c[2] in want]
        out.append(use)
        want = {c[0] for c in use}
    return out[::-1]


def step_flops(cfg: dict, coo: dict) -> float:
    """FLOPs of one full-graph step over the relations whose output reaches
    the loss (the program also computes the others): each GraphConv's
    projection (2 N din dout, on the source side when it narrows, else
    on the destination side) and its aggregation (an add per edge and
    feature at the narrower width), forward; backward the weight's
    gradient, and the input's gradient and the aggregation's transpose
    where the input needs a gradient (not the target's features). No
    norms, biases, ReLU, loss or Adam."""
    rels = coo["relations"]
    nn_ = coo["num_nodes"]
    dims = [None, cfg["hidden_feats"], cfg["out_feats"]]
    total = 0.0
    for layer, use in enumerate(useful_relations(cfg, rels)):
        for c in use:
            st, _, dt = c
            din = _width(cfg, st) if layer == 0 else dims[layer]
            dout = dims[layer + 1]
            e = rels[c][0].shape[0]
            n_proj = nn_[st] if din > dout else nn_[dt]
            proj = 2.0 * n_proj * din * dout
            agg = float(e) * min(din, dout)
            grad_in = layer > 0 or st != cfg["target"]
            total += proj + agg + proj + (proj + agg if grad_in else 0.0)
    return total
