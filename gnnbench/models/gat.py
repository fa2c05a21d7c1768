"""GAT through the program's ``models.GAT``: what a configuration of model
``gat`` runs, its weights, its inputs and its FLOPs a step.

Every model module gives the harness the same five names: ``build``,
``inputs``, ``params``, ``step_flops`` and ``REFERENCE`` (the module name
under ``reference/``)."""

from __future__ import annotations

import torch

REFERENCE = "gat"


def _layers(cfg: dict):
    """(in width, heads, head width) of each layer."""
    out = []
    din = cfg["in_feats"]
    for i in range(cfg["num_layers"]):
        last = i == cfg["num_layers"] - 1
        h = cfg["out_heads"] if last else cfg["heads"]
        f = cfg["out_feats"] if last else cfg["hidden_feats"]
        out.append((din, h, f))
        din = h * f
    return out


def build(cfg: dict, graph, device, gen: torch.Generator):
    """The program's model; ``gen`` (on ``device``) keeps its own init
    draws on the card, which the harness's weights then replace."""
    from dgl1_tpu_torch.models import GAT

    return GAT(cfg["in_feats"], cfg["hidden_feats"], cfg["out_feats"],
               num_layers=cfg["num_layers"], heads=cfg["heads"],
               out_heads=cfg["out_heads"], feat_drop=cfg["feat_drop"],
               attn_drop=cfg["attn_drop"],
               negative_slope=cfg["negative_slope"],
               residual=cfg["residual"], device=device, generator=gen)


def params(cfg: dict, coo: dict):
    """(name, shape, std) of every parameter, in the program's names; std
    0 is a zero fill. Linear weights (and the residual's) lecun normal,
    attention vectors Glorot normal over (heads, width), as GAT's authors
    initialise them."""
    out = []
    for i, (din, h, f) in enumerate(_layers(cfg)):
        p = f"layers.{i}."
        out += [(p + "fc.weight", (h * f, din), din ** -0.5),
                (p + "attn_l", (1, h, f), (2.0 / (h + f)) ** 0.5),
                (p + "attn_r", (1, h, f), (2.0 / (h + f)) ** 0.5),
                (p + "bias", (1, h, f), 0.0)]
        if cfg["residual"]:
            out.append((p + "res_fc.weight", (h * f, din), din ** -0.5))
    return out


def inputs(cfg: dict, coo: dict, gen: torch.Generator, device) -> dict:
    """Standard normal features and uniform labels, drawn from ``gen``."""
    n = coo["num_nodes"]
    feat = torch.randn(n, cfg["in_feats"], generator=gen, device=device)
    labels = torch.randint(0, cfg["out_feats"], (n,), generator=gen,
                           device=device)
    return {"feat": feat, "labels": labels}


def step_flops(cfg: dict, coo: dict) -> float:
    """FLOPs of one full-graph training step, forward and backward, from
    the shapes and the edge count (self-loops included): the projections
    (2 N din H F, once forward, once for the weight's gradient, once for
    the input's gradient but at the first layer, whose input needs
    none; twice with the residual's), the attention logits (2 N H F each side, twice with their
    gradient) and per edge 2 H F + 8 H forward (logit, leaky_relu, exp,
    weighted sum) and 4 H F + 12 H backward. No recomputation, and no
    elementwise work outside the attention (bias, ELU, loss, Adam)."""
    n = coo["num_nodes"]
    e = coo["src"].shape[0] + (n if coo.get("self_loops") else 0)
    total = 0.0
    for i, (din, h, f) in enumerate(_layers(cfg)):
        proj = 2.0 * n * din * h * f * (2 if cfg["residual"] else 1)
        total += proj * (2 if i == 0 else 3)
        total += 2 * (2.0 * 2 * n * h * f)
        total += e * (2.0 * h * f + 8 * h) + e * (4.0 * h * f + 12 * h)
    return total
