"""The plain reference of model ``hetero_rgcn``: R-GCN (Schlichtkrull et
al., ESWC 2018) on a heterograph, written over each relation's edge list
with gathers and index sums, in float64.

Layer l, relation r from type s to type d: ``out_d += D_in^-1/2 A_r
D_out^-1/2 x_s W_r^T + b_r`` (degrees within the relation, 0 read as 1),
summed over the relations into d; ReLU between the layers; the target's
rows of the last layer are the logits. The target's input is its
features, every other type's a learnt embedding."""

from __future__ import annotations

import torch

from gnnbench.reference.common import cross_entropy


def prepare(cfg: dict, coo: dict, device) -> dict:
    rels = {}
    for c, (s, d) in coo["relations"].items():
        src = torch.as_tensor(s, device=device).long()
        dst = torch.as_tensor(d, device=device).long()
        n_s, n_d = coo["num_nodes"][c[0]], coo["num_nodes"][c[2]]
        out_deg = torch.bincount(src, minlength=n_s).double().clamp(min=1)
        in_deg = torch.bincount(dst, minlength=n_d).double().clamp(min=1)
        rels[c] = (src, dst, out_deg.rsqrt()[:, None],
                   in_deg.rsqrt()[:, None])
    return {"rels": rels, "num_nodes": coo["num_nodes"]}


def _conv(x, rel, w, b, n_dst, mm):
    src, dst, norm_s, norm_d = rel
    x = x * norm_s
    narrow = w.shape[1] > w.shape[0]
    if narrow:
        x = mm(x, w.T)
    agg = x.new_zeros((n_dst, x.shape[1])).index_add(0, dst, x[src])
    if not narrow:
        agg = mm(agg, w.T)
    return agg * norm_d + b


def logits(cfg: dict, prep: dict, inputs: dict, p: dict, mm):
    t = cfg["target"]
    x = {nt: p[f"emb.emb_{nt}.weight"] for nt in prep["num_nodes"]
         if nt != t}
    x[t] = inputs["feat"]
    for layer in range(cfg["num_layers"]):
        out = {}
        for c, rel in prep["rels"].items():
            q = f"rgcn.l{layer}.mods.{c[1]}."
            r = _conv(x[c[0]], rel, p[q + "weight.weight"], p[q + "bias"],
                      prep["num_nodes"][c[2]], mm)
            out[c[2]] = out[c[2]] + r if c[2] in out else r
        x = out if layer == cfg["num_layers"] - 1 else {
            k: torch.relu(v) for k, v in out.items()}
    return x[t]


def loss(cfg: dict, prep: dict, inputs: dict, p: dict, mm):
    return cross_entropy(logits(cfg, prep, inputs, p, mm), inputs["labels"])
