"""The plain reference of model ``gat``: GAT (Velickovic et al., ICLR 2018)
written over the edge list with gathers and index sums, in float64.

Per layer, heads H of width F: ``h = x W^T``; ``el = <h, a_l>`` and ``er =
<h, a_r>`` per head; per edge ``e = leaky_relu(el[src] + er[dst])``; a
softmax of ``e`` over each destination's in-edges; ``out[dst] = sum
softmax * h[src] + x R^T + bias`` (the residual ``R`` where the
configuration has one); ELU on the concatenated heads between layers,
the mean over heads after the last. The graph gets one self-loop a node
here, from the edge list the traffic generated."""

from __future__ import annotations

import torch

from gnnbench.reference.common import cross_entropy, edge_sum


def prepare(cfg: dict, coo: dict, device) -> dict:
    n = coo["num_nodes"]
    src = torch.as_tensor(coo["src"], device=device).long()
    dst = torch.as_tensor(coo["dst"], device=device).long()
    if coo.get("self_loops"):
        loops = torch.arange(n, device=device)
        src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    return {"n": n, "src": src, "dst": dst}


def _layer(prep, x, w, a_l, a_r, bias, res, heads, width, slope, mm):
    n, src, dst = prep["n"], prep["src"], prep["dst"]
    h = mm(x, w.T).view(n, heads, width)
    el = (h * a_l).sum(-1)
    er = (h * a_r).sum(-1)
    e = torch.nn.functional.leaky_relu(el[src] + er[dst], slope)
    # The softmax is shift-invariant: subtract each destination's max,
    # held constant, for range alone.
    top = torch.full((n, heads), float("-inf"), dtype=e.dtype,
                     device=e.device)
    top = top.scatter_reduce(0, dst[:, None].expand(-1, heads), e.detach(),
                             "amax")
    p = torch.exp(e - top[dst])
    den = torch.zeros((n, heads), dtype=p.dtype, device=p.device)
    den = den.index_add(0, dst, p)
    num = edge_sum(src, dst, p, h, n)
    out = num / den[:, :, None] + bias
    return out if res is None else out + mm(x, res.T).view(n, heads, width)


def logits(cfg: dict, prep: dict, inputs: dict, p: dict, mm):
    x = inputs["feat"]
    layers = cfg["num_layers"]
    for i in range(layers):
        last = i == layers - 1
        heads = cfg["out_heads"] if last else cfg["heads"]
        width = cfg["out_feats"] if last else cfg["hidden_feats"]
        q = f"layers.{i}."
        out = _layer(prep, x, p[q + "fc.weight"], p[q + "attn_l"],
                     p[q + "attn_r"], p[q + "bias"],
                     p.get(q + "res_fc.weight"), heads, width,
                     cfg["negative_slope"], mm)
        x = out.mean(1) if last else torch.nn.functional.elu(
            out.reshape(prep["n"], -1))
    return x


def loss(cfg: dict, prep: dict, inputs: dict, p: dict, mm):
    return cross_entropy(logits(cfg, prep, inputs, p, mm), inputs["labels"])
