"""R-GCN link prediction with a DistMult decoder (the reference's
``examples/train_rgcn_link_pred.py``) on a scaled synthetic knowledge
graph. Its triples are uniformly random, so the only signal is
memorisation: expect the MRR to grow slowly. Usage:

    python -m dgl1_tpu_torch.examples.train_rgcn_link_pred [--scale 8]
        [--presorted] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgl1_tpu_torch.examples import NO_GATE, Stepper, run
from dgl1_tpu_torch.examples.train_rgcn import sorted_typed_graph


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--num-bases", type=int, default=8)
    p.add_argument("--neg-k", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--scale", type=int, default=8,
                   help="divide the synthetic KG size by this")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--presorted", action="store_true",
                   help="use the grouped-GEMM (segment_mm) path")
    return p.parse_args(argv)


class RGCNDistMult(nn.Module):
    """A featureless 2-layer ``RGCN`` encoder (``rgcn``) and DistMult
    relation embeddings ``rel_w`` (normal rows of std 0.1)."""

    def __init__(self, num_nodes, hidden, num_rels, num_bases, device=None):
        super().__init__()
        from dgl1_tpu_torch.models import RGCN

        self.rgcn = RGCN(num_nodes, hidden, hidden, num_rels,
                         num_bases=num_bases, num_layers=2, device=device,
                         generator=torch.Generator().manual_seed(0))
        self.rel_w = nn.Parameter(0.1 * torch.randn(
            num_rels, hidden, generator=torch.Generator().manual_seed(1))
            .to(device))

    def score(self, h, s, r, d):
        return (h[s] * self.rel_w[r] * h[d]).sum(dim=-1)


def build(args, device):
    from dgl1_tpu_torch.data.knowledge import _typed_graph

    num_nodes, num_edges, num_rels = (14541 // args.scale,
                                      310116 // args.scale, 237)
    g = _typed_graph(num_nodes, num_edges, num_rels, seed=1, device=device)
    print(f"[data] synthetic KG: {num_nodes} nodes, {num_edges} edges, "
          f"{num_rels} relations")
    g2, etypes, counts, (src, dst) = sorted_typed_graph(g, num_rels, device)
    model = RGCNDistMult(num_nodes, args.hidden, num_rels, args.num_bases,
                         device=device)
    data = dict(g=g2, etypes_host=etypes, src=src, dst=dst, counts=counts,
                etypes=torch.as_tensor(etypes.astype(np.int64),
                                       device=device),
                num_nodes=num_nodes, rng=np.random.default_rng(0))
    return data, model


def embed(args, data, model):
    return model.rgcn(data["g"], data["etypes"], presorted=args.presorted,
                      etype_counts=data["counts"])


def first_batch(args, data, device):
    """A batch of positive triples and their uniform head and tail
    corruptions, drawn from the data's stream in the script's order."""
    rng, e = data["rng"], len(data["src"])
    n = min(4096, e)
    eids = rng.choice(e, size=n, replace=False)
    et = data["etypes_host"]
    pos = (data["src"][eids], et[eids], data["dst"][eids])
    neg = (rng.integers(0, data["num_nodes"], size=n * args.neg_k),
           np.tile(et[eids], args.neg_k),
           rng.integers(0, data["num_nodes"], size=n * args.neg_k))
    return tuple(tuple(torch.as_tensor(a, device=device).long() for a in t)
                 for t in (pos, neg))


def step_loss(args, data, model, batch):
    pos, neg = batch
    h = embed(args, data, model)
    ps, ns = model.score(h, *pos), model.score(h, *neg)
    scores = torch.cat([ps, ns])
    y = torch.cat([torch.ones_like(ps), torch.zeros_like(ns)])
    reg = 1e-5 * ((h ** 2).sum() + (model.rel_w ** 2).sum())
    return F.binary_cross_entropy_with_logits(scores, y) + reg


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    for epoch in range(args.epochs):
        batch = first_batch(args, data, device)
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, batch)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 10 == 0 or epoch == 0:
            print(f"epoch {epoch + 1:3d} loss {loss:.4f}")

    # MRR on a sample (raw, unfiltered).
    with torch.no_grad():
        h = embed(args, data, model).cpu().numpy()
    r_np = model.rel_w.detach().cpu().numpy()
    e = len(data["src"])
    ranks = []
    for i in data["rng"].choice(e, size=min(200, e), replace=False):
        s, r, d = data["src"][i], data["etypes_host"][i], data["dst"][i]
        scores = (h[s] * r_np[r]) @ h.T
        ranks.append(1 + int((scores > scores[d]).sum()))
    mrr = float(np.mean(1.0 / np.asarray(ranks)))
    print(f"MRR (raw, {len(ranks)} samples): {mrr:.4f}")
    return st.metrics(test=mrr)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
