"""Link prediction with a GraphSAGE encoder and a dot-product scorer (the
reference's ``examples/train_link_pred.py``: the ``EdgeDataLoader``
pattern). Usage:

    python -m dgl1_tpu_torch.examples.train_link_pred [--epochs 3] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from dgl1_tpu_torch.examples import NO_GATE, Stepper, first_of, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--neg-k", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def auc(pos_s, neg_s) -> float:
    """Rank-sum AUC of positive against negative scores (numpy)."""
    labels = np.concatenate([np.ones_like(pos_s), np.zeros_like(neg_s)])
    scores = np.concatenate([pos_s, neg_s])
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.dataloading import (EdgeDataLoader, NeighborSampler,
                                            negative_sampler)
    from dgl1_tpu_torch.models import GraphSAGE

    # The graph stays on the host, where the sampler reads it.
    g = dgl.data.synthetic_classification_graph(
        num_nodes=4000, num_classes=8, feat_dim=64, avg_degree=8, seed=0,
        device="cpu")
    print(f"[data] {g.num_nodes()} nodes, {g.num_edges()} edges")
    sampler = NeighborSampler([10, 10], static_shapes=False)
    loader = EdgeDataLoader(
        g, np.arange(g.num_edges()), sampler, batch_size=args.batch_size,
        negative_sampler=negative_sampler.Uniform(args.neg_k), seed=0,
        device=device)
    # The script takes its first batch to give its model shapes; the draw
    # advances the loader's stream, so it is made here too.
    first_of(loader)
    feat = g.ndata["feat"]
    model = GraphSAGE(feat.shape[1], args.hidden, args.hidden,
                      device=device,
                      generator=torch.Generator().manual_seed(0))
    return dict(g=g, loader=loader, feat=feat.to(device)), model


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    from dgl1_tpu_torch import ops

    inp, pos_g, neg_g, blocks = batch
    h = model(blocks, data["feat"].index_select(0, inp))
    pos = ops.u_dot_v(pos_g, h, h)[: pos_g.num_edges(), 0]
    neg = ops.u_dot_v(neg_g, h, h)[: neg_g.num_edges(), 0]
    scores = torch.cat([pos, neg])
    y = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
    return F.binary_cross_entropy_with_logits(scores, y)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.sampling import global_uniform_negative_sampling

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    # The script applies its model deterministically: no dropout.
    model.eval()
    for epoch in range(args.epochs):
        tot = nb = 0
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            tot += st.done(loss)
            nb += 1
            if nb >= 8:  # keep the demo quick
                break
        print(f"epoch {epoch} loss {tot / max(nb, 1):.4f}")

    # AUC on a held-out sample of positives against random negatives.
    g = data["g"]
    with torch.no_grad():
        g_dev = g.to(device)
        hp = model([g_dev, g_dev], data["feat"]).cpu().numpy()
    e = g.num_edges()
    pos_idx = np.random.default_rng(1).choice(e, size=min(2000, e),
                                              replace=False)
    ps, pd = g.src[:e].numpy()[pos_idx], g.dst[:e].numpy()[pos_idx]
    ns, nd = global_uniform_negative_sampling(g, len(pos_idx))
    value = auc((hp[ps] * hp[pd]).sum(1), (hp[ns] * hp[nd]).sum(1))
    print(f"link-pred AUC: {value:.4f}")
    return st.metrics(test=value)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
