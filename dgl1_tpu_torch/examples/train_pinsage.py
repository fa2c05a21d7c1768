"""PinSAGE item embeddings (the reference's ``examples/train_pinsage.py``):
random-walk neighbour sampling on an item co-interaction graph, a
visit-count-weighted neighbour mean (``u_mul_e`` and ``copy_e`` sums on
the frontier) with the item's own features, a max-margin triplet loss
whose positives are co-interacted items. Synthetic interactions with
latent item categories; the report is the top-5 neighbour category
purity of the learned embeddings. Usage:

    python -m dgl1_tpu_torch.examples.train_pinsage [--steps 300] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import NO_GATE, Stepper, run

# The reference's flax names -> the port's.
REFERENCE_NAMES = {"Dense_0": "fc1", "Dense_1": "fc2"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--items", type=int, default=500)
    p.add_argument("--users", type=int, default=300)
    p.add_argument("--categories", type=int, default=5)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def item_graph(args, rng, device):
    """The categories and the item-item graph of items co-interacted by a
    user (the script's draws, in its order: users mostly pick items of
    their own category)."""
    import dgl1_tpu_torch as dgl

    items, users, cats = args.items, args.users, args.categories
    cat = rng.integers(0, cats, items)
    u_cat = rng.integers(0, cats, users)
    n_inter = users * 12
    iu = rng.integers(0, users, n_inter)
    in_cat = rng.random(n_inter) < 0.85
    it = np.where(in_cat, rng.permutation(items)[np.searchsorted(
        np.sort(cat), u_cat[iu], side="left").clip(0, items - 1)],
        rng.integers(0, items, n_inter))
    by_cat = [np.flatnonzero(cat == c) for c in range(cats)]
    it = np.where(in_cat, np.asarray(
        [by_cat[c][rng.integers(0, len(by_cat[c]))] for c in u_cat[iu]]), it)
    order = np.argsort(iu, kind="stable")
    iu_s, it_s = iu[order], it[order]
    ss, dd = [], []
    for a, b in zip(np.searchsorted(iu_s, np.arange(users), side="left"),
                    np.searchsorted(iu_s, np.arange(users), side="right")):
        its = np.unique(it_s[a:b])
        if len(its) > 1:
            pairs = np.array(np.meshgrid(its, its)).reshape(2, -1)
            keep = pairs[0] != pairs[1]
            ss.append(pairs[0][keep])
            dd.append(pairs[1][keep])
    g = dgl.to_simple(dgl.graph((np.concatenate(ss), np.concatenate(dd)),
                                num_nodes=items, device=device))
    return cat, g


class PinSAGEConv(nn.Module):
    """The script's conv (``examples/train_pinsage.py:84-102``): the
    visit-count-weighted neighbour mean beside the item's own features,
    two dense layers, rows l2-normalised."""

    def __init__(self, in_feats: int, hidden: int, device=None,
                 generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn.conv import dense

        self.fc1 = dense(2 * in_feats, hidden, True, device, generator)
        self.fc2 = dense(hidden, hidden, True, device, generator)

    def forward(self, frontier, x):
        from dgl1_tpu_torch.ops import gspmm

        w = frontier.edata["weights"][:, None]
        num = gspmm(frontier, "mul", "sum", x, w)
        den = gspmm(frontier, "copy_rhs", "sum", None, w)
        agg = num / den.clamp_min(1e-6)
        h = self.fc2(torch.relu(self.fc1(torch.cat([x, agg], dim=1))))
        return h / torch.linalg.vector_norm(h, dim=1,
                                            keepdim=True).clamp_min(1e-6)


def build(args, device):
    from dgl1_tpu_torch.sampling import PinSAGESampler

    rng = np.random.default_rng(0)
    cat, g = item_graph(args, rng, device)
    print(f"[data] item graph: {g.num_nodes()} items, {g.num_edges()} "
          f"co-interaction edges, {args.categories} categories")
    sampler = PinSAGESampler(g, num_traversals=2, termination_prob=0.5,
                             num_random_walks=16, num_neighbors=5, seed=1)
    feat = (rng.normal(size=(args.items, 16))
            + 0.5 * np.eye(args.categories)[cat] @ rng.normal(
                size=(args.categories, 16))).astype(np.float32)
    frontier = sampler(np.arange(args.items))
    src, dst = (t.cpu().numpy() for t in g.edges())
    model = PinSAGEConv(16, args.hidden, device=device,
                        generator=torch.Generator().manual_seed(0))
    return dict(cat=cat, frontier=frontier, src=src, dst=dst, rng=rng,
                feat=torch.as_tensor(feat, device=device),
                device=device), model


def make_batch(args, data):
    """Query items, a co-interaction neighbour of each (itself where it
    has none) and random negatives."""
    rng, src, dst = data["rng"], data["src"], data["dst"]
    q = rng.integers(0, args.items, args.batch_size)
    pos = q.copy()
    for j, s in enumerate(q):
        nbrs = dst[src == s]
        if len(nbrs):
            pos[j] = nbrs[rng.integers(0, len(nbrs))]
    neg = rng.integers(0, args.items, args.batch_size)
    return tuple(torch.as_tensor(a, device=data["device"])
                 for a in (q, pos, neg))


def first_batch(args, data, device):
    return make_batch(args, data)


def step_loss(args, data, model, batch):
    """The triplet hinge with margin 0.5 on dot products."""
    q, pos, neg = batch
    z = model(data["frontier"], data["feat"])
    zq, zp, zn = z[q], z[pos], z[neg]
    margin = (zq * zn).sum(1) - (zq * zp).sum(1) + 0.5
    return margin.clamp_min(0.0).mean()


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    for i in range(args.steps):
        batch = make_batch(args, data)
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, batch)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (i + 1) % 100 == 0:
            print(f"step {i + 1} loss {loss:.4f}")
    with torch.no_grad():
        z = model(data["frontier"], data["feat"]).cpu().numpy()
    sims = z @ z.T
    np.fill_diagonal(sims, -np.inf)
    topk = np.argsort(-sims, axis=1)[:, :5]
    cat = data["cat"]
    purity = float((cat[topk] == cat[:, None]).mean())
    print(f"top-5 neighbor category purity: {purity:.4f} "
          f"(random = {1 / args.categories:.2f})")
    return st.metrics(test=purity)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
