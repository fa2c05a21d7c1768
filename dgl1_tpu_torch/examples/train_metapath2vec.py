"""metapath2vec on a synthetic ACM-style heterograph (the reference's
``examples/train_metapath2vec.py``): author-paper-author metapath walks
(``sampling.random_walk``) feed a skip-gram objective with uniform
negatives, one step an epoch over all its pairs. Authors write within
planted communities; after training, author similarity inside a
community must exceed that across communities. Usage:

    python -m dgl1_tpu_torch.examples.train_metapath2vec [--epochs 30]
        [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import Stepper, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--authors", type=int, default=300)
    p.add_argument("--papers", type=int, default=600)
    p.add_argument("--communities", type=int, default=4)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--walk-repeats", type=int, default=4,
                   help="APA metapath repetitions per walk")
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--negatives", type=int, default=5)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class SkipGram(nn.Module):
    """The script's two tables (``center``, ``context``), authors then
    papers, drawn as it draws them: 0.1 times the numpy stream's
    normals."""

    def __init__(self, center, context, device=None):
        super().__init__()
        self.center = nn.Parameter(torch.as_tensor(center, device=device))
        self.context = nn.Parameter(torch.as_tensor(context, device=device))

    def forward(self, centers, contexts, negs):
        """The negative-sampling loss of the (center, context) pairs."""
        c = self.center[centers]
        pos = (c * self.context[contexts]).sum(dim=-1)
        neg = torch.einsum("bd,bkd->bk", c, self.context[negs])
        f = torch.nn.functional.logsigmoid
        return -(f(pos).mean() + f(-neg).mean())


def build(args, device):
    import dgl1_tpu_torch as dgl

    rng = np.random.default_rng(0)
    comm_a = rng.integers(0, args.communities, args.authors)
    comm_p = rng.integers(0, args.communities, args.papers)
    pairs = []  # each paper gets 3 authors of its own community
    for paper in range(args.papers):
        pool = np.nonzero(comm_a == comm_p[paper])[0]
        for a in rng.choice(pool, size=min(3, len(pool)), replace=False):
            pairs.append((a, paper))
    a_ids, p_ids = map(np.asarray, zip(*pairs))
    hg = dgl.heterograph({
        ("author", "writes", "paper"): (a_ids, p_ids),
        ("paper", "written_by", "author"): (p_ids, a_ids),
    }, num_nodes_dict={"author": args.authors, "paper": args.papers},
        device="cpu")
    n_emb = args.authors + args.papers  # one table, papers offset
    center = 0.1 * rng.normal(size=(n_emb, args.dim)).astype("float32")
    context = 0.1 * rng.normal(size=(n_emb, args.dim)).astype("float32")
    return dict(hg=hg, rng=rng, comm_a=comm_a, n_emb=n_emb, budget=None,
                device=device), SkipGram(center, context, device)


def walks_to_pairs(args, traces, types):
    """Skip-gram (center, context) pairs within the window, both ends
    alive, ids offset into the joint table."""
    offset = np.where(np.asarray(types) == 0, 0, args.authors)
    ids = np.where(traces >= 0, traces + offset[None, :], -1)
    cs, xs = [], []
    L = ids.shape[1]
    for i in range(L):
        for j in range(max(0, i - args.window), min(L, i + args.window + 1)):
            if i == j:
                continue
            ok = (ids[:, i] >= 0) & (ids[:, j] >= 0)
            cs.append(ids[ok, i])
            xs.append(ids[ok, j])
    return np.concatenate(cs), np.concatenate(xs)


def epoch_batch(args, data):
    """One walk from every author, its pairs cut or padded (by
    repetition) to the first epoch's count, and the negatives."""
    from dgl1_tpu_torch.sampling import random_walk

    rng = data["rng"]
    metapath = ["writes", "written_by"] * args.walk_repeats
    traces, types = random_walk(data["hg"], np.arange(args.authors),
                                metapath=metapath, rng=rng)
    cs, xs = walks_to_pairs(args, traces, types)
    budget = data["budget"] = data["budget"] or len(cs)
    take = rng.permutation(len(cs))[:budget]
    cs, xs = cs[take], xs[take]
    if len(cs) < budget:
        pad = rng.integers(0, len(cs), budget - len(cs))
        cs = np.concatenate([cs, cs[pad]])
        xs = np.concatenate([xs, xs[pad]])
    negs = rng.integers(0, data["n_emb"], (budget, args.negatives))
    return tuple(torch.as_tensor(a, device=data["device"])
                 for a in (cs, xs, negs))


def first_batch(args, data, device):
    return epoch_batch(args, data)


def step_loss(args, data, model, batch):
    return model(*batch)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    for epoch in range(args.epochs):
        batch = epoch_batch(args, data)
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, batch)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 10 == 0 or epoch == 0:
            print(f"epoch {epoch + 1:3d} loss {loss:.4f} "
                  f"({data['budget']} pairs)")
    emb = model.center.detach()[: args.authors].cpu().numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sims = emb @ emb.T
    comm = data["comm_a"]
    same = comm[:, None] == comm[None, :]
    np.fill_diagonal(sims, np.nan)
    intra = float(np.nanmean(np.where(same, sims, np.nan)))
    inter = float(np.nanmean(np.where(~same, sims, np.nan)))
    print(f"author cosine: intra-community {intra:.3f} vs "
          f"inter-community {inter:.3f}")
    return st.metrics(test=intra - inter, intra=intra, inter=inter)


def gate(args, data, metrics) -> str:
    if metrics["intra"] <= metrics["inter"] + 0.1:
        raise SystemExit("SIGNAL GATE FAILED: metapath2vec embeddings did "
                         "not separate the planted communities")
    return "community-separation gate passed"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
