"""Heterogeneous link prediction, user-item recommendation on sampled
blocks (the reference's ``examples/train_hetero_link_pred.py``). A
planted-cluster bipartite graph (users buy items of their own group)
gives a signal the held-out AUC must show: the gate is AUC >= 0.70. The
encoder is two ``HeteroGraphConv`` layers over per-relation sampled
blocks; scores are dot products on the positive and negative pair
graphs, with ``exclude='reverse_types'`` keeping the reverse relation
from leaking. Usage:

    python -m dgl1_tpu_torch.examples.train_hetero_link_pred [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgl1_tpu_torch.examples import Stepper, first_of, run

ETYPES = ["buys", "bought_by"]
BUYS = ("user", "buys", "item")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--users", type=int, default=200)
    p.add_argument("--items", type=int, default=150)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--edges", type=int, default=2000)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


class Encoder(nn.Module):
    """``emb`` (learned inputs of the featureless graph: normal rows of
    std 0.1) into two ``HeteroGraphConv({etype: GraphConv})`` layers
    (``enc.l0``, relu, ``enc.l1``)."""

    def __init__(self, users, items, hidden, device=None):
        super().__init__()
        from dgl1_tpu_torch.nn import GraphConv, HeteroGraphConv

        gen = torch.Generator().manual_seed(1)

        def layer():
            return HeteroGraphConv({e: GraphConv(hidden, hidden,
                                                 device=device,
                                                 generator=gen)
                                    for e in ETYPES})

        self.l0, self.l1 = layer(), layer()
        self.emb = nn.ParameterDict({
            nt: nn.Parameter(0.1 * torch.randn(
                n, hidden, generator=torch.Generator().manual_seed(i))
                .to(device))
            for i, (nt, n) in enumerate((("user", users), ("item", items)))})

    def inputs(self, input_nodes: dict) -> dict:
        """The rows of each type's input nodes (ids clamped into range)."""
        return {nt: self.emb[nt].index_select(
            0, torch.as_tensor(ids, device=self.emb[nt].device).long()
            .clamp(0, len(self.emb[nt]) - 1))
            for nt, ids in input_nodes.items()}

    def forward(self, blocks, input_nodes: dict):
        h = self.l0(blocks[0], self.inputs(input_nodes))
        return self.l1(blocks[1], {k: torch.relu(v) for k, v in h.items()})


def score(h, pair):
    """Dot products of the pair graph's buys edges: its local ids index
    the blocks' seed prefix of each type."""
    rel = pair.rel_graphs[BUYS]
    e = rel.num_edges()
    return (h["user"][rel.src[:e].long()]
            * h["item"][rel.dst[:e].long()]).sum(dim=-1)


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.dataloading import EdgeDataLoader, NeighborSampler
    from dgl1_tpu_torch.dataloading.negative_sampler import Uniform

    rng = np.random.default_rng(0)
    gu = rng.integers(0, args.groups, args.users)
    gi = rng.integers(0, args.groups, args.items)
    # 90% of purchases stay within the user's group.
    src, dst = [], []
    for _ in range(args.edges):
        u = rng.integers(args.users)
        if rng.random() < 0.9:
            pool = np.nonzero(gi == gu[u])[0]
        else:
            pool = np.arange(args.items)
        src.append(u)
        dst.append(int(rng.choice(pool)))
    src, dst = np.asarray(src), np.asarray(dst)
    # The graph stays on the host, where the sampler reads it.
    hg = dgl.heterograph({BUYS: (src, dst),
                          ("item", "bought_by", "user"): (dst, src)},
                         num_nodes_dict={"user": args.users,
                                         "item": args.items}, device="cpu")
    eids = rng.permutation(args.edges)
    n_train = int(0.8 * args.edges)
    sampler = NeighborSampler([{e: 5 for e in ETYPES}] * 2,
                              static_shapes=False)
    loader = EdgeDataLoader(
        hg, {"buys": eids[:n_train]}, sampler, batch_size=args.batch_size,
        negative_sampler=Uniform(4), exclude="reverse_types",
        reverse_etypes={"buys": "bought_by", "bought_by": "buys"}, seed=0,
        device=device)
    # The script takes its first batch to give its model shapes; the draw
    # advances the loader's stream, so it is made here too.
    first_of(loader)
    model = Encoder(args.users, args.items, args.hidden, device=device)
    return dict(hg=hg, loader=loader, src=src, dst=dst,
                test_eids=eids[n_train:], rng=rng), model


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    inp, pos, neg, blocks = batch
    h = model(blocks, inp)
    return -(F.logsigmoid(score(h, pos)).mean()
             + F.logsigmoid(-score(h, neg)).mean())


def held_out_auc(args, data, model, device) -> float:
    """Test edges against random item corruptions of their users, scored
    through a full-neighbourhood (unsampled) encoder pass."""
    from dgl1_tpu_torch.dataloading import NeighborSampler

    full = NeighborSampler([{e: -1 for e in ETYPES}] * 2,
                           static_shapes=False)
    inp, _, blocks = full.sample_blocks(
        data["hg"], {"user": np.arange(args.users),
                     "item": np.arange(args.items)})
    with torch.no_grad():
        h = model([b.to(device) for b in blocks], inp)
    hu, hi = h["user"].cpu().numpy(), h["item"].cpu().numpy()
    t = data["test_eids"]
    ts, td = data["src"][t], data["dst"][t]
    neg_d = data["rng"].integers(0, args.items, len(t))
    pos_s = np.sum(hu[ts] * hi[td], axis=-1)
    neg_s = np.sum(hu[ts] * hi[neg_d], axis=-1)
    return float(np.mean(pos_s[:, None] > neg_s[None, :]))


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        losses = []
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            losses.append(st.done(loss))
        print(f"epoch {epoch + 1:2d} loss {np.mean(losses):.4f}")
    value = held_out_auc(args, data, model, device)
    print(f"done in {time.perf_counter() - t0:.1f}s; held-out AUC "
          f"{value:.3f}")
    return st.metrics(test=value)


def gate(args, data, metrics) -> str:
    if metrics["test"] < 0.70:
        raise SystemExit(f"SIGNAL GATE FAILED: AUC {metrics['test']:.3f} "
                         f"< 0.70")
    return f"signal gate passed (AUC {metrics['test']:.3f} >= 0.70)"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
