"""Distributed sampled typed R-GCN, the DistDGL training shape (the
reference's ``examples/train_rgcn_dist_sampled.py``): the heterograph
partitioned (homogenize, partition, split per node type); each rank draws
its minibatch seeds from the train papers its partition owns, samples
typed blocks on the host and runs a replicated two-layer
``HeteroGraphConv(GraphConv)`` model whose gradients, and those of the
replicated embedding tables of the featureless types, are averaged over
the ranks. Usage:

    python -m dgl1_tpu_torch.examples.train_rgcn_dist_sampled [--parts 8]
        [--cpu]

``--parts P`` runs P ranks: gloo on the CPU (``--cpu``), NCCL on the card,
one card a rank (more parts than cards exits before any work).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dgl1_tpu_torch.examples import Stepper, rank_and_world, run_parts


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--scale", type=int, default=120)
    ap.add_argument("--classes", type=int, default=12)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=48)
    ap.add_argument("--embed-dim", type=int, default=48)
    ap.add_argument("--fanout", default="4,4")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--min-acc", type=float, default=0.55)
    return ap.parse_args(argv)


class DPRGCN(torch.nn.Module):
    """The replicated model: ``net`` (the script's two
    ``HeteroGraphConv({etype: GraphConv})`` layers, ``l0`` and ``l1``)
    and ``emb``, a whole embedding table a featureless type."""

    def __init__(self, net, emb: dict, device):
        super().__init__()
        self.net = net
        self.emb = torch.nn.ParameterDict({
            nt: torch.nn.Parameter(torch.as_tensor(v).to(device))
            for nt, v in emb.items()})

    def forward(self, blocks, x_paper, ids):
        """Logits of the batch's seed papers: the paper rows and the
        embedding rows of ``ids`` (clipped into the table, as the script
        takes them)."""
        x = {"paper": x_paper}
        for nt, t in self.emb.items():
            x[nt] = t.index_select(0, ids[nt].clamp(0, t.shape[0] - 1))
        return self.net(blocks, x)


def init_tables(hg, embed_types, dim: int) -> dict:
    """The script's tables: ``normal(fold_in(PRNGKey(0), i), (N, dim)) *
    0.1`` for the i-th featureless type."""
    from dgl1_tpu_torch import random as R

    key = R.prng_key(0)
    return {nt: R.prng_normal(R.prng_fold_in(key, i),
                              (hg.num_nodes(nt), dim)) * np.float32(0.1)
            for i, nt in enumerate(embed_types)}


def build(args, device):
    """The synthetic ogbn-mag heterograph on the host, the greedy typed
    assignment and the partition book, each part's train seeds, the
    typed sampler, the model (``HeteroRGCN`` drawn as the script's
    ``model.init(PRNGKey(1))`` scheme) and the tables; then the script's
    first draw of every rank's batch (its init batch), which advances
    the batch stream."""
    from dgl1_tpu_torch.data.synthetic import synthetic_mag_heterograph
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.models import HeteroRGCN
    from dgl1_tpu_torch.parallel import (GraphPartitionBook,
                                         hetero_partition_assignment)

    rank, world = rank_and_world()
    if world != args.parts:
        raise ValueError(f"--parts {args.parts} on a group of {world}")
    K = args.parts
    hg, split = synthetic_mag_heterograph(
        scale=args.scale, num_classes=args.classes, feat_dim=args.feat_dim,
        device="cpu")
    part = hetero_partition_assignment(hg, K, part_method="greedy")
    book = GraphPartitionBook(part["paper"], K)
    seeds_per_part = [np.intersect1d(book.partid2nids(p), split["train"])
                      for p in range(K)]
    print(f"partitioned: {[len(s) for s in seeds_per_part]} train seeds "
          f"per device")
    fanouts = [int(x) for x in args.fanout.split(",")]
    etypes = [c[1] for c in hg.canonical_etypes]
    embed_types = [nt for nt in hg.ntypes if nt != "paper"]
    data = dict(
        hg=hg, split=split, K=K, rank=rank, seeds=seeds_per_part,
        sampler=NeighborSampler([{e: k for e in etypes} for k in fanouts]),
        embed_types=embed_types, rng=np.random.default_rng(0),
        feat=hg.nodes["paper"].data["feat"].numpy(),
        labels=hg.nodes["paper"].data["label"].numpy())
    next_batch(args, data, device)  # the script's init batch
    dims = dict({nt: args.embed_dim for nt in embed_types},
                paper=args.feat_dim)
    net = HeteroRGCN(hg.canonical_etypes, dims, args.hidden, args.classes,
                     device=device,
                     generator=torch.Generator().manual_seed(1))
    model = DPRGCN(net, init_tables(hg, embed_types, args.embed_dim),
                   device)
    return data, model


def part_batch(args, data, p: int, rng):
    """Part ``p``'s sampled batch (the script's ``device_batch``): its
    seeds drawn from its own train papers, the typed blocks, the paper
    rows, the embedded types' input ids and the labels (numpy, host
    blocks)."""
    own = data["seeds"][p]
    seeds = rng.choice(own, size=args.batch_size,
                       replace=len(own) < args.batch_size)
    inp, out, blocks = data["sampler"].sample_blocks_hetero(
        data["hg"], {"paper": seeds}, rng=rng)
    ids = {nt: np.asarray(inp.get(nt, np.zeros(0, np.int64)))
           for nt in data["embed_types"]}
    return (blocks, data["feat"][np.asarray(inp["paper"])], ids,
            data["labels"][np.asarray(out["paper"])])


def next_batch(args, data, device):
    """This rank's batch of the next step, on ``device``. The script
    draws every part's batch from one stream in part order; each rank
    draws them all the same way and keeps its own."""
    batches = [part_batch(args, data, p, data["rng"])
               for p in range(data["K"])]
    blocks, x, ids, y = batches[data["rank"]]
    return ([b.to(device) for b in blocks],
            torch.from_numpy(x).to(device),
            {nt: torch.from_numpy(v).to(device) for nt, v in ids.items()},
            torch.from_numpy(y).to(device).long())


def first_batch(args, data, device):
    return next_batch(args, data, device)


def step_loss(args, data, model, batch):
    """This rank's mean cross entropy over its batch's seeds."""
    blocks, x, ids, y = batch
    return F.cross_entropy(model(blocks, x, ids), y)


def average_grads(params, world: int) -> None:
    """The mean of each gradient over the ranks (the script's ``pmean``;
    the embedding tables' too, as they are replicated). A parameter the
    loss does not reach (a relation of the last layer into another type
    than paper) takes a zero gradient, as the script's does, so that
    every rank reduces the same tensors."""
    if world == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad)
        p.grad /= world


@torch.no_grad()
def sampled_accuracy(args, data, model, device) -> float:
    """The script's sampled test accuracy: 4 batches of test papers
    drawn without replacement from ``default_rng(99)``."""
    test_ids = data["split"]["test"]
    hits = total = 0
    eval_rng = np.random.default_rng(99)
    for _ in range(4):
        seeds = eval_rng.choice(test_ids, size=args.batch_size,
                                replace=False)
        inp, out, blocks = data["sampler"].sample_blocks_hetero(
            data["hg"], {"paper": seeds}, rng=eval_rng)
        ids = {nt: torch.from_numpy(np.asarray(inp[nt])).to(device)
               for nt in data["embed_types"]}
        x = torch.from_numpy(data["feat"][np.asarray(inp["paper"])]).to(
            device)
        pred = model([b.to(device) for b in blocks], x, ids).argmax(dim=-1)
        yb = data["labels"][np.asarray(out["paper"])]
        hits += int((pred.cpu().numpy() == yb).sum())
        total += len(yb)
    return hits / total


def train(args, data, model, device) -> dict:
    _, world = rank_and_world()
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    params = list(model.parameters())
    steps = max(min(len(s) for s in data["seeds"]) // args.batch_size, 1)
    st = Stepper()
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        tot = 0.0
        for _ in range(steps):
            batch = next_batch(args, data, device)
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            average_grads(params, world)
            opt.step()
            mean = loss.detach().clone()
            if world > 1:
                dist.all_reduce(mean)
            tot += st.done(mean / world)
        print(f"epoch {epoch:3d} loss {tot / steps:.4f}")
    dt = time.perf_counter() - t0
    acc = None
    if data["rank"] == 0:
        acc = sampled_accuracy(args, data, model, device)
        print(f"done in {dt:.1f}s ({args.epochs * steps / dt:.1f} "
              f"steps/s); sampled test acc {acc:.4f}")
    return st.metrics(test=acc, steps_per_epoch=steps)


def gate(args, data, metrics) -> str:
    acc = metrics["test"]
    if acc < args.min_acc:
        raise SystemExit(f"gate failed: {acc:.4f} < {args.min_acc}")
    return f"sampled accuracy gate passed: {acc:.4f} >= {args.min_acc}"


def main(argv=None):
    return run_parts(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
