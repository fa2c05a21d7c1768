"""Sampled heterogeneous R-GCN entity classification at ogbn-mag's shape
(the reference's ``examples/train_rgcn_sampled.py``): per-relation
fanout sampling into hetero blocks, learned embeddings for the
featureless node types updated by the row-sparse Adam of
:mod:`dgl1_tpu_torch.optim`, on the synthetic ogbn-mag stand-in. Usage:

    python -m dgl1_tpu_torch.examples.train_rgcn_sampled [--scale 64]
        [--epochs 5] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from dgl1_tpu_torch.examples import NO_GATE, Stepper, first_of, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=64,
                    help="divide ogbn-mag node counts by this")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--fanout", type=str, default="10,10")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--embed-dim", type=int, default=64)
    ap.add_argument("--num-classes", type=int, default=16,
                    help="349 on the real dataset; fewer for the scaled "
                         "synthetic stand-in")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--sparse-lr", type=float, default=5e-2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--metrics", type=str, default=None)
    return ap.parse_args(argv)


def build(args, device):
    from dgl1_tpu_torch.data.synthetic import synthetic_mag_heterograph
    from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
    from dgl1_tpu_torch.models import HeteroRGCN
    from dgl1_tpu_torch.optim import NodeEmbedding, sparse_adam_init

    # The graph stays on the host, where the sampler reads it.
    hg, split = synthetic_mag_heterograph(
        scale=args.scale, num_classes=args.num_classes, device="cpu")
    print(f"synthetic ogbn-mag/{args.scale}: "
          + ", ".join(f"{nt}={hg.num_nodes(nt)}" for nt in hg.ntypes)
          + f", {hg.num_edges()} edges, {args.num_classes} classes")
    fanouts = [int(x) for x in args.fanout.split(",")]
    etypes = [c[1] for c in hg.canonical_etypes]
    sampler = NeighborSampler([{e: k for e in etypes} for k in fanouts])
    loader = NodeDataLoader(hg, {"paper": split["train"]}, sampler,
                            batch_size=args.batch_size, shuffle=True,
                            seed=0, device=device)
    val_loader = NodeDataLoader(hg, {"paper": split["val"]}, sampler,
                                batch_size=args.batch_size, shuffle=False,
                                seed=1, device=device)
    embed_types = [nt for nt in hg.ntypes if nt != "paper"]
    # One generator a table, seeded with the table's index, as the script
    # folds the table's index into its key.
    tables = {nt: NodeEmbedding.create(
        hg.num_nodes(nt), args.embed_dim,
        generator=torch.Generator().manual_seed(i), device=device).table
        for i, nt in enumerate(embed_types)}
    states = {nt: sparse_adam_init(t) for nt, t in tables.items()}
    # The script takes its first batch to give its model static shapes;
    # the draw advances the loader's stream, so it is made here too.
    first_of(loader)
    feat = hg.nodes["paper"].data["feat"]
    dims = dict({nt: args.embed_dim for nt in embed_types},
                paper=feat.shape[1])
    model = HeteroRGCN(hg.canonical_etypes, dims, args.hidden,
                       args.num_classes, device=device,
                       generator=torch.Generator().manual_seed(1))
    data = dict(hg=hg, loader=loader, val_loader=val_loader, tables=tables,
                states=states, feat=feat.to(device),
                labels=hg.nodes["paper"].data["label"].to(device))
    return data, model


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    return batch_loss(data, model, batch)[0]


def step_leaves(args, data, model, batch):
    """The step's loss and the embedding rows it read by node type: the
    leaves besides the model's parameters whose gradients the step's
    sparse update takes."""
    return batch_loss(data, model, batch)[:2]


def batch_loss(data, model, batch):
    """The loss of one batch and the embedding rows it read (leaves whose
    ``grad`` the sparse update takes), with their ids."""
    from dgl1_tpu_torch.optim import take_rows
    from dgl1_tpu_torch.train import embed_ids

    inp, out, blocks, mask = batch
    ids = embed_ids(inp, blocks, data["tables"])
    rows = {nt: take_rows(t, ids[nt]).requires_grad_(True)
            for nt, t in data["tables"].items()}
    x = {"paper": data["feat"].index_select(0, inp["paper"]), **rows}
    logits = model(blocks, x)
    y = data["labels"].index_select(0, out["paper"]).long()
    m = mask.to(logits.dtype)
    ls = F.cross_entropy(logits, y, reduction="none")
    return (ls * m).sum() / m.sum().clamp_min(1.0), rows, ids


@torch.no_grad()
def val_accuracy(data, model) -> float:
    from dgl1_tpu_torch.optim import take_rows
    from dgl1_tpu_torch.train import embed_ids

    correct = total = 0.0
    for inp, out, blocks, mask in data["val_loader"]:
        ids = embed_ids(inp, blocks, data["tables"])
        x = {"paper": data["feat"].index_select(0, inp["paper"]),
             **{nt: take_rows(t, ids[nt])
                for nt, t in data["tables"].items()}}
        pred = model(blocks, x).argmax(dim=1)
        y = data["labels"].index_select(0, out["paper"])
        correct += float(((pred == y) & mask).sum())
        total += float(mask.sum())
    return correct / max(total, 1)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.optim import sparse_adam_update
    from dgl1_tpu_torch.utils import MetricsLogger

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    logger = MetricsLogger(args.metrics) if args.metrics else None
    st = Stepper()
    acc = None
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        tot = n = 0.0
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss, rows, ids = batch_loss(data, model, batch)
            loss.backward()
            opt.step()
            for nt, t in data["tables"].items():
                sparse_adam_update(t, data["states"][nt], ids[nt],
                                   rows[nt].grad, lr=args.sparse_lr)
            tot += st.done(loss)
            n += 1
        dt = time.perf_counter() - t0
        acc = val_accuracy(data, model)
        print(f"epoch {epoch:3d} loss {tot / n:.4f} val acc {acc:.4f} "
              f"({dt:.2f}s, {len(data['loader'])} batches)")
        if logger:
            logger.log(epoch=epoch, loss=tot / n, val_acc=acc,
                       epoch_time_s=dt)
    print(f"final val accuracy {acc:.4f} (synthetic stand-in)")
    return st.metrics(val=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
