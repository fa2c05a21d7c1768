"""Cluster-GCN, partition-based mini-batch training on whole subgraphs
(the reference's ``examples/train_cluster_gcn.py``): each batch is the
node-induced subgraph of a random union of clusters, padded to bucketed
shapes. Usage:

    python -m dgl1_tpu_torch.examples.train_cluster_gcn [--epochs 10]
        [--num-parts 16] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dgl1_tpu_torch.examples import (NO_GATE, Stepper, accuracy, first_of,
                                     masked_ce, run)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--num-parts", type=int, default=16)
    p.add_argument("--parts-per-batch", type=int, default=4)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--metrics", default=None)
    return p.parse_args(argv)


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.dataloading import ClusterGCNDataLoader
    from dgl1_tpu_torch.models import GCN

    ds = dgl.data.CoraGraphDataset(device=device)
    g = dgl.add_self_loop(ds[0])
    print(f"[data] cora{'(synthetic)' if ds.is_synthetic else ''}: "
          f"{g.num_nodes()} nodes, {g.num_edges()} edges, "
          f"{args.num_parts} clusters")
    loader = ClusterGCNDataLoader(
        g, num_parts=args.num_parts, parts_per_batch=args.parts_per_batch,
        shuffle=True, seed=0, device=device)
    # The script takes its first batch to give its model shapes; the draw
    # advances the loader's stream, so it is made here too.
    first_of(loader)
    labels = g.ndata["label"]
    model = GCN(g.ndata["feat"].shape[1], args.hidden,
                int(labels.max()) + 1, dropout=0.0, device=device,
                generator=torch.Generator().manual_seed(0))
    return dict(g=g, loader=loader, labels=labels,
                train_mask=g.ndata["train_mask"]), model


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    sg, node_mask = batch
    ids = sg.ndata["_ID"].long()
    tm = data["train_mask"][ids] & node_mask
    return masked_ce(model(sg, sg.ndata["feat"]), data["labels"][ids], tm,
                     floor=1.0)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.utils import MetricsLogger

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    logger = MetricsLogger(args.metrics) if args.metrics else None
    st = Stepper()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        total = n = 0
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            total += st.done(loss)
            n += 1
        print(f"epoch {epoch} loss {total / max(n, 1):.4f} "
              f"({time.perf_counter() - t0:.2f}s)")
        if logger:
            logger.log(epoch=epoch, loss=total / max(n, 1))
    # Full-graph evaluation.
    g = data["g"]
    with torch.no_grad():
        pred = model(g, g.ndata["feat"]).argmax(dim=1)
    accs = {}
    for split in ("val", "test"):
        accs[split] = accuracy(pred, data["labels"], g.ndata[f"{split}_mask"])
        print(f"{split} acc: {accs[split]:.4f}")
    return st.metrics(**accs)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
