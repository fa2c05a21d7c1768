"""Tree-LSTM sentiment classification on (synthetic) SST (the
reference's ``examples/train_treelstm.py``): trees batched with
``batch`` and padded to one node count, the recurrence leaves to root
through the compiled topological schedule (``topo_schedule`` +
``prop_nodes_topo_compiled``; ``--eager`` takes the host-scheduled
frontier loop), a 5-class label on every node. Usage:

    python -m dgl1_tpu_torch.examples.train_treelstm [--epochs 5]
        [--cell childsum|nary] [--eager] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dgl1_tpu_torch.examples import Stepper, run

# Every batch's schedule is padded to these (levels, width, arity).
SCHED_PAD = dict(pad_levels=16, pad_width=256, pad_k=4)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--x-size", type=int, default=64)
    p.add_argument("--h-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--cell", default="childsum", choices=["childsum", "nary"])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--eager", action="store_true",
                   help="the host-scheduled frontier loop")
    return p.parse_args(argv)


def build(args, device):
    from dgl1_tpu_torch.data import SSTDataset
    from dgl1_tpu_torch.models import TreeLSTM

    train_set = SSTDataset("train", device="cpu")
    # The test split shares the train vocabulary: the embedding table is
    # sized from it.
    test_set = SSTDataset("test", vocab=train_set._vocab, device="cpu")
    print(f"[data] SST(synthetic): {len(train_set)} train / "
          f"{len(test_set)} test trees, vocab {train_set.vocab_size}")
    model = TreeLSTM(train_set.vocab_size, args.x_size, args.h_size,
                     SSTDataset.num_classes, cell_type=args.cell,
                     device=device,
                     generator=torch.Generator().manual_seed(0))
    # One node count for every batch (the trees have at most 23 nodes).
    node_pad = 1 << int(np.ceil(np.log2(args.batch_size * 24 + 1)))
    return dict(train_set=train_set, test_set=test_set, node_pad=node_pad,
                rng=np.random.default_rng(0), device=device), model


def batch_of(args, data, trees):
    """``(graph, tokens, mask, labels, roots, n_real, schedule)`` of the
    trees batched and padded with isolated nodes to ``node_pad``; the
    root of each tree is the last node of its segment."""
    import dgl1_tpu_torch as dgl

    bg = dgl.batch(trees, device=data["device"])
    n = bg.num_nodes()
    bg = dgl.add_nodes(bg, data["node_pad"] - n)
    sched = None if args.eager else dgl.topo_schedule(bg, **SCHED_PAD)
    offs = np.cumsum([0] + [t.num_nodes() for t in trees])
    return (bg, bg.ndata["x"].long(), bg.ndata["mask"].float(),
            bg.ndata["y"].long(), offs[1:] - 1, n, sched)


def first_batch(args, data, device):
    ds = data["train_set"]
    order = np.random.default_rng(0).permutation(len(ds))
    return batch_of(args, data, [ds[i] for i in order[:args.batch_size]])


def step_loss(args, data, model, batch):
    """The cross entropy summed over the real nodes, over their count."""
    g, toks, mask, y, _, n_real, sched = batch
    ce = torch.nn.functional.cross_entropy(model(g, toks, mask, sched)
                                           [:n_real], y[:n_real],
                                           reduction="sum")
    return ce / n_real


@torch.no_grad()
def test_accuracy(args, data, model):
    """Root and all-node accuracy on the test split."""
    ds = data["test_set"]
    root_hit = root_tot = node_hit = node_tot = 0
    for s in range(0, len(ds), args.batch_size):
        trees = [ds[i] for i in range(s, min(s + args.batch_size, len(ds)))]
        g, toks, mask, y, roots, n_real, sched = batch_of(args, data, trees)
        pred = model(g, toks, mask, sched).argmax(dim=1)
        node_hit += int((pred[:n_real] == y[:n_real]).sum())
        node_tot += n_real
        r = torch.as_tensor(roots, device=pred.device)
        root_hit += int((pred[r] == y[r]).sum())
        root_tot += len(roots)
    return root_hit / root_tot, node_hit / node_tot


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    ds, rng = data["train_set"], data["rng"]
    n = len(ds)
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        t0 = time.perf_counter()
        losses = []
        for s in range(0, n, args.batch_size):
            batch = batch_of(args, data,
                             [ds[i] for i in order[s:s + args.batch_size]])
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            losses.append(st.done(loss))
        print(f"epoch {epoch} loss {np.mean(losses):.4f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    root, node = test_accuracy(args, data, model)
    print(f"test acc: root {root:.4f} all-node {node:.4f}")
    return st.metrics(test=node, root=root)


def gate(args, data, metrics) -> str:
    if metrics["test"] < 0.75:
        raise SystemExit(f"gate failed: all-node acc {metrics['test']:.4f}"
                         f" < 0.75")
    return f"gate passed: all-node acc {metrics['test']:.4f} >= 0.75"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
