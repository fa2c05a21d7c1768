"""Mini-batch GraphSAGE with neighbour sampling (the reference's
``examples/train_sage_minibatch.py``: fanouts 10,25 on Reddit). The
graph stays on the host, where the loader's threads sample; blocks and
features go to the device. Usage:

    python -m dgl1_tpu_torch.examples.train_sage_minibatch [--epochs 5]
        [--full-scale] [--feature-store] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dgl1_tpu_torch.examples import Stepper, first_of, masked_ce, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--fanouts", default="10,25")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--full-scale", action="store_true",
                   help="full-size synthetic Reddit")
    p.add_argument("--feature-store", action="store_true",
                   help="keep the features in the host store (threaded "
                        "row gather, copied to the device ahead of the "
                        "step)")
    p.add_argument("--metrics", default=None)
    return p.parse_args(argv)


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.data import HostFeatureStore
    from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
    from dgl1_tpu_torch.models import GraphSAGE

    ds = dgl.data.RedditDataset(full_scale=args.full_scale, device="cpu")
    g = ds[0]
    print(f"[data] reddit{'(synthetic)' if ds.is_synthetic else ''}: "
          f"{g.num_nodes()} nodes, {g.num_edges()} edges")
    feat = g.ndata["feat"].numpy()
    labels = g.ndata["label"].numpy().astype(np.int32)
    train_ids = np.nonzero(g.ndata["train_mask"].numpy())[0]
    test_ids = np.nonzero(g.ndata["test_mask"].numpy())[0]
    fanouts = [int(x) for x in args.fanouts.split(",")]
    sampler = NeighborSampler(fanouts)
    loader = NodeDataLoader(g, train_ids, sampler,
                            batch_size=args.batch_size, shuffle=True, seed=0,
                            device=device)
    # The script samples one batch to give its model static shapes; the
    # draw advances the loader's stream, so it is made here too.
    loader.collator.collate(train_ids[: args.batch_size], args.batch_size)
    model = GraphSAGE(feat.shape[1], args.hidden, int(labels.max()) + 1,
                      num_layers=len(fanouts), device=device,
                      generator=torch.Generator().manual_seed(0))
    data = dict(ds=ds, g=g, device=device, feat_host=feat,
                labels_host=labels,
                labels=torch.as_tensor(labels, device=device),
                sampler=sampler, loader=loader, test_ids=test_ids)
    if args.feature_store:
        # The features never enter the device whole: the host store
        # gathers each batch's rows (threaded) and copies them over.
        data["store"] = HostFeatureStore(feat, device=device)
    else:
        data["feat"] = torch.as_tensor(feat, device=device)
    return data, model


def input_rows(data, inp):
    """The input nodes' feature rows on the device."""
    if "store" in data:
        return data["store"].pull_to_device(inp)
    return data["feat"].index_select(0, inp)


def batches(args, data):
    """The epoch's ``(input_nodes, output_nodes, blocks, mask, x, y)``:
    with ``--feature-store`` the rows pulled from the host store by a
    thread ahead of the step, else gathered from the device copy."""
    from dgl1_tpu_torch.data import prefetch_to_device

    loader = data["loader"]
    if "store" in data:
        for inp, out, blocks, mask, x, y in prefetch_to_device(
                iter(loader), data["store"], labels=data["labels_host"]):
            yield inp, out, blocks, mask, x, y.reshape(-1)
        return
    for inp, out, blocks, mask in loader:
        yield (inp, out, blocks, mask, data["feat"].index_select(0, inp),
               data["labels"].index_select(0, out))


def first_batch(args, data, device):
    return first_of(batches(args, data))


def step_loss(args, data, model, batch):
    """The cross entropy over the batch's real seeds."""
    _, _, blocks, mask, x, y = batch
    return masked_ce(model(blocks, x), y, mask, floor=1.0)


@torch.no_grad()
def sampled_accuracy(args, data, model) -> float:
    """Test accuracy on sampled blocks (the script's approximate
    inference)."""
    from dgl1_tpu_torch.dataloading import NodeDataLoader

    loader = NodeDataLoader(data["g"], data["test_ids"], data["sampler"],
                            batch_size=args.batch_size, shuffle=False,
                            device=data["device"])
    correct = total = 0
    for inp, out, blocks, mask in loader:
        pred = model(blocks, input_rows(data, inp)).argmax(dim=1)
        y = data["labels"].index_select(0, out)
        correct += int(((pred == y) & mask).sum())
        total += int(mask.sum())
    return correct / max(total, 1)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.utils import MetricsLogger

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    logger = MetricsLogger(args.metrics) if args.metrics else None
    st = Stepper()
    # The script applies its model deterministically: no dropout.
    model.eval()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        total_loss = n_batches = seeds = 0
        for batch in batches(args, data):
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            total_loss += st.done(loss)
            n_batches += 1
            seeds += int(batch[3].sum())
        dt = time.perf_counter() - t0
        print(f"epoch {epoch} loss {total_loss / max(n_batches, 1):.4f} "
              f"({dt:.1f}s, {seeds / dt:.0f} seeds/s)")
        if logger:
            logger.log(epoch=epoch, loss=total_loss / max(n_batches, 1),
                       seeds_per_s=seeds / dt)
    acc = sampled_accuracy(args, data, model)
    print(f"test acc (sampled inference): {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    """Hamilton et al. 2017: Reddit ~0.95 with sampled inference; real
    data only."""
    if data["ds"].is_synthetic:
        return "no gate on synthetic data"
    if metrics["test"] < 0.94:
        raise SystemExit(f"ACCURACY GATE FAILED: reddit test "
                         f"{metrics['test']:.4f} < 0.94")
    return f"accuracy gate passed ({metrics['test']:.4f} >= 0.94)"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
