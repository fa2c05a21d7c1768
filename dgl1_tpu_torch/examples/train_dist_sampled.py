"""Multi-process sampled GraphSAGE training, DistDGL-style (the
reference's ``examples/train_dist_sampled.py``). Each process owns one
partition: it samples seeds from its own part of the partition book,
pulls features for any node from the replicated mmap store written by
``partition_graph`` (or, with ``--sharded-store``, from the sharded
store: its own rows locally, the others from their owners over sockets),
and averages gradients over the process group. Usage:

    python -m dgl1_tpu_torch.examples.train_dist_sampled [--parts 2]
        [--epochs 5] [--sharded-store] [--cpu]

The launcher partitions the graph to ``--out`` and runs one worker a part
(``--worker --part-id p``; more parts than cards on ``cuda`` exits before
any work; one part runs in this process). Workers on other hosts join
with ``--worker --part-id p --coordinator host:port``. ``--out`` and the
ports default to a temporary directory and free ports of this host.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dgl1_tpu_torch.examples import (NO_GATE, Stepper, device_of,
                                     free_port_base, module_name,
                                     need_cards, rank_and_world, run_rank,
                                     spawn_ranks)

GRAPH = "dist_sampled"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parts", type=int, default=2)
    p.add_argument("--nodes", type=int, default=2000)
    p.add_argument("--feat-dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--fanout", type=str, default="5,5")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--out", type=str, default=None,
                   help="partition directory (default: a temporary one, "
                        "removed after the run)")
    p.add_argument("--worker", action="store_true")
    p.add_argument("--part-id", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the process group's store (default: "
                        "a free port of this host)")
    p.add_argument("--sharded-store", action="store_true",
                   help="pull features through the sharded store (each "
                        "process maps only its own partition's rows; "
                        "remote rows over sockets) instead of the "
                        "replicated mmap")
    p.add_argument("--store-port-base", type=int, default=None,
                   help="the sharded store of part p serves on this port "
                        "plus p (default: free ports of this host)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def prepare(args):
    """The launcher's offline step: build the synthetic graph (seed 4),
    partition it greedily and write the partition, the replicated feature
    store, the per-part feature shards and the structure to ``--out``."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel.partition import partition_graph

    g = dgl.data.synthetic_classification_graph(
        num_nodes=args.nodes, num_classes=args.classes,
        feat_dim=args.feat_dim, avg_degree=8.0, seed=4,
        train_per_class=max(args.nodes // (4 * args.classes), 20),
        device="cpu")
    g.ndata["label"] = g.ndata["label"].to(torch.int32)
    partition_graph(g, GRAPH, args.parts, args.out, part_method="greedy")
    print(f"[prepare] partitioned {args.nodes} nodes into {args.parts} "
          f"parts under {args.out}")


class _StoreField:
    """``ndata[field]`` read through the sharded store."""

    def __init__(self, store, field):
        self.store, self.field = store, field

    def __getitem__(self, nids):
        return self.store.pull(self.field, np.asarray(nids))


def rows(field, nids) -> np.ndarray:
    """``field[nids]`` as numpy, from a DistTensor or the sharded store
    (``nids`` numpy or a tensor on any device)."""
    if isinstance(nids, torch.Tensor):
        nids = nids.cpu().numpy()
    out = field[np.asarray(nids)]
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


class SampledSAGE(torch.nn.Module):
    """The script's model: mean aggregation, ``relu(h @ W1)``, mean again
    on the second block's sources, ``@ W2``. Its weights are the
    script's ``normal * 0.2`` under the two halves of ``PRNGKey(0)``, the
    same on every rank."""

    def __init__(self, args, device):
        super().__init__()
        from dgl1_tpu_torch import random as R

        k1, k2 = R.prng_split(R.prng_key(0))
        for name, key, shape in (("W1", k1, (args.feat_dim, args.hidden)),
                                 ("W2", k2, (args.hidden, args.classes))):
            w = R.prng_normal(key, shape) * np.float32(0.2)
            setattr(self, name,
                    torch.nn.Parameter(torch.from_numpy(w).to(device)))

    def forward(self, blocks, x):
        from dgl1_tpu_torch import ops

        h = ops.gspmm(blocks[0], "copy_lhs", "mean", x, None)
        h = torch.relu(h @ self.W1)
        h = ops.gspmm(blocks[1], "copy_lhs", "mean",
                      h[: blocks[1].num_src_nodes()], None)
        return h @ self.W2


def build(args, device):
    """This worker's view: ``DistGraph.from_partition`` (the structure on
    the host, where the sampler reads it; batches go to ``device``), with ``--sharded-store`` a serving
    ``ShardedFeatureStore`` whose fields replace ``ndata`` (every server
    listening before any pull); its own train seeds, the loader (shuffled
    with its part id as seed, the last partial batch dropped), the equal
    step count (the least over the ranks) and the weights."""
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.parallel.dist_dataloader import DistNodeDataLoader
    from dgl1_tpu_torch.parallel.dist_graph import DistGraph

    pid, world = rank_and_world()
    if world != args.parts:
        raise ValueError(f"--parts {args.parts} on a group of {world}")
    dist_g = DistGraph.from_partition(args.out, GRAPH, pid, device="cpu")
    store = None
    if args.sharded_store:
        from dgl1_tpu_torch.parallel.kvstore import ShardedFeatureStore

        addrs = [("127.0.0.1", args.store_port_base + p)
                 for p in range(args.parts)]
        store = ShardedFeatureStore(args.out, GRAPH, pid, dist_g.part,
                                    addrs=addrs, serve=True, device="cpu")
        if args.parts > 1 and not store.local_rows < dist_g.num_nodes():
            raise AssertionError("the sharded store holds the full matrix")
        for fld in list(dist_g.ndata):
            dist_g.ndata[fld] = _StoreField(store, fld)
        if dist.is_initialized():
            dist.barrier()  # every feature server is listening
    own = dist_g.book.partid2nids(pid)
    train_ids = own[rows(dist_g.ndata["train_mask"], own).reshape(-1)
                    .astype(bool)]
    fanouts = [int(x) for x in args.fanout.split(",")]
    loader = DistNodeDataLoader(
        dist_g, train_ids, NeighborSampler(fanouts), feat_name="feat",
        batch_size=args.batch_size, shuffle=True, seed=pid, drop_last=True,
        prefetch=0, device=device)
    # Equal step counts over the processes (the collectives are
    # synchronous), counted as the script counts them.
    steps = torch.tensor([len(loader) - (
        0 if len(train_ids) % args.batch_size == 0 else 1)], device=device)
    if dist.is_initialized():
        dist.all_reduce(steps, op=dist.ReduceOp.MIN)
    data = dict(dist_g=dist_g, store=store, own=own, loader=loader,
                fanouts=fanouts, rank=pid, world=world,
                steps=max(int(steps.item()), 1))
    return data, SampledSAGE(args, device)


def release(data) -> None:
    """Stop this worker's feature server (a build whose ``train`` did not
    run keeps it listening)."""
    if data["store"] is not None:
        data["store"].close()


def first_batch(args, data, device):
    it = iter(data["loader"])
    try:
        return next(it)
    finally:
        it.close()


def labels_of(data, out, device):
    return torch.from_numpy(rows(data["dist_g"].ndata["label"], out)
                            .reshape(-1)).to(device).long()


def step_loss(args, data, model, batch):
    """The masked mean cross entropy of this rank's batch."""
    inp, out, blocks, mask, x = batch
    y = labels_of(data, out, x.device)
    ls = torch.nn.functional.cross_entropy(model(blocks, x), y,
                                           reduction="none")
    m = mask.to(ls.dtype)
    return (ls * m).sum() / m.sum().clamp_min(1.0)


@torch.no_grad()
def test_counts(args, data, model, device):
    """(correct, total) of this rank's own test nodes, sampled."""
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.parallel.dist_dataloader import DistNodeDataLoader

    dist_g, own = data["dist_g"], data["own"]
    test_ids = own[rows(dist_g.ndata["test_mask"], own).reshape(-1)
                   .astype(bool)]
    loader = DistNodeDataLoader(
        dist_g, test_ids, NeighborSampler(data["fanouts"]),
        feat_name="feat", batch_size=args.batch_size, shuffle=False,
        prefetch=0, device=device)
    correct = total = 0
    for inp, out, blocks, mask, x in loader:
        pred = model(blocks, x).argmax(dim=1)
        y = labels_of(data, out, device)
        correct += int(((pred == y) & mask).sum())
        total += int(mask.sum())
    return correct, total


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum
    from dgl1_tpu_torch.parallel.train import make_dp_sampled_step

    steps = data["steps"]
    # The masked mean cross entropy of each rank's batch, the gradients'
    # and the loss's mean over the ranks.
    step = make_dp_sampled_step(
        model, torch.optim.Adam(model.parameters(), lr=args.lr))
    st = Stepper()
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        tot = 0.0
        it = iter(data["loader"])
        for _ in range(steps):
            inp, out, blocks, mask, x = next(it)
            y = labels_of(data, out, device)
            st.start()
            tot += st.done(step(blocks, x, y, mask))
        it.close()
        if data["rank"] == 0:
            print(f"[worker0] epoch {epoch} loss {tot / steps:.4f} "
                  f"({time.perf_counter() - t0:.1f}s, {steps} steps x "
                  f"{args.parts} procs)", flush=True)
    correct, total = test_counts(args, data, model, device)
    agg = all_reduce_sum(torch.tensor([correct, total], dtype=torch.int64,
                               device=device)).cpu()
    acc = float(agg[0]) / max(int(agg[1]), 1)
    metrics = st.metrics(test=acc, test_nodes=int(agg[1]))
    store = data["store"]
    if store is not None:
        st_ = store.stats()
        remote_all = int(all_reduce_sum(torch.tensor(
            [st_["remote_rows"]], dtype=torch.int64, device=device)).item())
        metrics.update(local_rows=store.local_rows,
                       num_nodes=data["dist_g"].num_nodes(),
                       pulls_local=st_["local_rows"],
                       pulls_remote=st_["remote_rows"],
                       remote_rows_all=remote_all)
        if data["rank"] == 0:
            print(f"[worker0] sharded store: local_rows="
                  f"{store.local_rows}/{data['dist_g'].num_nodes()}, pulls "
                  f"local={st_['local_rows']} remote={st_['remote_rows']} "
                  f"(all-proc remote={remote_all})", flush=True)
        if dist.is_initialized():
            dist.barrier()  # every peer has pulled its last row
        store.close()
    if data["rank"] == 0:
        print(f"[worker0] test acc {acc:.4f} ({int(agg[1])} test nodes "
              f"across {args.parts} parts)", flush=True)
    return metrics


def gate(args, data, metrics) -> str:
    """The script's gate with ``--sharded-store``: remote rows really
    crossed the socket. One part owns every row, so there it only
    reports that no pull could be remote."""
    if not args.sharded_store:
        return NO_GATE
    if args.parts == 1:
        return (f"sharded store over 1 part: all {metrics['local_rows']} "
                f"rows local, no remote pull possible (the remote-pull "
                f"gate needs 2 or more parts)")
    if metrics["remote_rows_all"] <= 0:
        raise SystemExit("no remote pulls: the sharded store was not "
                         "exercised")
    return (f"sharded store gate passed: {metrics['remote_rows_all']} "
            f"remote rows pulled")


def worker_argv(args, rank: int) -> list:
    """The command line of part ``rank``'s worker."""
    argv = ["--worker", "--part-id", str(rank), "--parts", str(args.parts),
            "--nodes", str(args.nodes), "--feat-dim", str(args.feat_dim),
            "--classes", str(args.classes), "--hidden", str(args.hidden),
            "--fanout", args.fanout, "--batch-size", str(args.batch_size),
            "--epochs", str(args.epochs), "--lr", str(args.lr), "--out",
            args.out, "--coordinator", args.coordinator]
    if args.store_port_base is not None:
        argv += ["--store-port-base", str(args.store_port_base)]
    if args.sharded_store:
        argv.append("--sharded-store")
    if args.cpu:
        argv.append("--cpu")
    return argv


def launch(args) -> dict:
    """Partition to ``--out``, then one worker a part (spawned ranks;
    this process for one part); rank 0's metrics."""
    need_cards(args.parts, device_of(args))
    tmp = None
    if args.out is None:
        tmp = args.out = tempfile.mkdtemp(prefix="dgl1_dist_sampled_")
    try:
        if args.coordinator is None:
            args.coordinator = f"127.0.0.1:{free_port_base()}"
        if args.sharded_store and args.store_port_base is None:
            args.store_port_base = free_port_base(args.parts)
        prepare(args)
        name = module_name(sys.modules[__name__])
        calls = [(name, worker_argv(args, r), r, args.parts,
                  f"tcp://{args.coordinator}") for r in range(args.parts)]
        if args.parts == 1:
            return run_rank(*calls[0])
        return spawn_ranks("dgl1_tpu_torch.examples", "run_rank", calls)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        if args.coordinator is None or args.out is None:
            raise SystemExit("--worker needs --coordinator and --out")
        return run_rank(module_name(sys.modules[__name__]), argv,
                        args.part_id, args.parts,
                        f"tcp://{args.coordinator}")
    return launch(args)


if __name__ == "__main__":
    main()
