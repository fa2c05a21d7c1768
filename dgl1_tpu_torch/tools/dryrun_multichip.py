"""Dry run of the distributed layer: the homogeneous legs of the
reference's ``dryrun_multichip`` (``__graft_entry__.py``).

    python -m dgl1_tpu_torch.tools.dryrun_multichip --nproc 4 --device cpu
    python -m dgl1_tpu_torch.tools.dryrun_multichip --device cuda

``--device cpu`` runs ``--nproc`` ranks over gloo on the host;
``--device cuda`` runs one rank over NCCL on the card (world size 1: one
process a card). Rank 0 prints one line per leg, as the reference does:

1. the halo GCN train step (``to_bidirected(powerlaw_graph(100000, 12))``,
   16 -> 32 -> 8, greedy edge-balanced parts, the segment path over the
   int8 wire, Adam 1e-2);
2. a 2-layer sharded GAT train step on leg 1's build (2 heads of 8);
3. the vertex-cut GCN matvec forward and gradient
   (``powerlaw_graph(20000, 5, seed=1)``, tile reduce);
4. the vertex-cut online-softmax GAT forward and gradient;
5. the hub-engine matvec forward and gradient
   (``powerlaw_graph(12000, 6, seed=4)``, hub 256, dense floor 512, bf16
   wire, identity relabel);
6. the flagship combined + prefilled identity GCN train step on leg 5's
   build;
7. the block-dense matvec forward and gradient (a 50,000-node band
   graph, contiguous parts, F = 32);
11. the data-parallel sampled GraphSAGE step: ``partition_graph`` of a
   20,000-node graph into random parts, ``DistGraph.from_partition``,
   ``DistNodeDataLoader`` over the part's own seeds (batch 256, fanouts
   [5, 5]), features from the replicated mmap store, gradients averaged.

``--scale`` multiplies every node count (for a quick CPU run).
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["run_legs", "main"]


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _sum_all(x: float) -> float:
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64)
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t)
    return float(t[0])


def run_legs(rank: int, world: int, device, scale: float = 1.0,
             workdir=None, log=None):
    """Run legs 1-7 and 11 on this rank (``torch.distributed`` initialized
    when ``world`` > 1); returns one record per leg. ``log(record)`` is
    called on each as it ends."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.data.synthetic import (powerlaw_graph,
                                               synthetic_classification_graph)
    from dgl1_tpu_torch.parallel import (build_partitioned_graph,
                                         vertex_cut_edge_owner)
    from dgl1_tpu_torch.parallel.partition import greedy_partition_assignment
    from dgl1_tpu_torch.parallel.sharded_ops import (
        fill_halo_combined, make_sharded_gat_layer, make_sharded_gcn_matvec)
    from dgl1_tpu_torch.parallel.train import (init_gcn_params,
                                               make_gcn_train_step)

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    records = []

    def n_of(n):
        return max(int(n * scale), 64)

    def done(leg, name, t0, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"leg": leg, "name": name, "world": world,
               "seconds": time.perf_counter() - t0, **kw}
        records.append(rec)
        if log is not None:
            log(rec)

    def local(pg):
        return pg.local(rank, dev)

    def shard(pg, data):
        return pg.shard_node_data(data, rank).to(dev)

    def fwd_grad(fn, x):
        x = x.clone().requires_grad_(True)
        val = torch.sin(fn(x)).sum()
        val.backward()
        return _sum_all(float(val.detach())), x.grad

    # Leg 1: the halo GCN train step.
    t0 = time.perf_counter()
    n, in_f, hidden, classes = n_of(100_000), 16, 32, 8
    g = dgl.to_bidirected(powerlaw_graph(n, 12, seed=0, device="cpu"))
    part = greedy_partition_assignment(g, world, balance_edges=True)
    pg = build_partitioned_graph(g, part, world, tiles=False,
                                 halo_dtype="int8")
    pl = local(pg)
    params = init_gcn_params(in_f, hidden, classes, device=dev,
                             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step, _ = make_gcn_train_step(pl, opt, classes)
    feat = rng.normal(size=(n, in_f)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    x = shard(pg, feat)
    mask = torch.as_tensor(pg.node_mask[rank], device=dev)
    loss = step(params, x, shard(pg, labels), mask)
    done(1, "halo GCN train step", t0, nodes=n, edges=g.num_edges(),
         loss=loss)

    # Leg 2: a 2-layer sharded GAT train step on leg 1's build.
    t0 = time.perf_counter()
    h, d = 2, 8
    gen = torch.Generator().manual_seed(1)
    gp = {k: (torch.randn(shape, generator=gen) * 0.1).to(dev)
          .requires_grad_(True) for k, shape in (
              ("W1", (in_f, h * d)), ("al1", (h, d)), ("ar1", (h, d)),
              ("W2", (h * d, h * d)), ("al2", (h, d)), ("ar2", (h, d)))}
    gopt = torch.optim.Adam(gp.values(), lr=1e-3)
    layer = make_sharded_gat_layer(pl)

    def gat_layer(w, al, ar, x2):
        ft = (x2 @ w).reshape(x2.shape[0], h, d)
        out = layer((ft * al).sum(-1), (ft * ar).sum(-1), ft)
        return torch.nn.functional.elu(out.reshape(x2.shape[0], h * d))

    gopt.zero_grad()
    h1 = gat_layer(gp["W1"], gp["al1"], gp["ar1"], x)
    h2 = gat_layer(gp["W2"], gp["al2"], gp["ar2"], h1)
    gat_loss = (h2 ** 2).sum() / pl.n_loc
    gat_loss.backward()
    from dgl1_tpu_torch.parallel.sharded_ops import allreduce_grads

    allreduce_grads(gp.values())
    gopt.step()
    done(2, "2-layer sharded GAT train step", t0,
         loss=_sum_all(float(gat_loss.detach())))
    del pg, pl, g

    # Legs 3 and 4: vertex cut (tile reduce) matvec and online softmax.
    t0 = time.perf_counter()
    n2 = n_of(20_000)
    g2 = powerlaw_graph(n2, 5, seed=1, device="cpu")
    part2 = greedy_partition_assignment(g2, world, balance_edges=True)
    eo = vertex_cut_edge_owner(g2, part2, world)
    pg2 = build_partitioned_graph(g2, part2, world, edge_owner=eo)
    if world > 1 and pg2.m_part == 0:
        raise AssertionError("expected split destinations on a hub graph")
    pl2 = local(pg2)
    val, _ = fwd_grad(make_sharded_gcn_matvec(pl2),
                      shard(pg2, rng.normal(size=(n2, 16)).astype(
                          np.float32)))
    done(3, "vertex-cut GCN matvec fwd+grad", t0, e_loc=pg2.e_loc,
         m_part=pg2.m_part, value=val)
    t0 = time.perf_counter()
    layer2 = make_sharded_gat_layer(pl2)
    el, er = (shard(pg2, rng.normal(size=(n2, h)).astype(np.float32))
              .requires_grad_(True) for _ in range(2))
    ft = shard(pg2, rng.normal(size=(n2, h, d)).astype(
        np.float32)).requires_grad_(True)
    val = (layer2(el, er, ft) ** 2).sum()
    val.backward()
    done(4, "vertex-cut online-softmax GAT fwd+grad", t0,
         value=_sum_all(float(val.detach())))
    del pg2, pl2, g2

    # Leg 5: the hub engine's matvec on the identity-relabeled layouts.
    t0 = time.perf_counter()
    n2b = n_of(12_000)
    g2b = powerlaw_graph(n2b, 6, seed=4, device="cpu")
    part2b = greedy_partition_assignment(g2b, world, balance_edges=True)
    pg2b = build_partitioned_graph(g2b, part2b, world, tiles=False, hub=256,
                                   hub_dense_floor=512, halo_dtype="bf16",
                                   hub_identity=True)
    m = pg2b.hub_meta
    if m is None or not m.identity_expand:
        raise AssertionError(f"leg 5 needs an identity hub layout: {m}")
    pl2b = local(pg2b)
    feat2b = rng.normal(size=(n2b, 16)).astype(np.float32)
    val, _ = fwd_grad(make_sharded_gcn_matvec(pl2b), shard(pg2b, feat2b))
    done(5, "sharded HUB-engine GCN matvec fwd+grad", t0,
         groups=m.n_groups, dense=m.n_dense,
         cov=m.covered / g2b.num_edges(), value=val)

    # Leg 6: the flagship combined + prefilled identity train step.
    t0 = time.perf_counter()
    p6 = init_gcn_params(16, 16, 8, device=dev,
                         generator=torch.Generator().manual_seed(3))
    opt6 = torch.optim.Adam(p6.values(), lr=1e-2)
    step6, _ = make_gcn_train_step(pl2b, opt6, 8, combined=True,
                                   prefilled=True)
    x6 = fill_halo_combined(pl2b)(
        pg2b.shard_node_data_combined(feat2b, rank).to(dev))
    y6 = shard(pg2b, rng.integers(0, 8, n2b))
    loss6 = step6(p6, x6, y6, torch.as_tensor(pg2b.node_mask[rank],
                                              device=dev))
    done(6, "FLAGSHIP combined+prefilled identity train step", t0,
         loss=loss6)
    del pg2b, pl2b, g2b

    # Leg 7: the block-dense local reduce.
    t0 = time.perf_counter()
    n3 = n_of(50_000)
    rng3 = np.random.default_rng(3)
    src3 = rng3.integers(0, n3, n3 * 8)
    dst3 = np.clip(src3 + rng3.integers(-150, 150, n3 * 8), 0, n3 - 1)
    g3 = dgl.graph((src3, dst3), num_nodes=n3, device="cpu")
    part3 = (np.arange(n3) * world // n3).astype(np.int32)
    pg3 = build_partitioned_graph(g3, part3, world, bdense=True)
    cov = float(pg3.bdense["a"].to(torch.float64).sum()) / g3.num_edges()
    pl3 = local(pg3)
    val, _ = fwd_grad(make_sharded_gcn_matvec(pl3), shard(
        pg3, rng.normal(size=(n3, 32)).astype(np.float32)))
    done(7, "block-dense sharded SpMM fwd+grad", t0, cov=cov, value=val)
    del pg3, pl3, g3

    # Leg 11: the data-parallel sampled GraphSAGE step.
    t0 = time.perf_counter()
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.models import GraphSAGE
    from dgl1_tpu_torch.parallel import (DistGraph, DistNodeDataLoader,
                                         node_split, partition_graph)
    from dgl1_tpu_torch.parallel.train import make_dp_sampled_step

    n5, f5, c5, batch = n_of(20_000), 16, 8, 256
    own_dir = None
    if workdir is None:
        own_dir = tempfile.TemporaryDirectory()
        workdir = own_dir.name
    try:
        if rank == 0:
            g5 = synthetic_classification_graph(
                num_nodes=n5, num_classes=c5, feat_dim=f5, avg_degree=8.0,
                seed=5, device="cpu")
            partition_graph(g5, "dryrun5", world, workdir,
                            part_method="random")
        _barrier()
        dg = DistGraph.from_partition(workdir, "dryrun5", rank,
                                      device="cpu")
        seeds = node_split(np.ones(dg.num_nodes(), bool), dg.book, rank)
        loader = DistNodeDataLoader(
            dg, seeds, NeighborSampler([5, 5]), batch_size=batch,
            shuffle=True, seed=11 + rank, device=dev, prefetch=0)
        model = GraphSAGE(f5, 32, c5, dropout=0.0, device=dev,
                          generator=torch.Generator().manual_seed(3))
        sstep = make_dp_sampled_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-2))
        inp, out, blocks, bmask, xb = next(iter(loader))
        yb = torch.as_tensor(dg.ndata["label"][out.cpu().numpy()],
                             device=dev)
        sloss = sstep(blocks, xb, yb, bmask)
        _barrier()
    finally:
        if own_dir is not None:
            own_dir.cleanup()
    done(11, "data-parallel SAMPLED GraphSAGE step", t0, batch=batch,
         loss=sloss, sample_ms=[s * 1e3 for s in loader.loader.sample_s])
    for r in records:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"leg {r['leg']}: {k} = {v}")
    return records


def _line(world, rec) -> str:
    extra = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                      f"{k}={v}" for k, v in rec.items()
                      if k not in ("leg", "name", "world", "seconds",
                                   "sample_ms"))
    return (f"dryrun_multichip({world}): {rec['name']} OK ({extra}, "
            f"{rec['seconds']:.1f}s)")


def _rank_main(rank, world, init, device, scale, workdir):
    from dgl1_tpu_torch import parallel

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    parallel.initialize(init, world, rank, timeout_s=300, device=device)

    def log(rec):
        if rank == 0:
            print(_line(world, rec), flush=True)

    try:
        run_legs(rank, world, "cuda" if device == "cuda" else "cpu", scale,
                 workdir, log)
    finally:
        parallel.exit_client()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (cpu: any; cuda: 1, one process a card)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    world = args.nproc or (1 if args.device == "cuda" else 4)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dryrun_multichip: no CUDA device", file=sys.stderr)
            return 1
        if world != 1:
            print("dryrun_multichip: --device cuda runs one rank a card; "
                  "this tool drives one card (--nproc 1)", file=sys.stderr)
            return 2
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init = f"127.0.0.1:{port}"
    with tempfile.TemporaryDirectory() as workdir:
        if world == 1:
            _rank_main(0, 1, init, args.device, args.scale, workdir)
        else:
            torch.multiprocessing.spawn(
                _rank_main, args=(world, init, args.device, args.scale,
                                  workdir), nprocs=world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
