"""Partitioned full-graph GCN training (the reference's
``examples/train_dist.py``): the graph edge-partitioned over P ranks, one
halo exchange a layer over the process group (over the wire format of
``--halo-dtype``), replicated weights whose gradients are summed over the
ranks. ``--hub-identity`` takes the flagship layout: each part's hub-first
renumbering, activations in the combined [owned | halo | pad] rows and the
first layer's halo filled once. Usage:

    python -m dgl1_tpu_torch.examples.train_dist [--parts 8] [--cpu]

``--parts P`` runs P ranks: gloo on the CPU (``--cpu``), NCCL on the card,
one card a rank (more parts than cards exits before any work).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dgl1_tpu_torch.examples import (NO_GATE, Stepper, rank_and_world,
                                     run_parts)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--halo-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="halo exchange wire format (bf16 halves the bytes, "
                        "int8 with a per-row scale quarters them)")
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-degree", type=float, default=8.0)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--homophily", type=float, default=0.9,
                   help="SBM same-class edge probability; lower is a "
                        "harder task")
    p.add_argument("--noise-mult", type=float, default=None,
                   help="feature noise multiplier x sqrt(feat_dim)")
    p.add_argument("--acc-gate", type=float, default=None,
                   help="failable accuracy gate: exit nonzero unless test "
                        "acc >= this (with --homophily/--noise-mult a "
                        "task with headroom, so that wire or relabel "
                        "damage shows)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--part-method", default="greedy",
                   choices=["greedy", "random"])
    p.add_argument("--hub-identity", action="store_true",
                   help="per-part hub-first renumbering, combined [owned | "
                        "halo | pad] activations and a layer-1 halo filled "
                        "once (static input features)")
    return p.parse_args(argv)


def init_params(args, device) -> torch.nn.ParameterDict:
    """The script's weights: ``init_gcn_params(PRNGKey(0), ...)``,
    Glorot-uniform kernels under the key's two halves and zero biases
    (``dgl1_tpu_torch.random``'s ``jax.random`` draws)."""
    from dgl1_tpu_torch import random as R

    k1, k2 = R.prng_split(R.prng_key(0))
    w = {"w1": R.prng_glorot_uniform(k1, (args.feat_dim, args.hidden)),
         "b1": np.zeros(args.hidden, np.float32),
         "w2": R.prng_glorot_uniform(k2, (args.hidden, args.classes)),
         "b2": np.zeros(args.classes, np.float32)}
    return torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v).to(device))
        for k, v in w.items()})


def build(args, device):
    """This rank's part: the synthetic SBM graph (seed 0), the script's
    assignment and host build, the part's tensors on ``device``, its
    features (the combined layout's halo filled once under
    ``--hub-identity``), labels and masks; the weights."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel import build_partitioned_graph
    from dgl1_tpu_torch.parallel.partition import (
        edge_cut_fraction, greedy_partition_assignment,
        random_partition_assignment)
    from dgl1_tpu_torch.parallel.sharded_ops import fill_halo_combined

    rank, world = rank_and_world()
    if world != args.parts:
        raise ValueError(f"--parts {args.parts} on a group of {world}")
    noise = (args.noise_mult * float(np.sqrt(args.feat_dim))
             if args.noise_mult is not None else None)
    g = dgl.data.synthetic_classification_graph(
        num_nodes=args.nodes, num_classes=args.classes,
        feat_dim=args.feat_dim, avg_degree=args.avg_degree,
        homophily=args.homophily, feature_noise=noise,
        train_per_class=max(20, args.nodes // (4 * args.classes)), seed=0,
        device="cpu")
    assign = (greedy_partition_assignment if args.part_method == "greedy"
              else random_partition_assignment)
    part = assign(g, args.parts)
    print(f"[partition] {args.parts} parts, edge cut "
          f"{edge_cut_fraction(g, part):.3f}")
    pg = build_partitioned_graph(g, part, args.parts,
                                 halo_dtype=args.halo_dtype,
                                 hub=64 if args.hub_identity else False,
                                 hub_identity=args.hub_identity)
    print(f"[partition] n_loc={pg.n_loc} e_loc={pg.e_loc} "
          f"m_halo={pg.m_halo}"
          + (f" identity={pg.hub_meta.identity_expand}"
             if pg.hub_meta is not None else ""))
    pl = pg.local(rank, device)
    combined = args.hub_identity and pg.hub is not None
    feat = g.ndata["feat"]
    x_own = pg.shard_node_data(feat, rank).to(device)
    if combined:
        x = fill_halo_combined(pl)(
            pg.shard_node_data_combined(feat, rank).to(device))
    else:
        x = x_own
    own = torch.as_tensor(pg.node_mask[rank], device=device)
    data = dict(
        g=g, pg=pg, pl=pl, rank=rank, combined=combined, x=x,
        x_own=x_own,
        labels=pg.shard_node_data(g.ndata["label"], rank).to(
            device, torch.int32),
        masks={k: pg.shard_node_data(g.ndata[f"{k}_mask"], rank).to(
            device).bool() & own for k in ("train", "test")})
    return data, init_params(args, device)


def loss_fn(args, data):
    """This rank's term of the global masked mean (the ranks' terms sum
    to it): ``make_gcn_train_step``'s loss on the part."""
    from dgl1_tpu_torch.parallel.train import make_gcn_train_step

    if "loss_fn" not in data:
        _, data["loss_fn"] = make_gcn_train_step(
            data["pl"], None, args.classes, combined=data["combined"],
            prefilled=data["combined"])
    return data["loss_fn"]


def step_loss(args, data, model, batch=None):
    return loss_fn(args, data)(model, data["x"], data["labels"],
                               data["masks"]["train"])


def oracle_loss(args, data, model, batch=None):
    """The global loss of ``model``'s weights on the single-device
    float64 oracle: the 2-layer GCN ``A relu(A X W1 + b1) W2 + b2`` (A =
    D_in^-1/2 A D_out^-1/2 with global degrees) over the whole graph on
    the oracle engine, the masked mean over the train nodes. At one part
    it is :func:`step_loss`, the rank's term, and its gradients."""
    from dgl1_tpu_torch import ops

    dev = data["x"].device
    g = data["g"].to(dev)
    no = g.out_degrees().double().clamp(min=1.0) ** -0.5
    ni = g.in_degrees().double().clamp(min=1.0) ** -0.5

    def a(h):
        return ops.gspmm(g, "copy_lhs", "sum", h * no[:, None],
                         None) * ni[:, None]

    w1, b1, w2, b2 = (model[k].double() for k in ("w1", "b1", "w2", "b2"))
    ops.set_engine("xla")
    try:
        h = torch.relu(a(g.ndata["feat"].to(dev).double()) @ w1 + b1)
        logits = a(h) @ w2 + b2
    finally:
        ops.set_engine("auto")
    labels = g.ndata["label"].to(dev).long()
    m = g.ndata["train_mask"].to(dev).double()
    ce = torch.nn.functional.cross_entropy(logits, labels, reduction="none")
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum
    from dgl1_tpu_torch.parallel.train import (make_gcn_predict,
                                               make_gcn_train_step)

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step, _ = make_gcn_train_step(data["pl"], opt, args.classes,
                                  combined=data["combined"],
                                  prefilled=data["combined"])
    st = Stepper()
    for epoch in range(args.epochs):
        st.start()
        loss = st.done(step(model, data["x"], data["labels"],
                            data["masks"]["train"]))
        if (epoch + 1) % 10 == 0 or epoch == 0:
            print(f"epoch {epoch + 1:3d} loss {loss:.4f}")
    dt = sum(st.step_ms) / 1e3
    edges_per_s = data["g"].num_edges() * 2 * args.epochs / max(dt, 1e-9)
    print(f"done in {dt:.1f}s ({edges_per_s / 1e6:.1f} M edge-aggr/s "
          f"across {args.parts} parts)")
    # Test accuracy on the sharded model, counted over every part.
    pred = make_gcn_predict(data["pl"])(model, data["x_own"])
    test = data["masks"]["test"]
    hits = all_reduce_sum(((pred == data["labels"]) & test).sum().double())
    total = all_reduce_sum(test.sum().double())
    acc = float(hits / total.clamp_min(1.0))
    print(f"test acc {acc:.4f} ({int(total)} test nodes)")
    return st.metrics(test=acc, test_nodes=int(total))


def gate(args, data, metrics) -> str:
    acc = metrics["test"]
    if args.acc_gate is not None:
        if acc < args.acc_gate:
            raise SystemExit(
                f"ACCURACY GATE FAILED: sharded GCN test acc {acc:.4f} < "
                f"{args.acc_gate} (hard task homophily={args.homophily}, "
                f"wire={args.halo_dtype})")
        return f"accuracy gate passed: {acc:.4f} >= {args.acc_gate}"
    if args.epochs >= 30:
        if acc < 0.6:
            raise SystemExit(
                f"SANITY GATE FAILED: sharded GCN test acc {acc:.4f} < 0.6 "
                f"on the learnable synthetic task")
        return f"sanity gate passed: {acc:.4f} >= 0.6"
    return NO_GATE


def main(argv=None):
    return run_parts(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
