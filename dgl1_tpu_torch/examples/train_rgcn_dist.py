"""Partitioned typed R-GCN entity classification at ogbn-mag's shape (the
reference's ``examples/train_rgcn_dist.py``): the heterograph partitioned
by homogenize, partition, split per node type; every relation's edges on
their destination's part; each layer one exchange a source node type over
the process group. The featureless types' embeddings are sharded by
ownership (each rank holds its own rows, whose gradients come back
through the exchanges' backward); the relation, self and input weights
are replicated. Usage:

    python -m dgl1_tpu_torch.examples.train_rgcn_dist [--parts 8]
        [--check-oracle] [--cpu]

``--parts P`` runs P ranks: gloo on the CPU (``--cpu``), NCCL on the card,
one card a rank (more parts than cards exits before any work).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dgl1_tpu_torch.examples import Stepper, rank_and_world, run_parts


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--scale", type=int, default=200,
                   help="ogbn-mag divisor (200 -> ~3.7k papers)")
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--check-oracle", action="store_true",
                   help="also hold the step-0 forward against the "
                        "single-device per-relation oracle")
    p.add_argument("--min-acc", type=float, default=0.6)
    return p.parse_args(argv)


def etype_key(c) -> str:
    """A canonical etype as a module key."""
    return "__".join(c)


class ShardedRGCN(torch.nn.Module):
    """The script's parameter tree on one rank: replicated ``w1`` / ``w2``
    (a relation each), ``s1`` (a node type each), ``s2`` (paper) and the
    paper input projection ``w_in``; ``emb``, this rank's rows (n_loc, h)
    of each featureless type's ownership-sharded embedding table."""

    def __init__(self, tree, etypes, device):
        super().__init__()
        self.etypes = list(etypes)

        def pd(d, key=str):
            return torch.nn.ParameterDict({
                key(k): torch.nn.Parameter(torch.as_tensor(v).to(device))
                for k, v in d.items()})

        self.w1 = pd(tree["w1"], etype_key)
        self.s1 = pd(tree["s1"])
        self.w2 = pd(tree["w2"], etype_key)
        self.s2 = pd(tree["s2"])
        self.w_in = torch.nn.Parameter(torch.as_tensor(tree["w_in"]).to(
            device))
        self.emb = pd(tree["emb"])

    def weights(self, layer: int):
        """(relation weights by canonical etype, self weights by ntype)."""
        w, s = (self.w1, self.s1) if layer == 1 else (self.w2, self.s2)
        return {c: w[etype_key(c)] for c in self.etypes}, dict(s.items())

    def replicated(self):
        """The parameters every rank holds a copy of."""
        return [p for n, p in self.named_parameters()
                if not n.startswith("emb.")]


def init_tree(phg, args) -> dict:
    """The script's draws: ``split(PRNGKey(0), 64)`` taken in order by
    ``w1`` (each relation), ``s1`` (each ntype), ``w2``, ``s2``, ``w_in``
    (``normal * sqrt(2 / (in + out))``), then each featureless type's
    (P, n_loc, h) table (``normal * 0.1``), of which rank p holds row
    block p."""
    from dgl1_tpu_torch import random as R

    rank, _ = rank_and_world()
    keys = iter(R.prng_split(R.prng_key(0), 64))
    h, f_in = args.hidden, args.feat_dim

    def dense(i, o):
        return R.prng_normal(next(keys), (i, o)) * np.float32(
            (2.0 / (i + o)) ** 0.5)

    tree = {"w1": {c: dense(h, h) for c in phg.etypes},
            "s1": {nt: dense(h, h) for nt in phg.ntypes},
            "w2": {c: dense(h, args.classes) for c in phg.etypes},
            "s2": {"paper": dense(h, args.classes)},
            "w_in": dense(f_in, h)}
    tree["emb"] = {nt: (R.prng_normal(next(keys), (
        args.parts, phg.n_loc[nt], h)) * np.float32(0.1))[rank]
        for nt in phg.ntypes if nt != "paper"}
    return tree


def build(args, device):
    """This rank's part of the synthetic ogbn-mag heterograph: the greedy
    typed assignment, the host build, the part's tensors on ``device``,
    its paper features, labels and masks; the weights."""
    from dgl1_tpu_torch.data.synthetic import synthetic_mag_heterograph
    from dgl1_tpu_torch.parallel import (build_partitioned_hetero,
                                         hetero_edge_cut_fraction,
                                         hetero_partition_assignment)

    rank, world = rank_and_world()
    if world != args.parts:
        raise ValueError(f"--parts {args.parts} on a group of {world}")
    t0 = time.perf_counter()
    hg, split = synthetic_mag_heterograph(
        scale=args.scale, num_classes=args.classes, feat_dim=args.feat_dim,
        device="cpu")
    part = hetero_partition_assignment(hg, args.parts, part_method="greedy")
    phg = build_partitioned_hetero(hg, part, args.parts)
    cut = hetero_edge_cut_fraction(hg, part)
    print(f"partitioned {dict(phg.num_nodes)} nodes over {args.parts} "
          f"parts, cut={cut:.3f} ({time.perf_counter() - t0:.1f}s)")
    pl = phg.local(rank, device)
    n_paper = hg.num_nodes("paper")
    masks = {}
    for name in ("train", "test"):
        m = np.zeros(n_paper, np.float32)
        m[split[name]] = 1.0
        masks[name] = phg.shard_node_data("paper", torch.from_numpy(m),
                                          rank).to(device)
    data = dict(
        hg=hg, split=split, phg=phg, pl=pl, rank=rank, masks=masks,
        x=phg.shard_node_data("paper", hg.nodes["paper"].data["feat"],
                              rank).to(device),
        y=phg.shard_node_data("paper", hg.nodes["paper"].data["label"],
                              rank).to(device, torch.int64))
    return data, ShardedRGCN(init_tree(phg, args), phg.etypes, device)


def layer_of(data):
    from dgl1_tpu_torch.parallel import make_sharded_rgcn_layer

    if "layer" not in data:
        data["layer"] = make_sharded_rgcn_layer(data["pl"])
    return data["layer"]


def forward(data, model):
    """This rank's paper logits (n_loc, C): the projected paper features
    and the embedding rows through two typed layers, relu between."""
    layer = layer_of(data)
    h0 = {"paper": data["x"] @ model.w_in, **dict(model.emb.items())}
    h1 = {nt: torch.relu(v) for nt, v in layer(h0, *model.weights(1)).items()}
    return layer(h1, *model.weights(2))["paper"]


def masked_loss(args, data, logits, mask):
    """This rank's term of the global masked mean cross entropy (labels
    clipped to the classes, as the script does)."""
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum

    ce = F.cross_entropy(logits, data["y"].clamp(0, args.classes - 1),
                         reduction="none")
    total = all_reduce_sum(mask.sum().detach()).clamp_min(1.0)
    return (ce * mask).sum() / total


def step_loss(args, data, model, batch=None):
    return masked_loss(args, data, forward(data, model),
                       data["masks"]["train"])


def oracle_logits(data, model, dtype=torch.float64):
    """The single-device per-relation oracle (the script's
    ``_check_oracle``) of every paper's logits (N_paper, C) in ``dtype``
    on the oracle engine: each featured or embedded type's global rows,
    ``copy_u`` sum of ``x[src] @ W_r`` over each relation, over the total
    in-degree, plus ``x @ W_self``; relu between the two layers. Its
    inputs are every rank's rows gathered to every rank (a sum over the
    ranks of each rank's rows in place), differentiably."""
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum

    hg, phg, rank = data["hg"], data["phg"], data["rank"]
    dev = data["x"].device

    def to_global(nt, v):
        own = torch.as_tensor(phg.node_mask[nt][rank], device=dev)
        ids = torch.as_tensor(phg.orig_ids[nt][rank].astype(np.int64),
                              device=dev)
        out = v.new_zeros((hg.num_nodes(nt),) + tuple(v.shape[1:]))
        return all_reduce_sum(out.index_put((ids[own],), v[own]))

    feats = {"paper": to_global("paper", (data["x"] @ model.w_in).to(
        dtype))}
    for nt, e in model.emb.items():
        feats[nt] = to_global(nt, e.to(dtype))
    rels = {c: hg[c].to(dev) for c in hg.canonical_etypes}
    in_deg = {nt: torch.zeros(hg.num_nodes(nt), dtype=dtype, device=dev)
              for nt in hg.ntypes}
    for c, g in rels.items():
        in_deg[c[2]] += g.in_degrees().to(dtype)

    def ref_layer(x, layer):
        w, s = model.weights(layer)
        out = {}
        for c, g in rels.items():
            st, _, dt = c
            if st not in x:
                continue
            v = ops.gspmm(g, "copy_lhs", "sum", x[st] @ w[c].to(dtype),
                          None)
            out[dt] = out[dt] + v if dt in out else v
        for nt in out:
            out[nt] = out[nt] / in_deg[nt].clamp_min(1.0)[:, None]
            if nt in s:
                out[nt] = out[nt] + x[nt] @ s[nt].to(dtype)
        return out

    ops.set_engine("xla")
    try:
        h1 = {nt: torch.relu(v) for nt, v in ref_layer(feats, 1).items()}
        return ref_layer(h1, 2)["paper"]
    finally:
        ops.set_engine("auto")


def oracle_loss(args, data, model, batch=None):
    """The global loss on :func:`oracle_logits` in float64 (at one part,
    :func:`step_loss` and its gradients)."""
    hg, split = data["hg"], data["split"]
    logits = oracle_logits(data, model)
    dev = logits.device
    y = hg.nodes["paper"].data["label"].to(dev).long().clamp(
        0, args.classes - 1)
    m = torch.zeros(hg.num_nodes("paper"), dtype=logits.dtype, device=dev)
    m[torch.as_tensor(split["train"], device=dev)] = 1.0
    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def check_oracle(args, data, model) -> float:
    """The script's ``--check-oracle``: the step-0 sharded forward,
    gathered to every paper, against the single-device oracle (float32,
    as the script's); raises past 1e-3."""
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum

    with torch.no_grad():
        got = forward(data, model)
        phg, rank = data["phg"], data["rank"]
        own = torch.as_tensor(phg.node_mask["paper"][rank],
                              device=got.device)
        ids = torch.as_tensor(phg.orig_ids["paper"][rank].astype(np.int64),
                              device=got.device)
        full = got.new_zeros((data["hg"].num_nodes("paper"), got.shape[1]))
        full[ids[own]] = got[own]
        full = all_reduce_sum(full)
        ref = oracle_logits(data, model, torch.float32)
    err = float((full - ref).abs().max())
    print(f"oracle check: max |sharded - single| = {err:.2e}")
    if not err < 1e-3:
        raise AssertionError(f"oracle check failed: {err}")
    return err


def accuracy(data, model, mask) -> float:
    from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum

    with torch.no_grad():
        pred = forward(data, model).argmax(dim=-1)
        hit = (pred == data["y"]).to(mask.dtype) * mask
        return float(all_reduce_sum(hit.sum())
                     / all_reduce_sum(mask.sum()).clamp_min(1.0))


def train(args, data, model, device) -> dict:
    from dgl1_tpu_torch.parallel.sharded_ops import (all_reduce_sum,
                                                     allreduce_grads)

    if args.check_oracle:
        check_oracle(args, data, model)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    rep = model.replicated()
    st = Stepper()
    acc = None
    for epoch in range(1, args.epochs + 1):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model)
        loss.backward()
        # The replicated weights' gradients are summed over the ranks;
        # the embedding rows' arrived through the exchanges' backward.
        allreduce_grads(rep)
        opt.step()
        loss = st.done(all_reduce_sum(loss.detach()))
        if epoch % 10 == 0 or epoch == 1:
            acc = accuracy(data, model, data["masks"]["test"])
            print(f"epoch {epoch:4d} loss {loss:.4f} test {acc:.4f}")
    dt = sum(st.step_ms) / 1e3
    acc = accuracy(data, model, data["masks"]["test"])
    print(f"done in {dt:.1f}s ({args.epochs / max(dt, 1e-9):.1f} "
          f"epochs/s); test acc {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    acc = metrics["test"]
    if acc < args.min_acc:
        raise SystemExit(f"accuracy gate failed: {acc:.4f} < {args.min_acc}")
    return f"accuracy gate passed: {acc:.4f} >= {args.min_acc}"


def main(argv=None):
    return run_parts(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
