"""Rank worker of the port's distributed CPU tests.

Imports torch and ``dgl1_tpu_torch`` only: spawned ranks import the
module that holds their target, and a test module would pull JAX into
every rank. :func:`run_world` starts P ranks over gloo (``file://``
init in a directory of the caller's, so parallel test workers never
share a port), runs one named case function of this module in each and
returns each rank's result; a rank that fails or hangs past the timeout
fails the call.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def _entry(target: str, rank: int, world: int, init: str, out_dir: str,
           payload: bytes):
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        from dgl1_tpu_torch import parallel

        parallel.initialize(init, world, rank, timeout_s=60, device="cpu")
        res = globals()[target](rank, world, *pickle.loads(payload))
        parallel.exit_client()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except Exception:  # noqa: BLE001 - reported to the parent
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def run_world(target: str, world: int, args: tuple, tmp_dir,
              timeout: float = 120.0):
    """Run ``target(rank, world, *args)`` in ``world`` spawned ranks;
    returns the list of their results."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{tmp_dir / 'init'}"
    payload = pickle.dumps(args)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, init,
                                              str(tmp_dir), payload))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = [(tmp_dir / f"rank{r}.err") for r in range(world)]
    msgs = [e.read_text() for e in errs if e.exists()]
    if msgs:
        raise RuntimeError("rank failed:\n" + "\n".join(msgs))
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    out = []
    for r in range(world):
        with open(tmp_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ----------------------------------------------------------------------
# Case functions (run in each rank)
# ----------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _case_matvec(pg, rank, c):
    from dgl1_tpu_torch.parallel import sharded_ops as so

    pl = pg.local(rank, "cpu")
    x = torch.tensor(c["x"][rank], requires_grad=True)
    if c.get("combined"):
        fn = so.make_sharded_gcn_matvec_combined(pl)
    else:
        fn = so.make_sharded_gcn_matvec(pl)
    y = fn(x)
    (y * torch.tensor(c["w"][rank])).sum().backward()
    return {"y": _np(y), "gx": _np(x.grad)}


def _case_gat(pg, rank, c):
    from dgl1_tpu_torch.parallel import sharded_ops as so

    pl = pg.local(rank, "cpu")
    el, er, ft = (torch.tensor(c[k][rank], requires_grad=True)
                  for k in ("el", "er", "ft"))
    out = so.make_sharded_gat_layer(pl, fused=c.get("fused", False))(
        el, er, ft)
    (out ** 2).sum().backward()
    return {"y": _np(out), "gel": _np(el.grad), "ger": _np(er.grad),
            "gft": _np(ft.grad)}


def _case_train(pg, rank, c):
    from dgl1_tpu_torch.parallel import sharded_ops as so
    from dgl1_tpu_torch.parallel.train import (make_gcn_predict,
                                               make_gcn_train_step)
    from dgl1_tpu_torch.params import from_jax_params

    pl = pg.local(rank, "cpu")
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(c["params"]).items()}
    opt = torch.optim.Adam(params.values(), lr=c["lr"])
    step, _ = make_gcn_train_step(pl, opt, c["classes"],
                                  combined=c["combined"],
                                  prefilled=c["prefilled"])
    x = torch.tensor(c["x"][rank])
    if c["prefilled"]:
        x = so.fill_halo_combined(pl)(x)
    y = torch.tensor(c["labels"][rank])
    m = torch.tensor(c["mask"][rank])
    losses = [step(params, x, y, m) for _ in range(c["steps"])]
    res = {"losses": np.asarray(losses),
           "w1": _np(params["w1"]), "b2": _np(params["b2"])}
    if not c["combined"]:
        res["pred"] = _np(make_gcn_predict(pl)(params, x))
    return res


def _case_tp(rank, world, c):
    import dgl1_tpu_torch as tdgl
    from dgl1_tpu_torch.parallel.tp import make_tp_gcn_layer, shard_params_tp

    g = tdgl.graph((c["src"], c["dst"]), num_nodes=c["n"], device="cpu")
    w1, w2 = shard_params_tp(torch.tensor(c["w1"]), torch.tensor(c["w2"]),
                             rank, world)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    y = make_tp_gcn_layer(g)(w1, w2, torch.tensor(c["x"]))
    (y * torch.tensor(c["w"])).sum().backward()
    return {"y": _np(y), "gw1": _np(w1.grad), "gw2": _np(w2.grad)}


_KINDS = {"matvec": _case_matvec, "gat": _case_gat, "train": _case_train}


def sharded_cases(rank, world, cases):
    """Each case ``{"name", "kind", "pg", ...}`` on this rank's part; one
    result dict per case name. ``kind`` "tp" cases take no partition."""
    out = {}
    for c in cases:
        if c["kind"] == "tp":
            out[c["name"]] = _case_tp(rank, world, c)
        else:
            out[c["name"]] = _KINDS[c["kind"]](c["pg"], rank, c)
    return out


def _case_kvstore(rank, world, c):
    import torch.distributed as dist

    from dgl1_tpu_torch.parallel.kvstore import ShardedFeatureStore

    store = ShardedFeatureStore(c["dir"], "g", rank, c["part"],
                                addrs=c["addrs"], device="cpu")
    dist.barrier()  # every server is up
    try:
        rows = store.pull("feat", c["ids"])
        item = store[c["ids"][:5]] if len(store.meta) == 1 else None
        stats = store.stats()
    finally:
        dist.barrier()  # every peer has pulled
        store.close()
    return {"rows": _np(rows), "stats": stats,
            "item": None if item is None else _np(item),
            "local_rows": store.local_rows}


def _case_dp_sage(rank, world, c):
    import torch.distributed as dist

    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.models import GraphSAGE
    from dgl1_tpu_torch.parallel import (DistGraph, DistNodeDataLoader,
                                         node_split)
    from dgl1_tpu_torch.parallel.train import make_dp_sampled_step

    dg = DistGraph.from_partition(c["dir"], "g", rank, device="cpu")
    seeds = node_split(c["train_mask"], dg.book, rank)
    loader = DistNodeDataLoader(dg, seeds, NeighborSampler([4, 4]),
                                batch_size=64, seed=rank, device="cpu",
                                prefetch=0)
    model = GraphSAGE(c["f"], 16, c["classes"], dropout=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    step = make_dp_sampled_step(model, torch.optim.SGD(model.parameters(),
                                                       lr=0.0))
    inp, out, blocks, mask, x = next(iter(loader))
    y = torch.as_tensor(dg.ndata["label"][out.numpy()])
    # This rank's own gradient, before the mean over the ranks.
    model.zero_grad()
    ce = torch.nn.functional.cross_entropy(model(blocks, x), y.long(),
                                           reduction="none")
    m = mask.float()
    local = (ce * m).sum() / m.sum()
    local.backward()
    own = [p.grad.clone() for p in model.parameters()]
    loss = step(blocks, x, y, mask)
    mean = [p.grad.clone() for p in model.parameters()]
    dist.barrier()
    return {"seeds": seeds, "inp": _np(inp), "out": _np(out),
            "mask": _np(mask), "x": _np(x), "local": float(local),
            "loss": loss, "own": [_np(g) for g in own],
            "mean": [_np(g) for g in mean]}


def _case_dryrun(rank, world, c):
    from dgl1_tpu_torch.tools.dryrun_multichip import run_legs

    return run_legs(rank, world, "cpu", scale=c["scale"],
                    workdir=c["dir"])


def dist_cases(rank, world, cases):
    """The named cases of ``test_torch_dist.py`` on this rank."""
    fns = {"kvstore": _case_kvstore, "dp_sage": _case_dp_sage,
           "dryrun": _case_dryrun, "tp": _case_tp}
    return {c["name"]: fns[c["kind"]](rank, world, c) for c in cases}


# ----------------------------------------------------------------------
# Typed (heterograph) cases of test_torch_hetero_parallel.py
# ----------------------------------------------------------------------

def _tensors(d, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad)
            for k, v in d.items()}


def _grads(d):
    return {k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
                else _np(v.grad)) for k, v in d.items()}


def _masked_sin(phg, rank, out):
    """sum of sin over the real (owned, non-phantom) rows of every output."""
    tot = 0.0
    for nt, v in out.items():
        m = torch.as_tensor(phg.node_mask[nt][rank])
        tot = tot + (torch.sin(v) * m.reshape((-1,) + (1,) * (v.dim() - 1))
                     ).sum()
    return tot


def _case_hetero_layer(rank, c):
    from dgl1_tpu_torch.parallel.hetero import make_sharded_rgcn_layer
    from dgl1_tpu_torch.parallel.sharded_ops import allreduce_grads

    phg = c["phg"]
    pl = phg.local(rank, "cpu")
    x = {nt: phg.shard_node_data(nt, torch.tensor(v), rank)
         .requires_grad_(True) for nt, v in c["feats"].items()}
    w = _tensors(c["w"], True)
    s = _tensors(c["s"], True) if c["s"] is not None else None
    out = make_sharded_rgcn_layer(pl, norm=c["norm"])(x, w, s)
    _masked_sin(phg, rank, out).backward()
    allreduce_grads(list(w.values()) + (list(s.values()) if s else []))
    return {"out": {nt: _np(v) for nt, v in out.items()},
            "gx": _grads(x), "gw": _grads(w),
            "gs": _grads(s) if s else {}}


def _case_hetero_attn(rank, c):
    from dgl1_tpu_torch.parallel.hetero import make_sharded_hetero_attention

    phg = c["phg"]
    pl = phg.local(rank, "cpu")

    def shard(d, key):
        return {k: phg.shard_node_data(key(k), torch.tensor(v), rank)
                .requires_grad_(True) for k, v in d.items()}

    el = shard(c["el"], lambda k: k[0])
    er = shard(c["er"], lambda k: k)
    ft = shard(c["ft"], lambda k: k[0])
    out = make_sharded_hetero_attention(pl)(el, er, ft)
    _masked_sin(phg, rank, out).backward()
    return {"out": {nt: _np(v) for nt, v in out.items()},
            "gel": _grads(el), "ger": _grads(er), "gft": _grads(ft)}


def _case_hetero_train(rank, c):
    """Dry run leg 9's loss on this rank: paper features projected by the
    replicated ``w_in``, sharded embeddings for the other node types, two
    typed layers; replicated gradients all-reduced, embedding gradients
    left where the exchanges' backward put them."""
    from dgl1_tpu_torch.parallel.hetero import make_sharded_rgcn_layer
    from dgl1_tpu_torch.parallel.sharded_ops import allreduce_grads

    phg = c["phg"]
    pl = phg.local(rank, "cpu")
    layer = make_sharded_rgcn_layer(pl)
    rep = {k: _tensors(v, True) if isinstance(v, dict)
           else torch.tensor(v, requires_grad=True)
           for k, v in c["params"].items() if k != "emb"}
    emb = {nt: phg.shard_node_data(nt, torch.tensor(v), rank)
           .requires_grad_(True) for nt, v in c["params"]["emb"].items()}
    x = phg.shard_node_data("paper", torch.tensor(c["x"]), rank)
    y = phg.shard_node_data("paper", torch.tensor(c["y"]), rank).long()
    m = phg.shard_node_data("paper", torch.tensor(c["mask"]), rank)
    h0 = {"paper": x @ rep["w_in"], **emb}
    h1 = {nt: torch.relu(v) for nt, v in
          layer(h0, rep["w1"], rep["s1"]).items()}
    logits = layer(h1, rep["w2"], rep["s2"])["paper"]
    ce = torch.nn.functional.cross_entropy(logits, y, reduction="none")
    loss = (ce * m).sum() / c["mask_total"]
    loss.backward()
    flat = [p for v in rep.values()
            for p in (v.values() if isinstance(v, dict) else [v])]
    allreduce_grads(flat)
    return {"loss": float(loss), "gemb": _grads(emb),
            "gw_in": _np(rep["w_in"].grad), "gw1": _grads(rep["w1"]),
            "gs2": _grads(rep["s2"])}


def hetero_cases(rank, world, cases):
    """The named typed cases on this rank's part."""
    fns = {"layer": _case_hetero_layer, "attn": _case_hetero_attn,
           "train": _case_hetero_train}
    return {c["name"]: fns[c["kind"]](rank, c) for c in cases}


# ----------------------------------------------------------------------
# The distributed trainers of test_torch_examples_dist.py
# ----------------------------------------------------------------------

_CPU = torch.device("cpu")


def _trainer(name):
    import importlib

    return importlib.import_module(f"dgl1_tpu_torch.examples.{name}")


def _case_train_dist(rank, c):
    """``train_dist``'s build and train on this rank (float64 on request:
    the weights and features cast after the build); the losses, the
    initial weights and the test predictions of the owned rows."""
    from dgl1_tpu_torch.parallel.train import make_gcn_predict

    mod = _trainer("train_dist")
    args = mod.parse_args(c["argv"] + ["--cpu"])
    data, model = mod.build(args, _CPU)
    init = {k: _np(v).copy() for k, v in model.items()}
    if c["f64"]:
        model.double()
        data["x"], data["x_own"] = data["x"].double(), data["x_own"].double()
    m = mod.train(args, data, model, _CPU)
    pg = data["pg"]
    pred = make_gcn_predict(data["pl"])(model, data["x_own"])
    return {"losses": np.asarray(m["losses"]), "init": init,
            "pred": _np(pred), "ids": pg.orig_ids[rank],
            "own": pg.node_mask[rank], "test": m["test"]}


def _case_rgcn_dist(rank, c):
    """``train_rgcn_dist`` on this rank: the step-0 paper logits (float64
    from the port's own draws), the script's oracle check, then the
    trainer's steps; the draws, logits and losses."""
    mod = _trainer("train_rgcn_dist")
    args = mod.parse_args(c["argv"] + ["--cpu"])
    data, model = mod.build(args, _CPU)
    init = {k: _np(v).copy() for k, v in model.state_dict().items()}
    err = mod.check_oracle(args, data, model)
    model.double()
    data["x"] = data["x"].double()
    data["masks"] = {k: v.double() for k, v in data["masks"].items()}
    with torch.no_grad():
        logits = mod.forward(data, model)
    m = mod.train(args, data, model, _CPU)
    phg = data["phg"]
    return {"init": init, "logits": _np(logits), "oracle_err": err,
            "ids": phg.orig_ids["paper"][rank],
            "own": phg.node_mask["paper"][rank],
            "losses": np.asarray(m["losses"])}


def _case_rgcn_dist_sampled(rank, c):
    """``train_rgcn_dist_sampled``'s first step on this rank from the
    reference's initial weights in float64: the mean loss over the ranks
    and every gradient after the mean over the ranks, by name."""
    import torch.distributed as dist

    from dgl1_tpu_torch.models import HeteroRGCN

    mod = _trainer("train_rgcn_dist_sampled")
    args = mod.parse_args(c["argv"] + ["--cpu"])
    data, model = mod.build(args, _CPU)
    tables = {k: _np(v).copy() for k, v in model.emb.items()}
    model.net.load_state_dict(HeteroRGCN.jax_state_dict(
        c["params"], data["hg"].canonical_etypes), strict=True)
    model.double()
    blocks, x, ids, y = mod.first_batch(args, data, _CPU)
    loss = mod.step_loss(args, data, model, (blocks, x.double(), ids, y))
    loss.backward()
    world = dist.get_world_size()
    mod.average_grads(list(model.parameters()), world)
    mean = loss.detach().clone()
    dist.all_reduce(mean)
    return {"loss": float(mean) / world, "tables": tables,
            "grads": {n: _np(p.grad) for n, p in model.named_parameters()}}


def examples_cases(rank, world, cases):
    """The named trainer cases of ``test_torch_examples_dist.py``."""
    fns = {"train_dist": _case_train_dist, "rgcn_dist": _case_rgcn_dist,
           "rgcn_dist_sampled": _case_rgcn_dist_sampled}
    return {c["name"]: fns[c["kind"]](rank, c) for c in cases}


def rank_outcome(kind: str, rank: int):
    """A spawned rank of ``examples.spawn_ranks``'s own test: rank 1
    raises (``"raise"``), exits with a message (``"exit"``, as a failed
    gate) or returns like rank 0 (``"ok"``)."""
    if rank == 1 and kind == "raise":
        raise ValueError("rank 1 failed on purpose")
    if rank == 1 and kind == "exit":
        raise SystemExit("GATE FAILED on rank 1")
    return {"rank": rank, "threads": torch.get_num_threads()}
