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
