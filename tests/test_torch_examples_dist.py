"""The port's distributed trainers (``train_dist``, ``train_rgcn_dist``,
``train_rgcn_dist_sampled``, ``train_dist_sampled``) on gloo ranks
against the reference's scripts on the virtual CPU devices.

The port's side runs its trainer's own ``build`` and ``train`` in spawned
ranks (``torch_dist_worker.examples_cases``, one world a rank count); the
reference's side runs in this process, its in-script steps transcribed
from the scripts' lines (cited at each). The partition arrays are held
equal; the weights are the port's own draws, held bit for bit against
the reference's ``jax.random`` draws, except the flax ``GraphConv``s of
the sampled R-GCN, whose reference tree is carried in.

* ``train_dist``, 2 parts, f32 wire, float64: 3 losses to rtol 1e-4
  (atol 1e-6) and the test predictions.
* ``train_dist``, 4 parts, hub identity, int8 wire, float32: 5 losses to
  1e-3 relative (a scale computed apart can move an int8 code by one),
  test predictions agreeing on 99% of the test nodes.
* ``train_rgcn_dist``, 2 parts, float64: the step-0 paper logits to 1e-4
  of their largest, 3 losses to rtol 1e-4; the script's oracle check.
* ``train_rgcn_dist_sampled``, 2 parts, float64: the first step's mean
  loss and every parameter's and embedding table's gradient (the mean
  over the ranks) to rtol 1e-4.
* ``train_dist_sampled``, 2 parts, sharded store: the launcher exits 0
  with free ports and a partition directory under ``tmp_path``, remote
  rows crossed the sockets; each rank's first batch, sampled by both
  packages from the same partition and held array for array, gives the
  reference's ``loss_grads`` loss to rtol 1e-4 (mean over the ranks).

Also: the failable gate of ``train_dist.py#hard-int8`` at the harness's
arguments on 4 gloo ranks, the rank runner's failure paths, the
card-count check and the in-script draws. The distributed entries' smoke
runs are in ``test_torch_examples_smoke.py``.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PS

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch import examples as ex
from dgl1_tpu_torch import random as R
from dgl1_tpu_torch.tools import run_examples as harness

import torch_parity  # noqa: F401  (loads the reference's native library)
from test_torch_neighbor import assert_block_equal
from torch_dist_worker import run_world

CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)

DIST_F64 = ["--parts", "2", "--nodes", "1200", "--epochs", "3",
            "--feat-dim", "16", "--hidden", "16", "--classes", "4"]
DIST_INT8 = ["--parts", "4", "--nodes", "1600", "--epochs", "5",
             "--feat-dim", "16", "--hidden", "16", "--classes", "4",
             "--homophily", "0.55", "--noise-mult", "1.0",
             "--halo-dtype", "int8", "--hub-identity"]
RGCN = ["--parts", "2", "--scale", "800", "--epochs", "3", "--hidden", "16",
        "--feat-dim", "16", "--classes", "8"]
RGCN_SAMPLED = ["--parts", "2", "--scale", "800", "--hidden", "16",
                "--embed-dim", "16", "--feat-dim", "16", "--classes", "8",
                "--batch-size", "32"]
SAGE = ["--parts", "2", "--nodes", "1200", "--epochs", "1",
        "--sharded-store"]


def trainer(name):
    return importlib.import_module(f"dgl1_tpu_torch.examples.{name}")


def mesh_of(p):
    return Mesh(np.array(jax.devices()[:p]), ("p",))


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        tree)


def global_rows(res, n, key="pred"):
    """Each rank's owned rows of ``key`` scattered to their ``n`` global
    ids."""
    out = np.zeros((n,) + res[0][key].shape[1:], res[0][key].dtype)
    for r in res:
        out[r["ids"][r["own"]]] = r[key][r["own"]]
    return out


# ---------------------------------------------------------------------------
# The reference's in-script steps
# ---------------------------------------------------------------------------

def reference_train_dist(args, x64):
    """``examples/train_dist.py:90-158``: the graph, the greedy assignment,
    the host build, ``make_gcn_train_step`` with Adam for the epochs and
    ``make_gcn_predict``; float64 under ``x64``."""
    from dgl1_tpu.parallel import build_partitioned_graph
    from dgl1_tpu.parallel.partition import greedy_partition_assignment
    from dgl1_tpu.parallel.sharded_ops import fill_halo_combined
    from dgl1_tpu.parallel.train import (init_gcn_params, make_gcn_predict,
                                         make_gcn_train_step)

    noise = (args.noise_mult * float(np.sqrt(args.feat_dim))
             if args.noise_mult is not None else None)
    g = jdgl.data.synthetic_classification_graph(
        num_nodes=args.nodes, num_classes=args.classes,
        feat_dim=args.feat_dim, avg_degree=args.avg_degree,
        homophily=args.homophily, feature_noise=noise,
        train_per_class=max(20, args.nodes // (4 * args.classes)), seed=0)
    part = greedy_partition_assignment(g, args.parts)
    pg = build_partitioned_graph(g, part, args.parts,
                                 halo_dtype=args.halo_dtype,
                                 hub=64 if args.hub_identity else False,
                                 hub_identity=args.hub_identity)
    mesh = mesh_of(args.parts)
    combined = args.hub_identity and pg.hub is not None
    step, _ = make_gcn_train_step(pg, mesh, optax.adam(args.lr),
                                  args.classes, combined=combined,
                                  prefilled=combined)
    feat = np.asarray(g.ndata["feat"])
    if combined:
        x = fill_halo_combined(pg, mesh)(pg.shard_node_data_combined(feat))
    else:
        x = pg.shard_node_data(feat)
    labels = pg.shard_node_data(g.ndata["label"]).astype(jnp.int32)
    train_mask = pg.shard_node_data(g.ndata["train_mask"]) & pg.node_mask
    params = init_gcn_params(jax.random.PRNGKey(0), args.feat_dim,
                             args.hidden, args.classes)
    init = {k: np.asarray(v) for k, v in params.items()}
    x_eval = pg.shard_node_data(feat)
    losses = []
    with jax.enable_x64(x64):
        if x64:
            params, x, x_eval = f64(params), f64(x), f64(x_eval)
        state = optax.adam(args.lr).init(params)
        for _ in range(args.epochs):
            params, state, loss = step(params, state, x, labels, train_mask)
            losses.append(float(loss))
        pred = np.asarray(pg.unshard_node_data(
            make_gcn_predict(pg, mesh)(params, x_eval)))
    return dict(part=np.asarray(part), init=init, losses=losses, pred=pred,
                test=np.asarray(g.ndata["test_mask"]))


def reference_rgcn_dist(args):
    """``examples/train_rgcn_dist.py:67-137`` in float64: the mag graph,
    the typed assignment and build, the script's draws, the step-0 paper
    logits and the losses of ``args.epochs`` Adam steps."""
    from dgl1_tpu.data.synthetic import synthetic_mag_heterograph
    from dgl1_tpu.parallel import (build_partitioned_hetero,
                                   hetero_partition_assignment,
                                   make_sharded_rgcn_layer)

    hg, split = synthetic_mag_heterograph(
        scale=args.scale, num_classes=args.classes, feat_dim=args.feat_dim)
    part = hetero_partition_assignment(hg, args.parts, part_method="greedy")
    phg = build_partitioned_hetero(hg, part, args.parts)
    layer = make_sharded_rgcn_layer(phg, mesh_of(args.parts))
    etypes, ntypes = list(phg.etypes), list(phg.ntypes)
    keys = iter(jax.random.split(jax.random.PRNGKey(0), 64))
    h, f_in = args.hidden, args.feat_dim

    def dense(key, i, o):
        return jax.random.normal(key, (i, o)) * (2.0 / (i + o)) ** 0.5

    params = {
        "w1": {c: dense(next(keys), h, h) for c in etypes},
        "s1": {nt: dense(next(keys), h, h) for nt in ntypes},
        "w2": {c: dense(next(keys), h, args.classes) for c in etypes},
        "s2": {"paper": dense(next(keys), h, args.classes)},
        "w_in": dense(next(keys), f_in, h),
        "emb": {nt: jax.random.normal(
            next(keys), (args.parts, phg.n_loc[nt], h)) * 0.1
            for nt in ntypes if nt != "paper"},
    }
    init = jax.tree.map(np.asarray, params)
    feat = np.asarray(hg.nodes["paper"].data["feat"])
    labels = np.asarray(hg.nodes["paper"].data["label"])
    with jax.enable_x64():
        params = f64(params)
        x_paper = f64(phg.shard_node_data("paper", feat))
        y = phg.shard_node_data("paper", jnp.asarray(labels)).astype(
            jnp.int32)
        m = np.zeros(hg.num_nodes("paper"), np.float64)
        m[split["train"]] = 1.0
        mask = phg.shard_node_data("paper", jnp.asarray(m))
        opt = optax.adam(args.lr)

        def forward(prm):
            h0 = {"paper": jnp.einsum("pnf,fh->pnh", x_paper, prm["w_in"])}
            h0.update(prm["emb"])
            h1 = layer(h0, prm["w1"], prm["s1"])
            h1 = {nt: jax.nn.relu(v) for nt, v in h1.items()}
            return layer(h1, prm["w2"], prm["s2"])["paper"]

        def loss_fn(prm):
            ll = optax.softmax_cross_entropy_with_integer_labels(
                forward(prm), jnp.clip(y, 0, args.classes - 1))
            return jnp.sum(ll * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        @jax.jit
        def train_step(prm, state):
            loss, grads = jax.value_and_grad(loss_fn)(prm)
            upd, state = opt.update(grads, state)
            return optax.apply_updates(prm, upd), state, loss

        logits = np.asarray(phg.unshard_node_data(
            "paper", jax.jit(forward)(params)))
        state, losses = opt.init(params), []
        for _ in range(args.epochs):
            params, state, loss = train_step(params, state)
            losses.append(float(loss))
    return dict(part=part, init=init, logits=logits, losses=losses)


def reference_rgcn_dist_sampled(args):
    """``examples/train_rgcn_dist_sampled.py:67-154``: the graph, the
    per-device seeds, one rng drawing every device's batch in device
    order (the init batch, then the first step's), the tables, the flax
    model's init, and the ``shard_map`` step's loss and ``pmean``'d
    gradients in float64."""
    import flax.linen as nn

    from dgl1_tpu.data.synthetic import synthetic_mag_heterograph
    from dgl1_tpu.dataloading import NeighborSampler
    from dgl1_tpu.nn.conv import GraphConv
    from dgl1_tpu.nn.hetero import HeteroGraphConv
    from dgl1_tpu.parallel import (GraphPartitionBook,
                                   hetero_partition_assignment)

    K = args.parts
    mesh = mesh_of(K)
    hg, split = synthetic_mag_heterograph(
        scale=args.scale, num_classes=args.classes, feat_dim=args.feat_dim)
    feat = np.asarray(hg.nodes["paper"].data["feat"])
    labels = np.asarray(hg.nodes["paper"].data["label"])
    part = hetero_partition_assignment(hg, K, part_method="greedy")
    book = GraphPartitionBook(part["paper"], K)
    seeds_per_dev = [np.intersect1d(book.partid2nids(p), split["train"])
                     for p in range(K)]
    fanouts = [int(x) for x in args.fanout.split(",")]
    etypes = [c[1] for c in hg.canonical_etypes]
    sampler = NeighborSampler([{e: k for e in etypes} for k in fanouts])
    embed_types = [nt for nt in hg.ntypes if nt != "paper"]

    class RGCN(nn.Module):
        @nn.compact
        def __call__(self, blocks, x):
            h = HeteroGraphConv({e: GraphConv(args.hidden) for e in etypes},
                                name="l0")(blocks[0], x)
            h = {k: nn.relu(v) for k, v in h.items()}
            h = HeteroGraphConv({e: GraphConv(args.classes) for e in etypes},
                                name="l1")(blocks[1], h)
            return h["paper"]

    model = RGCN()
    rngs = np.random.default_rng(0)

    def device_batch(p, rng):
        own = seeds_per_dev[p]
        seeds = rng.choice(own, size=args.batch_size,
                           replace=len(own) < args.batch_size)
        inp, out, blocks = sampler.sample_blocks_hetero(
            hg, {"paper": seeds}, rng=rng)
        ids = {nt: np.asarray(inp.get(nt, np.zeros(0, np.int64)))
               for nt in embed_types}
        return (blocks, feat[np.asarray(inp["paper"])], ids,
                labels[np.asarray(out["paper"])])

    def stacked_step_inputs(rng):
        per_dev = [device_batch(p, rng) for p in range(K)]
        blocks = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *[b for b, _, _, _ in per_dev])
        x = jnp.asarray(np.stack([x for _, x, _, _ in per_dev]))
        ids = {nt: jnp.asarray(np.stack([d[2][nt] for d in per_dev]))
               for nt in embed_types}
        y = jnp.asarray(np.stack([d[3] for d in per_dev]))
        return blocks, x, ids, y

    blocks0, x0, ids0, y0 = stacked_step_inputs(rngs)
    key = jax.random.PRNGKey(0)
    emb = {nt: jax.random.normal(jax.random.fold_in(key, i),
                                 (hg.num_nodes(nt), args.embed_dim)) * 0.1
           for i, nt in enumerate(embed_types)}

    def body(blocks, x, ids, y, params, emb):
        b = [jax.tree.map(lambda a: a[0], blk) for blk in blocks]

        def loss_fn(params, emb):
            feats = {"paper": x[0]}
            for nt in embed_types:
                feats[nt] = jnp.take(emb[nt], ids[nt][0], axis=0,
                                     mode="clip")
            logits = model.apply(params, b, feats)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y[0]).mean()

        loss, (gp, ge) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            params, emb)
        return (jax.lax.pmean(loss, "p"), jax.lax.pmean(gp, "p"),
                jax.lax.pmean(ge, "p"))

    step = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(PS("p"), PS("p"), PS("p"), PS("p"), PS(), PS()),
        out_specs=(PS(), PS(), PS()), check_vma=False))
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(1),
        [jax.tree.map(lambda a: a[0], blk) for blk in blocks0],
        {"paper": x0[0],
         **{nt: jnp.take(emb[nt], ids0[nt][0], axis=0, mode="clip")
            for nt in embed_types}}))()
    blocks, x, ids, y = stacked_step_inputs(rngs)
    with jax.enable_x64():
        loss, gp, ge = step(blocks, f64(x), ids, y, f64(params), f64(emb))
    return dict(part=part, params=jax.tree.map(np.asarray, params),
                emb=jax.tree.map(np.asarray, emb), loss=float(loss),
                gp=jax.tree.map(np.asarray, gp),
                ge=jax.tree.map(np.asarray, ge),
                etypes=hg.canonical_etypes)


# ---------------------------------------------------------------------------
# One world of two ranks for the 2-part cases, one of four for int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_parts(tmp_path_factory):
    args_s = trainer("train_rgcn_dist_sampled").parse_args(
        RGCN_SAMPLED + ["--cpu"])
    refs = {"train_dist": reference_train_dist(
                trainer("train_dist").parse_args(DIST_F64 + ["--cpu"]), True),
            "rgcn_dist": reference_rgcn_dist(
                trainer("train_rgcn_dist").parse_args(RGCN + ["--cpu"])),
            "rgcn_dist_sampled": reference_rgcn_dist_sampled(args_s)}
    cases = [{"name": "train_dist", "kind": "train_dist", "argv": DIST_F64,
              "f64": True},
             {"name": "rgcn_dist", "kind": "rgcn_dist", "argv": RGCN},
             {"name": "rgcn_dist_sampled", "kind": "rgcn_dist_sampled",
              "argv": RGCN_SAMPLED,
              "params": refs["rgcn_dist_sampled"]["params"]}]
    out = run_world("examples_cases", 2, (cases,),
                    tmp_path_factory.mktemp("examples_dist2"), timeout=240)
    return refs, {c["name"]: [r[c["name"]] for r in out] for c in cases}


def test_train_dist_matches_reference(two_parts):
    """The f32 wire in float64: the same assignment and draws, the three
    global losses on every rank, the predictions."""
    refs, got = two_parts
    ref, res = refs["train_dist"], got["train_dist"]
    args = trainer("train_dist").parse_args(DIST_F64 + ["--cpu"])
    g = tdgl.data.synthetic_classification_graph(
        num_nodes=args.nodes, num_classes=args.classes,
        feat_dim=args.feat_dim, avg_degree=args.avg_degree,
        homophily=args.homophily,
        train_per_class=max(20, args.nodes // (4 * args.classes)), seed=0,
        device="cpu")
    part = tdgl.parallel.greedy_partition_assignment(g, args.parts)
    np.testing.assert_array_equal(part, ref["part"])
    for k, v in ref["init"].items():
        np.testing.assert_array_equal(res[0]["init"][k], v, err_msg=k)
    for r in res:
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], **LOSS_TOL)
    test = ref["test"]
    np.testing.assert_array_equal(global_rows(res, len(test))[test], ref["pred"][test])


def test_train_rgcn_dist_matches_reference(two_parts):
    """The script's draws (each rank's block of the sharded tables), the
    step-0 paper logits in float64, three losses, the oracle check."""
    from dgl1_tpu_torch.examples.train_rgcn_dist import etype_key

    refs, got = two_parts
    ref, res = refs["rgcn_dist"], got["rgcn_dist"]
    for rank, r in enumerate(res):
        init = r["init"]
        for grp in ("w1", "w2", "s1", "s2"):
            for k, v in ref["init"][grp].items():
                name = etype_key(k) if isinstance(k, tuple) else k
                np.testing.assert_array_equal(init[f"{grp}.{name}"], v)
        np.testing.assert_array_equal(init["w_in"], ref["init"]["w_in"])
        for nt, v in ref["init"]["emb"].items():
            np.testing.assert_array_equal(init[f"emb.{nt}"], v[rank])
        assert r["oracle_err"] < 1e-3
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
    want = ref["logits"]
    np.testing.assert_allclose(global_rows(res, len(want), "logits"), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], **LOSS_TOL)


def test_train_rgcn_dist_sampled_matches_reference(two_parts):
    """The first step from the same draws: the mean loss, every
    parameter's and every embedding table's gradient after the mean over
    the ranks; the tables are the script's ``fold_in`` draws."""
    from dgl1_tpu_torch.models import HeteroRGCN

    refs, got = two_parts
    ref, res = refs["rgcn_dist_sampled"], got["rgcn_dist_sampled"]
    for nt, v in ref["emb"].items():
        np.testing.assert_array_equal(res[0]["tables"][nt], v)
    for r in res:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-4)
    want = {f"net.{k}": np.asarray(v) for k, v in HeteroRGCN.jax_state_dict(
        ref["gp"], ref["etypes"]).items()}
    want.update({f"emb.{nt}": v for nt, v in ref["ge"].items()})
    assert set(want) == set(res[0]["grads"])
    for r in res:
        for k, v in want.items():
            np.testing.assert_allclose(
                r["grads"][k], v, rtol=1e-4,
                atol=1e-9 * max(np.abs(v).max(), 1e-30), err_msg=k)


def test_train_dist_int8_hub_identity_matches_reference(tmp_path):
    """The flagship layout over the int8 wire in float32 on four ranks:
    the losses to 1e-3 relative and the test predictions."""
    args = trainer("train_dist").parse_args(DIST_INT8 + ["--cpu"])
    ref = reference_train_dist(args, False)
    res = [r["int8"] for r in run_world(
        "examples_cases", 4, ([{"name": "int8", "kind": "train_dist",
                                 "argv": DIST_INT8, "f64": False}],),
        tmp_path, timeout=240)]
    for k, v in ref["init"].items():
        np.testing.assert_array_equal(res[0]["init"][k], v, err_msg=k)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=1e-3)
    test = ref["test"]
    agree = (global_rows(res, len(test))[test] == ref["pred"][test]).mean()
    assert agree >= 0.99, agree


def test_train_dist_sampled_matches_reference(tmp_path):
    """The launcher end to end with free ports and its partition under
    ``tmp_path``; then each rank's first batch from both packages (the
    port's from the launcher's partition, the reference's from its own),
    held array for array, through the port's step and the script's
    ``loss_grads``."""
    from dgl1_tpu.dataloading import NeighborSampler as JSampler
    from dgl1_tpu.parallel.dist_dataloader import (DistNodeDataLoader as
                                                   JLoader)
    from dgl1_tpu.parallel.dist_graph import DistGraph as JDistGraph
    from dgl1_tpu.parallel.partition import partition_graph

    mod = trainer("train_dist_sampled")
    out = tmp_path / "parts"
    argv = SAGE + ["--out", str(out), "--coordinator",
                   f"127.0.0.1:{ex.free_port_base()}", "--store-port-base",
                   str(ex.free_port_base(2)), "--cpu"]
    m = mod.main(argv)
    assert m["remote_rows_all"] > 0 and m["pulls_remote"] > 0
    assert m["local_rows"] < m["num_nodes"]
    assert m["gate"].startswith("sharded store gate passed")
    args = mod.parse_args(argv)
    # The script's prepare (examples/train_dist_sampled.py:62-70).
    g = jdgl.data.synthetic_classification_graph(
        num_nodes=args.nodes, num_classes=args.classes,
        feat_dim=args.feat_dim, avg_degree=8.0, seed=4,
        train_per_class=max(args.nodes // (4 * args.classes), 20))
    g.ndata["label"] = jnp.asarray(
        np.asarray(g.ndata["label"]).astype(np.int32))
    partition_graph(g, "dist_sampled", args.parts, str(tmp_path / "ref"),
                    part_method="greedy")
    np.testing.assert_array_equal(np.load(out / "node_part.npy"),
                                  np.load(tmp_path / "ref" / "node_part.npy"))
    # Its weights and loss_grads (:147-167).
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"W1": jax.random.normal(k1, (args.feat_dim, args.hidden)) * 0.2,
              "W2": jax.random.normal(k2, (args.hidden, args.classes)) * 0.2}
    model = mod.SampledSAGE(args, CPU)
    for k, v in params.items():
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), v)

    @jax.jit
    def loss_grads(params, blocks, x, y, m):
        def loss_fn(p):
            h = jdgl.ops.gspmm(blocks[0], "copy_lhs", "mean", x, None)
            h = jax.nn.relu(h @ p["W1"])
            h = jdgl.ops.gspmm(blocks[1], "copy_lhs", "mean",
                               h[: blocks[1].num_src_nodes()], None)
            logits = h @ p["W2"]
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.sum(ls * m) / jnp.maximum(m.sum(), 1.0)

        return jax.value_and_grad(loss_fn)(params)

    fanouts = [int(x) for x in args.fanout.split(",")]
    got, want = [], []
    for pid in range(args.parts):
        jg = JDistGraph.from_partition(str(tmp_path / "ref"), "dist_sampled",
                                       pid)
        own = jg.book.partid2nids(pid)
        train_ids = own[np.asarray(jg.ndata["train_mask"][own]).reshape(-1)
                        .astype(bool)]
        jinp, jout, jblocks, jmask, jx = next(iter(JLoader(
            jg, train_ids, JSampler(fanouts), feat_name="feat",
            batch_size=args.batch_size, shuffle=True, seed=pid,
            drop_last=True, prefetch=0)))
        tg = tdgl.parallel.DistGraph.from_partition(str(out), "dist_sampled",
                                                    pid, device=CPU)
        data = {"dist_g": tg, "loader": tdgl.parallel.DistNodeDataLoader(
            tg, train_ids, tdgl.dataloading.NeighborSampler(fanouts),
            feat_name="feat", batch_size=args.batch_size, shuffle=True,
            seed=pid, drop_last=True, prefetch=0, device=CPU)}
        batch = mod.first_batch(args, data, CPU)
        np.testing.assert_array_equal(batch[0].numpy(), np.asarray(jinp))
        np.testing.assert_array_equal(batch[1].numpy(), np.asarray(jout))
        for bj, bt in zip(jblocks, batch[2]):
            assert_block_equal(bj, bt, f"rank {pid} block")
        np.testing.assert_array_equal(batch[3].numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(batch[4].numpy(), np.asarray(jx))
        y = jnp.asarray(np.asarray(jg.ndata["label"][np.asarray(jout)])
                        .reshape(-1))
        loss, _ = loss_grads(params, jblocks, jnp.asarray(jx), y,
                             jnp.asarray(jmask, jnp.float32))
        want.append(float(loss))
        with torch.no_grad():
            got.append(float(mod.step_loss(args, data, model, batch)))
    np.testing.assert_allclose(np.mean(got), np.mean(want), rtol=1e-4)
    # The launcher's ranks trained on those batches first.
    np.testing.assert_allclose(m["losses"][0], np.mean(got), rtol=1e-6)


# ---------------------------------------------------------------------------
# The gate, the runner, the draws
# ---------------------------------------------------------------------------

def test_hard_int8_gate_passes_on_four_gloo_ranks(capfd):
    """``train_dist.py#hard-int8`` at the harness's arguments: 4 parts,
    the int8 wire, the hub identity layout, the failable 0.84 gate."""
    argv, _ = harness.EXAMPLES["train_dist.py#hard-int8"]
    m = trainer("train_dist").main(list(argv) + ["--cpu"])
    assert m["test"] >= 0.84
    assert m["gate"].startswith("accuracy gate passed")
    assert m["gate"] in capfd.readouterr().out


@pytest.mark.parametrize("kind", ["raise", "exit"])
def test_spawned_rank_failures_fail_the_run(kind):
    """A rank's exception fails the run with its traceback; a rank's
    ``SystemExit`` (a failed gate) exits with its message."""
    calls = [(kind, r) for r in range(2)]
    if kind == "raise":
        with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
            ex.spawn_ranks("torch_dist_worker", "rank_outcome", calls, 60)
    else:
        with pytest.raises(SystemExit, match="GATE FAILED on rank 1"):
            ex.spawn_ranks("torch_dist_worker", "rank_outcome", calls, 60)


def test_more_parts_than_cards_exits_before_any_work():
    """On ``cuda`` the ranks need a card each: more parts than cards exit
    with the counts; the CPU takes any number of gloo ranks. The harness
    reports such an entry as not run, and runs it under ``--cpu``."""
    with pytest.raises(SystemExit, match="need 4 devices, have 1"):
        ex.need_cards(4, "cuda", present=1)
    ex.need_cards(1, "cuda", present=1)
    ex.need_cards(8, "cpu")
    args = harness.EXAMPLES["train_dist.py#hard-int8"][0]
    assert harness.not_run(args, cpu=False, cards=1) == (
        "not run: needs 4 cards, 1 present")
    assert harness.not_run(args, cpu=True, cards=0) is None
    assert harness.not_run(args, cpu=False, cards=4) is None
    assert harness.not_run(["--epochs", "2"], cpu=False, cards=1) is None


@pytest.mark.parametrize("shape", [(64, 64), (16, 4), (3, 7, 5)])
def test_in_script_draws_are_jax_random_bit_for_bit(shape):
    """``prng_uniform`` and the scripts' in-script draws against
    ``jax.random``: Glorot uniform (train_dist), ``normal * 0.2``
    (train_dist_sampled), the scaled dense and ``normal * 0.1``
    (train_rgcn_dist), ``normal`` under ``fold_in`` times 0.1
    (train_rgcn_dist_sampled)."""
    key, k = jax.random.PRNGKey(3), R.prng_key(3)
    np.testing.assert_array_equal(R.prng_uniform(k, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(
        R.prng_uniform(k, shape, -1.0, 2.0),
        np.asarray(jax.random.uniform(key, shape, minval=-1.0, maxval=2.0)))
    np.testing.assert_array_equal(
        R.prng_normal(k, shape) * np.float32(0.2),
        np.asarray(jax.random.normal(key, shape) * 0.2))
    np.testing.assert_array_equal(
        R.prng_normal(k, shape) * np.float32(0.1),
        np.asarray(jax.random.normal(key, shape) * 0.1))
    for i in range(3):
        np.testing.assert_array_equal(
            R.prng_fold_in(k, i),
            np.asarray(jax.random.fold_in(key, i)))
        np.testing.assert_array_equal(
            R.prng_normal(R.prng_fold_in(k, i), shape) * np.float32(0.1),
            np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape)
                       * 0.1))
    if len(shape) == 2:
        i, o = shape
        np.testing.assert_array_equal(
            R.prng_glorot_uniform(k, shape),
            np.asarray(jax.nn.initializers.glorot_uniform()(key, shape)))
        np.testing.assert_array_equal(
            R.prng_normal(k, shape) * np.float32((2.0 / (i + o)) ** 0.5),
            np.asarray(jax.random.normal(key, shape)
                       * (2.0 / (i + o)) ** 0.5))
