"""Cases of the port's sharded-op parity tests (``test_torch_sharded*.py``):
the graphs, the partitioned builds of both packages from one assignment,
the inputs and the reference's outputs on a P-device CPU mesh (each
reference call jitted), and :func:`run_cases`, which runs the port's side
in one world of P gloo ranks (``torch_dist_worker.sharded_cases``).
"""

import numpy as np

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import torch_parity  # noqa: F401  (loads the reference's native library)
from torch_dist_worker import run_world

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.data.synthetic import powerlaw_graph as j_powerlaw
from dgl1_tpu.parallel import halo as jhalo
from dgl1_tpu.parallel import sharded_ops as jso
from dgl1_tpu.parallel import train as jtrain
from dgl1_tpu.parallel.partition import greedy_partition_assignment
from dgl1_tpu_torch.data.synthetic import powerlaw_graph as t_powerlaw
from dgl1_tpu_torch.parallel import halo as thalo

P = 4
F = 8


def _graphs():
    """(name, reference graph, port graph) of the three edge sets."""
    gj_b = jdgl.to_bidirected(j_powerlaw(1500, 5, seed=4))
    gt_b = tdgl.to_bidirected(t_powerlaw(1500, 5, seed=4, device="cpu"))
    gj_p = j_powerlaw(2000, 5, seed=1)
    gt_p = t_powerlaw(2000, 5, seed=1, device="cpu")
    rng = np.random.default_rng(3)
    n3 = 1200
    s3 = rng.integers(0, n3, n3 * 8)
    d3 = np.clip(s3 + rng.integers(-100, 100, n3 * 8), 0, n3 - 1)
    gj_l = jdgl.graph((s3, d3), num_nodes=n3)
    gt_l = tdgl.graph((s3, d3), num_nodes=n3, device="cpu")
    return {"bidir": (gj_b, gt_b), "power": (gj_p, gt_p),
            "band": (gj_l, gt_l)}


# name -> (graph, build keywords, case kind, extra case keys)
BUILDS = {
    "tiles": ("bidir", dict(), "matvec", {}),
    "segment_int8": ("bidir", dict(tiles=False, halo_dtype="int8"),
                     "matvec", {}),
    "segment_bf16": ("bidir", dict(tiles=False, halo_dtype="bf16"),
                     "matvec", {}),
    "vertex_cut": ("power", dict(vertex_cut=True), "matvec", {}),
    "bdense": ("band", dict(bdense=True), "matvec", {}),
    "bdense_vertex_cut": ("power", dict(bdense=True, vertex_cut=True),
                          "matvec", {}),
    "hub": ("bidir", dict(tiles=False, hub=256, hub_dense_floor=512),
            "matvec", {}),
    # Two of the four parts have no hub group of their own (allow_empty).
    "hub_empty_parts": ("power", dict(tiles=False, hub=600), "matvec", {}),
    "hub_identity": ("bidir", dict(tiles=False, hub=256,
                                   hub_dense_floor=512, hub_identity=True),
                     "matvec", {}),
    "hub_combined": ("bidir", dict(tiles=False, hub=256,
                                   hub_dense_floor=512), "matvec",
                     {"combined": True}),
    "hub_identity_combined": ("bidir", dict(tiles=False, hub=256,
                                            hub_dense_floor=512,
                                            hub_identity=True),
                              "matvec", {"combined": True}),
    "gat_halo": ("bidir", dict(tiles=False), "gat", {}),
    "gat_vertex_cut": ("power", dict(vertex_cut=True, tiles=False), "gat",
                       {}),
    "gat_fused": ("bidir", dict(tiles=False, hub=256, hub_dense_floor=512,
                                hub_identity=True), "gat", {"fused": True}),
    # Parts 1 and 2 have no hub edge: their layouts keep no chunk, and the
    # attention wrappers return without a launch.
    "gat_fused_empty_parts": ("power", dict(tiles=False, hub=600), "gat",
                              {"fused": True}),
    "train_halo": ("bidir", dict(tiles=False, halo_dtype="int8"), "train",
                   {"combined": False, "prefilled": False}),
    "train_combined": ("bidir", dict(tiles=False, hub=256,
                                     hub_dense_floor=512,
                                     hub_identity=True), "train",
                       {"combined": True, "prefilled": True}),
}
H, D, CLASSES, HIDDEN, STEPS, LR = 2, 4, 5, 16, 3, 1e-2


def _mesh():
    return Mesh(np.array(jax.devices()[:P]), ("p",))


def _build(graphs, name):
    gname, kw, _, _ = BUILDS[name]
    gj, gt = graphs[gname]
    kw = dict(kw)
    part = greedy_partition_assignment(gj, P, balance_edges=True)
    if kw.pop("vertex_cut", False):
        kw["edge_owner"] = jhalo.vertex_cut_edge_owner(gj, part, P)
    return (jhalo.build_partitioned_graph(gj, part, P, **kw),
            thalo.build_partitioned_graph(gt, part, P, **kw), gt)


def _fwd_vjp(fn, args, w):
    """fn(*args) and the gradients of sum(y * w) (w None: sum(y ** 2))."""
    y, vjp = jax.vjp(fn, *args)
    return y, vjp(2.0 * y if w is None else w)


def _case(name, pj, pt, gt, rng):
    _, _, kind, extra = BUILDS[name]
    n = gt.num_nodes()
    c = {"name": name, "kind": kind, "pg": pt, **extra}
    ref = {}
    mesh = _mesh()
    if kind == "matvec":
        x = rng.normal(size=(n, F)).astype(np.float32)
        if extra.get("combined"):
            xs = pt.shard_node_data_combined(x).numpy()
            w = rng.normal(size=xs.shape).astype(np.float32)
            mv = jso.make_sharded_gcn_matvec_combined(pj, mesh)
        else:
            xs = pt.shard_node_data(x).numpy()
            w = rng.normal(size=xs.shape).astype(np.float32)
            mv = jso.make_sharded_gcn_matvec(pj, mesh)
        y, gx = jax.jit(lambda x_, w_: _fwd_vjp(mv, (x_,), w_))(
            jnp.asarray(xs), jnp.asarray(w))
        ref = {"y": y, "gx": gx[0]}
        c.update(x=xs, w=w)
    elif kind == "gat":
        el = pt.shard_node_data(rng.normal(size=(n, H)).astype(
            np.float32)).numpy()
        er = pt.shard_node_data(rng.normal(size=(n, H)).astype(
            np.float32)).numpy()
        ft = pt.shard_node_data(rng.normal(size=(n, H, D)).astype(
            np.float32)).numpy()
        layer = jso.make_sharded_gat_layer(pj, mesh,
                                           fused=extra.get("fused", False))
        y, (gel, ger, gft) = jax.jit(
            lambda *a: _fwd_vjp(layer, a, None))(
                *map(jnp.asarray, (el, er, ft)))
        ref = {"y": y, "gel": gel, "ger": ger, "gft": gft}
        c.update(el=el, er=er, ft=ft)
    else:  # train
        x = rng.normal(size=(n, F)).astype(np.float32)
        labels = rng.integers(0, CLASSES, n)
        mask = (rng.random(n) < 0.6).astype(np.float32)
        xs = (pt.shard_node_data_combined(x) if extra["combined"]
              else pt.shard_node_data(x)).numpy()
        ys = pt.shard_node_data(labels).numpy().astype(np.int32)
        ms = pt.shard_node_data(mask).numpy()
        params = jtrain.init_gcn_params(jax.random.PRNGKey(0), F, HIDDEN,
                                        CLASSES)
        opt = optax.adam(LR)
        step, _ = jtrain.make_gcn_train_step(
            pj, mesh, opt, CLASSES, combined=extra["combined"],
            prefilled=extra["prefilled"])
        xj = jnp.asarray(xs)
        if extra["prefilled"]:
            xj = jso.fill_halo_combined(pj, mesh)(xj)
        p_, st, losses = params, opt.init(params), []
        for _ in range(STEPS):
            p_, st, loss = step(p_, st, xj, jnp.asarray(ys),
                                jnp.asarray(ms))
            losses.append(float(loss))
        ref = {"losses": np.asarray(losses), "w1": p_["w1"],
               "b2": p_["b2"]}
        if not extra["combined"]:
            pred = jtrain.make_gcn_predict(pj, mesh)(p_, xj)
            ref["pred"] = pred
        c.update(x=xs, labels=ys, mask=ms, classes=CLASSES, lr=LR,
                 steps=STEPS, combined=extra["combined"],
                 prefilled=extra["prefilled"],
                 params={k: np.asarray(v) for k, v in params.items()})
    return c, {k: np.asarray(v) for k, v in ref.items()}


def run_cases(names, tmp_dir):
    """(reference outputs, port outputs stacked over ranks, port builds)
    of the named cases, the port's side in one world of P ranks."""
    graphs = _graphs()
    rng = np.random.default_rng(0)
    cases, refs, pgs = [], {}, {}
    for name in names:
        pj, pt, gt = _build(graphs, name)
        c, ref = _case(name, pj, pt, gt, rng)
        cases.append(c)
        refs[name] = ref
        pgs[name] = pt
    out = run_world("sharded_cases", P, (cases,), tmp_dir, timeout=150)
    got = {name: {k: np.stack([r[name][k] for r in out])
                  for k in out[0][name]} for name in names}
    return refs, got, pgs


def close(name, what, got, want, mask, rtol=1e-5):
    """|got - want| <= rtol * |want| + rtol * max|want| on owned rows."""
    sel = mask.reshape(mask.shape + (1,) * (want.ndim - mask.ndim))
    g = np.where(sel, got, 0.0)
    w = np.where(sel, want, 0.0)
    tol = rtol * np.abs(w) + rtol * max(float(np.abs(w).max()), 1e-30)
    bad = np.abs(g - w) > tol
    assert not bad.any(), (
        f"{name} {what}: {int(bad.sum())} elements off, max err "
        f"{float(np.abs(g - w).max())}")
