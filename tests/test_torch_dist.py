"""The rest of the port's distributed layer: tensor parallelism, the
sharded KVStore, DistGraph / DistTensor, the data-parallel sampled
GraphSAGE step over DistNodeDataLoader, the dry run's legs, and
``initialize`` failing on a missing peer.

One world of 2 gloo ranks runs the multi-process cases: the TP layer
against the reference's ``make_tp_gcn_layer`` on a 2-device mesh (output
and each rank's weight-block gradients to 1e-5 relative plus 1e-5 of the
largest magnitude: sums of a few dozen float32 terms), remote and local
KVStore pulls against the written features (exactly), the DP step (each
rank's seeds its own part's, its features the store's rows, the averaged
gradients the ranks' mean to 1e-6 and equal on both ranks), and the dry
run at 2% of the reference's sizes (every leg finite). DistGraph and
DistTensor are compared with the reference's in one process.
"""

import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parity  # noqa: F401  (loads the reference's native library)
from torch_dist_worker import run_world

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.parallel import dist_graph as jdist
from dgl1_tpu.parallel import tp as jtp
from dgl1_tpu_torch import parallel as tpar
from dgl1_tpu_torch.data.synthetic import synthetic_classification_graph
from dgl1_tpu_torch.parallel import dist_graph as tdist

WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tp_case(rng):
    n, e, fin, hid, fout = 300, 3000, 8, 16, 4
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    w1 = (rng.normal(size=(fin, hid)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(hid, fout)) * 0.3).astype(np.float32)
    w = rng.normal(size=(n, fout)).astype(np.float32)
    gj = jdgl.graph((src, dst), num_nodes=n)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("m",))
    layer = jtp.make_tp_gcn_layer(gj, mesh)
    w1s, w2s = jtp.shard_params_tp(mesh, jnp.asarray(w1), jnp.asarray(w2))
    y = layer(w1s, w2s, jnp.asarray(x))
    gw1, gw2 = jax.jit(jax.grad(
        lambda a, b: jnp.sum(layer(a, b, jnp.asarray(x)) * w),
        argnums=(0, 1)))(w1s, w2s)
    case = dict(name="tp", kind="tp", src=src, dst=dst, n=n, x=x, w1=w1,
                w2=w2, w=w)
    return case, {"y": np.asarray(y), "gw1": np.asarray(gw1),
                  "gw2": np.asarray(gw2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("dist")
    g = synthetic_classification_graph(num_nodes=600, num_classes=4,
                                       feat_dim=8, avg_degree=6.0, seed=1,
                                       device="cpu")
    part = tpar.partition_graph(g, "g", WORLD, str(tmp / "parts"),
                                part_method="random")
    feat = g.ndata["feat"].numpy()
    ids = rng.integers(0, g.num_nodes(), 120)
    train_mask = rng.random(g.num_nodes()) < 0.5
    tp_case, tp_ref = _tp_case(rng)
    cases = [
        tp_case,
        dict(name="kvstore", kind="kvstore", dir=str(tmp / "parts"),
             part=part, ids=ids,
             addrs=[("127.0.0.1", _free_port()) for _ in range(WORLD)]),
        dict(name="dp_sage", kind="dp_sage", dir=str(tmp / "parts"),
             train_mask=train_mask, f=8, classes=4),
        dict(name="dryrun", kind="dryrun", scale=0.02,
             dir=str(tmp / "dryrun")),
    ]
    (tmp / "dryrun").mkdir()
    out = run_world("dist_cases", WORLD, (cases,), tmp / "world",
                    timeout=150)
    return dict(out=out, g=g, part=part, feat=feat, ids=ids,
                train_mask=train_mask, tp_ref=tp_ref)


def _close(what, got, want, rtol=1e-5):
    tol = rtol * np.abs(want) + rtol * float(np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), (
        what, float(np.abs(got - want).max()))


def test_tp_layer_matches_reference(world):
    ref = world["tp_ref"]
    hid = ref["gw1"].shape[1]
    step = hid // WORLD
    for r, res in enumerate(world["out"]):
        got = res["tp"]
        _close("y", got["y"], ref["y"])
        _close("gw1", got["gw1"], ref["gw1"][:, r * step:(r + 1) * step])
        _close("gw2", got["gw2"], ref["gw2"][r * step:(r + 1) * step])


def test_sharded_store_pulls_local_and_remote_rows(world):
    feat, ids, part = world["feat"], world["ids"], world["part"]
    for r, res in enumerate(world["out"]):
        got = res["kvstore"]
        np.testing.assert_array_equal(got["rows"], feat[ids])
        assert got["local_rows"] == int((part == r).sum())
        n_local = int((part[ids] == r).sum())
        assert got["stats"]["local_rows"] == n_local
        assert got["stats"]["remote_rows"] == len(ids) - n_local


def test_dp_sampled_step_over_dist_loader(world):
    feat, part, g = world["feat"], world["part"], world["g"]
    outs = [res["dp_sage"] for res in world["out"]]
    mask = world["train_mask"]
    for r, got in enumerate(outs):
        # node_split: this rank's seeds are its own part's training nodes.
        np.testing.assert_array_equal(
            got["seeds"], np.flatnonzero(mask & (part == r)))
        real = got["out"][got["mask"]]
        assert np.isin(real, got["seeds"]).all()
        # DistTensor rows of the input nodes (the replicated mmap store).
        np.testing.assert_array_equal(got["x"], feat[got["inp"]])
    # The loss and every gradient are the mean over the ranks.
    np.testing.assert_allclose(outs[0]["loss"],
                               np.mean([o["local"] for o in outs]),
                               rtol=1e-6)
    for i in range(len(outs[0]["own"])):
        want = np.mean([o["own"][i] for o in outs], axis=0)
        for o in outs:
            np.testing.assert_allclose(o["mean"][i], want, rtol=1e-6,
                                       atol=1e-7)
        assert np.array_equal(outs[0]["mean"][i], outs[1]["mean"][i])
    assert g.num_nodes() == 600


def test_dryrun_legs_run_at_small_scale(world):
    recs = world["out"][0]["dryrun"]
    assert [r["leg"] for r in recs] == list(range(1, 12))
    for r in recs:
        for k, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), (r["leg"], k)
    assert recs[2]["m_part"] > 0
    # Every rank reports the same global loss.
    for a, b in zip(recs, world["out"][1]["dryrun"]):
        if "loss" in a and a["leg"] != 11:
            assert a["loss"] == b["loss"]


def test_dist_graph_and_tensor_match_reference():
    rng = np.random.default_rng(3)
    n = 400
    src, dst = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    feat = rng.normal(size=(n, 5)).astype(np.float32)
    gj = jdgl.graph((src, dst), num_nodes=n)
    gj.ndata["feat"] = feat
    gt = tdgl.graph((src, dst), num_nodes=n, device="cpu")
    gt.ndata["feat"] = torch.tensor(feat)
    for method in ("greedy", "random", "metis"):
        dj = jdist.DistGraph(gj, 3, part_method=method)
        dt = tdist.DistGraph(gt, 3, part_method=method)
        np.testing.assert_array_equal(dt.part, dj.part)
        assert dt.num_nodes() == dj.num_nodes() == n
        assert dt.num_edges() == dj.num_edges()
        ids = rng.integers(0, n, 50)
        np.testing.assert_array_equal(dt.ndata["feat"][ids],
                                      dj.ndata["feat"][ids])
        assert dt.ndata["feat"].shape == dj.ndata["feat"].shape
        val = rng.normal(size=(10, 5)).astype(np.float32)
        dj.ndata["feat"][ids[:10]] = val
        dt.ndata["feat"][torch.as_tensor(ids[:10])] = torch.tensor(val)
        np.testing.assert_array_equal(dt.ndata["feat"][ids],
                                      dj.ndata["feat"][ids])
        for p in range(3):
            lj, lt = dj.local_graph(p), dt.local_graph(p)
            np.testing.assert_array_equal(lt.src.numpy()[: lt.num_edges()],
                                          np.asarray(lj.src)[
                                              : lj.num_edges()])
        pj, pt = dj.partitioned(tiles=False), dt.partitioned(tiles=False)
        np.testing.assert_array_equal(pt.esrc, np.asarray(pj.esrc))
        np.testing.assert_array_equal(pt.send_idx, np.asarray(pj.send_idx))
        assert dt.get_partition_book().num_parts == 3
    hg = tdgl.heterograph({("a", "r", "b"): ([0, 1], [1, 0])},
                          device="cpu")
    # Heterographs take the typed facade and partitioner
    # (test_torch_hetero_parallel.py holds them against the reference).
    dh = tdist.DistGraph(hg, 2)
    assert dh.hetero and set(dh.part) == {"a", "b"}
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        part = tpar.partition_graph(hg, "h", 2, d)
        assert set(part) == {"a", "b"}
    assert tpar.DistEmbedding is tdgl.optim.NodeEmbedding


def test_initialize_raises_on_a_missing_peer():
    """Rank 0 of 2 waits for a peer that never comes: RuntimeError within
    the timeout, no process group left behind."""
    import time

    import torch.distributed as dist

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="could not join"):
        tpar.initialize(f"127.0.0.1:{_free_port()}", 2, 0, timeout_s=2,
                        device="cpu")
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()
    assert tpar.initialize() is None  # no coordinator: single process
