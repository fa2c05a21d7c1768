"""GraphSAINT and Cluster-GCN batches of the port against the JAX
package's on the same graph and seeds, array for array; one GCN step on
a batch (the loss of ``examples/train_saint.py``, weighted by
``loss_norm`` on a SAINT batch) against the reference's with the same
weights.

Tolerances, float32: the loss rtol 1e-5, the gradients rtol 1e-4 and
atol 1e-6 (sums in another order than XLA's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import GCN as JGCN
from dgl1_tpu_torch.models import GCN
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, powerlaw_edges

N, F, C = 600, 8, 3


def parent():
    src, dst = powerlaw_edges(N, 5, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, F)).astype(np.float32)
    y = rng.integers(0, C, N)
    train = rng.random(N) < 0.6
    gj = jdgl.graph((src, dst), num_nodes=N)
    gt = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    gj.ndata.update(feat=jnp.asarray(x), label=jnp.asarray(y),
                    train_mask=jnp.asarray(train))
    gt.ndata.update(feat=torch.from_numpy(x), label=torch.from_numpy(y),
                    train_mask=torch.from_numpy(train))
    return gj, gt


def assert_batch_equal(bj, bt):
    (sj, mj), (st, mt) = bj, bt
    assert st.num_nodes() == sj.num_nodes()
    assert st.num_edges() == sj.num_edges()
    assert st.num_edges_padded() == sj.src.shape[0]
    e = sj.num_edges()
    for a in ("src", "dst"):
        np.testing.assert_array_equal(getattr(st, a).numpy()[:e],
                                      np.asarray(getattr(sj, a))[:e])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert set(st.ndata) == set(sj.ndata)
    for k in sj.ndata:
        np.testing.assert_array_equal(st.ndata[k].numpy(),
                                      np.asarray(sj.ndata[k]), err_msg=k)
    for k in sj.edata:
        np.testing.assert_array_equal(st.edata[k].numpy()[:e],
                                      np.asarray(sj.edata[k])[:e],
                                      err_msg=k)


SAINT_CASES = [("node", 150), ("edge", 300), ("walk", (40, 3))]


@pytest.mark.parametrize("mode,budget", SAINT_CASES)
def test_saint_batches_match_reference(mode, budget):
    gj, gt = parent()
    kw = dict(num_batches=3, num_pre=4, seed=5, node_pad_multiple=64,
              edge_pad_multiple=256)
    sj = jdgl.dataloading.SAINTSampler(gj, mode, budget, **kw)
    st = tdgl.dataloading.SAINTSampler(gt, mode, budget, device="cpu", **kw)
    np.testing.assert_array_equal(st._node_count, sj._node_count)
    np.testing.assert_array_equal(st._edge_count, sj._edge_count)
    batches = list(zip(sj, st))
    assert len(batches) == 3
    for bj, bt in batches:
        assert_batch_equal(bj, bt)


@pytest.mark.parametrize("assignment", ["greedy", "given"])
def test_cluster_batches_match_reference(assignment):
    gj, gt = parent()
    part = (None if assignment == "greedy"
            else np.random.default_rng(6).integers(0, 12, N))
    kw = dict(num_parts=12, parts_per_batch=5, seed=7, node_pad_multiple=64,
              edge_pad_multiple=256, partition_assignment=part)
    lj = jdgl.dataloading.ClusterGCNDataLoader(gj, **kw)
    lt = tdgl.dataloading.ClusterGCNDataLoader(gt, device="cpu", **kw)
    assert len(lt) == len(lj) == 3
    for cj, ct in zip(lj.clusters, lt.clusters):
        np.testing.assert_array_equal(ct, cj)
    for _ in range(2):  # two epochs: the shuffles follow one stream
        batches = list(zip(lj, lt))
        assert len(batches) == 3
        for bj, bt in batches:
            assert_batch_equal(bj, bt)


def test_cluster_producer_error_reaches_consumer():
    _, gt = parent()
    loader = tdgl.dataloading.ClusterGCNDataLoader(
        gt, 4, device="cpu", partition_assignment=np.arange(N) % 4)

    def broken(nodes):
        raise RuntimeError("producer failed")

    loader._make_batch = broken
    with pytest.raises(RuntimeError, match="producer failed"):
        list(loader)


def saint_loss_jax(model, sg, mask, train):
    def loss(p):
        logp = jax.nn.log_softmax(model.apply(p, sg, sg.ndata["feat"]))
        ce = -jnp.take_along_axis(
            logp, sg.ndata["label"][:, None].astype(jnp.int32), axis=1)[:, 0]
        tm = jnp.take(train, sg.ndata["_ID"], axis=0, mode="clip")
        w = sg.ndata.get("loss_norm", 1.0) * mask * tm
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1e-6)
    return loss


def saint_loss_torch(model, sg, mask, train):
    logp = torch.log_softmax(model(sg, sg.ndata["feat"]), dim=1)
    ce = -logp.gather(1, sg.ndata["label"].long()[:, None])[:, 0]
    tm = train[sg.ndata["_ID"].long()]
    w = sg.ndata.get("loss_norm", 1.0) * mask * tm
    return (ce * w).sum() / w.sum().clamp_min(1e-6)


@pytest.mark.parametrize("loader", ["saint", "cluster"])
def test_gcn_step_on_a_batch_matches_reference(loader):
    gj, gt = parent()
    if loader == "saint":
        kw = dict(num_batches=1, num_pre=3, seed=2, node_pad_multiple=64,
                  edge_pad_multiple=256)
        (sj, mj), = jdgl.dataloading.SAINTSampler(gj, "walk", (60, 3), **kw)
        (st, mt), = tdgl.dataloading.SAINTSampler(gt, "walk", (60, 3),
                                                  device="cpu", **kw)
    else:
        kw = dict(num_parts=6, parts_per_batch=3, seed=2, prefetch=0,
                  node_pad_multiple=64, edge_pad_multiple=256,
                  partition_assignment=np.arange(N) % 6)
        sj, mj = next(iter(jdgl.dataloading.ClusterGCNDataLoader(gj, **kw)))
        st, mt = next(iter(tdgl.dataloading.ClusterGCNDataLoader(
            gt, device="cpu", **kw)))
    jmodel = JGCN(hidden_feats=16, out_feats=C, dropout=0.0)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), sj, sj.ndata["feat"]))
    tmodel = GCN(F, 16, C, dropout=0.0, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    with engines("xla", "xla"):
        want, jgrads = jax.value_and_grad(saint_loss_jax(
            jmodel, sj, mj, gj.ndata["train_mask"]))(params)
        loss = saint_loss_torch(tmodel, st, mt, gt.ndata["train_mask"])
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    for k, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
