"""Sampled heterographs in the port against the JAX package, on the CPU:

- the hetero ``NodeDataLoader`` (inline and with two workers) gives the
  reference's batches, blocks equal array for array, and its
  ``pull_features`` hook the feature store's rows;
- ``HostFeatureStore`` files written by one package open in the other;
- sparse Adam and Adagrad (out-of-range, negative and repeated ids
  included) within 1e-6 relative of the reference;
- the sampled R-GCN slice of ``examples/train_rgcn_sampled.py`` on
  ``synthetic_mag_heterograph(scale=2048)`` at hidden 16, both packages
  on their ELL engine (the backward through the tile sums over every
  relation's ``tsrc``, the empty relations of the output block included):
  step-0 logits, the loss, every dense grad and the embedding rows' grads
  within 1e-5 * (1 + |ref|) element by element; the dense parameters, the
  tables and the sparse Adam state after one step likewise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import optim as joptim
from dgl1_tpu.data.feature_store import HostFeatureStore as JStore
from dgl1_tpu.data.synthetic import synthetic_mag_heterograph as jmag
from dgl1_tpu.dataloading import NeighborSampler as JSampler
from dgl1_tpu.dataloading import NodeDataLoader as JLoader
from dgl1_tpu.nn.conv import GraphConv as JGraphConv
from dgl1_tpu.nn.hetero import HeteroGraphConv as JHeteroGraphConv
from dgl1_tpu_torch import optim as toptim
from dgl1_tpu_torch.data import HostFeatureStore
from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
from dgl1_tpu_torch.models import HeteroRGCN
from dgl1_tpu_torch.train import embed_ids

from test_torch_neighbor import assert_hetero_equal
from torch_parity import engines, t

BATCH, FANOUT, HIDDEN, EMB = 64, 5, 16, 16


def _close(got, ref, what, rtol=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref)
    bad = err > rtol * (1.0 + np.abs(ref))
    assert not bad.any(), (f"{what}: {int(bad.sum())} past {rtol} * (1 + "
                           f"|ref|); max err {err.max()}")


@pytest.fixture(scope="module")
def mag():
    hj, sj = jmag(scale=2048)
    ht, st = tdgl.data.synthetic_mag_heterograph(scale=2048, device="cpu")
    return hj, ht, st["train"]


def _fanouts(hg):
    return [{c[1]: FANOUT for c in hg.canonical_etypes}] * 2


@pytest.mark.parametrize("prefetch,workers", [(0, 1), (2, 2)])
def test_hetero_loader_matches_reference(mag, prefetch, workers):
    hj, ht, train = mag
    ids = train[:150]
    kw = dict(batch_size=BATCH, shuffle=True, seed=3, prefetch=prefetch,
              num_workers=workers)
    jb = list(JLoader(hj, {"paper": ids}, JSampler(_fanouts(hj)), **kw))
    feat = ht.nodes["paper"].data["feat"].numpy()
    store = HostFeatureStore(feat, device="cpu")
    loader = NodeDataLoader(ht, {"paper": ids}, NeighborSampler(_fanouts(ht)),
                            pull_features=lambda inp: store.pull_to_device(
                                inp["paper"]), device="cpu", **kw)
    tb = list(loader)
    assert len(tb) == len(jb) == 3
    for (it, ot, bt, mt, xt), (ij, oj, bj, mj) in zip(tb, jb):
        assert set(it) == set(ij) and list(ot) == ["paper"]
        for nt in ij:
            np.testing.assert_array_equal(it[nt].numpy(), np.asarray(ij[nt]))
        np.testing.assert_array_equal(ot["paper"].numpy(),
                                      np.asarray(oj["paper"]))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        for b1, b2 in zip(bj, bt):
            assert_hetero_equal(b1, b2)
        np.testing.assert_array_equal(xt.numpy(),
                                      feat[it["paper"].numpy()])
    assert int(tb[-1][3].sum()) == 150 - 2 * BATCH
    assert len(loader.sample_s) == len(loader.pull_s) == 3


def test_feature_store_files_cross_packages(tmp_path):
    x = np.random.default_rng(0).normal(size=(500, 7)).astype(np.float32)
    ids = np.array([3, 499, 0, 3, 250])
    JStore.save(tmp_path / "ref.bin", x)
    HostFeatureStore.save(tmp_path / "port.bin", x, device="cpu")
    for name in ("ref.bin", "port.bin"):
        st = HostFeatureStore.load(tmp_path / name, device="cpu")
        sj = JStore.load(tmp_path / name)
        assert st.shape == sj.shape == x.shape and st.dtype == sj.dtype
        np.testing.assert_array_equal(st.pull(ids), np.asarray(sj.pull(ids)))
        got = st.pull_to_device(torch.as_tensor(ids))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), x[ids])
    np.save(tmp_path / "a.npy", x)
    np.testing.assert_array_equal(
        HostFeatureStore(tmp_path / "a.npy", mmap=True,
                         device="cpu").pull(ids), x[ids])
    with pytest.raises(IndexError):
        HostFeatureStore(x, device="cpu").pull([500])


def test_prefetch_to_device_pulls_rows_and_labels():
    from dgl1_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 200, 1500), rng.integers(0, 200, 1500)
    g = tdgl.graph((src, dst), num_nodes=200, device="cpu")
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = rng.integers(0, 4, 200).astype(np.int32)
    loader = NodeDataLoader(g, np.arange(120), NeighborSampler([3, 2]),
                            batch_size=32, seed=1, device="cpu")
    plain = list(loader)
    loader.rng = np.random.default_rng(1)
    got = list(prefetch_to_device(loader, HostFeatureStore(x, device="cpu"),
                                  labels=y, depth=2))
    assert len(got) == len(plain) == 4
    for (inp, out, blocks, mask, xb, yb), (i2, o2, _, m2) in zip(got,
                                                                 plain):
        assert torch.equal(inp, i2) and torch.equal(mask, m2)
        np.testing.assert_array_equal(xb.numpy(), x[inp.numpy()])
        np.testing.assert_array_equal(yb.numpy(), y[out.numpy()])


def _rows(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# Repeated ids, ids at and past the end, and a negative id.
_IDS = np.array([4, 9, 4, 20, 23, -1, 0, 4, 31])


def test_sparse_adam_matches_reference():
    table = _rows(1, 20, 6)
    tj, sj = jnp.asarray(table), joptim.sparse_adam_init(jnp.asarray(table))
    tt = torch.from_numpy(table.copy())
    st = toptim.sparse_adam_init(tt)
    for step in range(3):
        ids = np.roll(_IDS, step)
        g = _rows(10 + step, len(ids), 6)
        tj, sj = joptim.sparse_adam_update(tj, sj, jnp.asarray(ids),
                                           jnp.asarray(g), lr=0.05)
        tt, st = toptim.sparse_adam_update(tt, st, torch.from_numpy(ids),
                                           torch.from_numpy(g), lr=0.05)
        np.testing.assert_array_equal(st.step.numpy(), np.asarray(sj.step))
        for a, b, what in ((tt, tj, "table"), (st.m, sj.m, "m"),
                           (st.v, sj.v, "v")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{what} {step}")
    assert st.step.dtype == torch.int32


def test_sparse_adagrad_matches_reference():
    table = _rows(2, 20, 5)
    tj, aj = jnp.asarray(table), joptim.sparse_adagrad_init(jnp.asarray(table))
    tt = torch.from_numpy(table.copy())
    at = toptim.sparse_adagrad_init(tt)
    for step in range(3):
        ids = np.roll(_IDS, 2 * step)
        g = _rows(20 + step, len(ids), 5)
        tj, aj = joptim.sparse_adagrad_update(tj, aj, jnp.asarray(ids),
                                              jnp.asarray(g))
        tt, at = toptim.sparse_adagrad_update(tt, at, torch.from_numpy(ids),
                                              torch.from_numpy(g))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6,
                                   atol=1e-7)


def test_node_embedding_reads_clip_and_fill():
    emb = toptim.NodeEmbedding.create(10, 4, generator=torch.Generator()
                                      .manual_seed(0), device="cpu")
    assert emb.table.abs().max() <= 0.5
    ids = torch.tensor([0, 9, 12, -3])
    np.testing.assert_array_equal(emb(ids).numpy(),
                                  emb.table.numpy()[[0, 9, 9, 0]])
    got = toptim.take_rows(emb.table, ids).numpy()
    want = jnp.take(jnp.asarray(emb.table.numpy()), jnp.asarray(ids.numpy()),
                    axis=0, mode="fill", fill_value=0.0)
    np.testing.assert_array_equal(got, np.asarray(want))


class _JRGCN(fnn.Module):
    """The model of examples/train_rgcn_sampled.py."""

    etypes: tuple
    hidden: int
    out: int

    @fnn.compact
    def __call__(self, blocks, x):
        h = JHeteroGraphConv({e: JGraphConv(self.hidden)
                              for e in self.etypes}, name="l0")(blocks[0], x)
        h = {k: fnn.relu(v) for k, v in h.items()}
        h = JHeteroGraphConv({e: JGraphConv(self.out) for e in self.etypes},
                             name="l1")(blocks[1], h)
        return h["paper"]


@pytest.fixture(scope="module")
def rgcn_slice(mag):
    """One batch in both packages, the reference's model and tables, the
    port's model and tables made from them."""
    hj, ht, train = mag
    kw = dict(batch_size=BATCH, shuffle=True, seed=5, prefetch=0)
    inp_j, out_j, bj, mask = next(iter(JLoader(
        hj, {"paper": train[:200]}, JSampler(_fanouts(hj)), **kw)))
    batch_t = next(iter(NodeDataLoader(
        ht, {"paper": train[:200]}, NeighborSampler(_fanouts(ht)),
        device="cpu", **kw)))
    for b1, b2 in zip(bj, batch_t[2]):
        assert_hetero_equal(b1, b2)
    embed = [nt for nt in ht.ntypes if nt != "paper"]
    key = jax.random.PRNGKey(0)
    tables_j = {nt: joptim.NodeEmbedding.create(
        jax.random.fold_in(key, i), ht.num_nodes(nt), EMB).table
        for i, nt in enumerate(embed)}
    ids_j = {}
    for nt in embed:
        ids = np.asarray(inp_j[nt], np.int64).copy()
        ids[bj[0].meta["num_real_src"][nt]:] = ht.num_nodes(nt)
        ids_j[nt] = jnp.asarray(ids)
    feat = hj.nodes["paper"].data["feat"]
    x_paper = feat[jnp.asarray(inp_j["paper"])]
    y = hj.nodes["paper"].data["label"][jnp.asarray(out_j["paper"])]
    etypes = tuple(c[1] for c in ht.canonical_etypes)
    model_j = _JRGCN(etypes, HIDDEN, 349)
    rows0 = {nt: jnp.take(tables_j[nt], ids_j[nt], axis=0, mode="fill",
                          fill_value=0.0) for nt in embed}
    params = model_j.init(jax.random.PRNGKey(1), bj,
                          {"paper": x_paper, **rows0})
    dims = {nt: EMB for nt in embed}
    dims["paper"] = 128
    model_t = HeteroRGCN(ht.canonical_etypes, dims, HIDDEN, 349,
                         device="cpu")
    sd = HeteroRGCN.jax_state_dict(
        jax.tree_util.tree_map(np.asarray, params), ht.canonical_etypes)
    assert set(sd) == set(model_t.state_dict())
    model_t.load_state_dict(sd)
    s = dict(bj=bj, batch_t=batch_t, mask=np.asarray(mask), embed=embed,
             tables_j=tables_j, ids_j=ids_j, x_paper=x_paper, y=y,
             model_j=model_j, params=params, model_t=model_t,
             labels_t=ht.nodes["paper"].data["label"],
             feat_t=ht.nodes["paper"].data["feat"])
    loss_fn, rows_j = _loss_j(s)
    with engines("ell", "ell"):
        s["ref"] = jax.value_and_grad(loss_fn, argnums=(0, 1),
                                      has_aux=True)(params, rows_j)
    return s


def model_t_etypes(s):
    return s["batch_t"][2][0].canonical_etypes


def _loss_j(s):
    model, embed, bj = s["model_j"], s["embed"], s["bj"]
    mask = jnp.asarray(s["mask"], jnp.float32)

    def loss_fn(p, rows):
        logits = model.apply(p, bj, {"paper": s["x_paper"], **rows})
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, s["y"])
        return jnp.sum(ls * mask) / jnp.maximum(mask.sum(), 1.0), logits

    rows = {nt: jnp.take(s["tables_j"][nt], s["ids_j"][nt], axis=0,
                         mode="fill", fill_value=0.0) for nt in embed}
    return loss_fn, rows


def test_sampled_rgcn_step_matches_reference(rgcn_slice):
    s = rgcn_slice
    (loss_j, logits_j), (gp, grows) = s["ref"]
    with engines("ell", "ell"):
        inp, out, blocks, mask = s["batch_t"]
        tables = {nt: torch.from_numpy(np.array(s["tables_j"][nt]))
                  for nt in s["embed"]}
        ids = embed_ids(inp, blocks, tables)
        for nt in s["embed"]:
            np.testing.assert_array_equal(ids[nt].numpy(),
                                          np.asarray(s["ids_j"][nt]))
        rows = {nt: toptim.take_rows(tables[nt], ids[nt]).requires_grad_()
                for nt in s["embed"]}
        x = {"paper": s["feat_t"].index_select(0, inp["paper"]), **rows}
        model = s["model_t"]
        model.zero_grad()
        logits = model(blocks, x)
        ce = torch.nn.functional.cross_entropy(
            logits, s["labels_t"].index_select(0, out["paper"]).long(),
            reduction="none")
        m = mask.float()
        loss = (ce * m).sum() / m.sum().clamp(min=1.0)
        loss.backward()
    _close(logits.detach(), logits_j, "logits")
    _close(float(loss.detach()), float(loss_j), "loss")
    grads = HeteroRGCN.jax_state_dict(
        jax.tree_util.tree_map(np.asarray, gp),
        blocks[0].canonical_etypes)
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        got = named[name].grad
        if got is None:
            # A relation whose output never reaches the paper logits (its
            # dst type has no seeds downstream): no grad in torch, zeros
            # in jax.
            assert not g.any(), name
            continue
        _close(got, g, f"grad {name}")
    for nt in s["embed"]:
        _close(rows[nt].grad, grows[nt], f"row grad {nt}")
    # The output block's relations into author, institution and
    # field_of_study are empty, and they ran.
    empty = [c for c, r in blocks[1].rel_graphs.items()
             if r.num_dst_nodes() == 0]
    assert len(empty) == 4


def test_sampled_rgcn_train_step_matches_reference(rgcn_slice):
    """One step of the reference's train step (optax Adam 1e-2, sparse
    Adam 5e-2) against :func:`train_sampled_rgcn`."""
    s = rgcn_slice
    (loss_j, _), (gp, grows) = s["ref"]
    opt = optax.adam(1e-2)
    with engines("ell", "ell"):
        upd, _ = opt.update(gp, opt.init(s["params"]))
        params1 = optax.apply_updates(s["params"], upd)
        new = {nt: joptim.sparse_adam_update(
            s["tables_j"][nt], joptim.sparse_adam_init(s["tables_j"][nt]),
            s["ids_j"][nt], grows[nt], lr=5e-2) for nt in s["embed"]}
        model = HeteroRGCN(
            [c for c in s["batch_t"][2][0].canonical_etypes],
            {nt: (128 if nt == "paper" else EMB)
             for nt in s["embed"] + ["paper"]}, HIDDEN, 349, device="cpu")
        model.load_state_dict(s["model_t"].state_dict())
        tables = {nt: torch.from_numpy(np.array(s["tables_j"][nt]))
                  for nt in s["embed"]}
        res = tdgl.train_sampled_rgcn([s["batch_t"]], s["feat_t"],
                                      s["labels_t"], model, tables,
                                      lr=1e-2, sparse_lr=5e-2)
    _close(res["losses"][0], float(loss_j), "loss")
    for name, p in HeteroRGCN.jax_state_dict(
            jax.tree_util.tree_map(np.asarray, params1),
            model_t_etypes(s)).items():
        _close(dict(model.named_parameters())[name].detach(), p,
               f"param {name}")
    for nt in s["embed"]:
        tj, sj = new[nt]
        _close(tables[nt], tj, f"table {nt}")
        st = res["states"][nt]
        _close(st.m, sj.m, f"m {nt}")
        _close(st.v, sj.v, f"v {nt}")
        np.testing.assert_array_equal(st.step.numpy(), np.asarray(sj.step))
