"""The port's SAGEConv and GraphSAGE against the reference with the same
weights (``from_jax_params``), on a full graph and on sampled blocks (the
same blocks in both packages: the samplers agree bit for bit).

Engines are forced by name in both packages as they run on their
devices: ``ell`` for ``mean``/``gcn`` (on blocks its grad_u is K9 over
the reverse tiles: the reference's ``_segment_sum_tiles`` in interpret
mode, the port's plain version) and the reference's ``pallas`` / the
port's ``tile`` for ``pool`` (K10 forward, K9 for ties and grad_u).
Dropout is off (eval mode): flax's masks cannot be drawn in torch.

Tolerances, float32: values rtol 1e-4, atol 1e-5; grads rtol 1e-4, atol
1e-5. The dense layers' sums run in another order than XLA's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.dataloading import NeighborSampler as JSampler
from dgl1_tpu.models import GraphSAGE as JGraphSAGE
from dgl1_tpu.nn import SAGEConv as JSAGEConv
from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
from dgl1_tpu_torch.models import GraphSAGE
from dgl1_tpu_torch.nn import SAGEConv
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, skewed_edges, t

IN, HID, OUT = 16, 32, 7
ENGINE = {"mean": ("ell", "ell"), "gcn": ("ell", "ell"),
          "pool": ("pallas", "tile")}


@pytest.fixture(scope="module")
def graphs():
    """A full graph (N=300) and two sampled blocks (fanouts [3, 4], 32
    seeds, 30 of them real) of a 2,000-node parent, in both packages."""
    src, dst = skewed_edges()
    full = (jdgl.graph((src, dst), num_nodes=300),
            tdgl.graph((src, dst), num_nodes=300, device="cpu"))
    rng = np.random.default_rng(4)
    ps, pd = rng.integers(0, 2000, 12000), rng.integers(0, 2000, 12000)
    pj = jdgl.graph((ps, pd), num_nodes=2000, formats=("csc",))
    pt = tdgl.graph((ps, pd), num_nodes=2000, formats=("csc",),
                    device="cpu")
    seeds = rng.choice(2000, 32, replace=False)
    ij, _, bj = JSampler([3, 4]).sample_blocks(
        pj, seeds, rng=np.random.default_rng(9), num_real=30)
    it, _, bt = NeighborSampler([3, 4]).sample_blocks(
        pt, seeds, rng=np.random.default_rng(9), num_real=30)
    np.testing.assert_array_equal(it, np.asarray(ij))
    return {"full": full, "blocks": (bj, bt), "n_src": len(it)}


def _inputs(graphs, kind):
    if kind == "full":
        gj, gt = graphs["full"]
        return gj, gt, feats(300, IN, seed=3), 300
    bj, bt = graphs["blocks"]
    return bj, bt, feats(graphs["n_src"], IN, seed=3), bt[-1].num_dst_nodes()


def _check_grads(tmodel, jgrads):
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    tg = dict(tmodel.named_parameters())
    assert set(jg) == set(tg)
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].grad.numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["full", "blocks"])
@pytest.mark.parametrize("agg", ["mean", "gcn", "pool"])
def test_sageconv_matches_reference(graphs, agg, kind):
    gj, gt, x, _ = _inputs(graphs, kind)
    if kind == "blocks":  # the outer block: the input side
        gj, gt = gj[0], gt[0]
    n_dst = gt.num_dst_nodes()
    w = np.random.default_rng(6).normal(size=(n_dst, 8)).astype(np.float32)
    conv = JSAGEConv(8, aggregator_type=agg)
    params = jax.tree.map(np.asarray,
                          conv.init(jax.random.PRNGKey(1), gj,
                                    jnp.asarray(x)))
    tconv = SAGEConv(IN, 8, aggregator_type=agg, device="cpu")
    tconv.load_state_dict(from_jax_params(params))

    def loss(p, xx):
        out = conv.apply(p, gj, xx)
        return jnp.sum(out * w), out

    ej, et = ENGINE[agg]
    with engines(ej, et):
        (_, want), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tx = t(x).requires_grad_(True)
        got = tconv(gt, tx)
        (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    jg = from_jax_params(jax.tree.map(np.asarray, gp))
    for k, p in tconv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["full", "blocks"])
@pytest.mark.parametrize("agg", ["mean", "pool"])
def test_graphsage_matches_reference(graphs, agg, kind):
    gj, gt, x, n_out = _inputs(graphs, kind)
    labels = np.random.default_rng(8).integers(0, OUT, n_out)
    mask = np.ones(n_out, bool)
    mask[-2:] = kind == "full"  # a block batch's padding seeds drop out
    jmodel = JGraphSAGE(hidden_feats=HID, out_feats=OUT, aggregator=agg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), gj, jnp.asarray(x)))
    tmodel = GraphSAGE(IN, HID, OUT, aggregator=agg, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    tmodel.eval()

    def loss(p):
        logits = jmodel.apply(p, gj, jnp.asarray(x))
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                  jnp.asarray(labels)[:, None], axis=1)[:, 0]
        m = jnp.asarray(mask, jnp.float32)
        return jnp.sum(ce * m) / jnp.sum(m), logits

    ej, et = ENGINE[agg]
    with engines(ej, et):
        (jl, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
        logits = tmodel(gt, t(x))
        ce = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(labels), reduction="none")
        m = torch.from_numpy(mask).float()
        tl = (ce * m).sum() / m.sum()
        tl.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _check_grads(tmodel, jgrads)


def test_from_jax_params_maps_sage_names():
    p = {"params": {"layer0": {"fc_self": {"kernel": np.ones((3, 5))},
                               "fc_neigh": {"kernel": np.ones((3, 5))},
                               "fc_pool": {"kernel": np.ones((3, 3)),
                                           "bias": np.zeros(3)},
                               "bias": np.zeros(5)}}}
    sd = from_jax_params(p)
    model = GraphSAGE(3, 4, 5, num_layers=1, aggregator="pool",
                      device="cpu")
    assert set(sd) == set(model.state_dict())
    assert sd["layers.0.fc_self.weight"].shape == (5, 3)
    with pytest.raises(NotImplementedError, match="lstm"):
        SAGEConv(3, 4, aggregator_type="lstm", device="cpu")


def test_train_sampled_on_the_cpu():
    """A few steps through the whole pipeline with the port's engines
    forced as the card runs them (ELL for mean, the tile engine for
    pool): finite losses, and on one batch repeated the loss falls."""
    g, f, classes, train = tdgl.data.minibatch_graph("smoke")
    gen = torch.Generator().manual_seed(0)
    feat = torch.randn(g.num_nodes(), f, generator=gen)
    labels = torch.randint(0, classes, (g.num_nodes(),), generator=gen)
    loader = NodeDataLoader(g, train, NeighborSampler([10, 25]),
                            batch_size=256, seed=0, num_workers=2,
                            device="cpu")
    for agg, engine in (("mean", "ell"), ("pool", "tile")):
        model = GraphSAGE(f, 64, classes, aggregator=agg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        with engines("xla", engine):
            res = tdgl.train_sampled(loader, feat, labels, model, steps=3,
                                     generator=torch.Generator()
                                     .manual_seed(2))
            assert len(res["losses"]) == len(res["step_s"]) == 3
            assert all(np.isfinite(res["losses"]))
            assert len(res["sample_ms"]) >= 3
            batch = next(iter(loader))
            rep = tdgl.train_sampled([batch] * 4, feat, labels, model,
                                     lr=1e-2)
        assert rep["losses"][-1] < rep["losses"][0]
        assert rep["sample_ms"] == []


def test_sage_dropout_uses_the_given_generator(graphs):
    _, bt = graphs["blocks"]
    x = t(feats(bt[0].num_src_nodes(), IN, seed=5))
    model = GraphSAGE(IN, HID, OUT, dropout=0.5, device="cpu")
    model.train()
    with engines("xla", "ell"):
        a = model(bt, x, generator=torch.Generator().manual_seed(4))
        b = model(bt, x, generator=torch.Generator().manual_seed(4))
        c = model(bt, x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
