"""``khop_in_subgraph``, ``GNNExplainer`` and the geometry helpers of the
port against the JAX package's on the same inputs.

``khop_in_subgraph`` and ``neighbor_matching`` exactly; the
farthest-point indices exactly; GNNExplainer's node and graph masks after
20 epochs from the same starting masks (the reference's ``jax.random.
normal`` draw patched to return the port's draw) within atol 1e-5 (float32
sums in another order, through 20 Adam steps of lr 0.01)."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.nn import GraphConv as JGraphConv
from dgl1_tpu_torch.models import GCN
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, powerlaw_edges


def pair(n=200, deg=4, seed=0, pad=None):
    src, dst = powerlaw_edges(n, deg, seed=seed)
    kw = {} if pad is None else {"pad_edges_to": pad}
    return (jdgl.graph((src, dst), num_nodes=n, **kw),
            tdgl.graph((src, dst), num_nodes=n, device="cpu", **kw))


@pytest.mark.parametrize("node,k", [(0, 1), (0, 2), (57, 2), (199, 3)])
def test_khop_in_subgraph_matches_reference(node, k):
    gj, gt = pair()
    sj, cj = jdgl.khop_in_subgraph(gj, node, k)
    st, ct = tdgl.khop_in_subgraph(gt, node, k)
    assert ct == cj and st.num_nodes() == sj.num_nodes()
    e = sj.num_edges()
    assert st.num_edges() == e
    for a in ("src", "dst"):
        np.testing.assert_array_equal(getattr(st, a).numpy()[:e],
                                      np.asarray(getattr(sj, a))[:e])
    np.testing.assert_array_equal(st.ndata["_ID"].numpy(),
                                  np.asarray(sj.ndata["_ID"]))
    np.testing.assert_array_equal(st.edata["_ID"].numpy()[:e],
                                  np.asarray(sj.edata["_ID"])[:e])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("relabel", [False, True])
def test_neighbor_matching_matches_reference(weighted, relabel):
    gj, gt = pair(n=150, deg=3, seed=1)
    w = (np.random.default_rng(2).integers(1, 5, gt.num_edges())
         .astype(np.float32) if weighted else None)
    want = jdgl.geometry.neighbor_matching(gj, edge_weights=w,
                                           relabel_idx=relabel)
    got = tdgl.geometry.neighbor_matching(
        gt, edge_weights=None if w is None else torch.from_numpy(w),
        relabel_idx=relabel)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [None, 7])
def test_farthest_point_sampler_matches_reference(start):
    pos = np.random.default_rng(3).normal(size=(3, 200, 3)).astype(
        np.float32)
    want = np.asarray(jdgl.geometry.farthest_point_sampler(pos, 40, start))
    got = tdgl.geometry.farthest_point_sampler(pos, 40, start, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # A single cloud (N, C), and ties: equal points keep the first index.
    flat = np.repeat(pos[0, :10], 2, axis=0)
    np.testing.assert_array_equal(
        tdgl.geometry.farthest_point_sampler(flat, 6, device="cpu").numpy(),
        np.asarray(jdgl.geometry.farthest_point_sampler(flat, 6)))


class JNet(fnn.Module):
    """The port's ``models.GCN`` (2 layers, norm 'both', ReLU) with the
    edge weight given to both layers."""

    @fnn.compact
    def __call__(self, g, x, ew):
        h = fnn.relu(JGraphConv(8, name="layer0")(g, x, edge_weight=ew))
        return JGraphConv(3, name="layer1")(g, h, edge_weight=ew)


def explainer_pair(monkeypatch, gj, x, graph_level, epochs=20):
    jnet = JNet()
    ones = jnp.ones(gj.src.shape[0])
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), gj,
                                                jnp.asarray(x), ones))
    tnet = GCN(x.shape[1], 8, 3, dropout=0.0, device="cpu").eval()
    tnet.load_state_dict(from_jax_params(params))

    def readout(o, mean):
        return o.mean(0) if mean else o

    def jfn(g, feat, ew):
        return readout(jnet.apply(params, g, feat, ew), graph_level)

    def tfn(g, feat, ew):
        return readout(tnet(g, feat, edge_weight=ew), graph_level)

    gen_seed = 3
    draws = {}

    def fake_normal(key, shape, *a, **k):
        # The port's draw for this graph, edge logits then features,
        # unscaled: the reference multiplies the draw by 0.1.
        if not draws:
            em, fm = tdgl.nn.GNNExplainer.initial_masks(
                shape[0], x.shape[1], torch.Generator().manual_seed(gen_seed))
            draws.update(em=em.numpy() / 0.1, fm=fm.numpy() / 0.1)
            return jnp.asarray(draws["em"])
        return jnp.asarray(draws["fm"])

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    return (jdgl.nn.GNNExplainer(jfn, num_hops=2, num_epochs=epochs),
            tdgl.nn.GNNExplainer(tfn, num_hops=2, num_epochs=epochs),
            torch.Generator().manual_seed(gen_seed))


def test_gnn_explainer_node_masks_match_reference(monkeypatch):
    gj, gt = pair(n=120, deg=4, seed=5)
    x = np.random.default_rng(6).normal(size=(120, 5)).astype(np.float32)
    ej, et, gen = explainer_pair(monkeypatch, gj, x, graph_level=False)
    with engines("xla", "xla"):
        cj, sj, fmj, emj = ej.explain_node(9, gj, jnp.asarray(x))
        ct, st, fmt, emt = et.explain_node(9, gt, torch.from_numpy(x),
                                           generator=gen)
    assert ct == cj and st.num_edges() == sj.num_edges()
    assert emt.shape == (st.num_edges(),) and fmt.shape == (5,)
    np.testing.assert_allclose(emt.numpy(), np.asarray(emj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(fmt.numpy(), np.asarray(fmj), rtol=0,
                               atol=1e-5)
    # The masks moved from their start.
    assert np.abs(emt.numpy() - 0.5).max() > 0.06


def test_gnn_explainer_graph_masks_match_reference(monkeypatch):
    # Padded edges: the masks cover the padded count, the result the real.
    gj, gt = pair(n=90, deg=3, seed=7, pad=300)
    x = np.random.default_rng(8).normal(size=(90, 5)).astype(np.float32)
    ej, et, gen = explainer_pair(monkeypatch, gj, x, graph_level=True)
    with engines("xla", "xla"):
        fmj, emj = ej.explain_graph(gj, jnp.asarray(x))
        fmt, emt = et.explain_graph(gt, torch.from_numpy(x), generator=gen)
    assert emt.shape == (gt.num_edges(),) == emj.shape
    np.testing.assert_allclose(emt.numpy(), np.asarray(emj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(fmt.numpy(), np.asarray(fmj), rtol=0,
                               atol=1e-5)
