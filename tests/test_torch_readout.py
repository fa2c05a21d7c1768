"""The graph-level layer of the port against the reference on the same
numpy inputs: ``batch``/``unbatch`` (graphs and heterographs), every
readout of ``readout.py`` (an empty graph in the batch included), the
pooling modules of ``nn/glob.py`` with weights carried by
``from_jax_params``, ``GraphDataLoader`` (padding, mask, a partial batch,
an error in the producer thread) and ``GIN`` end to end on a padded batch.

Tolerance: rtol 1e-5, atol 1e-5 for the readouts (segment sums of a few
terms); rtol 1e-4, atol 1e-5 for modules, their grads and GIN (float32
sums in another order). Indices and structure compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import nn as jnn
from dgl1_tpu.dataloading import GraphDataLoader as JLoader
from dgl1_tpu.models import GIN as JGIN
from dgl1_tpu_torch import nn as tnn
from dgl1_tpu_torch.dataloading import GraphDataLoader
from dgl1_tpu_torch.models import GIN
from dgl1_tpu_torch.nn.conv import dense
from dgl1_tpu_torch.params import from_jax_params
from torch_parity import close, module_pair, rand

CPU = dict(device="cpu")
RTOL = dict(rtol=1e-5, atol=1e-5)
SIZES = [(5, 12), (3, 4), (7, 20)]


def pair(n, e, seed):
    """The same random graph with features ``h`` (n, 4), ``w`` (n,) and
    edge features ``e`` (e, 3) in both packages."""
    gj = jdgl.rand_graph(n, e, seed=seed)
    gt = tdgl.rand_graph(n, e, seed=seed, **CPU)
    rng = np.random.default_rng(seed)
    for k, v in (("h", rng.normal(size=(n, 4))), ("w", rng.random(n))):
        gj.ndata[k], gt.ndata[k] = jnp.asarray(v, jnp.float32), \
            torch.tensor(v, dtype=torch.float32)
    ev = rng.normal(size=(e, 3))
    gj.edata["e"], gt.edata["e"] = jnp.asarray(ev, jnp.float32), \
        torch.tensor(ev, dtype=torch.float32)
    return gj, gt


def batched(sizes=SIZES, seed=0):
    pairs = [pair(n, e, seed + i) for i, (n, e) in enumerate(sizes)]
    return (jdgl.batch([p[0] for p in pairs]),
            tdgl.batch([p[1] for p in pairs], **CPU))


def same_graph(gt, gj):
    e = gj.num_edges()
    assert gt.num_nodes() == gj.num_nodes() and gt.num_edges() == e
    np.testing.assert_array_equal(gt.src[:e].numpy(), np.asarray(gj.src)[:e])
    np.testing.assert_array_equal(gt.dst[:e].numpy(), np.asarray(gj.dst)[:e])
    for k in gj.ndata:
        close(gt.ndata[k], gj.ndata[k], k, RTOL)
    for k in gj.edata:
        close(gt.edata[k][:e], np.asarray(gj.edata[k])[:e], k, RTOL)


def test_batch_and_unbatch_match_reference():
    bj, bt = batched()
    same_graph(bt, bj)
    np.testing.assert_array_equal(tdgl.batch_num_nodes(bt).numpy(),
                                  np.asarray(jdgl.batch_num_nodes(bj)))
    np.testing.assert_array_equal(tdgl.batch_num_edges(bt).numpy(),
                                  np.asarray(jdgl.batch_num_edges(bj)))
    parts_t, parts_j = tdgl.unbatch(bt), jdgl.unbatch(bj)
    assert len(parts_t) == len(parts_j) == 3
    for a, b in zip(parts_t, parts_j):
        same_graph(a, b)
    single = tdgl.rand_graph(4, 5, **CPU)
    assert tdgl.batch_num_nodes(single).tolist() == [4]


def _hetero_pair(seed):
    rng = np.random.default_rng(seed)
    data = {("a", "r", "b"): (rng.integers(0, 4, 6), rng.integers(0, 3, 6)),
            ("b", "s", "a"): (rng.integers(0, 3, 5), rng.integers(0, 4, 5))}
    nn_ = {"a": 4, "b": 3}
    hj = jdgl.heterograph(data, num_nodes_dict=nn_)
    ht = tdgl.heterograph(data, num_nodes_dict=nn_, **CPU)
    x = rng.normal(size=(4, 2)).astype(np.float32)
    hj.nframes["a"]["x"], ht.nframes["a"]["x"] = jnp.asarray(x), \
        torch.tensor(x)
    w = rng.normal(size=(6, 1)).astype(np.float32)
    hj.rel_graphs[("a", "r", "b")].edata["w"] = jnp.asarray(w)
    ht.rel_graphs[("a", "r", "b")].edata["w"] = torch.tensor(w)
    return hj, ht


def test_hetero_batch_and_unbatch_match_reference():
    pairs = [_hetero_pair(s) for s in range(3)]
    bj = jdgl.batch([p[0] for p in pairs])
    bt = tdgl.batch([p[1] for p in pairs], **CPU)
    for c in bj.canonical_etypes:
        same_graph_rel(bt.rel_graphs[c], bj.rel_graphs[c])
    close(bt.nframes["a"]["x"], bj.nframes["a"]["x"], tol=RTOL)
    for nt in ("a", "b"):
        np.testing.assert_array_equal(
            tdgl.batch_num_nodes(bt, nt).numpy(),
            np.asarray(jdgl.batch_num_nodes(bj, nt)))
    np.testing.assert_array_equal(
        tdgl.batch_num_edges(bt, "s").numpy(),
        np.asarray(jdgl.batch_num_edges(bj, "s")))
    with pytest.raises(ValueError):
        tdgl.batch_num_nodes(bt)
    for a, b in zip(tdgl.unbatch(bt), jdgl.unbatch(bj)):
        for c in b.canonical_etypes:
            same_graph_rel(a.rel_graphs[c], b.rel_graphs[c])
        close(a.nframes["a"]["x"], b.nframes["a"]["x"], tol=RTOL)


def same_graph_rel(rt, rj):
    e = rj.num_edges()
    assert rt.num_edges() == e
    np.testing.assert_array_equal(rt.src[:e].numpy(), np.asarray(rj.src)[:e])
    np.testing.assert_array_equal(rt.dst[:e].numpy(), np.asarray(rj.dst)[:e])
    for k in rj.edata:
        close(rt.edata[k][:e], np.asarray(rj.edata[k])[:e], k, RTOL)


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_readouts_match_reference(op, empty):
    """Node and edge readouts, plain and weighted; with ``empty`` a graph
    of no nodes and a graph of nodes but no edges sit in the batch (a
    0 row, as the reference gives)."""
    sizes = SIZES + ([(0, 0), (2, 0)] if empty else [])
    bj, bt = batched(sizes)
    for got, want in (
            (tdgl.readout_nodes(bt, "h", op=op),
             jdgl.readout_nodes(bj, "h", op=op)),
            (tdgl.readout_nodes(bt, "h", "w", op=op),
             jdgl.readout_nodes(bj, "h", "w", op=op)),
            (tdgl.readout_edges(bt, "e", op=op),
             jdgl.readout_edges(bj, "e", op=op))):
        close(got, want, op, RTOL)
    named = {"sum": (tdgl.sum_nodes, jdgl.sum_nodes, tdgl.sum_edges,
                     jdgl.sum_edges),
             "mean": (tdgl.mean_nodes, jdgl.mean_nodes, tdgl.mean_edges,
                      jdgl.mean_edges),
             "max": (tdgl.max_nodes, jdgl.max_nodes, tdgl.max_edges,
                     jdgl.max_edges)}.get(op)
    if named:
        close(named[0](bt, "h"), named[1](bj, "h"), tol=RTOL)
        close(named[2](bt, "e"), named[3](bj, "e"), tol=RTOL)


@pytest.mark.parametrize("empty", [False, True])
def test_softmax_and_broadcast_match_reference(empty):
    sizes = SIZES + ([(0, 0), (2, 0)] if empty else [])
    bj, bt = batched(sizes)
    close(tdgl.softmax_nodes(bt, "h"), jdgl.softmax_nodes(bj, "h"),
          tol=RTOL)
    close(tdgl.softmax_edges(bt, "e"), jdgl.softmax_edges(bj, "e"),
          tol=RTOL)
    gf = np.arange(len(sizes) * 2, dtype=np.float32).reshape(-1, 2)
    close(tdgl.broadcast_nodes(bt, torch.tensor(gf)),
          jdgl.broadcast_nodes(bj, jnp.asarray(gf)), tol=RTOL)
    close(tdgl.broadcast_edges(bt, torch.tensor(gf)),
          jdgl.broadcast_edges(bj, jnp.asarray(gf)), tol=RTOL)


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("sortby", [None, 1])
def test_topk_matches_reference(descending, sortby):
    """Values and indices; the features are small integers, so many keys
    tie, and both packages keep the lower position first."""
    bj, bt = batched()
    ties = np.random.default_rng(3).integers(0, 3, (15, 4)).astype(
        np.float32)
    for x_t, x_j in ((bt.ndata["h"], bj.ndata["h"]),
                     (torch.tensor(ties), jnp.asarray(ties))):
        vt, it = tdgl.topk_nodes(bt, x_t, 3, descending=descending,
                                 sortby=sortby)
        vj, ij = jdgl.topk_nodes(bj, x_j, 3, descending=descending,
                                 sortby=sortby)
        close(vt, vj, tol=RTOL)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    vt, it = tdgl.topk_edges(bt, "e", 2, sortby=sortby)
    vj, ij = jdgl.topk_edges(bj, "e", 2, sortby=sortby)
    close(vt, vj, tol=RTOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # A 1-D feature (squeezed like the reference's).
    vt, it = tdgl.topk_nodes(bt, "w", 2)
    vj, ij = jdgl.topk_nodes(bj, "w", 2)
    close(vt, vj, tol=RTOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    with pytest.raises(ValueError):
        tdgl.topk_nodes(bt, "h", 4)  # the smallest graph has 3 nodes


def test_unbatched_graph_reads_out_as_one():
    gj, gt = pair(5, 12, 0)
    close(tdgl.sum_nodes(gt, "h"), jdgl.sum_nodes(gj, "h"), tol=RTOL)


POOLS = {
    "sum": lambda: (jnn.SumPooling(), tnn.SumPooling()),
    "avg": lambda: (jnn.AvgPooling(), tnn.AvgPooling()),
    "max": lambda: (jnn.MaxPooling(), tnn.MaxPooling()),
    "sort": lambda: (jnn.SortPooling(k=4), tnn.SortPooling(4)),
    "attention": lambda: (
        jnn.GlobalAttentionPooling(gate_nn=jax_dense(1),
                                   feat_nn=jax_dense(5)),
        tnn.GlobalAttentionPooling(dense(4, 1, **CPU), dense(4, 5, **CPU))),
    "set2set": lambda: (jnn.Set2Set(input_dim=4, n_iters=3),
                        tnn.Set2Set(4, n_iters=3, **CPU)),
    "weight_and_sum": lambda: (jnn.WeightAndSum(in_feats=4),
                               tnn.WeightAndSum(4, **CPU)),
    "st_encoder_sab": lambda: (
        jnn.SetTransformerEncoder(d_model=8, num_heads=2, d_ff=16,
                                  n_layers=2),
        tnn.SetTransformerEncoder(4, 8, num_heads=2, d_ff=16, n_layers=2,
                                  **CPU)),
    "st_encoder_isab": lambda: (
        jnn.SetTransformerEncoder(d_model=4, num_heads=2, d_ff=16,
                                  block_type="isab", m=3),
        tnn.SetTransformerEncoder(4, 4, num_heads=2, d_ff=16,
                                  block_type="isab", m=3, **CPU)),
    "st_decoder": lambda: (
        jnn.SetTransformerDecoder(d_model=8, num_heads=2, d_ff=16, k=2),
        tnn.SetTransformerDecoder(4, 8, num_heads=2, d_ff=16, k=2, **CPU)),
}


def jax_dense(n):
    import flax.linen as fnn

    return fnn.Dense(n)


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_matches_reference(name):
    """Each pooling module on a batch of three graphs: values and grads
    (of the features and every parameter)."""
    bj, bt = batched()
    jm, tm = POOLS[name]()
    module_pair(jm, tm, bj, bt, [rand((15, 4), 5)],
                tol=dict(rtol=1e-4, atol=1e-5))


def test_edge_softmax_is_exported_under_nn():
    assert tnn.edge_softmax is tdgl.ops.edge_softmax


class _Data:
    """(graph, label) items in one package, graph i of ``n_i`` nodes and
    its own features; index ``bad`` raises."""

    def __init__(self, pkg, count=7, bad=None):
        self.pkg, self.count, self.bad = pkg, count, bad

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f"item {i}")
        n = 3 + (i * 5) % 7
        kw = CPU if self.pkg is tdgl else {}
        g = self.pkg.rand_graph(n, 2 * n, seed=i, **kw)
        x = np.random.default_rng(i).normal(size=(n, 4)).astype(np.float32)
        g.ndata["x"] = torch.tensor(x) if self.pkg is tdgl else jnp.asarray(x)
        return g, i % 2


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_graph_dataloader_matches_reference(pad, shuffle):
    """Batches of 3 over 7 graphs (the last one partial, repeat-filled):
    the same batched graphs, labels and masks; with ``pad`` the node and
    edge counts are multiples of 16 and 32 and the padding graph is the
    last segment."""
    kw = dict(batch_size=3, shuffle=shuffle, pad=pad, node_pad_multiple=16,
              edge_pad_multiple=32, seed=4)
    lj = JLoader(_Data(jdgl), **kw)
    lt = GraphDataLoader(_Data(tdgl), **kw, **CPU)
    assert len(lt) == len(lj) == 3
    n_batches = 0
    for (bt, yt, mt), (bj, yj, mj) in zip(lt, lj):
        same_graph(bt, bj)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(tdgl.batch_num_nodes(bt).numpy(),
                                      np.asarray(jdgl.batch_num_nodes(bj)))
        if pad:
            assert bt.num_nodes() % 16 == 0 and bt.num_edges() % 32 == 0
            assert len(tdgl.batch_num_nodes(bt)) == 4
        n_batches += 1
    assert n_batches == 3
    assert mt.tolist() == [True, False, False]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_graph_dataloader_raises_producer_error(prefetch):
    """An item that raises: the batches before it arrive, then the error
    is raised in the consumer (from the producer thread with prefetch)."""
    loader = GraphDataLoader(_Data(tdgl, bad=4), batch_size=2,
                             prefetch=prefetch, **CPU)
    got = []
    with pytest.raises(KeyError, match="item 4"):
        for b in loader:
            got.append(b)
    assert len(got) == 2


@pytest.mark.parametrize("readout", ["sum", "mean"])
def test_gin_matches_reference_on_padded_batch(readout):
    """GIN (3 layers, hidden 8, learnable eps) on a padded loader batch:
    logits (the padding graph's row included) and every grad of the
    masked cross entropy."""
    kw = dict(batch_size=3, pad=True, node_pad_multiple=16,
              edge_pad_multiple=32)
    bj, yj, mj = next(iter(JLoader(_Data(jdgl), **kw)))
    bt, yt, mt = next(iter(GraphDataLoader(_Data(tdgl), **kw, **CPU)))
    jm = JGIN(hidden=8, classes=2, num_layers=3, learn_eps=True,
              readout=readout)
    tm = GIN(4, 8, 2, num_layers=3, learn_eps=True, readout=readout, **CPU)
    xj, xt = bj.ndata["x"], bt.ndata["x"]
    params = jax.tree.map(np.asarray, jax.jit(
        lambda x: jm.init(jax.random.PRNGKey(0), bj, x))(xj))
    tm.load_state_dict(from_jax_params(params))

    def loss(p):
        logits = jm.apply(p, bj, xj)[:3]
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, yj[:, None], 1)[:, 0]
        return jnp.sum(nll * mj) / jnp.sum(mj), jm.apply(p, bj, xj)

    (lj, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    got = tm(bt, xt)
    assert got.shape == (4, 2)  # three graphs and the padding graph
    nll = torch.nn.functional.cross_entropy(got[:3], yt.long(),
                                            reduction="none")
    lt = (nll * mt).sum() / mt.sum()
    lt.backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    close(got, want, tol=tol)
    close(lt, lj, tol=tol)
    jg = from_jax_params(jax.tree.map(np.asarray, gp))
    for k, p in tm.named_parameters():
        close(p.grad, jg[k], k, tol)


@pytest.mark.parametrize("reducer", ["max", "min"])
def test_max_min_gradient_at_exact_zero_matches_reference(reducer):
    """A row whose max (min) is exactly 0.0 takes its whole gradient, as
    in the reference: the oracle g-SpMM (node 1's only in-edge carries
    0.0) and the segment readout (a graph whose one node holds 0.0). An
    initial value of 0 in torch's scatter_reduce halved it."""
    src, dst = np.array([0, 1, 2, 0]), np.array([1, 2, 2, 0])
    x = np.array([[0.0, 1.5], [2.0, -1.0], [-3.0, 0.5]], np.float32)
    ct = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    gj = jdgl.graph((src, dst), num_nodes=3)
    gt = tdgl.graph((src, dst), num_nodes=3, **CPU)
    want = jax.grad(lambda u: jnp.sum(jdgl.ops.gspmm(
        gj, "copy_lhs", reducer, u, None) * ct))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tdgl.ops.gspmm(gt, "copy_lhs", reducer, xt, None)
     * torch.tensor(ct)).sum().backward()
    close(xt.grad, want, tol=RTOL)
    bj = jdgl.batch([jdgl.graph(([0], [0]), num_nodes=1),
                     jdgl.rand_graph(3, 4, seed=1)])
    bt = tdgl.batch([tdgl.graph(([0], [0]), num_nodes=1, **CPU),
                     tdgl.rand_graph(3, 4, seed=1, **CPU)], **CPU)
    h = np.array([[0.0], [1.0], [-2.0], [0.5]], np.float32)
    want = jax.grad(lambda u: jnp.sum(jdgl.readout_nodes(
        bj, u, op=reducer) * jnp.array([[2.0], [3.0]])))(jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    (tdgl.readout_nodes(bt, ht, op=reducer)
     * torch.tensor([[2.0], [3.0]])).sum().backward()
    close(ht.grad, want, tol=RTOL)
