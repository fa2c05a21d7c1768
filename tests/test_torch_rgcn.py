"""R-GCN in the port against the JAX package, on the CPU: the segment
matmuls, ``edge_subgraph``/``typed_subgraphs`` (plain and identity), the
typed synthetic graph, ``RelGraphConv`` on its per-relation, union-block
and per-edge (grouped-GEMM and gather) paths, and ``RGCN`` with and
without input features, with the same weights (``from_jax_params``) on
both sides.

Tolerances, float32: values and grads rtol 1e-4, atol 1e-5 (every sum runs
in another order than in XLA); losses of 3 Adam steps (optax
``adam(1e-2)`` against ``train``'s ``torch.optim.Adam``) rtol 1e-4, atol
1e-5."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import RGCN as JRGCN
from dgl1_tpu.nn.conv import RelGraphConv as JRelGraphConv
from dgl1_tpu.ops import segment as jseg
from dgl1_tpu_torch.models import RGCN
from dgl1_tpu_torch.nn import RelGraphConv
from dgl1_tpu_torch.ops import segment
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, skewed_edges, t

TOL = dict(rtol=1e-4, atol=1e-5)
R = 4
N = 300
HUB = dict(hub=300, hub_dense_floor=1000)


def _typed_edges(sort):
    src, dst = skewed_edges()
    et = np.random.default_rng(3).integers(0, R, len(src)).astype(np.int32)
    if sort:
        order = np.argsort(et, kind="stable")
        src, dst, et = src[order], dst[order], et[order]
    return src, dst, et


def _typed(sort):
    """The typed graph in both packages (hub floors of the mixed tier, so
    the grouped path's copy_e runs on a dense and a chunked group),
    its relation ids and per-relation counts."""
    src, dst, et = _typed_edges(sort)
    gj = jdgl.graph((src, dst), num_nodes=N, **HUB)
    gt = tdgl.graph((src, dst), num_nodes=N, device="cpu", **HUB)
    assert gt.hub_dst_meta.n_groups > gt.hub_dst_meta.n_dense > 0
    return gj, gt, et, np.bincount(et, minlength=R).astype(np.int32)


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=msg,
                               **TOL)


# ----------------------------------------------------------------------
# Segment matmuls
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [[3, 0, 5, 2], [1, 4, 2, 1]])
def test_segment_mm_matches_reference(lengths):
    """Rows past the last segment (the first case leaves 2) are zero."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(12, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5, 3)).astype(np.float32)
    w = rng.normal(size=(12, 3)).astype(np.float32)
    seg = np.asarray(lengths, np.int32)
    want = jseg.segment_mm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(seg))
    ga, gb = jax.grad(lambda x, y: jnp.sum(jseg.segment_mm(
        x, y, jnp.asarray(seg)) * w), argnums=(0, 1))(jnp.asarray(a),
                                                      jnp.asarray(b))
    at, bt = t(a).requires_grad_(True), t(b).requires_grad_(True)
    for s in (seg, t(seg)):  # host lengths or a tensor
        got = segment.segment_mm(at, bt, s)
        _close(got.detach(), want)
    (got * t(w)).sum().backward()
    _close(at.grad, ga)
    _close(bt.grad, gb)
    np.testing.assert_array_equal(
        segment.segment_ids_from_lengths(t(seg), 12).numpy(),
        np.asarray(jseg.segment_ids_from_lengths(jnp.asarray(seg), 12)))


def test_gather_mm_matches_reference():
    """Per-row relation index, out-of-range indices give zero rows."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 6)).astype(np.float32)
    b = rng.normal(size=(R, 6, 2)).astype(np.float32)
    idx = rng.integers(0, R, 20).astype(np.int32)
    idx[[3, 11]] = [R, -1]
    w = rng.normal(size=(20, 2)).astype(np.float32)
    want = jseg.gather_mm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx))
    ga, gb = jax.grad(lambda x, y: jnp.sum(jseg.gather_mm(
        x, y, jnp.asarray(idx)) * w), argnums=(0, 1))(jnp.asarray(a),
                                                      jnp.asarray(b))
    at, bt = t(a).requires_grad_(True), t(b).requires_grad_(True)
    got = segment.gather_mm(at, bt, t(idx))
    (got * t(w)).sum().backward()
    _close(got.detach(), want)
    _close(at.grad, ga)
    _close(bt.grad, gb)
    assert not got[[3, 11]].any()


# ----------------------------------------------------------------------
# Subgraphs and the typed graph
# ----------------------------------------------------------------------

def _same_graph(a, b):
    e = a.num_edges()
    assert b.num_edges() == e and b.num_nodes() == a.num_nodes()
    np.testing.assert_array_equal(b.src[:e].numpy(), np.asarray(a.src)[:e])
    np.testing.assert_array_equal(b.dst[:e].numpy(), np.asarray(a.dst)[:e])
    np.testing.assert_array_equal(b.edata["_ID"].numpy(),
                                  np.asarray(a.edata["_ID"]))
    assert (b.hub_dst_meta is None) == (a.hub_dst_meta is None)


@pytest.mark.parametrize("relabel", [True, False])
def test_edge_subgraph_matches_reference(relabel):
    gj, gt, _, _ = _typed(False)
    rng = np.random.default_rng(4)
    gj.ndata["x"] = jnp.asarray(feats(N, 2))
    gt.ndata["x"] = t(feats(N, 2))
    for edges in (rng.choice(gt.num_edges(), 700, replace=False),
                  rng.random(gt.num_edges()) < 0.2):
        a = jdgl.edge_subgraph(gj, edges, relabel_nodes=relabel)
        b = tdgl.edge_subgraph(gt, edges, relabel_nodes=relabel)
        _same_graph(a, b)
        np.testing.assert_array_equal(b.ndata["x"].numpy(),
                                      np.asarray(a.ndata["x"]))
        if relabel:
            np.testing.assert_array_equal(b.ndata["_ID"].numpy(),
                                          np.asarray(a.ndata["_ID"]))


def test_typed_subgraphs_match_reference():
    gj, gt, et, counts = _typed(False)
    ra = jdgl.typed_subgraphs(gj, et, R)
    rb = tdgl.typed_subgraphs(gt, t(et), R)
    assert len(rb) == R
    for a, b, c in zip(ra, rb, counts):
        _same_graph(a, b)
        assert b.num_edges() == c and b.num_nodes() == N
    # identity=True: at the default hub floors the relabeled parent has no
    # hub layout here, so both packages warn and keep the plain subgraphs
    # with the identity perm (test_torch_hetero.py holds the identity
    # layouts themselves).
    with pytest.warns(UserWarning, match="no identity hub layout"):
        ra, pa = jdgl.typed_subgraphs(gj, et, R, identity=True)
    with pytest.warns(UserWarning, match="no identity hub layout"):
        rb, pb = tdgl.typed_subgraphs(gt, t(et), R, identity=True)
    np.testing.assert_array_equal(pb, pa)
    for a, b in zip(ra, rb):
        _same_graph(a, b)


def test_typed_powerlaw_graph_and_sorted_copy():
    """The ids of tools/bench_models.py (default_rng(0) per edge) and the
    relation-sorted copy of examples/train_rgcn.py."""
    g, et = tdgl.data.typed_powerlaw_graph(2000, 4, R, seed=0, device="cpu")
    gj = jdgl.data.synthetic.powerlaw_graph(2000, 4, seed=0)
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(gj.src))
    np.testing.assert_array_equal(
        et, np.random.default_rng(0).integers(0, R, size=g.num_edges()))
    g2, et2, counts = tdgl.data.sort_by_relation(g, et, R)
    order = np.argsort(et, kind="stable")
    np.testing.assert_array_equal(g2.src.numpy(), g.src.numpy()[order])
    np.testing.assert_array_equal(g2.dst.numpy(), g.dst.numpy()[order])
    np.testing.assert_array_equal(et2, et[order])
    np.testing.assert_array_equal(counts, np.bincount(et, minlength=R))


# ----------------------------------------------------------------------
# RelGraphConv
# ----------------------------------------------------------------------

def _path_args(path, gj, gt, et, counts):
    """(reference kwargs, port kwargs) of one RelGraphConv path."""
    if path == "rel":
        return (dict(rel_graphs=jdgl.typed_subgraphs(gj, et, R)),
                dict(rel_graphs=tdgl.typed_subgraphs(gt, et, R)))
    if path == "presorted":
        return (dict(etypes=jnp.asarray(et), presorted=True,
                     etype_counts=jnp.asarray(counts)),
                dict(etypes=t(et), presorted=True, etype_counts=t(counts)))
    return dict(etypes=jnp.asarray(et)), dict(etypes=t(et))


# (path, regularizer, self_loop, norm, in, out)
_CONV_CASES = [
    ("presorted", None, True, None, 6, 5),
    ("presorted", "basis", False, "edge", 4, 7),
    ("gather", None, True, "edge", 6, 5),
    ("gather", "basis", True, None, 4, 7),
    ("rel", None, False, "dst", 6, 5),
    ("rel", "basis", True, None, 4, 7),
]


@pytest.mark.parametrize("path,reg,self_loop,norm,in_f,out_f", _CONV_CASES)
def test_relgraphconv_matches_reference(path, reg, self_loop, norm, in_f,
                                        out_f):
    """Values and the grads of the input and every parameter, on the hub
    engine (the per-edge paths end in a hub copy_e)."""
    gj, gt, et, counts = _typed(path == "presorted")
    x = feats(N, in_f, seed=5)
    coef = feats(N, out_f, seed=6)
    nrm = None
    if norm == "edge":
        nrm = feats(gt.num_edges(), 1, seed=7)
    elif norm == "dst":
        nrm = feats(N, 1, seed=7)
    jkw, tkw = _path_args(path, gj, gt, et, counts)
    nb = 2 if reg == "basis" else 0
    jconv = JRelGraphConv(in_f, out_f, R, regularizer=reg, num_bases=nb,
                          self_loop=self_loop, activation=jax.nn.relu)
    jnorm = None if nrm is None else jnp.asarray(nrm)
    with engines("hub", "hub"):
        params = jconv.init(jax.random.PRNGKey(0), gj, jnp.asarray(x),
                            norm=jnorm, **jkw)

        def jloss(p, xx):
            return jnp.sum(jconv.apply(p, gj, xx, norm=jnorm, **jkw) * coef)

        want = jconv.apply(params, gj, jnp.asarray(x), norm=jnorm, **jkw)
        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
        conv = RelGraphConv(in_f, out_f, R, regularizer=reg, num_bases=nb,
                            self_loop=self_loop, activation=torch.relu,
                            device="cpu")
        conv.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                          params)))
        xt = t(x).requires_grad_(True)
        got = conv(gt, xt, norm=None if nrm is None else t(nrm), **tkw)
        (got * t(coef)).sum().backward()
    _close(got.detach(), want)
    _close(xt.grad, jgx)
    pg = from_jax_params(jax.tree.map(np.asarray, jgp))
    assert set(pg) == {k for k, _ in conv.named_parameters()}
    for k, p in conv.named_parameters():
        _close(p.grad, pg[k], k)


def _union(relabel):
    """The typed graph's union block in both packages, hub=True so the
    stacked source space (R*N) has hub groups."""
    gj, gt, et, _ = _typed(False)
    uj, pj = jdgl.typed_union_graph(gj, et, R, hub=True, relabel=relabel)
    ut, pt = tdgl.typed_union_graph(gt, t(et), R, hub=True, relabel=relabel)
    np.testing.assert_array_equal(pt, pj)
    assert ut.hub_dst_meta is not None
    return gj, gt, et, uj, ut, pt


@pytest.mark.parametrize("reg,relabel,norm", [(None, True, "dst"),
                                              ("basis", False, None)])
def test_relgraphconv_union_matches_reference(reg, relabel, norm):
    """RelGraphConv(union_graph=) against the reference's on its node
    order (values, the input's and every parameter's grads, the hub
    engine), and against the port's rel_graphs path with the same
    parameters through ``perm``."""
    gj, gt, et, uj, ut, perm = _union(relabel)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    x = feats(N, 4, seed=5)[perm]
    coef = feats(N, 7, seed=6)
    nrm = None if norm is None else feats(N, 1, seed=7)
    nb = 2 if reg == "basis" else 0
    jconv = JRelGraphConv(4, 7, R, regularizer=reg, num_bases=nb,
                          activation=jax.nn.relu)
    jn = None if nrm is None else jnp.asarray(nrm)
    with engines("hub", "hub"):
        params = jconv.init(jax.random.PRNGKey(0), gj, jnp.asarray(x),
                            norm=jn, union_graph=uj)
        want = jconv.apply(params, gj, jnp.asarray(x), norm=jn,
                           union_graph=uj)
        jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jconv.apply(
            p, gj, xx, norm=jn, union_graph=uj) * coef), argnums=(0, 1))(
                params, jnp.asarray(x))
        conv = RelGraphConv(4, 7, R, regularizer=reg, num_bases=nb,
                            activation=torch.relu, device="cpu")
        conv.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                          params)))
        xt = t(x).requires_grad_(True)
        tn = None if nrm is None else t(nrm)
        got = conv(gt, xt, norm=tn, union_graph=ut)
        (got * t(coef)).sum().backward()
        # The per-relation path on the original ids, through perm.
        rel = tdgl.typed_subgraphs(gt, et, R)
        per_rel = conv(gt, t(x[inv]), norm=None if nrm is None
                       else t(nrm[inv]), rel_graphs=rel)
    _close(got.detach(), want)
    _close(xt.grad, jgx)
    pg = from_jax_params(jax.tree.map(np.asarray, jgp))
    for k, p in conv.named_parameters():
        _close(p.grad, pg[k], k)
    _close(per_rel.detach().numpy()[perm], got.detach().numpy())


def test_rgcn_union_graph_matches_rel_graphs():
    """RGCN(union_graph=) reproduces the rel_graphs path with the same
    parameters (tests/test_hub.py's check, without the relabel), in both
    packages."""
    gj, gt, et, uj, ut, _ = _union(False)
    x = feats(N, 6, seed=8)
    jmodel = JRGCN(num_nodes=N, hidden_feats=8, out_feats=3, num_rels=R,
                   num_bases=2)
    jrel = jdgl.typed_subgraphs(gj, et, R)
    with engines("hub", "hub"):
        params = jmodel.init(jax.random.PRNGKey(0), gj, None,
                             jnp.asarray(x), rel_graphs=jrel)
        want = jmodel.apply(params, gj, None, jnp.asarray(x),
                            union_graph=uj)
        model = RGCN(N, 8, 3, R, num_bases=2, in_feats=6, device="cpu")
        model.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                           params)))
        got = model(gt, None, t(x), union_graph=ut)
        per_rel = model(gt, None, t(x),
                        rel_graphs=tdgl.typed_subgraphs(gt, et, R))
    _close(got.detach(), want)
    _close(got.detach(), per_rel.detach())


def test_relgraphconv_errors():
    _, gt, et, _ = _typed(True)
    conv = RelGraphConv(3, 2, R, device="cpu")
    x = torch.ones((N, 3))
    with pytest.raises(ValueError, match="etype_counts"):
        conv(gt, x, t(et), presorted=True)
    # The union path: the typed graph's own union block gives the
    # per-relation path's output (in float64: the two float32 orders of
    # summation differ by rounding where terms cancel, whatever the
    # weights); a block of the wrong source count raises.
    ut, _ = tdgl.typed_union_graph(gt, et, R, hub=True, relabel=False)
    conv64, x64 = copy.deepcopy(conv).double(), x.double()
    _close(conv64(gt, x64, union_graph=ut).detach(),
           conv64(gt, x64,
                  rel_graphs=tdgl.typed_subgraphs(gt, et, R)).detach())
    with pytest.raises(ValueError, match="union_graph has"):
        conv(gt, x, union_graph=gt)
    with pytest.raises(ValueError, match="regularizer"):
        RelGraphConv(3, 2, R, regularizer="bdd", device="cpu")


def test_relgraphconv_dropout_uses_the_given_generator():
    _, gt, et, _ = _typed(False)
    conv = RelGraphConv(3, 4, R, dropout=0.5, device="cpu")
    x = t(feats(N, 3))
    outs = [conv(gt, x, t(et), generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    conv.eval()
    assert torch.equal(conv(gt, x, t(et)), conv(gt, x, t(et)))


# ----------------------------------------------------------------------
# RGCN
# ----------------------------------------------------------------------

def _rgcn(path, featureless, num_bases):
    gj, gt, et, counts = _typed(path == "presorted")
    jkw, tkw = _path_args(path, gj, gt, et, counts)
    x = None if featureless else feats(N, 6, seed=8)
    labels = np.random.default_rng(9).integers(0, 3, N).astype(np.int32)
    jmodel = JRGCN(num_nodes=N, hidden_feats=8, out_feats=3, num_rels=R,
                   num_bases=num_bases)
    jet = jkw.pop("etypes", None)
    tet = tkw.pop("etypes", None)
    xj = None if x is None else jnp.asarray(x)
    with engines("hub", "hub"):
        params = jmodel.init(jax.random.PRNGKey(0), gj, jet, xj, **jkw)
    params = jax.tree.map(np.asarray, params)
    model = RGCN(N, 8, 3, R, num_bases=num_bases,
                 in_feats=None if featureless else 6, device="cpu")
    model.load_state_dict(from_jax_params(params))

    def jloss(p):
        logits = jmodel.apply(p, gj, jet, xj, **jkw)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    return (jmodel, params, jloss, jet, xj, jkw), (model, gt, tet, x, tkw), \
        labels


@pytest.mark.parametrize("path,featureless,num_bases", [
    ("rel", False, 2), ("presorted", False, 0), ("presorted", True, 2),
    ("gather", True, 0)])
def test_rgcn_logits_and_grads_match_reference(path, featureless,
                                               num_bases):
    (jmodel, params, jloss, jet, xj, jkw), (model, gt, tet, x, tkw), \
        labels = _rgcn(path, featureless, num_bases)
    gj = _typed(path == "presorted")[0]
    with engines("hub", "hub"):
        want = jmodel.apply(params, gj, jet, xj, **jkw)
        jg = jax.grad(jloss)(params)
        logits = model(gt, tet, None if x is None else t(x), **tkw)
        torch.nn.functional.cross_entropy(logits,
                                          t(labels).long()).backward()
    _close(logits.detach(), want)
    pg = from_jax_params(jax.tree.map(np.asarray, jg))
    names = {k for k, _ in model.named_parameters()}
    assert set(pg) == names and ("embed" in names) == featureless
    for k, p in model.named_parameters():
        _close(p.grad, pg[k], k)


@pytest.mark.parametrize("path", ["rel", "presorted"])
def test_rgcn_adam_steps_match_reference(path):
    (jmodel, params, jloss, jet, xj, jkw), (model, gt, tet, x, tkw), \
        labels = _rgcn(path, False, 2)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jlosses = []
    with engines("hub", "hub"):
        for _ in range(3):
            val, grads = jax.value_and_grad(jloss)(params)
            updates, state = opt.update(grads, state)
            params = optax.apply_updates(params, updates)
            jlosses.append(float(val))
        res = tdgl.train(gt, t(x), t(labels), model, steps=3, lr=1e-2,
                         etypes=tet, **tkw)
    np.testing.assert_allclose(res["losses"], jlosses, **TOL)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)

