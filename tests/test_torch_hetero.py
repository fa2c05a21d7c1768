"""Typed graphs and heterographs in the port against the JAX package, on
the CPU: ``block``, the identity typed layouts
(``build_hub_format(identity_force=)``, ``typed_subgraphs(identity=True)``)
and the union block (``typed_union_graph``) with their copy_lhs sums
through the hub engine, ``edge_subgraph(pad_edges_to=, formats=)``, the
heterograph facade and its transforms, ``HeteroGraphConv`` with every
aggregate, the typed linears, ``HAN`` and ``synthetic_mag_heterograph``.

The hub engine is forced by name in both packages (the reference's Pallas
kernels in interpret mode). Tolerances: layouts, edges and generated data
equal exactly; aggregations within 1e-6 of the float64 sum over absolute
values (as the hub kernel tests hold them); logits and grads rtol 1e-4,
atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import hub_format as jhf
from dgl1_tpu import nn as jnn
from dgl1_tpu.graph import _build_ell as j_build_ell
from dgl1_tpu.heterograph import HeteroGraph as JHeteroGraph
from dgl1_tpu.models import HAN as JHAN
from dgl1_tpu.nn.linear import (HeteroEmbedding as JHeteroEmbedding,
                                HeteroLinear as JHeteroLinear,
                                TypedLinear as JTypedLinear)
from dgl1_tpu_torch import hub_format as thf
from dgl1_tpu_torch import nn as tnn
from dgl1_tpu_torch.graph import _build_ell as t_build_ell, _tree_to
from dgl1_tpu_torch.heterograph import HeteroGraph
from dgl1_tpu_torch.models import HAN
from dgl1_tpu_torch.params import from_jax_params

from test_torch_layout import _assert_graphs_equal, _assert_tree_equal
from torch_parity import engines, feats, make, powerlaw_edges, t

TOL = dict(rtol=1e-4, atol=1e-5)
REL = 1e-6
KEY = jax.random.PRNGKey(0)


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=msg,
                               **TOL)


def _within_abs_sum(got, want64, abs64, what):
    err = np.abs(np.asarray(got, np.float64) - want64)
    assert (err <= REL * abs64 + 1e-30).all(), (
        f"{what}: past {REL} of the abs sum; max err {err.max()}")


def _oracle64(src, dst, n_src, n_dst, x, w):
    """float64 copy_lhs sum, its grad for the cotangent w, and both over
    absolute values."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    out, out_abs = np.zeros((n_dst, x.shape[1])), np.zeros((n_dst,
                                                            x.shape[1]))
    np.add.at(out, dst, x64[src])
    np.add.at(out_abs, dst, np.abs(x64[src]))
    gx, gx_abs = np.zeros((n_src, x.shape[1])), np.zeros((n_src,
                                                          x.shape[1]))
    np.add.at(gx, src, w64[dst])
    np.add.at(gx_abs, src, np.abs(w64[dst]))
    return out, out_abs, gx, gx_abs


def _copy_lhs_both(gj, gt, x, w):
    """(out, grad) of the copy_lhs sum through each package's hub engine."""
    def f(a):
        return jdgl.ops.gspmm(gj, "copy_lhs", "sum", a, None)

    xt = t(x).requires_grad_(True)
    with engines("hub", "hub"):
        ref = (np.asarray(f(jnp.asarray(x))),
               np.asarray(jax.grad(lambda a: (f(a) * jnp.asarray(w)).sum())(
                   jnp.asarray(x))))
        out = tdgl.ops.gspmm(gt, "copy_lhs", "sum", xt, None)
        (out * t(w)).sum().backward()
    return ref, (out.detach().numpy(), xt.grad.numpy())


def _check_copy_lhs(gj, gt, x, w, what):
    e = gt.num_edges()
    src, dst = gt.src[:e].numpy(), gt.dst[:e].numpy()
    out, out_abs, gx, gx_abs = _oracle64(src, dst, gt.num_src_nodes(),
                                         gt.num_dst_nodes(), x, w)
    ref, port = _copy_lhs_both(gj, gt, x, w)
    for pkg, (o, g) in (("reference", ref), ("port", port)):
        _within_abs_sum(o, out, out_abs, f"{what} {pkg} fwd")
        _within_abs_sum(g, gx, gx_abs, f"{what} {pkg} grad")


# ----------------------------------------------------------------------
# block and edge_subgraph
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hub,pad", [(False, None), (True, 9000)])
def test_block_matches_reference(hub, pad):
    """A bipartite block (400 sources, 300 destinations), with the hub
    layout its skewed in-degrees earn, and padded edges."""
    rng = np.random.default_rng(2)
    e = 8000 if hub else 900
    src = rng.integers(0, 400, e)
    dst = (rng.zipf(1.5, e) % 300) if hub else rng.integers(0, 300, e)
    gj = jdgl.block((src, dst), 400, 300, pad_edges_to=pad)
    gt = tdgl.block((src, dst), 400, 300, pad_edges_to=pad, device="cpu")
    assert gt.is_block and gt.num_src_nodes() == 400
    assert gt.num_dst_nodes() == 300 and gt.num_edges() == e
    assert (gt.hub_dst_meta is not None) == hub
    _assert_graphs_equal(gj, gt)
    _assert_tree_equal(gj.tdst, gt.tdst, "tdst")
    _assert_tree_equal(gj.tsrc, gt.tsrc, "tsrc")
    if pad:
        assert gt.num_edges_padded() == pad
        np.testing.assert_array_equal(gt.edge_mask.numpy(),
                                      np.asarray(gj.edge_mask))
    np.testing.assert_array_equal(gt.out_degrees().numpy(),
                                  np.asarray(gj.out_degrees()))
    assert tdgl.create_block is tdgl.block
    # The static-shape sampled mode: a uniform ELL as wide as the largest
    # in-degree, both tile directions padded to the static tile bound.
    k = int(np.bincount(dst, minlength=300).max())
    uj = jdgl.block((src, dst), 400, 300, pad_edges_to=pad, uniform_ell_k=k)
    ut = tdgl.block((src, dst), 400, 300, pad_edges_to=pad, uniform_ell_k=k,
                    device="cpu")
    assert ut.meta["num_real_edges"] == uj.meta["num_real_edges"] == e
    assert ut.ell_dst_meta == uj.ell_dst_meta and ut.ell_src is None
    for name in ("src", "dst", "csr_indptr", "csr_dst", "csr_eid",
                 "csc_indptr", "csc_src", "csc_eid", "csc_dst"):
        _assert_tree_equal(getattr(uj, name), getattr(ut, name), name)
    for name in ("ell_dst", "tdst", "tsrc"):
        _assert_tree_equal(getattr(uj, name), getattr(ut, name), name)


@pytest.mark.parametrize("relabel", [True, False])
def test_edge_subgraph_pads_and_formats_match_reference(relabel):
    src, dst = powerlaw_edges(500, 6, seed=3)
    gj = jdgl.graph((src, dst), num_nodes=500)
    gt = tdgl.graph((src, dst), num_nodes=500, device="cpu")
    w = feats(len(src), 3, seed=4)
    gj.edata["w"] = jnp.asarray(w)
    gt.edata["w"] = t(w)
    edges = np.random.default_rng(5).choice(len(src), 700, replace=False)
    fmt = ("coo", "csr", "csc", "ell")
    a = jdgl.edge_subgraph(gj, edges, relabel_nodes=relabel,
                           pad_edges_to=1024, formats=fmt)
    b = tdgl.edge_subgraph(gt, edges, relabel_nodes=relabel,
                           pad_edges_to=1024, formats=fmt)
    assert b.num_edges() == 700 and b.num_edges_padded() == 1024
    assert b.hub_dst is None and b.tdst is None
    _assert_graphs_equal(a, b)
    np.testing.assert_array_equal(b.edata["w"].numpy(),
                                  np.asarray(a.edata["w"]))
    np.testing.assert_array_equal(b.edata["_ID"].numpy(),
                                  np.asarray(a.edata["_ID"]))
    np.testing.assert_array_equal(b.edge_mask.numpy(),
                                  np.asarray(a.edge_mask))


# ----------------------------------------------------------------------
# The identity typed layouts and the union block
# ----------------------------------------------------------------------

def _identity_parent():
    """The powerlaw graph of tests/test_hub.py's identity test (4,000
    nodes, self-loops), 3 relations from default_rng(0)."""
    src, dst = powerlaw_edges(4000, 8, seed=2)
    gj = jdgl.add_self_loop(jdgl.graph((src, dst), num_nodes=4000))
    gt = tdgl.add_self_loop(tdgl.graph((src, dst), num_nodes=4000,
                                       device="cpu"))
    et = np.random.default_rng(0).integers(0, 3, gt.num_edges())
    return gj, gt, et


def test_typed_subgraphs_identity_layouts_match_reference(monkeypatch):
    """Every array and meta of every relation equal, every relation
    claims identity_expand, the same perm; then with the tail buckets
    merged down to one (DGL1_TPU_TYPED_TAIL_BUCKETS)."""
    gj, gt, et = _identity_parent()
    for buckets in (None, "1"):
        if buckets:
            monkeypatch.setenv("DGL1_TPU_TYPED_TAIL_BUCKETS", buckets)
        rj, pj = jdgl.typed_subgraphs(gj, et, 3, identity=True)
        rt, pt = tdgl.typed_subgraphs(gt, t(et), 3, identity=True)
        np.testing.assert_array_equal(pt, pj)
        assert len(rt) == 3
        for a, b in zip(rj, rt):
            assert b.hub_dst_meta.identity_expand
            _assert_graphs_equal(a, b)
        if buckets:
            assert len(rt[0].hub_dst_meta.tail_meta_dst) == 1


def test_typed_subgraphs_identity_sums_match_reference():
    """copy_lhs sum and its grad on every relation's identity layout
    (phantom hub slots and tail rows read zeros), both packages against
    float64."""
    gj, gt, et = _identity_parent()
    rj, _ = jdgl.typed_subgraphs(gj, et, 3, identity=True)
    rt, _ = tdgl.typed_subgraphs(gt, et, 3, identity=True)
    x, w = feats(4000, 5, seed=6, shift=1.0), feats(4000, 5, seed=7)
    for r, (a, b) in enumerate(zip(rj, rt)):
        _check_copy_lhs(a, b, x, w, f"relation {r}")


def test_typed_subgraphs_identity_falls_back_without_a_hub():
    src, dst = powerlaw_edges(300, 2, seed=1)
    gt = tdgl.graph((src, dst), num_nodes=300, hub=False, device="cpu")
    et = np.arange(len(src)) % 2
    with pytest.warns(UserWarning, match="no identity hub layout"):
        rel, perm = tdgl.typed_subgraphs(gt, et, 2, identity=True)
    np.testing.assert_array_equal(perm, np.arange(300))
    assert [r.num_edges() for r in rel] == [int((et == k).sum())
                                            for k in (0, 1)]


def test_identity_force_mixed_tiers_match_reference():
    """build_hub_format(identity_force=) straight on a relation of a
    parent with a dense and chunked groups (the mixed floors, hub-first
    relabeled): equal arrays, identity_expand, the sum through the hub
    engine; a tail edge past the pinned range raises."""
    gj, gt = make("mixed", relabel=True)
    m = gt.hub_dst_meta
    assert m.identity_expand and m.n_groups > m.n_dense > 0
    ident = {"n_groups": m.n_groups, "n_dense": m.n_dense,
             "tail_meta_dst": m.tail_meta_dst}
    e, n = gt.num_edges(), gt.num_nodes()
    keep = np.random.default_rng(8).random(e) < 0.4
    s, d = gt.src.numpy()[keep], gt.dst.numpy()[keep]
    fmt = ("coo", "csr", "csc", "ell")
    rj = jdgl.graph((s, d), num_nodes=n, hub=False, formats=fmt)
    rt = tdgl.graph((s, d), num_nodes=n, hub=False, formats=fmt,
                    device="cpu")
    mj, aj = jhf.build_hub_format(
        *(np.asarray(getattr(rj, k)) for k in ("csc_indptr", "csc_src",
                                               "csc_eid", "csc_dst")),
        n, n, len(s), len(s), j_build_ell, identity_force=ident)
    mt, at = thf.build_hub_format(
        *(getattr(rt, k).numpy() for k in ("csc_indptr", "csc_src",
                                           "csc_eid", "csc_dst")),
        n, n, len(s), len(s), t_build_ell, identity_force=ident)
    assert mt == mj and mt.identity_expand
    assert mt.n_groups == m.n_groups and mt.n_dense == m.n_dense
    rj.hub_dst_meta, rj.hub_dst = mj, jax.tree.map(jnp.asarray, aj)
    rt.hub_dst_meta, rt.hub_dst = mt, _tree_to(at, "cpu")
    _assert_tree_equal(aj, rt.hub_dst, "hub_dst")
    _check_copy_lhs(rj, rt, feats(n, 4, seed=9, shift=1.0),
                    feats(n, 4, seed=10), "mixed relation")
    # A tail edge to a row past the pinned tail range.
    short = dict(ident, tail_meta_dst=((m.tail_meta_dst[0][0], 1),))
    with pytest.raises(ValueError, match="superset tail range"):
        thf.build_hub_format(
            *(getattr(rt, k).numpy() for k in ("csc_indptr", "csc_src",
                                               "csc_eid", "csc_dst")),
            n, n, len(s), len(s), t_build_ell, identity_force=short)


@pytest.mark.parametrize("relabel", [True, False])
def test_typed_union_graph_matches_reference(relabel):
    """The relation-stacked block of tests/test_hub.py's union test
    (2,000 nodes, 5 relations, hub=True): layout and perm equal,
    identity_expand after the relabel, the copy_lhs sum over the (R*N, F)
    stack against float64."""
    src, dst = powerlaw_edges(2000, 8, seed=2)
    gj = jdgl.graph((src, dst), num_nodes=2000, hub=True)
    gt = tdgl.graph((src, dst), num_nodes=2000, hub=True, device="cpu")
    et = np.random.default_rng(0).integers(0, 5, len(src))
    uj, pj = jdgl.typed_union_graph(gj, et, 5, hub=True, relabel=relabel)
    ut, pt = tdgl.typed_union_graph(gt, t(et), 5, hub=True,
                                    relabel=relabel)
    np.testing.assert_array_equal(pt, pj)
    assert ut.is_block and ut.num_src_nodes() == 10000
    assert ut.num_dst_nodes() == 2000
    assert ut.hub_dst_meta.identity_expand == relabel
    _assert_graphs_equal(uj, ut)
    _check_copy_lhs(uj, ut, feats(10000, 4, seed=3, shift=1.0),
                    feats(2000, 4, seed=4), "union")


# ----------------------------------------------------------------------
# The heterograph layer
# ----------------------------------------------------------------------

_SMALL = {
    ("user", "follows", "user"): (np.array([0, 1, 2, 2]),
                                  np.array([1, 2, 0, 1])),
    ("user", "plays", "game"): (np.array([0, 2, 2]), np.array([0, 1, 0])),
    ("game", "played_by", "user"): (np.array([0, 1, 0]),
                                    np.array([0, 2, 2])),
}


def _small(device="cpu"):
    return (jdgl.heterograph(_SMALL),
            tdgl.heterograph(_SMALL, device=device))


def test_heterograph_matches_reference():
    hj, ht = _small()
    assert ht.ntypes == hj.ntypes and ht.etypes == hj.etypes
    assert ht.canonical_etypes == hj.canonical_etypes
    for c in hj.canonical_etypes:
        _assert_graphs_equal(hj.rel_graphs[c], ht.rel_graphs[c])
        assert ht[c].is_block
    assert ht.num_nodes() == hj.num_nodes() and ht.num_edges() == 10
    assert ht.num_nodes("game") == 2 and ht.num_edges("plays") == 3
    assert ht.to_canonical_etype("plays") == ("user", "plays", "game")
    assert ht.get_ntype_id("user") == hj.get_ntype_id("user")
    assert ht.get_etype_id("plays") == hj.get_etype_id("plays")
    assert ht.srctypes == hj.srctypes and ht.dsttypes == hj.dsttypes
    np.testing.assert_array_equal(
        ht.in_degrees(etype="follows").numpy(),
        np.asarray(hj.in_degrees(etype="follows")))
    assert int(ht.out_degrees(2, etype="follows")) == 2
    np.testing.assert_array_equal(ht.has_nodes([0, 2, 3], "game"),
                                  [True, False, False])
    with pytest.raises(KeyError, match="unknown"):
        ht.to_canonical_etype("likes")
    mg = ht.metagraph()
    assert set(mg.nodes) == {"user", "game"} and mg.has_edge("user", "game")


def test_heterograph_frames_and_facade():
    _, ht = _small()
    ht.nodes["user"].data["h"] = torch.ones(3, 2)
    ht.ndata["x"] = {"game": torch.zeros(2, 1)}
    assert set(ht.ndata["x"]) == {"game"} and "h" in ht.ndata
    ht.apply_nodes(lambda nb: {"h2": nb.data["h"] * 2}, ntype="user")
    assert torch.equal(ht.nodes["user"].data["h2"], torch.full((3, 2), 2.))
    with ht.local_scope():
        ht.nodes["user"].data["tmp"] = torch.zeros(3, 1)
        ht.edges["plays"].data["e"] = torch.ones(3)
    assert "tmp" not in ht.nodes["user"].data
    assert "e" not in ht.edges["plays"].data
    assert ht.node_attr_schemes("user")["h"][0] == (2,)
    sub = tdgl.node_type_subgraph(ht, ["user"])
    assert sub.canonical_etypes == [("user", "follows", "user")]
    assert torch.equal(sub.ndata["h"], ht.nodes["user"].data["h"])
    sub = tdgl.edge_type_subgraph(ht, ["plays"])
    assert sub.ntypes == ["game", "user"] and sub.num_edges() == 3
    with pytest.raises(KeyError):
        tdgl.node_type_subgraph(ht, ["item"])
    moved = ht.to("cpu")
    assert moved.device.type == "cpu" and "h" in moved.nodes["user"].data
    clone = ht.clone()
    clone.nodes["user"].data["only_clone"] = torch.ones(3)
    assert "only_clone" not in ht.nodes["user"].data
    # The message-passing front end (test_torch_core.py holds it against
    # the reference).
    from dgl1_tpu_torch import function as fn

    assert ht.multi_update_all({}) == {}
    out = ht.update_all(fn.copy_u("h", "m"), fn.sum("m", "agg"),
                        etype="follows")
    assert out[("user", "agg")].shape == (3, 2)
    ht.nodes["game"].data["g"] = torch.ones(2, 2)
    assert ht.apply_edges(fn.u_dot_v("h", "g", "d"),
                          etype="plays").shape == (3, 1)


def test_to_homogeneous_round_trip_matches_reference():
    hj, ht = _small()
    gj = jdgl.transform.to_homogeneous(hj)
    gt = tdgl.to_homogeneous(ht)
    assert gt.num_nodes() == 5 and gt.num_edges() == 10
    for k in ("src", "dst"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k)))
    for frame in ("ndata", "edata"):
        for k in ("_TYPE", "_ID"):
            a = getattr(gt, frame)[k]
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(getattr(gj, frame)[k]))
    back_j = jdgl.transform.to_heterogeneous(gj, hj.ntypes, hj.etypes)
    back_t = tdgl.to_heterogeneous(gt, ht.ntypes, ht.etypes)
    assert back_t.canonical_etypes == back_j.canonical_etypes
    assert back_t.canonical_etypes == ht.canonical_etypes
    for c in ht.canonical_etypes:
        _assert_graphs_equal(back_j.rel_graphs[c], back_t.rel_graphs[c])
        for k in ("src", "dst"):
            np.testing.assert_array_equal(getattr(back_t[c], k).numpy(),
                                          getattr(ht[c], k).numpy())


def test_metapath_reachable_graph_matches_reference():
    """A same-type metapath (graph, with the type's frame) and a
    cross-type one (block)."""
    hj, ht = _small()
    x = feats(3, 2)
    hj.nodes_data("user")["x"] = jnp.asarray(x)
    ht.nodes["user"].data["x"] = t(x)
    for path in (["plays", "played_by"], ["follows", "plays"]):
        a = jdgl.metapath_reachable_graph(hj, path)
        b = tdgl.metapath_reachable_graph(ht, path)
        assert b.is_block == a.is_block
        _assert_graphs_equal(a, b)
        side = b.srcdata if b.is_block else b.ndata
        assert torch.equal(side["x"], t(x))
    with pytest.raises(ValueError, match="breaks"):
        tdgl.metapath_reachable_graph(ht, ["plays", "follows"])


def test_metapath_keeps_pairs_of_256_paths():
    """A pair reached through 256 middle nodes: the reference's int8 path
    counts wrap to 0 and drop it (ROADMAP queue 3); the port keeps it."""
    data = {("a", "ab", "b"): (np.zeros(256, np.int64), np.arange(256)),
            ("b", "ba", "a"): (np.arange(256), np.zeros(256, np.int64))}
    got = tdgl.metapath_reachable_graph(
        tdgl.heterograph(data, device="cpu"), ["ab", "ba"])
    assert got.num_edges() == 1
    assert (int(got.src[0]), int(got.dst[0])) == (0, 0)
    assert jdgl.metapath_reachable_graph(jdgl.heterograph(data),
                                         ["ab", "ba"]).num_edges() == 0


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------

def _param_grads(jparams, jgrads, module):
    """Port grads against the reference's, by name; a port parameter the
    reference has not made gets none."""
    pg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(pg) <= {k for k, _ in module.named_parameters()}
    for k, p in module.named_parameters():
        if k in pg:
            _close(p.grad, pg[k], k)
        else:
            assert k.startswith("fc_c.") and p.grad is None, k


def _hetero_block():
    """A hetero block: per type more source than destination nodes."""
    rng = np.random.default_rng(11)
    n_src, n_dst = {"user": 9, "game": 6}, {"user": 5, "game": 4}
    rels_j, rels_t = {}, {}
    for c in _SMALL:
        st, _, dt = c
        s = rng.integers(0, n_src[st], 20)
        d = rng.integers(0, n_dst[dt], 20)
        rels_j[c] = jdgl.block((s, d), n_src[st], n_dst[dt])
        rels_t[c] = tdgl.block((s, d), n_src[st], n_dst[dt], device="cpu")
    return (JHeteroGraph(rels_j, n_dst, num_src_nodes_dict=n_src),
            HeteroGraph(rels_t, n_dst, num_src_nodes_dict=n_src), n_src)


@pytest.mark.parametrize("aggregate", ["sum", "mean", "max", "min",
                                       "stack"])
@pytest.mark.parametrize("on_block", [False, True])
def test_hetero_graph_conv_matches_reference(aggregate, on_block):
    """GraphConv per relation (norm 'right', 'both' and 'left', so both
    degree sides of a bipartite relation count); values and the grads of
    the inputs and every parameter."""
    if on_block:
        hj, ht, counts = _hetero_block()
    else:
        (hj, ht), counts = _small(), {"user": 3, "game": 2}
    norms = {"follows": "right", "plays": "both", "played_by": "left"}
    xs = {nt: feats(n, 5, seed=i) for i, (nt, n) in
          enumerate(sorted(counts.items()))}
    jconv = jnn.HeteroGraphConv(
        {et: jnn.GraphConv(4, norm=nm) for et, nm in norms.items()},
        aggregate=aggregate)
    jx = {k: jnp.asarray(v) for k, v in xs.items()}
    params = jconv.init(KEY, hj, jx)
    coef = {nt: feats(*o.shape[:1], 4, seed=20)[:, None, :]
            if aggregate == "stack" else feats(o.shape[0], 4, seed=20)
            for nt, o in jconv.apply(params, hj, jx).items()}

    def jloss(p, x):
        out = jconv.apply(p, hj, x)
        return sum(jnp.sum(out[k] * coef[k]) for k in out)

    want = jconv.apply(params, hj, jx)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jx)
    conv = tnn.HeteroGraphConv(
        {et: tnn.GraphConv(5, 4, norm=nm, device="cpu")
         for et, nm in norms.items()}, aggregate=aggregate)
    conv.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    tx = {k: t(v).requires_grad_(True) for k, v in xs.items()}
    got = conv(ht, tx)
    assert set(got) == set(want)
    sum((got[k] * t(coef[k])).sum() for k in got).backward()
    for k in want:
        _close(got[k].detach(), want[k], k)
    for k in xs:
        _close(tx[k].grad, jgx[k], k)
    _param_grads(params, jg, conv)


@pytest.mark.parametrize("reg,sort", [(None, False), (None, True),
                                      ("basis", False), ("basis", True)])
def test_typed_linear_matches_reference(reg, sort):
    rng = np.random.default_rng(12)
    x = feats(40, 6, seed=13)
    types = rng.integers(0, 3, 40).astype(np.int32)
    if sort:
        types = np.sort(types)
    w = feats(40, 5, seed=14)
    nb = 2 if reg == "basis" else 0
    jlin = JTypedLinear(6, 5, 3, regularizer=reg, num_bases=nb)
    params = jlin.init(KEY, jnp.asarray(x), jnp.asarray(types), sort)

    def jloss(p, xx):
        return jnp.sum(jlin.apply(p, xx, jnp.asarray(types), sort) * w)

    want = jlin.apply(params, jnp.asarray(x), jnp.asarray(types), sort)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    lin = tnn.TypedLinear(6, 5, 3, regularizer=reg, num_bases=nb,
                          device="cpu")
    lin.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    xt = t(x).requires_grad_(True)
    got = lin(xt, t(types), sorted_by_type=sort)
    (got * t(w)).sum().backward()
    _close(got.detach(), want)
    _close(xt.grad, jgx)
    _param_grads(params, jg, lin)


def test_hetero_linear_and_embedding_match_reference():
    xs = {"a": feats(4, 3, seed=1), "b": feats(5, 2, seed=2)}
    jlin = JHeteroLinear({"a": 3, "b": 2, "c": 7}, 6)
    jx = {k: jnp.asarray(v) for k, v in xs.items()}
    lp = jlin.init(KEY, jx)
    jemb = JHeteroEmbedding({"a": 4, "b": 5}, 3)
    ids = {"a": np.array([3, 0, 0]), "b": np.array([4, 1])}
    ep = jemb.init(KEY, {k: jnp.asarray(v) for k, v in ids.items()})

    def jloss(p, q, x):
        return (sum(jnp.sum(v ** 2) for v in jlin.apply(p, x).values())
                + sum(jnp.sum(jnp.sin(v)) for v in jemb.apply(q, {
                    k: jnp.asarray(v) for k, v in ids.items()}).values()))

    jgl, jge, jgx = jax.grad(jloss, argnums=(0, 1, 2))(lp, ep, jx)
    lin = tnn.HeteroLinear({"a": 3, "b": 2, "c": 7}, 6, device="cpu")
    emb = tnn.HeteroEmbedding({"a": 4, "b": 5}, 3, device="cpu")
    # flax makes a type's parameters only when its input is given.
    missing = lin.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, lp)), strict=False)
    assert set(missing.missing_keys) == {"fc_c.weight", "fc_c.bias"}
    emb.load_state_dict(from_jax_params(jax.tree.map(np.asarray, ep)))
    tx = {k: t(v).requires_grad_(True) for k, v in xs.items()}
    out_l = lin(tx)
    out_e = emb({k: torch.as_tensor(v) for k, v in ids.items()})
    assert set(out_l) == {"a", "b"} and set(out_e) == {"a", "b"}
    for k, v in jlin.apply(lp, jx).items():
        _close(out_l[k].detach(), v, k)
    for k, v in jemb.apply(ep, {k: jnp.asarray(v)
                                for k, v in ids.items()}).items():
        _close(out_e[k].detach(), v, k)
    (sum((v ** 2).sum() for v in out_l.values())
     + sum(torch.sin(v).sum() for v in out_e.values())).backward()
    for k in xs:
        _close(tx[k].grad, jgx[k], k)
    _param_grads(lp, jgl, lin)
    _param_grads(ep, jge, emb)
    assert torch.equal(emb.weights()["b"], emb.emb_b.weight)


def _acm_like(n_papers=80, n_authors=30, n_fields=10, seed=0):
    """A small ACM-shaped heterograph (examples/train_han.py) and its PAP
    and PFP metapath graphs in both packages."""
    rng = np.random.default_rng(seed)
    pa = (np.repeat(np.arange(n_papers), 2),
          rng.integers(0, n_authors, 2 * n_papers))
    pf = (np.arange(n_papers), rng.integers(0, n_fields, n_papers))
    data = {("paper", "pa", "author"): pa,
            ("author", "ap", "paper"): pa[::-1],
            ("paper", "pf", "field"): pf,
            ("field", "fp", "paper"): pf[::-1]}
    hj = jdgl.heterograph(data)
    ht = tdgl.heterograph(data, device="cpu")
    paths = (["pa", "ap"], ["pf", "fp"])
    return ([jdgl.metapath_reachable_graph(hj, p) for p in paths],
            [tdgl.metapath_reachable_graph(ht, p) for p in paths])


def test_han_logits_and_grads_match_reference():
    gjs, gts = _acm_like()
    for a, b in zip(gjs, gts):
        _assert_graphs_equal(a, b)
    x = feats(80, 12, seed=3)
    labels = np.random.default_rng(4).integers(0, 3, 80)
    jmodel = JHAN(num_metapaths=2, hidden_feats=4, out_feats=3,
                  num_heads=2, dropout=0.0)
    params = jmodel.init(KEY, gjs, jnp.asarray(x))

    def jloss(p, xx):
        logits = jmodel.apply(p, gjs, xx)
        return -jnp.mean(jax.nn.log_softmax(logits)[np.arange(80), labels])

    want = jmodel.apply(params, gjs, jnp.asarray(x))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    model = HAN(2, 12, 4, 3, num_heads=2, dropout=0.0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    xt = t(x).requires_grad_(True)
    logits = model(gts, xt)
    torch.nn.functional.cross_entropy(logits, torch.as_tensor(
        labels)).backward()
    _close(logits.detach(), want)
    _close(xt.grad, jgx)
    _param_grads(params, jg, model)


def test_han_dropout_uses_the_given_generator():
    _, gts = _acm_like()
    model = HAN(2, 12, 4, 3, num_heads=2, dropout=0.6, device="cpu",
                generator=torch.Generator().manual_seed(0))
    x = t(feats(80, 12, seed=3))
    outs = [model(gts, x, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    model.eval()
    assert torch.equal(model(gts, x), model(gts, x))
    with pytest.raises(ValueError, match="metapaths"):
        model(gts[:1], x)


def test_synthetic_mag_heterograph_matches_reference():
    hj, sj = jdgl.data.synthetic.synthetic_mag_heterograph(scale=400)
    ht, st = tdgl.data.synthetic_mag_heterograph(scale=400, device="cpu")
    assert ht.canonical_etypes == hj.canonical_etypes
    for nt in hj.ntypes:
        assert ht.num_nodes(nt) == hj.num_nodes(nt)
    for c in hj.canonical_etypes:
        for k in ("src", "dst"):
            np.testing.assert_array_equal(getattr(ht[c], k).numpy(),
                                          np.asarray(getattr(hj[c], k)))
    for k in ("feat", "label"):
        a, b = ht.nodes["paper"].data[k], hj.nodes["paper"].data[k]
        assert a.dtype == {"feat": torch.float32, "label": torch.int32}[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(st[k], sj[k])
