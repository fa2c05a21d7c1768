"""The hub engine's weighted ops (u_mul_e and copy_e) in the port against
the JAX package, on the CPU.

* K2 in mul and rhs modes and K5: the plain versions (the wrappers on CPU
  tensors) against the reference's ``_chunk_call`` and ``_edge_grad_call``
  in interpret mode, on the same layouts; rtol 1e-4, atol 1e-5 in float32
  (sums in another order; the powerlaw graph's top hub row sums ~3,000
  terms).
* ``gspmm_hub`` mul and copy_rhs, sum and mean: values, grad_u and grad_e
  against the reference's ``gspmm_hub``, for a scalar weight, per-head
  weights (H=4, D=3), one weight per feature, self-loop diagonals, a
  hub-relabeled graph and padded edges; each within 1e-4 of the same
  computation over absolute values plus 1e-5 (hub rows sum up to ~2,000
  terms in another order than the reference).
* ``Graph.reverse``, ``graph(pad_edges_to=)``, ``GraphConv(edge_weight=)``
  and ``EdgeWeightNorm`` against the reference (rtol 1e-4, atol 1e-5),
  ``EdgeWeightedGCN`` (learnable edge logits) against the GCN it equals
  at zero logits, and the composed GAT chain on a hub graph against the
  fused attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.nn.conv import EdgeWeightNorm as JEdgeWeightNorm
from dgl1_tpu.nn.conv import GraphConv as JGraphConv
from dgl1_tpu.ops import engine_hub as ref_hub
from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.nn import EdgeWeightNorm, GraphConv
from dgl1_tpu_torch.ops import engine_hub as port_hub
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, make, skewed_edges, t

TOL = dict(rtol=1e-4, atol=1e-5)
F_PAD = 128


def _pad(x, rows, cols=F_PAD):
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _covered(out_id, n_out_blocks):
    blocks = np.unique(np.asarray(out_id))
    rows = (blocks[:, None] * BLK + np.arange(BLK)[None]).reshape(-1)
    return rows[rows < n_out_blocks * BLK]


# ----------------------------------------------------------------------
# K2 mul/rhs and K5: plain versions against the Pallas calls
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mixed", "chunked", "powerlaw"])
def layout_case(request):
    gj, _ = make(request.param, self_loops=request.param == "powerlaw")
    return gj


# (mode, he, rep)
_KERNEL_CASES = [("mul", 1, 10), ("mul", 4, 3), ("mul", 5, 1), ("rhs", 1, 1),
                 ("rhs", 4, 1)]


@pytest.mark.parametrize("mode,he,rep", _KERNEL_CASES)
def test_chunk_weighted_matches_reference(layout_case, mode, he, rep):
    g = layout_case
    hub, m = g.hub_dst, g.hub_dst_meta
    n, ne = g.num_nodes(), g.num_edges()
    e2 = feats(ne, he, seed=3)
    width = he * rep if mode == "mul" else he
    rows_pad = hub["dense_c"].shape[0]
    u = feats(n, width, seed=4)
    r = ref_hub._replication_r(mode, he, rep, F_PAD)
    for name, inp, n_out in (("full_fwd", _pad(u, rows_pad), m.n_groups),
                             ("full_bwd", _pad(feats(m.n_groups * BLK, width,
                                                     seed=5),
                                               m.n_groups * BLK), m.n_win)):
        if mode == "rhs" and name == "full_bwd":
            continue
        lay = {k: jnp.asarray(v) for k, v in hub[name].items()}
        wt = ref_hub._weights_t(jnp.asarray(e2), he, lay["eid"])
        want = np.asarray(ref_hub._chunk_call(
            mode, lay, wt, r, jnp.asarray(inp) if mode == "mul" else None,
            n_out, F_PAD))[:, :width]
        tlay = {k: t(v) for k, v in hub[name].items()}
        # The port's operands stop at the real rows and columns.
        got = K.chunk_weighted(
            mode, tlay, t(e2),
            t(inp[: (n if name == "full_fwd" else len(inp)), :width])
            if mode == "mul" else None, n_out, he, rep).numpy()
        rows = _covered(hub[name]["out_id"], n_out)
        np.testing.assert_allclose(got[rows], want[rows], **TOL)


@pytest.mark.parametrize("mode,he,rep", _KERNEL_CASES)
def test_edge_grad_matches_reference(layout_case, mode, he, rep):
    g = layout_case
    hub, m = g.hub_dst, g.hub_dst_meta
    n = g.num_nodes()
    width = he * rep if mode == "mul" else he
    u = feats(n, width, seed=6)
    ct = feats(m.n_groups * BLK, width, seed=7)
    lay = {k: jnp.asarray(v) for k, v in hub["full_fwd"].items()}
    r = ref_hub._replication_r(mode, he, rep, F_PAD)
    want = np.asarray(ref_hub._edge_grad_call(
        mode, lay, r, jnp.asarray(_pad(u, hub["dense_c"].shape[0])),
        jnp.asarray(_pad(ct, len(ct))), F_PAD))[:he].T
    tlay = {k: t(v) for k, v in hub["full_fwd"].items()}
    got = K.edge_grad(mode, tlay, t(u) if mode == "mul" else None, t(ct),
                      he, rep).numpy()
    assert got.shape == (len(hub["full_fwd"]["a"]), he)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[np.asarray(hub["full_fwd"]["a"]) < 0].any()


def test_weighted_wrappers_check_inputs_and_count_only_launches():
    _, gt = make("mixed")
    lay = gt.hub_dst["full_fwd"]
    m = gt.hub_dst_meta
    e2 = torch.ones((gt.num_edges(), 2))
    u = torch.ones((gt.num_nodes(), 6))
    K.reset_launches()
    assert K.chunk_weighted("mul", lay, e2, u, m.n_groups, 2, 3).shape == (
        m.n_groups * BLK, 6)
    assert K.edge_grad("rhs", lay, None, torch.ones((m.n_groups * BLK, 2)),
                       2, 1).shape == (lay["a"].shape[0], 2)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions ran
    assert {"chunk_mul", "chunk_rhs", "edge_grad_mul",
            "edge_grad_rhs"} <= set(K.KERNELS)
    with pytest.raises(ValueError, match="mode"):
        K.chunk_weighted("add", lay, e2, u, m.n_groups, 2, 3)
    with pytest.raises(ValueError, match="he \\* rep"):
        K.chunk_weighted("mul", lay, e2, u, m.n_groups, 2, 2)
    with pytest.raises(ValueError, match="no inp"):
        K.chunk_weighted("rhs", lay, e2, u, m.n_groups, 2, 1)
    with pytest.raises(TypeError):
        K.edge_grad("mul", lay, u.double(), torch.ones((m.n_groups * BLK, 6)),
                    2, 3)
    bad = dict(lay, eid=lay["eid"][:-1].contiguous())
    with pytest.raises(ValueError, match="slots"):
        K.chunk_weighted("rhs", bad, e2, None, m.n_groups, 2, 1)


# ----------------------------------------------------------------------
# gspmm_hub mul / copy_rhs against the reference
# ----------------------------------------------------------------------

# name -> (u feature shape or None, e feature shape, op)
_OPS = {
    "mul_scalar": ((6,), (1,), "mul"),
    "mul_heads": ((4, 3), (4, 1), "mul"),
    "mul_per_feature": ((5,), (5,), "mul"),
    "rhs_heads": (None, (4, 1), "copy_rhs"),
    "rhs_scalar": (None, (1,), "copy_rhs"),
}


def _graphs(case):
    if case == "padded":
        src, dst = skewed_edges()
        kw = dict(num_nodes=300, hub=300, hub_dense_floor=1000,
                  pad_edges_to=len(src) + 53)
        return jdgl.graph((src, dst), **kw), tdgl.graph((src, dst),
                                                        device="cpu", **kw)
    name, loops, relabel = {
        "chunked": ("chunked", False, False),
        "dense": ("dense", False, False),
        "mixed_loops": ("mixed", True, False),
        "powerlaw_loops": ("powerlaw", True, False),
        "powerlaw_relabel": ("powerlaw", False, True)}[case]
    return make(name, self_loops=loops, relabel=relabel)


def _inputs(gt, opname, seed=0):
    u_feat, e_feat, op = _OPS[opname]
    rng = np.random.default_rng(seed)
    u = (None if u_feat is None else
         rng.normal(size=(gt.num_nodes(),) + u_feat).astype(np.float32))
    e = rng.normal(size=(gt.num_edges_padded(),) + e_feat).astype(np.float32)
    out_feat = e_feat if u_feat is None else u_feat
    w = rng.normal(size=(gt.num_nodes(),) + out_feat).astype(np.float32)
    return op, u, e, w


def _reference(gj, op, red, u, e, w):
    def f(u_, e_):
        return ref_hub.gspmm_hub(gj, op, red, u_, e_)

    e_j = jnp.asarray(e)
    if u is None:
        out = f(None, e_j)
        ge = jax.grad(lambda e_: jnp.sum(f(None, e_) * w))(e_j)
        return [np.asarray(out), np.asarray(ge)]
    u_j = jnp.asarray(u)
    gu, ge = jax.grad(lambda u_, e_: jnp.sum(f(u_, e_) * w),
                      argnums=(0, 1))(u_j, e_j)
    return [np.asarray(f(u_j, e_j)), np.asarray(gu), np.asarray(ge)]


def _port(gt, op, red, u, e, w, engine=port_hub.gspmm_hub):
    ins = [t(x).requires_grad_(True) for x in (u, e) if x is not None]
    out = engine(gt, op, red, *([None] if u is None else []), *ins)
    grads = torch.autograd.grad((out * t(w)).sum(), ins)
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def _oracle(gt, op, red, u, e, w):
    from dgl1_tpu_torch.ops.engine_xla import gspmm_xla

    return _port(gt, op, red, u, e, w, engine=gspmm_xla)


def _assert_sums_close(got, want, scale):
    for i, (a, b, s) in enumerate(zip(got, want, scale)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.abs(a - b)
        tol = 1e-4 * s + 1e-5
        assert (err <= tol).all(), (i, float(err.max()))


_CASES = ["chunked", "dense", "mixed_loops", "powerlaw_loops",
          "powerlaw_relabel", "padded"]


@pytest.mark.parametrize("case,opname,red", [
    (c, o, "sum") for c in _CASES for o in _OPS] + [
    ("mixed_loops", o, "mean") for o in _OPS])
def test_hub_weighted_matches_reference(case, opname, red):
    gj, gt = _graphs(case)
    op, u, e, w = _inputs(gt, opname)
    got = _port(gt, op, red, u, e, w)
    want = _reference(gj, op, red, u, e, w)
    scale = _oracle(gt, op, red, *(None if x is None else np.abs(x)
                                   for x in (u, e, w)))
    _assert_sums_close(got, want, scale)
    if case == "mixed_loops":
        assert gt.hub_dst_meta.has_diag
    if case == "powerlaw_relabel":
        assert gt.hub_dst_meta.identity_expand
    if case == "padded":
        assert gt.edge_mask is not None and not gt.edge_mask[-53:].any()
        assert not got[-1][gt.num_edges():].any()  # grad_e of padded edges


def test_hub_weighted_kernel_sequence(monkeypatch):
    """u_mul_e runs K2 mul forward, K2 mul over full_bwd for grad_u and K5
    mul for grad_e; copy_e K2 rhs and K5 rhs; grads that are not asked
    for launch nothing."""
    calls = []
    for fn in ("chunk_weighted", "edge_grad", "dense_fwd", "chunk_sum"):
        orig = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0] if isinstance(a[0], str) else None)),
            _f(*a, **k))[1])
    _, gt = make("mixed")
    op, u, e, w = _inputs(gt, "mul_scalar")
    _port(gt, op, "sum", u, e, w)
    assert calls == [("chunk_weighted", "mul"), ("chunk_weighted", "mul"),
                     ("edge_grad", "mul")]
    calls.clear()
    ut = t(u)
    et = t(e).requires_grad_(True)
    (port_hub.gspmm_hub(gt, "mul", "sum", ut, et) * t(w)).sum().backward()
    assert calls == [("chunk_weighted", "mul"), ("edge_grad", "mul")]
    calls.clear()
    op, u, e, w = _inputs(gt, "rhs_heads")
    _port(gt, op, "sum", u, e, w)
    assert calls == [("chunk_weighted", "rhs"), ("edge_grad", "rhs")]


@pytest.mark.parametrize("op,grad_u,grad_e,kept", [
    ("copy_lhs", True, False, ()),
    ("copy_rhs", False, True, ()),
    ("mul", True, True, ("u", "e")),
    ("mul", False, True, ("u",)),   # grad_e of u_mul_e reads u only
    ("mul", True, False, ("e",)),   # grad_u reads e only
])
def test_hub_sum_keeps_only_what_its_backward_reads(op, grad_u, grad_e,
                                                    kept):
    """The autograd node of the hub sum holds u or e through backward only
    where a gradient that was asked for reads it, so copy_u and copy_e
    free their (E, F) inputs after the forward."""
    _, gt = make("mixed")
    n, ne = gt.num_nodes(), gt.num_edges()
    u = torch.randn(n, 6).requires_grad_(grad_u) if op != "copy_rhs" \
        else None
    e = torch.randn(ne, 1 if op == "mul" else 6).requires_grad_(grad_e) \
        if op != "copy_lhs" else None
    out = port_hub.gspmm_hub(gt, op, "sum", u, e)
    node = out.grad_fn
    assert type(node).__name__.startswith("_HubSum")
    saved = dict(zip(("u", "e"), node.saved_tensors or (None, None)))
    assert tuple(k for k, v in saved.items() if v is not None) == kept
    for k in kept:
        src = u if k == "u" else e
        assert saved[k].data_ptr() == src.data_ptr()  # a view, not a copy


def test_hub_declines_like_the_reference():
    gj, gt = make("mixed")
    n, ne = gt.num_nodes(), gt.num_edges()
    u, e_bad = np.ones((n, 10), np.float32), np.ones((ne, 7), np.float32)
    cases = [("mul", u, e_bad),                      # heads mismatch u
             ("mul", u, np.ones((ne, 1, 1, 1), np.float32)),  # too deep
             ("add", u, np.ones((ne, 10), np.float32)),
             ("copy_rhs", None, np.ones((ne, 3, 2), np.float32))]
    for op, uu, ee in cases:
        assert ref_hub.gspmm_hub(gj, op, "sum", None if uu is None
                                 else jnp.asarray(uu), jnp.asarray(ee)) \
            is None
        assert port_hub.gspmm_hub(gt, op, "sum", None if uu is None
                                  else t(uu), t(ee)) is None
    assert port_hub.gspmm_hub(gt, "mul", "max", t(u),
                              t(np.ones((ne, 1), np.float32))) is None
    assert port_hub.gspmm_hub(gt, "mul", "sum", t(u), torch.ones(
        (ne, 1), dtype=torch.int32)) is None


# ----------------------------------------------------------------------
# Graph.reverse and pad_edges_to
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 41])
def test_reverse_and_padding_match_reference(pad):
    src, dst = skewed_edges()
    kw = dict(num_nodes=300, hub=300, hub_dense_floor=1000,
              pad_edges_to=len(src) + pad if pad else None)
    gj = jdgl.graph((src, dst), **kw)
    gt = tdgl.graph((src, dst), device="cpu", **kw)
    gt.edata["w"] = torch.arange(gt.num_edges_padded(), dtype=torch.float32)
    for a, b in ((gj, gt), (gj.reverse(), gt.reverse())):
        assert b.num_src_nodes() == a.num_src_nodes()
        assert b.num_edges_padded() == a.num_edges_padded()
        for k in ("src", "dst", "csr_indptr", "csr_dst", "csr_eid",
                  "csr_src", "csc_indptr", "csc_src", "csc_eid", "csc_dst"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)), k)
        for k in ("idx", "eid", "inv_perm"):
            np.testing.assert_array_equal(b.ell_dst[k].numpy(),
                                          np.asarray(a.ell_dst[k]), k)
    for k in ("edge_to_fslot", "edge_to_tslot", "diag_edge_dst"):
        np.testing.assert_array_equal(gt.hub_dst[k].numpy(),
                                      np.asarray(gj.hub_dst[k]), k)
    np.testing.assert_array_equal(gt.edge_mask is not None and
                                  gt.edge_mask.numpy(),
                                  pad > 0 and np.asarray(gj.edge_mask))
    r = gt.reverse()
    assert r.hub_dst is None and "w" in r.edata
    assert "w" not in gt.reverse(copy_edata=False).edata
    assert r.reverse().ell_dst_meta == gt.ell_dst_meta
    # g-SpMM on the reverse: out-edge sums, as the reference's.
    u = feats(300, 3, seed=2)
    with engines("xla", "xla"):
        want = np.asarray(jdgl.ops.gspmm(gj.reverse(), "copy_lhs", "sum",
                                         jnp.asarray(u), None))
        got = tdgl.ops.gspmm(r, "copy_lhs", "sum", t(u), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# GraphConv(edge_weight=) and EdgeWeightNorm
# ----------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["both", "right"])
@pytest.mark.parametrize("case", ["mixed_loops", "padded"])
def test_edge_weight_norm_matches_reference(case, norm):
    gj, gt = _graphs(case)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.1, 2.0, size=gt.num_edges_padded()).astype(np.float32)
    coef = rng.normal(size=w.shape).astype(np.float32)
    fj = JEdgeWeightNorm(norm, eps=0.5)
    with engines("hub", "hub"):
        want = np.asarray(fj(gj, jnp.asarray(w)))
        gwant = np.asarray(jax.grad(lambda x: jnp.sum(
            fj(gj, x) * coef))(jnp.asarray(w)))
        wt = t(w).requires_grad_(True)
        got = EdgeWeightNorm(norm, eps=0.5)(gt, wt)
        (ggot,) = torch.autograd.grad((got * t(coef)).sum(), wt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ggot.numpy(), gwant, rtol=1e-4, atol=1e-5)
    if case == "padded":
        assert not got[gt.num_edges():].any()


def test_edge_weight_norm_rejects_non_positive_weights():
    _, gt = make("mixed")
    w = torch.ones(gt.num_edges())
    w[7] = 0.0
    with pytest.raises(ValueError, match="non-positive"):
        EdgeWeightNorm("both")(gt, w)
    EdgeWeightNorm("right")(gt, w)  # allowed under 'right'
    with pytest.raises(ValueError, match="invalid norm"):
        EdgeWeightNorm("left")


@pytest.mark.parametrize("in_f,out_f", [(6, 9), (9, 4)])
def test_graphconv_edge_weight_matches_reference(in_f, out_f):
    """Both mult orders (aggregate first, project first), norm 'both',
    through the hub engine's u_mul_e: logits and the grads of the
    parameters, the input and the edge weights."""
    gj, gt = make("mixed", self_loops=True)
    n = gt.num_nodes()
    x = feats(n, in_f, seed=8)
    ew = np.random.default_rng(9).uniform(
        0.2, 1.5, gt.num_edges()).astype(np.float32)
    coef = feats(n, out_f, seed=10)
    jconv = JGraphConv(out_f)
    params = jconv.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    conv = GraphConv(in_f, out_f, device="cpu")
    conv.load_state_dict(from_jax_params(params))
    with engines("hub", "hub"):
        def jloss(p, xx, ee):
            return jnp.sum(jconv.apply(p, gj, xx, edge_weight=ee) * coef)

        want = np.asarray(jconv.apply(params, gj, jnp.asarray(x),
                                      edge_weight=jnp.asarray(ew)))
        jg = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x),
                                                jnp.asarray(ew))
        xt, et = t(x).requires_grad_(True), t(ew).requires_grad_(True)
        out = conv(gt, xt, edge_weight=et)
        (out * t(coef)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(jg[2]),
                               rtol=1e-4, atol=1e-4)
    pg = from_jax_params(jax.tree.map(np.asarray, jg[0]))
    assert set(pg) == {k for k, _ in conv.named_parameters()}
    for k, v in conv.named_parameters():
        np.testing.assert_allclose(v.grad.numpy(), pg[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_edge_weighted_gcn_at_zero_logits_is_the_symmetric_gcn():
    """With theta zero, EdgeWeightNorm('both') of sigmoid(theta) is the
    symmetric normalisation 1/sqrt(out_deg(u) in_deg(v)), so the model
    equals GCN(norm='both') with the same layer weights (rtol 1e-4, atol
    1e-5: the same sums, weighted per edge instead of per node)."""
    _, gt = make("mixed", self_loops=True)
    n = gt.num_nodes()
    gen = torch.Generator().manual_seed(0)
    model = tdgl.models.EdgeWeightedGCN(gt.num_edges_padded(), 6, 8, 3,
                                        dropout=0.0, device="cpu",
                                        generator=gen)
    gcn = tdgl.models.GCN(6, 8, 3, dropout=0.0, device="cpu")
    gcn.load_state_dict(model.gcn.state_dict())
    assert any(p is model.theta for p in model.parameters())
    x = t(feats(n, 6, seed=11))
    with engines("hub", "hub"):
        torch.testing.assert_close(model(gt, x), gcn(gt, x), rtol=1e-4,
                                   atol=1e-5)


def test_train_learns_edge_weighted_gcn_logits():
    """``train`` optimises the edge logits with the layer weights: after 3
    Adam steps through the hub engine theta has moved and the loss fell."""
    _, gt = make("mixed", self_loops=True)
    n = gt.num_nodes()
    gen = torch.Generator().manual_seed(0)
    model = tdgl.models.EdgeWeightedGCN(gt.num_edges_padded(), 5, 8, 3,
                                        dropout=0.0, device="cpu",
                                        generator=gen)
    x = torch.randn(n, 5, generator=gen)
    y = torch.randint(0, 3, (n,), generator=gen)
    with engines("hub", "hub"):
        res = tdgl.train(gt, x, y, model, steps=3, lr=1e-2)
    assert res["losses"][-1] < res["losses"][0]
    assert model.theta.detach().abs().sum() > 0


# ----------------------------------------------------------------------
# The composed GAT chain on a hub graph
# ----------------------------------------------------------------------

def test_composed_gat_on_hub_graph_matches_fused():
    """edge_softmax (its denominator a hub copy_e) then u_mul_e per head
    (H=4, D=5), both on the hub engine, against the fused gat_attention
    on the same graph: values and the grads of el, er and ft (rtol 1e-4,
    atol 1e-5)."""
    _, gt = make("powerlaw", self_loops=True)
    n = gt.num_nodes()
    rng = np.random.default_rng(12)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((n, 4), (n, 4), (n, 4, 5))]
    w = t(rng.normal(size=(n, 4, 5)).astype(np.float32))
    ops = tdgl.ops

    def composed(el, er, ft):
        e = ops.gsddmm(gt, "add", el[:, :, None], er[:, :, None])
        a = ops.edge_softmax(gt, torch.nn.functional.leaky_relu(e, 0.2))
        return ops.gspmm(gt, "mul", "sum", ft, a)

    res = []
    for fn in (composed, lambda el, er, ft: ops.gat_attention(gt, el, er,
                                                              ft, 0.2)):
        ins = [t(x).requires_grad_(True) for x in xs]
        with engines("xla", "hub"):
            out = fn(*ins)
            grads = torch.autograd.grad((out * w).sum(), ins)
        res.append([out.detach()] + list(grads))
    for name, a, b in zip(("out", "el", "er", "ft"), *res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
