"""The port's g-SpMM engines against its oracle and the reference.

Hub engine (copy_lhs, sum and mean): values and grad_u against the
port's oracle engine and against ``dgl1_tpu.ops.gspmm`` with engine
``hub`` (Pallas in interpret mode). ELL engine: values and grads of every
op against the oracle. Tolerance: rtol 1e-5, atol 1e-4 in float32 — the
hub rows sum up to ~2,000 terms in another order than the oracle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.ops import engine_hub as ref_hub
from dgl1_tpu_torch.ops import engine_hub as port_hub
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops.engine_ell import gspmm_ell
from dgl1_tpu_torch.ops.engine_xla import gspmm_xla

from torch_parity import engines, feats, make, t

TOL = dict(rtol=1e-5, atol=1e-4)
F = 6


def _port(gt, red, u, w, engine):
    ut = t(u).requires_grad_(True)
    with engines("xla", engine):
        out = tdgl.ops.gspmm(gt, "copy_lhs", red, ut, None)
    (gu,) = torch.autograd.grad((out * t(w)).sum(), ut)
    return out.detach().numpy(), gu.numpy()


def _reference(gj, red, u, w):
    def f(x):
        return jdgl.ops.gspmm(gj, "copy_lhs", red, x, None)

    with engines("hub", "auto"):
        out = np.asarray(f(jnp.asarray(u)))
        gu = np.asarray(jax.grad(lambda x: (f(x) * jnp.asarray(w)).sum())(
            jnp.asarray(u)))
    return out, gu


def _run(name, red, self_loops=False, relabel=False, paths=None):
    gj, gt = make(name, self_loops=self_loops, relabel=relabel)
    n = gt.num_nodes()
    u, w = feats(n, F, seed=1, shift=1.0), feats(n, F, seed=2)
    hub = _port(gt, red, u, w, "hub")
    oracle = _port(gt, red, u, w, "xla")
    want = _reference(gj, red, u, w)
    for a, b, c in zip(hub, oracle, want):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, c, **TOL)
    return gt


@pytest.mark.parametrize("red", ["sum", "mean"])
@pytest.mark.parametrize("name,self_loops,relabel", [
    ("chunked", False, False), ("dense", False, False),
    ("mixed", False, False), ("mixed", True, False),
    ("powerlaw", False, True), ("powerlaw", True, False),
])
def test_hub_matches_oracle_and_reference(name, self_loops, relabel, red):
    gt = _run(name, red, self_loops=self_loops, relabel=relabel)
    assert gt.hub_dst_meta.has_diag == self_loops
    assert gt.hub_dst_meta.identity_expand == relabel


@pytest.mark.parametrize("red", ["sum", "mean"])
def test_hub_unfused_backward_and_gather_expand(monkeypatch, red):
    """Gates closed in both packages: the backward runs the plain dense
    kernel (K4b) plus the ELL tail, the forward the t_inv fill-gather."""
    for mod in (ref_hub, port_hub):
        monkeypatch.setattr(mod, "_BWD_TAIL_VMEM_BYTES", 0)
        monkeypatch.setattr(mod, "_EXPAND_VMEM_BYTES", 0)
    calls = []
    for fn in ("dense_bwd", "dense_bwd_fused", "expand"):
        orig = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _run("mixed", red, self_loops=True)
    assert calls == ["dense_bwd"]


def test_hub_kernel_sequence_of_a_training_graph(monkeypatch):
    """On a self-loop hub graph with a dense tier the engine runs K1 and
    K3 forward and K4a backward, as the arxiv GCN does."""
    calls = []
    for fn in ("dense_fwd", "chunk_sum", "expand", "dense_bwd_fused",
               "dense_bwd", "chunk_weighted", "edge_grad"):
        orig = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _run("powerlaw", "sum", self_loops=True)
    assert calls == ["dense_fwd", "expand", "dense_bwd_fused"]


@pytest.mark.parametrize("red", ["sum", "mean"])
def test_diag_rides_in_the_expand_kernel(monkeypatch, red):
    """On a self-looped hub graph (``has_diag``, the expand gate open)
    copy_u's forward passes the diagonal to K3 and runs no torch pass for
    it: with ``_diag_term`` made to raise, values and grad_u still equal
    the reference's and the oracle's."""
    gj, gt = make("powerlaw", self_loops=True)
    m = gt.hub_dst_meta
    assert m.has_diag and not m.identity_expand
    n_merged = m.n_tail_rows + m.n_groups * 128
    assert port_hub._use_expand(m, gt.hub_dst, n_merged)
    args = []
    orig = K.expand
    monkeypatch.setattr(K, "expand", lambda *a, **k: (
        args.append(len(a) + len(k)), orig(*a, **k))[1])

    def no_torch_pass(*a, **k):
        raise AssertionError("the diagonal took a torch pass")

    monkeypatch.setattr(port_hub, "_diag_term", no_torch_pass)
    n = gt.num_nodes()
    u, w = feats(n, F, seed=1, shift=1.0), feats(n, F, seed=2)
    got = _port(gt, red, u, w, "hub")
    for a, b, c in zip(got, _port(gt, red, u, w, "xla"),
                       _reference(gj, red, u, w)):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, c, **TOL)
    assert args == [6]  # merged, x_starts, x_desc, num_dst, diag_w, diag_u


@pytest.mark.parametrize("op,he", [("copy_lhs", 1), ("mul", 1), ("mul", 3),
                                   ("copy_rhs", 1), ("copy_rhs", 3)])
def test_expand_epilogue_equals_expand_plus_diag_term(op, he):
    """``expand_torch`` with the epilogue (K3's plain version) equals
    ``expand_torch`` without it plus the engine's ``_diag_term``, bit for
    bit, for each op's operands: the fused diagonal changes nothing."""
    _, gt = make("powerlaw", self_loops=True)
    hub, m = gt.hub_dst, gt.hub_dst_meta
    n = gt.num_nodes()
    rep = 4
    rng = np.random.default_rng(3)
    u2 = t(rng.normal(size=(n, he * rep)).astype(np.float32))
    e2 = t(rng.normal(size=(gt.num_edges(), he)).astype(np.float32))
    f = he if op == "copy_rhs" else he * rep
    merged = t(rng.normal(size=(m.n_tail_rows + m.n_groups * 128, f))
               .astype(np.float32))
    xs, xd = hub["x_starts"], hub["x_desc"]
    fused = K.expand_torch(merged, xs, xd, n,
                           *port_hub._diag_operands(gt, op, u2, e2))
    plain = K.expand_torch(merged, xs, xd, n) + port_hub._diag_term(
        gt, op, u2, e2, he, 1 if op == "copy_rhs" else rep)
    assert torch.equal(fused, plain)
    assert not torch.equal(fused, K.expand_torch(merged, xs, xd, n))


def test_hub_declines_and_raises():
    """Declines (None) where the reference declines; mul and copy_rhs,
    which raised NotImplementedError before K2 mul/rhs and K5 were
    ported, now compute; a malformed weight raises."""
    gj, gt = make("mixed")
    u = torch.ones((gt.num_nodes(), 2))
    e = torch.ones((gt.num_edges(), 1))
    assert port_hub.gspmm_hub(gt, "copy_lhs", "max", u, None) is None
    assert port_hub.gspmm_hub(gt, "mul", "sum", u, e).shape == u.shape
    np.testing.assert_allclose(
        port_hub.gspmm_hub(gt, "copy_rhs", "sum", None, e)[:, 0].numpy(),
        gt.in_degrees().numpy())
    with pytest.raises(ValueError, match="edge data"):  # a row short
        port_hub.gspmm_hub(gt, "copy_rhs", "sum", None, e[1:])
    plain = tdgl.graph(([0, 1], [1, 2]), num_nodes=3, device="cpu")
    assert port_hub.gspmm_hub(plain, "copy_lhs", "sum",
                              torch.ones((3, 2)), None) is None


@pytest.mark.parametrize("op", ["copy_lhs", "copy_rhs", "mul", "add",
                                "div"])
@pytest.mark.parametrize("red", ["sum", "mean"])
def test_ell_matches_oracle(op, red):
    _, gt = make("mixed", self_loops=True)
    n, e_rows = gt.num_nodes(), gt.num_edges()
    u = t(feats(n, F, seed=3, shift=2.0)).requires_grad_(True)
    e = t(feats(e_rows, 1, seed=4, shift=3.0)).requires_grad_(True)
    uu = None if op == "copy_rhs" else u
    ee = None if op == "copy_lhs" else e
    w = t(feats(n, 1 if op == "copy_rhs" else F, seed=5))
    a = gspmm_ell(gt, op, red, uu, ee)
    b = gspmm_xla(gt, op, red, uu, ee)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               **TOL)
    ins = [x for x in (uu, ee) if x is not None]
    ga = torch.autograd.grad((a * w).sum(), ins)
    gb = torch.autograd.grad((b * w).sum(), ins)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


@pytest.mark.parametrize("red", ["max", "min", "prod", "sum"])
def test_oracle_matches_reference_oracle(red):
    gj, gt = make("mixed")
    u = feats(gt.num_nodes(), F, seed=6, shift=1.0) * 0.1 + 1.0
    want = np.asarray(jdgl.ops.engine_xla.gspmm_xla(
        gj, "copy_lhs", red, jnp.asarray(u), None))
    got = gspmm_xla(gt, "copy_lhs", red, t(u), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_auto_engine_is_the_oracle_on_cpu(monkeypatch):
    _, gt = make("mixed")
    calls = []
    monkeypatch.setattr(tdgl.ops.dispatch, "_ENGINES",
                        {"hub": lambda *a: calls.append(a)})
    with engines("auto", "auto"):
        tdgl.ops.gspmm(gt, "copy_lhs", "sum",
                       torch.ones((gt.num_nodes(), 2)), None)
    assert calls == []
