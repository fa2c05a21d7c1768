"""K7's g-major mode (``attn_bwd_grp``) and the attention's route through
it, on the CPU.

* The port's plain version (the wrapper on CPU tensors) against the
  reference's ``_attn_bwd_call(slope, False, full_fwd, ...)`` in
  interpret mode, at dropout 0 and 0.6; and all three of it, the
  reference's g-major call and the port's ``to_src=True`` + K8 route
  against a float64 oracle: the gradient of ``<ct, out>`` with respect to
  er through the composed chain (logits -> leaky_relu -> edge softmax ->
  masked weighted sum) by autograd, on a graph whose hub rows take all
  their in-edges through the chunk layout. The reference's own tests
  never call this branch. Tolerance: |err| <= 1e-5 * (|want| + max
  |want|) + 1e-6 (float32 sums of up to ~2,000 signed terms against
  float64).
* ``GATConv`` on a layout whose ``full_bwd`` lost its gperm descriptors
  (the reference's route for them: grad_er from K7 g-major) against the
  same layer on the full layout (K7 + K8): values, every parameter's grad
  and the input's grad, at dropout 0 and 0.6 and in the bf16 mode, within
  rtol 1e-5 (atol 1e-6 of the largest value): the two routes add the
  same terms in another order.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl1_tpu_torch as tdgl
from dgl1_tpu.ops import attention as ref
from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.ops import attn_kernels as AK

from torch_parity import engines, feats, make, t

SLOPE = 0.2
SEED = np.array([-1234567891], np.int32)
H, D = 4, 8


def _pad(x, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _hub_rows(x, ids):
    ok = ids < x.shape[0]
    return np.where(ok[:, None], x[np.minimum(ids, x.shape[0] - 1)],
                    0.0).astype(x.dtype)


def _oracle(gt, el, er, ft, ct, drop):
    """float64 composed chain: (grad of <ct, out> w.r.t. er, lse, rho), the
    log-normaliser and the jacobian row term of every destination."""
    src, dst = (x.numpy().astype(np.int64) for x in gt.edges())
    n = gt.num_nodes()
    el64, ft64, ct64 = (torch.tensor(x, dtype=torch.float64)
                        for x in (el, ft, ct))
    er64 = torch.tensor(er, dtype=torch.float64, requires_grad=True)
    z = torch.nn.functional.leaky_relu(el64[src] + er64[dst], SLOPE)
    idx = torch.as_tensor(dst)[:, None].expand(-1, H)
    mx = torch.full((n, H), -torch.inf, dtype=torch.float64).scatter_reduce(
        0, idx, z.detach(), "amax")
    ex = torch.exp(z - mx[dst])
    den = torch.zeros((n, H), dtype=torch.float64).index_add(0, idx[:, 0], ex)
    a = ex / den[dst]
    if drop > 0:
        a = a * AK.drop_mask(torch.arange(len(src)), t(SEED), drop,
                             H).double()
    out = torch.zeros((n, H, D), dtype=torch.float64).index_add(
        0, idx[:, 0], a[:, :, None] * ft64.reshape(-1, H, D)[src])
    (ger,) = torch.autograd.grad((out * ct64.reshape(-1, H, D)).sum(), er64)
    lse = (mx + torch.log(den)).detach()
    rho = (out.detach() * ct64.reshape(-1, H, D)).sum(2)
    return ger.numpy(), lse.numpy(), rho.numpy()


def _close(got, want, msg):
    tol = 1e-5 * (np.abs(want) + np.abs(want).max()) + 1e-6
    err = np.abs(got - want)
    assert (err <= tol).all(), (msg, float(err.max()),
                                float(np.abs(want).max()))


@pytest.mark.parametrize("drop", [0.0, 0.6])
def test_gmajor_matches_reference_and_oracle(drop):
    gj, gt = make("mixed")
    hub, m = gj.hub_dst, gj.hub_dst_meta
    n, f = gt.num_nodes(), H * D
    rng = np.random.default_rng(31)
    el, er = (rng.normal(size=(n, H)).astype(np.float32) for _ in range(2))
    ft, ct = (rng.normal(size=(n, f)).astype(np.float32) for _ in range(2))
    want, lse, rho = _oracle(gt, el, er, ft, ct, drop)
    ids = np.asarray(hub["hub_ids"]).astype(np.int64)[: m.n_groups * BLK]
    er_g, lse_g, rho_g, ct_g = (_hub_rows(np.asarray(x, np.float32), ids)
                                for x in (er, lse, rho, ct))
    # Hub rows: real ids of groups the forward layout reaches.
    blocks = np.unique(np.asarray(hub["full_fwd"]["out_id"]))
    rows = (blocks[:, None] * BLK + np.arange(BLK)).reshape(-1)
    rows = rows[ids[rows] < n]
    want = want[ids[rows]]
    src, dst = (x.numpy() for x in gt.edges())
    hub_edges = np.isin(dst, ids[rows])
    # Every in-edge of those rows is a slot of the chunk layout.
    assert int((np.asarray(hub["full_fwd"]["a"]) >= 0).sum()) == \
        int(hub_edges.sum())

    tlay = {k: t(v) for k, v in hub["full_fwd"].items()}
    args = (t(el), t(er_g), t(lse_g), t(rho_g), t(ft), t(ct_g), H, D, SLOPE,
            drop, t(SEED))
    port = AK.attn_bwd_grp(tlay, *args, m.n_groups).numpy()[rows]
    f_pad, rows_pad = BLK, hub["dense_c"].shape[0]
    (jger,) = ref._attn_bwd_call(
        SLOPE, False, {k: jnp.asarray(v) for k, v in hub["full_fwd"].items()},
        jnp.asarray(_pad(el, rows_pad, BLK)),
        (jnp.asarray(_pad(np.concatenate([er_g, lse_g, rho_g], 1),
                          m.n_groups * BLK, BLK)),),
        jnp.asarray(_pad(ft, rows_pad, f_pad)),
        jnp.asarray(_pad(ct_g, m.n_groups * BLK, f_pad)), H, D, m.n_groups,
        f_pad, jnp.float32, drop, jnp.asarray(SEED))
    jger = np.asarray(jger)[rows, :H]
    blay = {k: t(v) for k, v in hub["full_bwd"].items()}
    _, _, gerp = AK.attn_bwd_src(blay, *args, m.n_win)
    via_k8 = AK.ger_reduce(blay, gerp, m.n_groups).numpy()[rows]

    _close(port, jger, "port vs reference g-major")
    for name, got in (("port g-major", port), ("reference g-major", jger),
                      ("port to_src + K8", via_k8)):
        _close(got, want, name)


def strip_gperm(g):
    """A view of ``g`` whose backward layout lacks the gperm descriptors,
    as a layout built before them would."""
    gs = copy.copy(g)
    gs.hub_dst = dict(g.hub_dst)
    gs.hub_dst["full_bwd"] = {k: v for k, v in g.hub_dst["full_bwd"].items()
                              if k not in ("gperm", "gout", "gfirst")}
    return gs


@pytest.mark.parametrize("drop,prec", [(0.0, "f32"), (0.6, "f32"),
                                       (0.0, "bf16")])
def test_gatconv_on_a_layout_without_gperm(drop, prec, monkeypatch):
    calls = {"attn_bwd_grp": 0, "ger_reduce": 0}
    for name in calls:
        def counted(*a, _f=getattr(AK, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(AK, name, counted)
    _, gt = make("mixed", self_loops=True)
    conv = tdgl.nn.GATConv(12, 8, num_heads=H, attn_drop=drop, residual=True,
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    conv.train()
    x0 = t(feats(gt.num_nodes(), 12, seed=23))
    results = []
    for g, route in ((gt, "ger_reduce"), (strip_gperm(gt), "attn_bwd_grp")):
        conv.zero_grad()
        x = x0.clone().requires_grad_(True)
        before = dict(calls)
        with engines("xla", "xla"), tdgl.ops.matmul_precision(prec):
            y = conv(g, x, generator=torch.Generator().manual_seed(4))
            (y ** 2).sum().backward()
        # Each layout takes its own route to grad_er, once.
        assert {k: calls[k] - before[k] for k in calls} == {
            k: int(k == route) for k in calls}
        grads = {k: p.grad.clone() for k, p in conv.named_parameters()}
        results.append((y.detach(), x.grad, grads))
    (y0, gx0, g0), (y1, gx1, g1) = results
    assert "gperm" not in strip_gperm(gt).hub_dst["full_bwd"]
    for name, a, b in [("out", y1, y0), ("x", gx1, gx0)] + [
            (k, g1[k], g0[k]) for k in g0]:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)
