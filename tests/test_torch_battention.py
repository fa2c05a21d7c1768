"""The port's block-dense GAT attention against the JAX package's
(``dgl1_tpu/ops/battention.py``) on the same inputs (numpy from a seed):
values and the el/er/ft grads, on a band graph with scattered tail edges,
with extreme logits, with zero-in-degree rows and on a fully covered
graph; GATConv's three-way choice; the GAT model on a block-dense graph
through ``from_jax_params`` (logits, grads, 3 Adam steps).

Tolerances, float32: values rtol 1e-4, atol 1e-5 and grads rtol 2e-4,
atol 2e-5 (tests/test_battention.py's, holding the reference against its
composed oracle: the softmax sums run in another order); extreme logits
rtol 1e-3, atol 1e-4 (as there); GAT logits rtol 1e-4, atol 1e-5, grads
rtol 1e-3, atol 1e-4 of the largest grad, parameters after Adam atol 1e-5
(as tests/test_torch_gat.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import GAT as JGAT
from dgl1_tpu.ops.battention import bdense_gat_attention as j_battention
from dgl1_tpu_torch.models import GAT
from dgl1_tpu_torch.ops import battention
from dgl1_tpu_torch.ops.battention import (bdense_gat_attention,
                                           can_fuse_battention)
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, make, t

FORMATS = ("coo", "csr", "csc", "ell", "bdense")
N, H, D = 520, 4, 8


def band(n=N, e=9000, width=60, seed=0, extra_scatter=300):
    """tests/test_battention.py's graph: a band and a scattered minority,
    so both tiers run."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-width, width, e), 0, n - 1)
    src = np.concatenate([src, rng.integers(0, n, extra_scatter)])
    dst = np.concatenate([dst, rng.integers(0, n, extra_scatter)])
    return src, dst


def both(src, dst, n=N):
    return (jdgl.graph((src, dst), num_nodes=n, formats=FORMATS),
            tdgl.graph((src, dst), num_nodes=n, formats=FORMATS,
                       device="cpu"))


def inputs(n=N, seed=1, el_scale=1.0):
    rng = np.random.default_rng(seed)
    el = (rng.normal(size=(n, H)) * el_scale).astype(np.float32)
    er = rng.normal(size=(n, H)).astype(np.float32)
    ft = rng.normal(size=(n, H, D)).astype(np.float32)
    w = rng.normal(size=(n, H, D)).astype(np.float32)
    return el, er, ft, w


def run_both(gj, gt, el, er, ft, w):
    """(values, grads) of sum(out * w) from the reference and the port."""
    def jloss(a, b, c):
        return jnp.sum(j_battention(gj, a, b, c) * jnp.asarray(w))

    jargs = tuple(jnp.asarray(x) for x in (el, er, ft))
    jout = np.asarray(j_battention(gj, *jargs))
    jgrads = [np.asarray(g) for g in jax.grad(jloss, (0, 1, 2))(*jargs)]
    targs = [t(x).requires_grad_(True) for x in (el, er, ft)]
    tout = bdense_gat_attention(gt, *targs)
    tgrads = torch.autograd.grad((tout * t(w)).sum(), targs)
    return (jout, jgrads), (tout.detach().numpy(), [g.numpy()
                                                    for g in tgrads])


def check(ref, got, rtol=1e-4, atol=1e-5, grtol=2e-4, gatol=2e-5):
    (jout, jgrads), (tout, tgrads) = ref, got
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, rtol=rtol, atol=atol)
    for name, a, b in zip(("gel", "ger", "gft"), tgrads, jgrads):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=grtol, atol=gatol,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_battention_matches_reference(seed):
    gj, gt = both(*band(seed=seed))
    m = gt.bdense_meta
    assert can_fuse_battention(gt) and 0 < m.covered < gt.num_edges()
    check(*run_both(gj, gt, *inputs(seed=seed + 1)))


def test_battention_extreme_logits_match_reference():
    gj, gt = both(*band(seed=7))
    ref, got = run_both(gj, gt, *inputs(seed=6, el_scale=40.0))
    check(ref, got, rtol=1e-3, atol=1e-4, grtol=1e-3, gatol=1e-4)


def test_battention_zero_in_degree_rows():
    src, dst = np.tile([0, 1, 2, 3], 40), np.tile([1, 2, 1, 2], 40)
    gj, gt = both(src, dst, n=300)
    ref, got = run_both(gj, gt, *inputs(n=300, seed=0))
    check(ref, got)
    assert np.allclose(got[0][[0] + list(range(3, 300))], 0.0)


def test_battention_fully_covered_graph():
    """No tail edges: the merge takes the dense tier alone."""
    rng = np.random.default_rng(4)
    blk = rng.integers(0, 4, 6000)
    src = np.minimum(blk * 128 + rng.integers(0, 128, 6000), N - 1)
    dst = np.minimum(blk * 128 + rng.integers(0, 128, 6000), N - 1)
    gj, gt = both(src, dst)
    assert gt.bdense["t_src"].numel() == 0
    check(*run_both(gj, gt, *inputs(seed=8)))


def test_battention_chunked_rows_agree(monkeypatch):
    """Chunks of one rb row at a time give what one chunk of all rows
    gives."""
    _, gt = both(*band(seed=9))
    el, er, ft, w = (t(x) for x in inputs(seed=9))
    args = [x.clone().requires_grad_(True) for x in (el, er, ft)]
    out = bdense_gat_attention(gt, *args)
    grads = torch.autograd.grad((out * w).sum(), args)
    monkeypatch.setattr(battention, "_CHUNK_ELEMS", 1)
    assert len(battention._chunks(gt.bdense_meta.n_rb, 1, H)) == \
        gt.bdense_meta.n_rb
    args2 = [x.clone().requires_grad_(True) for x in (el, er, ft)]
    out2 = bdense_gat_attention(gt, *args2)
    grads2 = torch.autograd.grad((out2 * w).sum(), args2)
    torch.testing.assert_close(out2, out, rtol=1e-6, atol=1e-6)
    for a, b in zip(grads2, grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_battention_declines_and_counts_calls():
    el, er, ft, _ = (t(x) for x in inputs())
    src, dst = band()
    g_plain = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    rng = np.random.default_rng(7)
    g_tail = tdgl.graph((rng.integers(0, N, 120), rng.integers(0, N, 120)),
                        num_nodes=N, formats=FORMATS, device="cpu")
    assert g_tail.bdense_meta.n_blocks == 0
    before = battention.CALLS["bdense_gat_attention"]
    assert bdense_gat_attention(g_plain, el, er, ft) is None
    assert bdense_gat_attention(g_tail, el, er, ft) is None
    assert battention.CALLS["bdense_gat_attention"] == before
    _, gt = both(src, dst)
    assert bdense_gat_attention(gt, el[:, :, None], er[:, :, None],
                                ft).shape == (N, H, D)
    assert battention.CALLS["bdense_gat_attention"] == before + 1


def test_gatconv_three_way_choice():
    """Hub graph: the fused hub attention; block-dense graph: the
    block-dense attention unless attention dropout applies, then the
    composed chain; all three give the composed chain's values."""
    calls = battention.CALLS
    conv = tdgl.nn.GATConv(12, D, num_heads=H, attn_drop=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    _, g_hub = make("mixed", self_loops=True)
    _, g_bd = both(*band(seed=11))
    for g in (g_hub, g_bd):
        x = t(feats(g.num_nodes(), 12, seed=12))
        plain = g.to("cpu")
        plain.hub_dst = plain.hub_dst_meta = None
        plain.bdense = plain.bdense_meta = None
        conv.eval()
        with engines("xla", "xla"):
            ref = conv(plain, x)
            n0 = calls["bdense_gat_attention"]
            out = conv(g, x)
            took_bdense = calls["bdense_gat_attention"] - n0
            assert took_bdense == (g is g_bd)
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            conv.train()
            n0 = calls["bdense_gat_attention"]
            conv(g, x, generator=torch.Generator().manual_seed(1))
            assert calls["bdense_gat_attention"] == n0
            conv.attn_drop = 0.0
            conv(g, x, generator=torch.Generator().manual_seed(1))
            assert calls["bdense_gat_attention"] == n0 + (g is g_bd)
            conv.attn_drop = 0.5


def _gat_setup():
    gj, gt = both(*band(seed=13))
    x = feats(N, 12, seed=41)
    labels = np.random.default_rng(42).integers(0, 5, N).astype(np.int32)
    jmodel = JGAT(hidden_feats=D, out_feats=5, heads=H, feat_drop=0.0,
                  attn_drop=0.0)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), gj,
                                                  jnp.asarray(x)))
    tmodel = GAT(12, D, 5, heads=H, feat_drop=0.0, attn_drop=0.0,
                 device="cpu")
    tmodel.load_state_dict(from_jax_params(params))

    def jloss(p):
        logits = jmodel.apply(p, gj, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits
    return gt, x, labels, params, tmodel, jax.jit(
        jax.value_and_grad(jloss, has_aux=True))


def test_gat_on_bdense_graph_matches_reference():
    gt, x, labels, params, tmodel, jfn = _gat_setup()
    n0 = battention.CALLS["bdense_gat_attention"]
    with engines("xla", "xla"):
        (_, want), jgrads = jfn(params)
        logits = tmodel(gt, t(x))
        torch.nn.functional.cross_entropy(logits,
                                          t(labels).long()).backward()
    assert battention.CALLS["bdense_gat_attention"] == n0 + 2
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    tg = dict(tmodel.named_parameters())
    assert set(jg) == set(tg)
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].grad.numpy(), v.numpy(), rtol=1e-3,
                                   atol=1e-4 * np.abs(v.numpy()).max(),
                                   err_msg=k)


def test_gat_adam_steps_on_bdense_graph_match_reference():
    gt, x, labels, params, tmodel, jfn = _gat_setup()
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jlosses = []
    with engines("xla", "xla"):
        for _ in range(3):
            (val, _), grads = jfn(params)
            updates, state = opt.update(grads, state)
            params = optax.apply_updates(params, updates)
            jlosses.append(float(val))
        res = tdgl.train(gt, t(x), t(labels), tmodel, steps=3, lr=1e-2)
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4, atol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
