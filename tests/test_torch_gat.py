"""The port's GAT against the reference GAT with the same weights
(``from_jax_params``): logits and the grads of the softmax cross-entropy
for every parameter, on a hub graph with self-loops (the fused attention,
K6-K8's plain versions) and on the Cora-scale graph (no hub layout: the
composed g-SDDMM -> edge_softmax -> u_mul_e path); then 3 Adam steps
(optax ``adam(1e-2)`` vs ``torch.optim.Adam(lr=1e-2)`` through
``dgl1_tpu_torch.train``), comparing the parameters.

Tolerances, float32 throughout: logits and losses rtol 1e-4, atol 1e-5,
or 1e-4 of the largest logit on Cora (its 1433-wide projection and two
attention layers sum in another order than XLA);
grads rtol 1e-3, atol 1e-4 of the parameter's largest grad (two
attention layers chain the softmax jacobian; sums run in another order
than in XLA); parameters after Adam
atol 1e-5 (Adam's m/sqrt(v) turns a relative grad error of ~1e-6 into
about that much of lr per step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import GAT as JGAT
from dgl1_tpu_torch.models import GAT
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, make, t

HEADS = 4


def _setup(case):
    if case == "hub":
        gj, gt = make("mixed", self_loops=True)
        assert tdgl.ops.can_fuse_attention(gt) and gt.hub_dst_meta.has_diag
        n, in_f, hidden, out = gt.num_nodes(), 16, 8, 7
        x = feats(n, in_f, seed=21)
    else:  # the Cora-scale graph of __graft_entry__.entry()
        kw = dict(num_nodes=2708, num_classes=7, feat_dim=1433,
                  avg_degree=4.0, seed=0)
        gj = jdgl.data.synthetic_classification_graph(**kw)
        gt = tdgl.data.synthetic_classification_graph(device="cpu", **kw)
        assert not tdgl.ops.can_fuse_attention(gt)
        n, in_f, hidden, out = 2708, 1433, 8, 7
        x = np.asarray(gj.ndata["feat"])
    labels = np.random.default_rng(22).integers(0, out, n).astype(np.int32)
    return gj, gt, x, labels, (in_f, hidden, out)


def _models(gj, x, dims):
    in_f, hidden, out = dims
    jmodel = JGAT(hidden_feats=hidden, out_feats=out, heads=HEADS,
                  feat_drop=0.0, attn_drop=0.0)
    params = jmodel.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)
    tmodel = GAT(in_f, hidden, out, heads=HEADS, feat_drop=0.0,
                 attn_drop=0.0, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    return jmodel, params, tmodel


def _jax_loss(jmodel, gj, x, labels):
    """The reference's (loss, logits) and grads, traced once."""
    def loss(p):
        logits = jmodel.apply(p, gj, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("case", ["hub", "cora"])
def test_gat_logits_and_grads_match_reference(case):
    gj, gt, x, labels, dims = _setup(case)
    jmodel, params, tmodel = _models(gj, x, dims)
    with engines("xla", "xla"):
        (_, want), jgrads = _jax_loss(jmodel, gj, x, labels)(params)
        want = np.asarray(want)
        logits = tmodel(gt, t(x))
        loss = torch.nn.functional.cross_entropy(logits, t(labels).long())
        loss.backward()
    atol = 1e-5 if case == "hub" else 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-4,
                               atol=atol)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    tg = dict(tmodel.named_parameters())
    assert set(jg) == set(tg) == {
        f"layers.{i}.{k}" for i in (0, 1)
        for k in ("fc.weight", "attn_l", "attn_r", "bias")}
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].grad.numpy(), v.numpy(), rtol=1e-3,
                                   atol=1e-4 * np.abs(v.numpy()).max(),
                                   err_msg=k)


def test_gat_adam_steps_match_reference():
    gj, gt, x, labels, dims = _setup("hub")
    jmodel, params, tmodel = _models(gj, x, dims)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    loss_fn = _jax_loss(jmodel, gj, x, labels)
    jlosses = []
    with engines("xla", "xla"):
        for _ in range(3):
            (val, _), grads = loss_fn(params)
            updates, state = opt.update(grads, state)
            params = optax.apply_updates(params, updates)
            jlosses.append(float(val))
        res = tdgl.train(gt, t(x), t(labels), tmodel, steps=3, lr=1e-2)
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4, atol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_gatconv_fused_and_composed_paths_agree():
    """The same GATConv on a hub graph, fused (the hub layout) and composed
    (the layout hidden), values and the grad of every parameter."""
    _, gt = make("mixed", self_loops=True)
    conv = tdgl.nn.GATConv(12, 8, num_heads=HEADS, residual=True,
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    x = t(feats(gt.num_nodes(), 12, seed=23))
    outs, grads = [], []
    for fused in (True, False):
        g = gt
        if not fused:
            g = gt.to("cpu")
            g.hub_dst = g.hub_dst_meta = None
        conv.zero_grad()
        with engines("xla", "xla"):
            y = conv(g, x)
        (y ** 2).sum().backward()
        outs.append(y.detach().numpy())
        grads.append({k: p.grad.clone() for k, p in conv.named_parameters()})
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    for k in grads[0]:
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("case", ["hub", "cora"])
def test_gat_dropout_uses_the_given_generator(case):
    _, gt, x, _, dims = _setup(case)
    model = GAT(*dims, heads=HEADS, device="cpu",
                generator=torch.Generator().manual_seed(3))
    model.train()
    with engines("xla", "xla"):
        a = model(gt, t(x), generator=torch.Generator().manual_seed(4))
        b = model(gt, t(x), generator=torch.Generator().manual_seed(4))
        c = model(gt, t(x), generator=torch.Generator().manual_seed(5))
        model.eval()
        d = model(gt, t(x))
        e = model(gt, t(x))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e) and not torch.equal(a, d)
