"""The port's fused GAT attention against the JAX package.

* K6-K8's plain torch versions (the wrappers on CPU tensors) against the
  reference's ``_attn_fwd_call``, ``_attn_bwd_call(to_src=True)`` and
  ``_ger_reduce_call`` in interpret mode, on the same layout arrays,
  comparing the columns the reference's callers read. mraw is a max and
  matches exactly. The sums run in another order over up to thousands of
  signed terms, so |err| <= 1e-5 * (|want| + max |want|) + 1e-5; num and
  den, which the reference reaches through an online max with a rescale
  per chunk and the port with the group's final max, within 1e-4 * (the
  same sum over |ft|) + 1e-5.
* ``_mix32``/``_drop_mask`` bit for bit.
* ``gat_attention`` values and grads of el, er and ft against the
  reference's and against the port's composed path (g-SDDMM ->
  edge_softmax -> u_mul_e on the oracle engine): rtol/atol 1e-4 on
  values, 2e-3 on grads (tests/test_attention.py's tolerances).
* Heads wider than ``MAX_HEAD_DIM`` decline the fused path, and
  ``edge_softmax`` masks padded edges as the reference does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.dataloading import NeighborSampler as JSampler
from dgl1_tpu.ops import attention as ref
from dgl1_tpu_torch.dataloading import NeighborSampler
from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.ops import attention as port
from dgl1_tpu_torch.ops import attn_kernels as AK
from dgl1_tpu_torch.ops import hub_kernels as HK

from torch_parity import engines, make, t

SLOPE = 0.2


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-5 * (np.abs(want) + np.abs(want).max(initial=0.0)) + 1e-5
    err = np.abs(got - want)
    assert got.shape == want.shape and (err <= tol).all(), (
        err_msg, float(err.max()), float(np.abs(want).max(initial=0.0)))
SEED = np.array([-1234567891], np.int32)


def _pad(x, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _hub_rows(x, hub_ids, n_groups):
    ids = np.asarray(hub_ids).astype(np.int64)
    ok = ids < x.shape[0]
    rows = np.where(ok[:, None], x[np.minimum(ids, x.shape[0] - 1)], 0.0)
    return rows[: n_groups * BLK].astype(np.float32)


def _jlay(hub, name):
    return {k: jnp.asarray(v) for k, v in hub[name].items()}


def _tlay(hub, name):
    return {k: t(v) for k, v in hub[name].items()}


# (graph, heads, head width, dropout): every (H, D) and dropout on the
# small "mixed" layout; one or two cases on the others, whose interpret
# runs cost more. (50, 4) has 3H > 128: the reference's unpacked blocks.
KERNEL_CASES = (
    [("mixed", h, d, p) for h, d in [(1, 16), (8, 32), (50, 4)]
     for p in (0.0, 0.6)]
    + [("chunked", 8, 32, 0.0), ("chunked", 50, 4, 0.6),
       ("dense", 1, 16, 0.6), ("dense", 8, 32, 0.0),
       ("powerlaw", 8, 32, 0.6)])


@pytest.mark.parametrize("name,h,d,drop", KERNEL_CASES)
def test_kernels_plain_match_reference_calls(name, h, d, drop):
    gj, _ = make(name, self_loops=True)
    hub, m = gj.hub_dst, gj.hub_dst_meta
    n, f = gj.num_nodes(), h * d
    f_pad = -(-f // BLK) * BLK
    rows_pad = hub["dense_c"].shape[0]
    g_rows = m.n_groups * BLK
    rng = np.random.default_rng(h * 100 + d)
    el = rng.normal(size=(n, h)).astype(np.float32)
    er = rng.normal(size=(n, h)).astype(np.float32)
    ft = rng.normal(size=(n, f)).astype(np.float32)
    er_g = _hub_rows(er, hub["hub_ids"], m.n_groups)
    seed = jnp.asarray(SEED)

    # K6
    num, den, mraw = ref._attn_fwd_call(
        SLOPE, _jlay(hub, "full_fwd"), jnp.asarray(_pad(el, rows_pad, BLK)),
        jnp.asarray(_pad(er_g, g_rows, BLK)),
        jnp.asarray(_pad(ft, rows_pad, f_pad)),
        ref._replication_r(h, d, f_pad), m.n_groups, f_pad, jnp.float32,
        drop, seed, h=h)
    tnum, tden, tmraw = AK.attn_fwd(_tlay(hub, "full_fwd"), t(el), t(er_g),
                                    t(ft), h, d, SLOPE, drop, t(SEED),
                                    m.n_groups)
    np.testing.assert_array_equal(tmraw.numpy(), np.asarray(mraw)[:, :h])
    scale, _, _ = AK.attn_fwd(_tlay(hub, "full_fwd"), t(el), t(er_g),
                              t(np.abs(ft)), h, d, SLOPE, drop, t(SEED),
                              m.n_groups)
    for got, want, sc in ((tden, np.asarray(den)[:, :h], tden),
                          (tnum, np.asarray(num)[:, :f], scale)):
        err = np.abs(got.numpy() - want)
        assert (err <= 1e-4 * sc.numpy() + 1e-5).all(), err.max()

    # K7 (to_src=True): lse near the log-sum of the real softmax keeps
    # acoef in range.
    lse = (rng.normal(size=(n, h)) + 3.0).astype(np.float32)
    rho = rng.normal(size=(n, h)).astype(np.float32)
    ct = rng.normal(size=(n, f)).astype(np.float32)
    lse_g, rho_g, ct_g = (_hub_rows(x, hub["hub_ids"], m.n_groups)
                          for x in (lse, rho, ct))
    if 3 * h <= BLK:
        blocks = (jnp.asarray(_pad(np.concatenate([er_g, lse_g, rho_g], 1),
                                   g_rows, BLK)),)
    else:
        blocks = tuple(jnp.asarray(_pad(x, g_rows, BLK))
                       for x in (er_g, lse_g, rho_g))
    lay_b = _jlay(hub, "full_bwd")
    gft, gel, gerp = ref._attn_bwd_call(
        SLOPE, True, lay_b, jnp.asarray(_pad(el, rows_pad, BLK)), blocks,
        jnp.asarray(_pad(ft, rows_pad, f_pad)),
        jnp.asarray(_pad(ct_g, g_rows, f_pad)), h, d, m.n_win, f_pad,
        jnp.float32, drop, seed)
    tgft, tgel, tgerp = AK.attn_bwd_src(
        _tlay(hub, "full_bwd"), t(el), t(er_g), t(lse_g), t(rho_g), t(ft),
        t(ct_g), h, d, SLOPE, drop, t(SEED), m.n_win)
    win = np.repeat(np.asarray(hub["win_mask_full"]), BLK)
    _close(tgft.numpy()[win], np.asarray(gft)[win, :f], "gft")
    _close(tgel.numpy()[win], np.asarray(gel)[win, :h], "gel")
    _close(tgerp.numpy(), np.asarray(gerp)[:, :h], "gerp")

    # K8, on the reference's partials.
    ger = ref._ger_reduce_call(lay_b, gerp, m.n_groups)
    tger = AK.ger_reduce(_tlay(hub, "full_bwd"),
                         t(np.asarray(gerp)[:, :h]), m.n_groups)
    _close(tger.numpy(), np.asarray(ger)[:, :h], "ger")


@pytest.mark.parametrize("seed", [0, -1, 2 ** 31 - 1, -2 ** 31, 987654321])
def test_mix32_and_drop_mask_bit_for_bit(seed):
    rng = np.random.default_rng(7)
    keys = np.concatenate([
        np.arange(2 ** 31 - 64, 2 ** 31, dtype=np.int64),
        np.arange(-2 ** 31, -2 ** 31 + 64, dtype=np.int64),
        rng.integers(-2 ** 31, 2 ** 31, 256)]).astype(np.int32)
    want = np.asarray(ref._mix32(jnp.asarray(keys), jnp.int32(seed)))
    got = AK._mix32(t(keys).long() & 0xFFFFFFFF,
                    torch.tensor(seed, dtype=torch.int64))
    assert np.array_equal(got.numpy().astype(np.uint32).view(np.int32),
                          want)
    # Edge ids above 2^24 (and large enough that eid * 131 wraps).
    eid = np.concatenate([rng.integers(1 << 24, 1 << 31, 300),
                          np.arange(64)]).astype(np.int32)
    heads = 8
    for drop in (0.1, 0.6):
        key = jnp.asarray(eid)[:, None] * jnp.int32(131) + jnp.arange(
            heads, dtype=jnp.int32)[None, :]
        want = np.asarray(ref._drop_mask(key, jnp.int32(seed), drop))
        got = AK.drop_mask(t(eid), torch.tensor([seed], dtype=torch.int32),
                           drop, heads).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def _composed(gt, el, er, ft):
    """The port's composed path on the oracle engine."""
    with engines("xla", "xla"):
        e = tdgl.ops.gsddmm(gt, "add", el[:, :, None], er[:, :, None],
                            lhs_target="u", rhs_target="v")
        a = tdgl.ops.edge_softmax(gt, torch.nn.functional.leaky_relu(
            e, SLOPE))
        return tdgl.ops.gspmm(gt, "mul", "sum", ft, a)


def _port_fused(gt, el, er, ft, drop):
    return port.gat_attention(gt, el, er, ft, SLOPE, drop, t(SEED))


# (graph, self-loops, relabel): every tier config, the diagonal, the
# identity merge of a hub-relabeled graph, and zero-in-degree rows
# ("mixed" without self-loops has three). The powerlaw layout runs in
# the kernel-level cases above.
GRAPH_CASES = [("chunked", True, False), ("dense", True, False),
               ("mixed", True, False), ("mixed", False, False),
               ("mixed", True, True)]


@pytest.mark.parametrize("drop", [0.0, 0.6])
@pytest.mark.parametrize("name,loops,relabel", GRAPH_CASES)
def test_gat_attention_matches_reference(name, loops, relabel, drop):
    gj, gt = make(name, self_loops=loops, relabel=relabel)
    assert port.can_fuse_attention(gt) and ref.can_fuse_attention(gj)
    assert gt.hub_dst_meta.identity_expand == relabel
    assert gt.hub_dst_meta.has_diag == loops
    n, h, d = gt.num_nodes(), 4, 8
    rng = np.random.default_rng(3)
    el, er = (rng.normal(size=(n, h)).astype(np.float32) for _ in range(2))
    ft, w = (rng.normal(size=(n, h, d)).astype(np.float32) for _ in range(2))

    def jloss(el_, er_, ft_):
        out = ref.gat_attention(gj, el_, er_, ft_, SLOPE, drop,
                                jnp.asarray(SEED))
        return jnp.sum(jnp.sin(out) * w), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(el), jnp.asarray(er), jnp.asarray(ft))
    xs = [t(x).requires_grad_(True) for x in (el, er, ft)]
    out = _port_fused(gt, *xs, drop)
    (torch.sin(out) * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for x, jg, k in zip(xs, jgrads, ("el", "er", "ft")):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
    if not loops:
        deg = gt.in_degrees().numpy()
        assert (deg == 0).any()
        np.testing.assert_array_equal(out.detach().numpy()[deg == 0], 0.0)

    if drop == 0.0:
        ys = [t(x).requires_grad_(True) for x in (el, er, ft)]
        comp = _composed(gt, *ys)
        (torch.sin(comp) * t(w)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(),
                                   comp.detach().numpy(), rtol=1e-4,
                                   atol=1e-4)
        for x, y, k in zip(xs, ys, ("el", "er", "ft")):
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                       rtol=2e-3, atol=2e-3, err_msg=k)


def test_gat_attention_declines_as_the_reference_does():
    gj, gt = make("mixed")
    x = torch.zeros((gt.num_nodes(), BLK + 1, 2))
    assert port.gat_attention(gt, x[..., 0], x[..., 0], x) is None
    g0 = tdgl.graph(([0, 1], [1, 2]), num_nodes=3, hub=False, device="cpu")
    assert not port.can_fuse_attention(g0)
    with pytest.raises(ValueError, match="seed"):
        port.gat_attention(gt, x[:, :2, 0], x[:, :2, 0], x[:, :2], 0.2, 0.5)


def test_composed_path_on_hub_graph_raises_under_the_hub_engine(monkeypatch):
    """H > 128 skips the fused op; under the forced hub engine the composed
    chain's copy_rhs (softmax denominator) and mul (aggregation) run K2 in
    rhs and mul mode and K5, and nothing falls to another engine. They agree
    with the oracle engine within 1e-5 (float32, different sum order)."""
    _, gt = make("mixed")
    conv = tdgl.nn.GATConv(4, 1, num_heads=BLK + 1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(gt.num_nodes(), 4)).astype(np.float32))
    with engines("xla", "xla"):
        want = conv(gt, x).detach()
    modes = []
    for fn in ("chunk_weighted", "edge_grad"):
        orig = getattr(HK, fn)
        monkeypatch.setattr(HK, fn, lambda mode, *a, _f=orig, _n=fn, **k: (
            modes.append((_n, mode)), _f(mode, *a, **k))[1])
    with engines("xla", "hub"):
        got = conv(gt, x)
        got.sum().backward()
    assert ("chunk_weighted", "rhs") in modes
    assert ("chunk_weighted", "mul") in modes
    assert ("edge_grad", "mul") in modes
    assert got.shape == want.shape == (gt.num_nodes(), BLK + 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_check_inputs_and_count_only_launches():
    _, gt = make("mixed")
    hub, m = gt.hub_dst, gt.hub_dst_meta
    n, h, d = gt.num_nodes(), 2, 3
    el, ft = torch.zeros((n, h)), torch.zeros((n, h * d))
    er_g = torch.zeros((m.n_groups * BLK, h))
    AK.reset_launches()
    num, den, mraw = AK.attn_fwd(hub["full_fwd"], el, er_g, ft, h, d, SLOPE,
                                 0.0, None, m.n_groups)
    assert num.shape == (m.n_groups * BLK, h * d)
    assert den.shape == mraw.shape == (m.n_groups * BLK, h)
    assert all(v == 0 for v in AK.LAUNCHES.values())  # plain version ran
    with pytest.raises(TypeError):
        AK.attn_fwd(hub["full_fwd"], el.double(), er_g, ft, h, d, SLOPE)
    with pytest.raises(ValueError, match="seed"):
        AK.attn_fwd(hub["full_fwd"], el, er_g, ft, h, d, SLOPE, 0.5, None,
                    m.n_groups)
    with pytest.raises(ValueError):
        AK.attn_fwd(hub["full_fwd"], el, er_g[:10], ft, h, d, SLOPE, 0.0,
                    None, m.n_groups)
    with pytest.raises(ValueError):
        AK.ger_reduce(hub["full_bwd"], torch.zeros((5, h)), m.n_groups)


def test_wide_heads_decline_the_fused_path(monkeypatch):
    """Heads wider than MAX_HEAD_DIM features decline the fused attention
    (the kernels stage a head in one shared-memory stripe), so GATConv
    takes the composed path, which computes the same function."""
    _, gt = make("mixed", self_loops=True)
    d = AK.MAX_HEAD_DIM + 1
    assert port.can_fuse_attention(gt) and port.can_fuse_attention(gt, d - 1)
    assert not port.can_fuse_attention(gt, d)
    x = torch.zeros((gt.num_nodes(), 1, d))
    assert port.gat_attention(gt, x[..., 0], x[..., 0], x) is None
    conv = tdgl.nn.GATConv(6, d, num_heads=1, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    feat = t(np.random.default_rng(6).normal(
        size=(gt.num_nodes(), 6)).astype(np.float32))
    calls = []
    monkeypatch.setattr(port, "_attn_forward",
                        lambda *a: calls.append(1) or None)
    with engines("xla", "xla"):
        got = conv(gt, feat)
        g_view = gt.to("cpu")
        g_view.hub_dst = g_view.hub_dst_meta = None
        want = conv(g_view, feat)
    assert not calls and got.shape == (gt.num_nodes(), 1, d)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())


def _edge_softmax_both(gj, gt, logits, ct):
    """Values and grads of sum(edge_softmax * ct) in both packages."""
    def jf(x):
        return jnp.sum(jdgl.ops.edge_softmax(gj, x) * ct)

    jval = np.asarray(jdgl.ops.edge_softmax(gj, jnp.asarray(logits)))
    jgrad = np.asarray(jax.grad(jf)(jnp.asarray(logits)))
    x = t(logits).requires_grad_(True)
    val = tdgl.ops.edge_softmax(gt, x)
    (val * t(ct)).sum().backward()
    return jval, jgrad, val.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("graph", ["padded", "block"])
def test_edge_softmax_masks_padded_edges(graph):
    """Padded edges take -inf in the max and 0 in exp, as in the
    reference: values and grads at the full padded length within 1e-6, on
    ``graph(pad_edges_to=400)`` (N=50, E=300 uniform, 2 heads) and on a
    sampled block; with padded logits of 100 the values still match (the
    port gave inf before) and the port's grads there are 0, where the
    reference's masked exp of an overflowed value gives NaN."""
    rng = np.random.default_rng(0)
    if graph == "padded":
        src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
        gj = jdgl.graph((src, dst), num_nodes=50, pad_edges_to=400)
        gt = tdgl.graph((src, dst), num_nodes=50, pad_edges_to=400,
                        device="cpu")
    else:
        src, dst = rng.integers(0, 500, 4000), rng.integers(0, 500, 4000)
        seeds = np.arange(0, 500, 7)
        _, _, (gj,) = JSampler([5]).sample_blocks(
            jdgl.graph((src, dst), num_nodes=500, formats=("csc",)), seeds,
            rng=np.random.default_rng(1), num_real=60)
        _, _, (gt,) = NeighborSampler([5]).sample_blocks(
            tdgl.graph((src, dst), num_nodes=500, formats=("csc",),
                       device="cpu"), seeds, rng=np.random.default_rng(1),
            num_real=60)
    mask = gt.edge_mask.numpy()
    e_pad = gt.num_edges_padded()
    assert e_pad > gt.num_edges() == int(mask.sum())
    ct = rng.normal(size=(e_pad, 2)).astype(np.float32)
    logits = rng.normal(size=(e_pad, 2)).astype(np.float32)
    jval, jgrad, val, grad = _edge_softmax_both(gj, gt, logits, ct)
    np.testing.assert_allclose(val, jval, rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=1e-6)
    assert not val[~mask].any()

    logits[~mask] = 100.0
    jval, jgrad, val, grad = _edge_softmax_both(gj, gt, logits, ct)
    assert np.isfinite(val).all() and np.isfinite(grad).all()
    np.testing.assert_allclose(val, jval, rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad[mask], jgrad[mask], rtol=0, atol=1e-6)
    assert not val[~mask].any() and not grad[~mask].any()
