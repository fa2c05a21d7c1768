"""The bf16 matmul mode (``ops/precision.py``) in the port against the JAX
package, on the CPU.

* The API: ``"f32"`` by default, ``DGL1_TPU_MATMUL_PRECISION`` read at
  import (an invalid value falls back to ``"f32"``), the context manager
  restores the mode, an invalid ``set_matmul_precision`` raises.
* Kernel level: each reference call that takes a compute dtype
  (``_dense_fwd_call``, ``_chunk_call`` plain/mul/rhs, both
  ``_dense_bwd*`` calls, ``_edge_grad_call`` mul/rhs, ``_block_call``
  through ``_dense_dir``, ``_attn_fwd_call`` and ``_attn_bwd_call`` in
  both modes) in interpret mode with ``dt=bfloat16`` against the port's
  plain version in bf16 mode, on the same arrays. K1, K2, K4, K5 and K11
  within rtol 1e-5 (atol 1e-5 of the output's largest value): both round
  the same float32 operands and sum in float32 in another order. K6 and
  K7 element by element within 1e-5 of the same sums over absolute
  values, but for at most FLIP_SHARE of the elements: their rounded
  operands include ``exp`` values, which the two libraries may compute a
  float32 ulp apart, and one such ulp can move a value to the other
  bfloat16 neighbour. Each case also shows that bf16 differs from f32 (by
  more than 1e-4 of the largest value); for K6 and K7 the float32 plain
  version must fail the same check wherever it differs.
* Model level: GCN, GAT and R-GCN (per-relation path) logits and every
  parameter's grad under ``matmul_precision("bf16")`` in both packages,
  at the reference's own bf16 tolerances (tests/test_attention.py:131-157,
  tests/test_bdense.py:242-252): rtol 5e-2, atol 5e-2 on values and rtol
  8e-2, atol 1.5e-1 on grads.
* ``rand_graph`` against the reference's, and the ``bench_models``
  counterpart on the CPU: its JSON keys, its unported R-GCN flags, the
  ``--precision`` flag.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import GAT as JGAT
from dgl1_tpu.models import GCN as JGCN
from dgl1_tpu.models import RGCN as JRGCN
from dgl1_tpu.ops import attention as ref_att
from dgl1_tpu.ops import engine_bdense as ref_bd
from dgl1_tpu.ops import engine_hub as ref_hub
from dgl1_tpu.ops.precision import matmul_precision as j_precision
from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.models import GAT, GCN, RGCN
from dgl1_tpu_torch.ops import attn_kernels as AK
from dgl1_tpu_torch.ops import bdense_kernels as BK
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops import precision as P
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, make, skewed_edges, t

F = 10
F_PAD = 128
SLOPE = 0.2
SEED = np.array([-1234567891], np.int32)
BF16 = jnp.bfloat16
# K6 and K7 round exp values to bf16: where the two libraries' float32 exp
# straddle a bf16 rounding boundary the two round to neighbours, a flip
# that can pass 1e-5 of a row with few terms. At most this share of an
# output's elements may.
FLIP_SHARE = 1e-3


def _pad(x, rows, cols=F_PAD):
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _jlay(hub, name):
    return {k: jnp.asarray(v) for k, v in hub[name].items()}


def _tlay(hub, name):
    return {k: t(v) for k, v in hub[name].items()}


def _cdtype(c):
    return {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(
        np.asarray(c).dtype.name, torch.float32)


def _close(got, want, f32):
    """rtol 1e-5 against the reference, and bf16 moved the result."""
    got, want, f32 = (np.asarray(x, np.float32) for x in (got, want, f32))
    scale = np.abs(want).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert np.abs(got - f32).max(initial=0.0) > 1e-4 * scale


def _close_exp(got, want, f32, scale, msg=""):
    """Within 1e-5 of ``scale`` (the same sums over absolute values) but
    for at most FLIP_SHARE of the elements, and the float32 version, where
    it differs from ``got``, fails the same check."""
    got, want, f32, scale = (np.asarray(x, np.float64)
                             for x in (got, want, f32, scale))
    assert got.shape == want.shape, msg
    tol = 1e-5 * scale + 1e-6
    allowed = int(FLIP_SHARE * got.size)
    n_past = int((np.abs(got - want) > tol).sum())
    assert n_past <= allowed, (msg, n_past, allowed)
    n_f32 = int((np.abs(f32 - want) > tol).sum())
    assert np.array_equal(got, f32) or n_f32 > allowed, (msg, n_f32)
    assert np.abs(got - f32).max(initial=0.0) > 1e-4 * np.abs(want).max(
        initial=0.0), msg


# ----------------------------------------------------------------------
# The API
# ----------------------------------------------------------------------

def test_precision_api(monkeypatch):
    assert tdgl.ops.get_matmul_precision() == "f32"
    with tdgl.ops.matmul_precision("bf16"):
        assert tdgl.ops.get_matmul_precision() == "bf16"
        with pytest.raises(ValueError):
            with tdgl.ops.matmul_precision("fp8"):
                pass
        assert tdgl.ops.get_matmul_precision() == "bf16"
    assert tdgl.ops.get_matmul_precision() == "f32"
    with pytest.raises(ValueError, match="one of"):
        tdgl.ops.set_matmul_precision("tf32")
    try:
        for value, want in (("bf16", "bf16"), ("f16", "f32"), ("f32", "f32")):
            monkeypatch.setenv("DGL1_TPU_MATMUL_PRECISION", value)
            assert importlib.reload(P).get_matmul_precision() == want
        # The engines read the mode through the module they imported.
        monkeypatch.setenv("DGL1_TPU_MATMUL_PRECISION", "bf16")
        importlib.reload(P)
        from dgl1_tpu_torch.ops import engine_hub
        assert engine_hub.get_matmul_precision() == "bf16"
    finally:
        monkeypatch.delenv("DGL1_TPU_MATMUL_PRECISION")
        importlib.reload(P)
    assert tdgl.ops.get_matmul_precision() == "f32"


def test_round_bf16_is_nearest_even_through_float32():
    x = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 257.0, 300.0,
                      -1.0 - 2 ** -8], dtype=torch.float64)
    np.testing.assert_array_equal(
        P.round_bf16(x).numpy(), [1.0, 1.0 + 2 ** -6, 256.0, 300.0, -1.0])
    # float64 goes through float32 first, as a kernel's float32 would.
    y = torch.tensor([1.0 + 2 ** -8 + 2 ** -30], dtype=torch.float64)
    assert float(P.round_bf16(y)) == 1.0


# ----------------------------------------------------------------------
# Kernel level: the plain versions against the reference's calls
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    gj, _ = make("mixed", self_loops=True)
    return gj


def test_dense_kernels_bf16_match_reference(mixed):
    """K1, K4a and K4b; also a count matrix with counts above 256, which
    bf16 rounds (257 -> 256) in both packages."""
    hub, m = mixed.hub_dst, mixed.hub_dst_meta
    c = hub["dense_c"]
    tc = t(c, np.float32).to(_cdtype(c))
    u = _pad(feats(mixed.num_nodes(), F), c.shape[0])
    want = ref_hub._dense_fwd_call(jnp.asarray(c), jnp.asarray(u), BF16)
    _close(K.dense_fwd(tc, t(u), bf16=True), want, K.dense_fwd(tc, t(u)))

    big = np.zeros((1024, 128), np.float32)
    big[:300, :4] = np.random.default_rng(3).integers(250, 300, (300, 4))
    want = ref_hub._dense_fwd_call(jnp.asarray(big), jnp.asarray(
        _pad(feats(1024, F, seed=2), 1024)), BF16)
    got = K.dense_fwd(t(big), t(_pad(feats(1024, F, seed=2), 1024)),
                      bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

    ct = _pad(feats(m.n_dense * BLK, F, seed=8), m.n_dense * BLK)
    want = ref_hub._dense_bwd_call(jnp.asarray(c), jnp.asarray(ct), BF16)
    _close(K.dense_bwd(tc, t(ct), bf16=True), want, K.dense_bwd(tc, t(ct)))

    n_rows = int(sum(n for _, n in m.tail_meta_src))
    tail2 = _pad(feats(n_rows, F, seed=6), -(-max(n_rows, 1) // 32) * 32)
    args = (t(tail2), t(hub["gb_starts"]), t(hub["gb_desc"]))
    want = ref_hub._dense_bwd_fused_call(
        jnp.asarray(c), jnp.asarray(ct), jnp.asarray(tail2),
        jnp.asarray(hub["gb_starts"]), jnp.asarray(hub["gb_desc"]), BF16)
    _close(K.dense_bwd_fused(tc, t(ct), *args, bf16=True), want,
           K.dense_bwd_fused(tc, t(ct), *args))


def _covered(out_id, n_out_blocks):
    blocks = np.unique(np.asarray(out_id))
    rows = (blocks[:, None] * BLK + np.arange(BLK)[None]).reshape(-1)
    return rows[rows < n_out_blocks * BLK]


def test_chunk_sum_bf16_matches_reference(mixed):
    hub, m = mixed.hub_dst, mixed.hub_dst_meta
    assert m.n_groups > m.n_dense
    u = _pad(feats(mixed.num_nodes(), F), hub["dense_c"].shape[0])
    n_out = m.n_groups - m.n_dense
    want = np.asarray(ref_hub._chunk_call(
        "plain", _jlay(hub, "part_fwd"), None, None, jnp.asarray(u), n_out,
        F_PAD, BF16))
    rows = _covered(hub["part_fwd"]["out_id"], n_out)
    lay = _tlay(hub, "part_fwd")
    _close(K.chunk_sum(lay, t(u), n_out, bf16=True).numpy()[rows],
           want[rows], K.chunk_sum(lay, t(u), n_out).numpy()[rows])


@pytest.mark.parametrize("mode,he,rep", [("mul", 1, 10), ("mul", 4, 3),
                                         ("rhs", 4, 1)])
def test_weighted_kernels_bf16_match_reference(mixed, mode, he, rep):
    """K2 mul/rhs over both full layouts (rhs: the forward one) and K5."""
    hub, m = mixed.hub_dst, mixed.hub_dst_meta
    n, ne = mixed.num_nodes(), mixed.num_edges_padded()
    e2 = feats(ne, he, seed=3)
    width = he * rep if mode == "mul" else he
    rows_pad = hub["dense_c"].shape[0]
    r = ref_hub._replication_r(mode, he, rep, F_PAD)
    u = feats(n, width, seed=4)
    cases = [("full_fwd", _pad(u, rows_pad), m.n_groups, n)]
    if mode == "mul":
        ct_in = feats(m.n_groups * BLK, width, seed=5)
        cases.append(("full_bwd", _pad(ct_in, len(ct_in)), m.n_win,
                      len(ct_in)))
    for name, inp, n_out, n_in in cases:
        lay = _jlay(hub, name)
        wt = ref_hub._weights_t(jnp.asarray(e2), he, lay["eid"])
        want = np.asarray(ref_hub._chunk_call(
            mode, lay, wt, r, jnp.asarray(inp) if mode == "mul" else None,
            n_out, F_PAD, BF16))[:, :width]
        x = t(inp[:n_in, :width]) if mode == "mul" else None
        args = (mode, _tlay(hub, name), t(e2), x, n_out, he, rep)
        rows = _covered(hub[name]["out_id"], n_out)
        _close(K.chunk_weighted(*args, bf16=True).numpy()[rows], want[rows],
               K.chunk_weighted(*args).numpy()[rows])

    ct = feats(m.n_groups * BLK, width, seed=7)
    want = np.asarray(ref_hub._edge_grad_call(
        mode, _jlay(hub, "full_fwd"), r, jnp.asarray(_pad(u, rows_pad)),
        jnp.asarray(_pad(ct, len(ct))), F_PAD, BF16))[:he].T
    args = (mode, _tlay(hub, "full_fwd"), t(u) if mode == "mul" else None,
            t(ct), he, rep)
    got = K.edge_grad(*args, bf16=True)
    if mode == "mul":
        _close(got, want, K.edge_grad(*args))
    else:
        # rhs only gathers ct: bf16 rounds it, the sums are one term each.
        np.testing.assert_array_equal(got.numpy(), want)
        assert not torch.equal(got, K.edge_grad(*args))


@pytest.mark.parametrize("transpose", [False, True])
def test_block_mm_bf16_matches_reference(transpose):
    rng = np.random.default_rng(5)
    n = 400
    src = rng.integers(0, n, 6000)
    dst = np.clip(src + rng.integers(-40, 40, 6000), 0, n - 1)
    fmt = ("coo", "csr", "csc", "ell", "bdense")
    gj = jdgl.graph((src, dst), num_nodes=n, formats=fmt)
    gt = tdgl.graph((src, dst), num_nodes=n, formats=fmt, device="cpu")
    x = feats(n, 40, seed=9)
    static = ref_bd._Static(num_src=n, num_dst=n, u_feat=(40,),
                            meta=gj.bdense_meta, prec="bf16")
    want = ref_bd._dense_dir(static, gj.bdense, jnp.asarray(x), transpose)
    bd = gt.bdense
    args = ((True, bd["ab"], bd["col_ptr"], bd["rbb"]) if transpose
            else (False, bd["a"], bd["row_ptr"], bd["cb"]))
    _close(BK.block_mm(*args, t(x), n, bf16=True), want,
           BK.block_mm(*args, t(x), n))


def _hub_rows(x, hub_ids, n_groups):
    ids = np.asarray(hub_ids).astype(np.int64)
    ok = ids < x.shape[0]
    rows = np.where(ok[:, None], x[np.minimum(ids, x.shape[0] - 1)], 0.0)
    return rows[: n_groups * BLK].astype(np.float32)


def attn_inputs(g, h, d, seed):
    """Random el, er, ft, lse, rho, ct (numpy) and their hub rows."""
    hub, m = g.hub_dst, g.hub_dst_meta
    n, f = g.num_nodes(), h * d
    rng = np.random.default_rng(seed)
    el, er = (rng.normal(size=(n, h)).astype(np.float32) for _ in range(2))
    ft = rng.normal(size=(n, f)).astype(np.float32)
    lse = (rng.normal(size=(n, h)) + 3.0).astype(np.float32)
    rho = rng.normal(size=(n, h)).astype(np.float32)
    ct = rng.normal(size=(n, f)).astype(np.float32)
    grp = {k: _hub_rows(x, hub["hub_ids"], m.n_groups)
           for k, x in (("er", er), ("lse", lse), ("rho", rho), ("ct", ct))}
    return el, ft, grp


def ref_group_blocks(grp, h, g_rows):
    """The reference's packed [er | lse | rho] block when 3h <= 128, else
    the three blocks."""
    if 3 * h <= BLK:
        return (jnp.asarray(_pad(np.concatenate(
            [grp["er"], grp["lse"], grp["rho"]], 1), g_rows, BLK)),)
    return tuple(jnp.asarray(_pad(grp[k], g_rows, BLK))
                 for k in ("er", "lse", "rho"))


# (heads, head width, dropout): 3h > 128 takes the reference's unpacked
# group blocks, whose lse and rho bf16 rounds.
@pytest.mark.parametrize("h,d,drop", [(8, 32, 0.6), (50, 4, 0.0)])
def test_attention_kernels_bf16_match_reference(mixed, h, d, drop):
    """K6, K7 src and K7 g-major: each output against the reference's, with
    the tolerance scaled by the same sums over |ft|, |ct| and -|rho|."""
    g = mixed
    hub, m = g.hub_dst, g.hub_dst_meta
    # Several chunks per group: the online softmax rescales between them.
    assert len(hub["full_fwd"]["in_id"]) > m.n_groups
    f, f_pad = h * d, -(-h * d // BLK) * BLK
    rows_pad, g_rows = hub["dense_c"].shape[0], m.n_groups * BLK
    el, ft, grp = attn_inputs(g, h, d, seed=h)
    seed = jnp.asarray(SEED)
    el_p = jnp.asarray(_pad(el, rows_pad, BLK))
    ft_p = jnp.asarray(_pad(ft, rows_pad, f_pad))

    num, den, mraw = ref_att._attn_fwd_call(
        SLOPE, _jlay(hub, "full_fwd"), el_p,
        jnp.asarray(_pad(grp["er"], g_rows, BLK)), ft_p,
        ref_att._replication_r(h, d, f_pad), m.n_groups, f_pad, BF16, drop,
        seed, h=h)
    args = (_tlay(hub, "full_fwd"), t(el), t(grp["er"]), t(ft), h, d, SLOPE,
            drop, t(SEED), m.n_groups)
    got, f32 = AK.attn_fwd(*args, bf16=True), AK.attn_fwd(*args)
    scale = AK.attn_fwd(*args[:3], t(ft).abs(), *args[4:], bf16=True)
    _close_exp(got[0], np.asarray(num)[:, :f], f32[0], scale[0], "num")
    _close_exp(got[1], np.asarray(den)[:, :h], f32[1], got[1], "den")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(mraw)[:, :h])

    group = (t(grp["er"]), t(grp["lse"]), t(grp["rho"]), t(ft), t(grp["ct"]))
    abs_group = (group[0], group[1], -group[2].abs(), group[3].abs(),
                 group[4].abs())
    tail = (h, d, SLOPE, drop, t(SEED))
    ct_p = jnp.asarray(_pad(grp["ct"], g_rows, f_pad))
    gft, gel, gerp = ref_att._attn_bwd_call(
        SLOPE, True, _jlay(hub, "full_bwd"), el_p,
        ref_group_blocks(grp, h, g_rows), ft_p, ct_p, h, d, m.n_win, f_pad,
        BF16, drop, seed)
    lay = _tlay(hub, "full_bwd")
    got = AK.attn_bwd_src(lay, t(el), *group, *tail, m.n_win, bf16=True)
    f32 = AK.attn_bwd_src(lay, t(el), *group, *tail, m.n_win)
    scale = AK.attn_bwd_src(lay, t(el), *abs_group, *tail, m.n_win,
                            bf16=True)
    win = np.repeat(np.asarray(hub["win_mask_full"]), BLK)
    for i, (name, want, w) in enumerate((("gft", gft, f), ("gel", gel, h),
                                         ("gerp", gerp, h))):
        rows = win if i < 2 else slice(None)
        _close_exp(got[i].numpy()[rows], np.asarray(want)[rows, :w],
                   f32[i].numpy()[rows], scale[i].numpy()[rows], name)

    (ger,) = ref_att._attn_bwd_call(
        SLOPE, False, _jlay(hub, "full_fwd"), el_p,
        ref_group_blocks(grp, h, g_rows), ft_p, ct_p, h, d, m.n_groups,
        f_pad, BF16, drop, seed)
    lay = _tlay(hub, "full_fwd")
    got = AK.attn_bwd_grp(lay, t(el), *group, *tail, m.n_groups, bf16=True)
    f32 = AK.attn_bwd_grp(lay, t(el), *group, *tail, m.n_groups)
    scale = AK.attn_bwd_grp(lay, t(el), *abs_group, *tail, m.n_groups,
                            bf16=True)
    rows = _covered(hub["full_fwd"]["out_id"], m.n_groups)
    _close_exp(got.numpy()[rows], np.asarray(ger)[rows, :h],
               f32.numpy()[rows], scale.numpy()[rows], "grad_er")


def test_attn_fwd_bf16_online_factors_follow_the_chunk_order():
    """Two chunks of one group whose second raises the max: its scale
    multiplies the first chunk's terms (den by the float32 scale, num by
    the scale rounded to bf16), and the p of the first chunk is taken
    against the first chunk's max."""
    lay = {"a": torch.tensor([0, 1, -1, -1], dtype=torch.int32),
           "b": torch.tensor([0, 0, -1, -1], dtype=torch.int32),
           "eid": torch.tensor([0, 1, -1, -1], dtype=torch.int32),
           "in_id": torch.tensor([0, 1], dtype=torch.int32),
           "out_id": torch.tensor([0, 0], dtype=torch.int32)}
    lay["a"][2], lay["b"][2], lay["eid"][2] = 0, 0, 2  # chunk 1, slot 0
    el = torch.zeros((256, 1), dtype=torch.float64)
    el[0, 0], el[1, 0], el[128, 0] = 0.3, -0.1, 1.7
    er_g = torch.zeros((128, 1), dtype=torch.float64)
    er_g[0, 0] = 0.45
    ft = torch.full((256, 1), 1.37, dtype=torch.float64)
    num, den, mraw = AK.attn_fwd_torch(lay, el, er_g, ft, 1, 1, SLOPE, 0.0,
                                       None, 1, bf16=True)
    lk = lambda x: torch.nn.functional.leaky_relu(  # noqa: E731
        torch.tensor(x, dtype=torch.float64), SLOPE)
    r = P.round_bf16
    p0 = [torch.exp(lk(0.45 + v) - lk(0.45 + 0.3)) for v in (0.3, -0.1)]
    p1 = torch.exp(lk(0.45 + 1.7) - lk(0.45 + 1.7))
    scale = torch.exp(lk(0.45 + 0.3) - lk(0.45 + 1.7))
    rft = r(torch.tensor(1.37, dtype=torch.float64))
    want_den = (r(p0[0]) + r(p0[1])) * scale + r(p1)
    want_num = (r(r(p0[0]) * rft) + r(r(p0[1]) * rft)) * r(scale) \
        + r(r(p1) * rft)
    assert float(mraw[0, 0]) == pytest.approx(1.7)
    assert float(den[0, 0]) == pytest.approx(float(want_den), rel=1e-12)
    assert float(num[0, 0]) == pytest.approx(float(want_num), rel=1e-12)


# ----------------------------------------------------------------------
# Model level
# ----------------------------------------------------------------------

VAL = dict(rtol=5e-2, atol=5e-2)
GRAD = dict(rtol=8e-2, atol=1.5e-1)


def _compare(logits, want, model, jgrads):
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               **VAL)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(jg) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(),
                                   err_msg=k, **GRAD)


def _xent(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(labels)).mean()


@pytest.mark.parametrize("model_name", ["gcn", "gat"])
def test_models_bf16_match_reference(model_name):
    gj, gt = make("mixed", self_loops=True)
    n, in_f = gt.num_nodes(), 16
    x = feats(n, in_f, seed=11)
    labels = np.random.default_rng(12).integers(0, 7, n).astype(np.int32)
    if model_name == "gcn":
        jmodel = JGCN(hidden_feats=32, out_feats=7, dropout=0.0)
        tmodel = GCN(in_f, 32, 7, dropout=0.0, device="cpu")
        eng = "hub"
    else:
        jmodel = JGAT(hidden_feats=8, out_feats=7, heads=4, feat_drop=0.0,
                      attn_drop=0.0)
        tmodel = GAT(in_f, 8, 7, heads=4, feat_drop=0.0, attn_drop=0.0,
                     device="cpu")
        eng = "xla"  # the attention is fused either way
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  gj, jnp.asarray(x)))
    tmodel.load_state_dict(from_jax_params(params))
    with engines(eng, eng), j_precision("bf16"), \
            tdgl.ops.matmul_precision("bf16"):
        loss = lambda p: _xent(jmodel.apply(p, gj, jnp.asarray(x)),  # noqa
                               labels)
        want = jmodel.apply(params, gj, jnp.asarray(x))
        jgrads = jax.grad(loss)(params)
        logits = tmodel(gt, t(x))
        torch.nn.functional.cross_entropy(logits,
                                          t(labels).long()).backward()
    _compare(logits, want, tmodel, jgrads)


def test_rgcn_bf16_matches_reference():
    n, r = 300, 4
    src, dst = skewed_edges()
    et = np.random.default_rng(3).integers(0, r, len(src)).astype(np.int32)
    hub = dict(hub=300, hub_dense_floor=1000)
    gj = jdgl.graph((src, dst), num_nodes=n, **hub)
    gt = tdgl.graph((src, dst), num_nodes=n, device="cpu", **hub)
    jrel = jdgl.typed_subgraphs(gj, et, r)
    trel = tdgl.typed_subgraphs(gt, et, r)
    x = feats(n, 6, seed=8)
    labels = np.random.default_rng(9).integers(0, 3, n).astype(np.int32)
    jmodel = JRGCN(num_nodes=n, hidden_feats=8, out_feats=3, num_rels=r,
                   num_bases=2)
    with engines("hub", "hub"), j_precision("bf16"), \
            tdgl.ops.matmul_precision("bf16"):
        params = jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(0), gj, None, jnp.asarray(x),
            rel_graphs=jrel))
        model = RGCN(n, 8, 3, r, num_bases=2, in_feats=6, device="cpu")
        model.load_state_dict(from_jax_params(params))
        fwd = lambda p: jmodel.apply(p, gj, None, jnp.asarray(x),  # noqa
                                     rel_graphs=jrel)
        want = fwd(params)
        jgrads = jax.grad(lambda p: _xent(fwd(p), labels))(params)
        logits = model(gt, None, t(x), rel_graphs=trel)
        torch.nn.functional.cross_entropy(logits,
                                          t(labels).long()).backward()
    _compare(logits, want, model, jgrads)


# ----------------------------------------------------------------------
# The bench_models counterpart
# ----------------------------------------------------------------------

def test_rand_graph_matches_reference():
    gj = jdgl.rand_graph(2708, 10832, seed=0)
    gt = tdgl.rand_graph(2708, 10832, seed=0, device="cpu")
    for a, b in zip(gt.edges(), gj.edges()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:10832])


def test_bench_models_prints_the_reference_keys(capsys):
    from dgl1_tpu_torch.tools import bench_models as bm

    rec = bm.bench("gcn", "cora", epochs=2, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"model", "scale", "nodes", "edges", "hidden",
                         "ms_per_epoch", "epochs_per_s", "compile_s",
                         "backend"}
    assert (line["model"], line["scale"], line["nodes"], line["edges"],
            line["hidden"], line["backend"]) == ("gcn", "cora", 2708,
                                                 10832 + 2708, 64, "cpu")
    assert rec["steps"] == 3 and len(rec["losses"]) == 3
    assert all(np.isfinite(rec["losses"]))
    # R-GCN's --union and --huborder at a small scale (2,000 nodes, the
    # arxiv degree, so the union block's 16,000 sources still earn a hub
    # group): every layout claims identity_expand (rgcn_graphs asserts
    # it), the reference's model names, finite losses.
    for flag, name in (("union", "rgcn+union"), ("huborder",
                                                 "rgcn+identity")):
        graphs = bm.rgcn_graphs("cpu", nodes=2000, **{flag: True})
        capsys.readouterr()
        rec = bm.bench("rgcn", "arxiv", epochs=1, device="cpu",
                       graph=graphs, **{flag: True})
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (line["model"], line["nodes"]) == (name, 2000)
        assert rec["steps"] == 2 and all(np.isfinite(rec["losses"]))
    # The CLI sets the matmul mode, as the reference's does.
    try:
        bm.main(["--scale", "cora", "--model", "gcn", "--epochs", "1",
                 "--device", "cpu", "--precision", "bf16"])
        assert tdgl.ops.get_matmul_precision() == "bf16"
    finally:
        tdgl.ops.set_matmul_precision("f32")
