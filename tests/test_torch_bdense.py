"""The port's block-dense layout, K11's plain version, the block-dense
engine, ``geometric_graph``, ``rcm_order`` and ``reorder_graph('rcm')``
against the JAX package on the same edges (numpy from a seed), plus the
GCN on a block-dense graph through ``from_jax_params``.

Tolerances: layout arrays, edges and permutations are equal exactly.
K11's plain version against the reference kernel (interpret mode) rtol
1e-5, atol 1e-5: float32 sums of at most 3 x 128 terms in another order.
Engine values and grad_u rtol 1e-4, atol 1e-4 (as tests/test_bdense.py
holds the reference against its oracle). GCN logits rtol 1e-4, atol 1e-5,
grads rtol 1e-4, atol 1e-6, parameters after 3 Adam steps atol 1e-5 (as
tests/test_torch_gcn.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import GCN as JGCN
from dgl1_tpu.ops import engine_bdense as jeb
from dgl1_tpu.ops.engine_bdense import gspmm_bdense as j_gspmm_bdense
from dgl1_tpu_torch.bdense_format import BLK, plan_blocks
from dgl1_tpu_torch.models import GCN
from dgl1_tpu_torch.ops import bdense_kernels as BK
from dgl1_tpu_torch.ops import dispatch
from dgl1_tpu_torch.ops.engine_bdense import gspmm_bdense
from dgl1_tpu_torch.ops.engine_xla import gspmm_xla
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import engines, feats, t

FORMATS = ("coo", "csr", "csc", "ell", "bdense")
N = 400


def band_edges(n=N, e=6000, width=40, seed=0):
    """tests/test_bdense.py's band graph: most blocks dense, a thin tail."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-width, width, e), 0, n - 1)
    return src, dst


def scattered_edges(n=N, e=120, seed=7):
    """No block reaches min_edges: everything on the ELL tail."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def covered_edges(n=N, seed=3):
    """Every edge inside a dense diagonal block: no tail at all."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, -(-n // BLK), 4000)
    src = np.minimum(blk * BLK + rng.integers(0, BLK, 4000), n - 1)
    dst = np.minimum(blk * BLK + rng.integers(0, BLK, 4000), n - 1)
    return src, dst


def banded_scatter_edges(n=N, seed=5):
    """The band plus a scattered minority: both tiers, with multi-edges."""
    s0, d0 = band_edges(n, seed=seed)
    s1, d1 = scattered_edges(n, 300, seed + 1)
    return np.concatenate([s0, s1]), np.concatenate([d0, d1])


EDGES = {"band": band_edges, "tail_only": scattered_edges,
         "covered": covered_edges, "band_scatter": banded_scatter_edges}


def both(name, n=N):
    src, dst = EDGES[name]()
    gj = jdgl.graph((src, dst), num_nodes=n, formats=FORMATS)
    gt = tdgl.graph((src, dst), num_nodes=n, formats=FORMATS, device="cpu")
    return gj, gt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def assert_layout_equal(gj, gt):
    mj, mt = gj.bdense_meta, gt.bdense_meta
    assert tuple(mj) == tuple(mt)
    assert set(gj.bdense) == set(gt.bdense)
    for k in gj.bdense:
        a, b = _np(gj.bdense[k]), _np(gt.bdense[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ("a", "ab"):
        want = torch.bfloat16 if _np(gj.bdense[k]).max(initial=0) <= 256 \
            else torch.float32
        assert gt.bdense[k].dtype == want, k


@pytest.mark.parametrize("name", list(EDGES))
def test_layout_matches_reference(name):
    gj, gt = both(name)
    assert_layout_equal(gj, gt)
    m, e = gt.bdense_meta, gt.num_edges()
    if name == "tail_only":
        assert m.n_blocks == 0 and m.covered == 0
    elif name == "covered":
        assert m.covered == e and gt.bdense["t_src"].numel() == 0
    elif name == "band_scatter":
        assert 0.9 * e < m.covered < e
    else:
        assert m.covered > 0.9 * e
    # The count blocks hold every covered edge once.
    assert float(gt.bdense["a"].double().sum()) == float(m.covered)


def test_plan_blocks_min_edges_and_float32_counts():
    """A block whose counts pass 256 stays float32, as the reference's;
    ``min_edges`` moves blocks between the tiers the same way."""
    src = np.concatenate([np.zeros(300, np.int64), np.arange(200) % 128])
    dst = np.concatenate([np.zeros(300, np.int64), (np.arange(200) * 7)
                          % 256])
    from dgl1_tpu.bdense_format import plan_blocks as jplan

    for min_edges in (None, 1, 150):
        kj, aj, tj = jplan(src, dst, 256, 256, min_edges)
        kt, at, tt = plan_blocks(src, dst, 256, 256, min_edges)
        assert kj == kt
        np.testing.assert_array_equal(tt, tj)
        for k in aj:
            np.testing.assert_array_equal(_np(at[k]), _np(aj[k]), err_msg=k)
        assert at["a"].dtype == torch.float32


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("f", [1, 16, 40])
def test_block_mm_plain_matches_reference_kernel(transpose, f):
    """K11's plain version against ``_block_call`` (interpret mode), masked
    and cut as the reference's ``_dense_dir`` does."""
    gj, gt = both("band_scatter")
    m = gt.bdense_meta
    x = feats(N, f, seed=f)
    static = jeb._Static(num_src=N, num_dst=N, u_feat=(f,),
                         meta=gj.bdense_meta)
    want = np.asarray(jeb._dense_dir(static, gj.bdense, jnp.asarray(x),
                                     transpose))
    bd = gt.bdense
    if transpose:
        got = BK.block_mm(True, bd["ab"], bd["col_ptr"], bd["rbb"], t(x), N)
    else:
        got = BK.block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], t(x), N)
    assert m.n_blocks > 0 and got.shape == (N, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_block_mm_checks_its_inputs():
    _, gt = both("band")
    bd = gt.bdense
    x = t(feats(N, 8))
    with pytest.raises(TypeError):
        BK.block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], x.double(), N)
    with pytest.raises(ValueError, match="runs"):
        BK.block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], x, N + 128)
    with pytest.raises(ValueError, match="must be"):
        BK.block_mm(False, bd["a"][:BLK], bd["row_ptr"], bd["cb"], x, N)
    before = dict(BK.LAUNCHES)
    BK.block_mm(False, bd["a"], bd["row_ptr"], bd["cb"], x, N)
    assert BK.LAUNCHES == before  # the plain version launches nothing


@pytest.mark.parametrize("red", ["sum", "mean"])
@pytest.mark.parametrize("name", ["band_scatter", "tail_only", "covered"])
def test_gspmm_bdense_matches_reference(name, red):
    gj, gt = both(name)
    x = feats(N, 16, seed=2)
    w = feats(N, 16, seed=3)

    def jloss(u):
        return jnp.sum(j_gspmm_bdense(gj, "copy_lhs", red, u, None)
                       * jnp.asarray(w))

    want = np.asarray(j_gspmm_bdense(gj, "copy_lhs", red, jnp.asarray(x),
                                     None))
    gwant = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    u = t(x).requires_grad_(True)
    out = gspmm_bdense(gt, "copy_lhs", red, u, None)
    (gu,) = torch.autograd.grad((out * t(w)).sum(), u)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gu.numpy(), gwant, rtol=1e-4, atol=1e-4)
    # And the oracle on the same graph.
    ref = gspmm_xla(gt, "copy_lhs", red, t(x), None)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_gspmm_bdense_multi_dim_features_and_float64():
    _, gt = both("band_scatter")
    x = torch.from_numpy(feats(N, 12, seed=4)).reshape(N, 3, 4)
    out = gspmm_bdense(gt, "copy_lhs", "sum", x, None)
    ref = gspmm_xla(gt, "copy_lhs", "sum", x, None)
    assert out.shape == (N, 3, 4)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    xd = x.double().requires_grad_(True)
    out = gspmm_bdense(gt, "copy_lhs", "mean", xd, None)
    assert out.dtype == torch.float64
    (g,) = torch.autograd.grad(out.sum(), xd)
    assert g.dtype == torch.float64 and g.shape == xd.shape


def test_gspmm_bdense_declines():
    _, gt = both("band")
    u = t(feats(N, 16))
    e = torch.ones(gt.num_edges(), 16)
    assert gspmm_bdense(gt, "mul", "sum", u, e) is None
    assert gspmm_bdense(gt, "copy_rhs", "sum", None, e) is None
    assert gspmm_bdense(gt, "copy_lhs", "max", u, None) is None
    assert gspmm_bdense(gt, "copy_lhs", "sum", None, None) is None
    assert gspmm_bdense(gt, "copy_lhs", "sum",
                        torch.ones(N, 4, dtype=torch.int32), None) is None
    src, dst = band_edges()
    g_none = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    assert gspmm_bdense(g_none, "copy_lhs", "sum", u, None) is None


def test_default_formats_build_no_bdense():
    """formats=None builds every other layout but never the block-dense
    one, so no existing graph changes engine under the new auto order."""
    src, dst = band_edges()
    g = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    assert g.bdense is None and g.bdense_meta is None
    assert g.ell_dst is not None and g.tdst is not None
    g = tdgl.data.powerlaw_graph(1 << 12, 8, device="cpu")
    assert g.hub_dst is not None and g.bdense is None
    assert tdgl.add_self_loop(g).bdense is None
    assert tdgl.reorder_graph(g, "hub").bdense is None
    assert tdgl.graph((src, dst), num_nodes=N, formats=("coo", "csc", "ell"),
                      device="cpu").bdense is None
    assert dispatch._AUTO_ORDER[0] == "bdense"


def test_auto_dispatch_on_cpu_uses_the_oracle():
    """On CPU tensors "auto" tries no engine (the reference likewise uses
    its oracle off the TPU); the bdense engine is tried first on CUDA."""
    _, gt = both("band_scatter")
    assert dispatch._candidates(False) == []
    assert dispatch._candidates(True)[:2] == ["bdense", "hub"]
    u = t(feats(N, 8, seed=9))
    with engines("xla", "auto"):
        out = tdgl.ops.gspmm(gt, "copy_lhs", "sum", u, None)
    assert torch.equal(out, gspmm_xla(gt, "copy_lhs", "sum", u, None))
    with engines("xla", "bdense"):
        got = tdgl.ops.gspmm(gt, "copy_lhs", "sum", u, None)
        # u_mul_e is not covered and falls through to the oracle.
        e = torch.full((gt.num_edges(), 8), 0.5)
        got2 = tdgl.ops.gspmm(gt, "mul", "sum", u, e)
    torch.testing.assert_close(got, out, rtol=1e-4, atol=1e-4)
    assert torch.equal(got2, gspmm_xla(gt, "mul", "sum", u, e))


def test_graph_to_and_reverse_keep_and_drop_the_layout():
    _, gt = both("band_scatter")
    g2 = gt.to("cpu")
    assert g2.bdense_meta == gt.bdense_meta
    assert set(g2.bdense) == set(gt.bdense)
    assert all(v.device.type == "cpu" for v in g2.bdense.values())
    assert torch.equal(g2.bdense["a"], gt.bdense["a"])
    assert gt.reverse().bdense is None


def test_padded_edges_stay_out_of_the_layout():
    src, dst = band_edges()
    e = len(src)
    g = tdgl.graph((src, dst), num_nodes=N, formats=FORMATS,
                   pad_edges_to=e + 100, device="cpu")
    ref = tdgl.graph((src, dst), num_nodes=N, formats=FORMATS, device="cpu")
    assert g.num_edges_padded() == e + 100
    assert g.bdense_meta == ref.bdense_meta
    for k in ref.bdense:
        assert torch.equal(g.bdense[k], ref.bdense[k]), k
    u = t(feats(N, 8))
    torch.testing.assert_close(gspmm_bdense(g, "copy_lhs", "sum", u, None),
                               gspmm_xla(ref, "copy_lhs", "sum", u, None),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,deg,seed", [(1000, 8, 0), (3000, 4, 2)])
def test_geometric_graph_matches_reference(n, deg, seed):
    from dgl1_tpu.data.synthetic import geometric_graph

    gj = geometric_graph(n, deg, seed=seed, formats=FORMATS)
    gt = tdgl.data.geometric_graph(n, deg, seed=seed, formats=FORMATS,
                                   device="cpu")
    e = gj.num_edges()
    assert gt.num_edges() == e == n * deg
    np.testing.assert_array_equal(gt.src.numpy(), np.asarray(gj.src)[:e])
    np.testing.assert_array_equal(gt.dst.numpy(), np.asarray(gj.dst)[:e])
    assert_layout_equal(gj, gt)
    assert gt.hub_dst is None and gt.bdense_meta.covered > 0.8 * e


def _shuffled_ring_of_cliques(n=2048, csize=64, epc=300, seed=11):
    """tests/test_bdense.py:129's graph: cliques on a ring, ids shuffled."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for c in range(n // csize):
        base = c * csize
        src.append(rng.integers(base, base + csize, epc))
        dst.append(rng.integers(base, base + csize, epc))
    src, dst = np.concatenate(src), np.concatenate(dst)
    shuf = rng.permutation(n)
    return shuf[src], shuf[dst], n, rng


def test_rcm_order_matches_reference():
    src, dst, n, _ = _shuffled_ring_of_cliques()
    gj = jdgl.graph((src, dst), num_nodes=n)
    gt = tdgl.graph((src, dst), num_nodes=n, device="cpu")
    np.testing.assert_array_equal(tdgl.rcm_order(gt), jdgl.rcm_order(gj))
    # A shuffled path: RCM recovers a near-diagonal order.
    p = np.random.default_rng(3).permutation(256)
    s, d = p[:-1], p[1:]
    g = tdgl.graph((np.concatenate([s, d]), np.concatenate([d, s])),
                   num_nodes=256, device="cpu")
    perm = tdgl.rcm_order(g)
    relabel = np.empty(256, np.int64)
    relabel[perm] = np.arange(256)
    assert np.abs(relabel[g.src.numpy()] - relabel[g.dst.numpy()]).max() <= 2


@pytest.mark.parametrize("edge_algo", ["src", "dst"])
def test_reorder_graph_rcm_matches_reference(edge_algo):
    src, dst, n, rng = _shuffled_ring_of_cliques()
    gj = jdgl.graph((src, dst), num_nodes=n, formats=FORMATS)
    gt = tdgl.graph((src, dst), num_nodes=n, formats=FORMATS, device="cpu")
    x = rng.normal(size=(n, 8)).astype(np.float32)
    gt.ndata["x"] = t(x)
    gt.edata["w"] = torch.arange(gt.num_edges(), dtype=torch.float32)
    rj = jdgl.reorder_graph(gj, node_permute_algo="rcm",
                            edge_permute_algo=edge_algo, formats=FORMATS)
    rt = tdgl.reorder_graph(gt, node_permute_algo="rcm",
                            edge_permute_algo=edge_algo, formats=FORMATS)
    e = gt.num_edges()
    for k in ("_ID",):
        np.testing.assert_array_equal(rt.ndata[k].numpy(),
                                      np.asarray(rj.ndata[k]))
        np.testing.assert_array_equal(rt.edata[k].numpy(),
                                      np.asarray(rj.edata[k]))
    np.testing.assert_array_equal(rt.src.numpy(), np.asarray(rj.src)[:e])
    np.testing.assert_array_equal(rt.dst.numpy(), np.asarray(rj.dst)[:e])
    assert_layout_equal(rj, rt)
    perm = rt.ndata["_ID"].long()
    assert torch.equal(rt.ndata["x"], gt.ndata["x"][perm])
    assert torch.equal(rt.edata["w"], rt.edata["_ID"].float())
    # Coverage recovered, and the same aggregate mapped back through _ID.
    before = gt.bdense_meta.covered / e
    after = rt.bdense_meta.covered / e
    assert after > max(before, 0.5)
    out_new = gspmm_bdense(rt, "copy_lhs", "sum", t(x)[perm], None)
    out_old = gspmm_xla(gt, "copy_lhs", "sum", t(x), None)
    torch.testing.assert_close(out_new, out_old[perm], rtol=1e-4, atol=1e-4)


def test_reorder_graph_custom_and_errors():
    src, dst = band_edges()
    g = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    ident = tdgl.reorder_graph(
        g, node_permute_algo="custom", edge_permute_algo="custom",
        permute_config={"nodes_perm": np.arange(N),
                        "edges_perm": np.arange(g.num_edges())})
    np.testing.assert_array_equal(ident.src.numpy(), src)
    np.testing.assert_array_equal(ident.dst.numpy(), dst)
    assert ident.bdense is None
    np.testing.assert_array_equal(ident.edata["_ID"].numpy(),
                                  np.arange(g.num_edges()))
    # 'metis' orders nodes by the partitioner's parts, as the reference.
    gj = jdgl.graph((src, dst), num_nodes=N)
    for k in (2, 4):
        cfg = {"k": k}
        rj = jdgl.reorder_graph(gj, node_permute_algo="metis",
                                permute_config=cfg)
        rt = tdgl.reorder_graph(g, node_permute_algo="metis",
                                permute_config=cfg)
        np.testing.assert_array_equal(rt.ndata["_ID"].numpy(),
                                      np.asarray(rj.ndata["_ID"]))
        np.testing.assert_array_equal(rt.src.numpy(), np.asarray(rj.src))
        np.testing.assert_array_equal(rt.dst.numpy(), np.asarray(rj.dst))
    with pytest.raises(ValueError, match="edge_permute_algo"):
        tdgl.reorder_graph(g, "rcm", edge_permute_algo="random")


def _gcn_setup():
    gj, gt = both("band_scatter")
    x = feats(N, 12, seed=31)
    labels = np.random.default_rng(32).integers(0, 5, N).astype(np.int32)
    jmodel = JGCN(hidden_feats=16, out_feats=5, dropout=0.0)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), gj,
                                                  jnp.asarray(x)))
    tmodel = GCN(12, 16, 5, dropout=0.0, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))

    def jloss(p):
        logits = jmodel.apply(p, gj, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits
    return gt, x, labels, params, tmodel, jax.jit(
        jax.value_and_grad(jloss, has_aux=True))


def test_gcn_on_bdense_graph_matches_reference():
    """Both packages on their block-dense engines (the reference's K11 in
    interpret mode, the port's plain K11): logits and every grad."""
    gt, x, labels, params, tmodel, jfn = _gcn_setup()
    with engines("bdense", "bdense"):
        (_, want), jgrads = jfn(params)
        logits = tmodel(gt, t(x))
        torch.nn.functional.cross_entropy(logits,
                                          t(labels).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    tg = dict(tmodel.named_parameters())
    assert set(jg) == set(tg)
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].grad.numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_gcn_adam_steps_on_bdense_graph_match_reference():
    gt, x, labels, params, tmodel, jfn = _gcn_setup()
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jlosses = []
    with engines("bdense", "bdense"):
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


def test_reorder_graph_takes_the_reference_signature():
    """The reference's parameters in its order and with its defaults
    (``'metis'`` first: the reference's permutation at its default 8
    parts); ``store_ids=False`` leaves no ``_ID``."""
    import inspect

    sig_t = inspect.signature(tdgl.reorder_graph)
    sig_j = inspect.signature(jdgl.reorder_graph)
    assert [(p.name, p.default) for p in sig_t.parameters.values()] == [
        (p.name, p.default) for p in sig_j.parameters.values()]
    src, dst = band_edges()
    g = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    np.testing.assert_array_equal(
        tdgl.reorder_graph(g).ndata["_ID"].numpy(),
        np.asarray(jdgl.reorder_graph(
            jdgl.graph((src, dst), num_nodes=N)).ndata["_ID"]))
    kept = tdgl.reorder_graph(g, "rcm")
    bare = tdgl.reorder_graph(g, "rcm", "src", False)
    assert "_ID" in kept.ndata and "_ID" in kept.edata
    assert "_ID" not in bare.ndata and "_ID" not in bare.edata
    np.testing.assert_array_equal(bare.src.numpy(), kept.src.numpy())
    np.testing.assert_array_equal(bare.dst.numpy(), kept.dst.numpy())
