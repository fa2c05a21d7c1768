"""The port's convs (``DotGatConv`` to ``HGTConv``), the ``nn/utils.py``
modules, the GRU mapping of ``from_jax_params`` and ``DGI`` against the
reference with the same weights (``from_jax_params``), on the same numpy
inputs: the output, the gradient of ``sum(out * ct)`` (a fixed random
cotangent) with respect to each float input and every parameter.

The reference runs on its oracle engine (XLA, the CPU). The port runs on
its oracle too, and the hub cases force the port's hub engine (its
kernels' plain versions here) on a graph with a hub layout, so each
conv's g-SpMMs go through the path the card takes. The port's modules
run in eval mode (no dropout), the reference's deterministic default.
Tolerance: rtol 1e-4,
atol 1e-5 on values and grads (float32 sums in another order), unless a
case says otherwise."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import nn as jnn
from dgl1_tpu import models as jmodels
from dgl1_tpu_torch import nn as tnn
from dgl1_tpu_torch import models as tmodels
from dgl1_tpu_torch.nn.conv import dense
from dgl1_tpu_torch.params import from_jax_params
from torch_parity import (both_graphs, close, module_pair as run, rand,
                          skewed_edges)

KEY = jax.random.PRNGKey(0)
N, E, F = 12, 48, 6
CPU = dict(device="cpu")


def graphs(n=N, e=E, seed=1, self_loop=False):
    gj = jdgl.rand_graph(n, e, seed=seed)
    gt = tdgl.rand_graph(n, e, seed=seed, device="cpu")
    if self_loop:
        gj, gt = jdgl.add_self_loop(gj), tdgl.add_self_loop(gt)
    return gj, gt


def hub_graphs(self_loop=False):
    """torch_parity's 300-node skewed graph with hub floors that give it a
    dense and a chunked tier."""
    src, dst = skewed_edges()
    gj, gt = both_graphs(src, dst, 300, self_loops=self_loop, hub=300,
                         hub_dense_floor=1000)
    assert gt.hub_dst is not None
    return gj, gt


def edge_feats(g, width, seed=4):
    return rand((g.num_edges_padded(), width), seed)


# name -> (reference module, port module, self loops, extra inputs of
# (graph) -> list, grad_of)
CASES = {
    "dotgat": lambda: (jnn.DotGatConv(4, num_heads=3),
                       tnn.DotGatConv(F, 4, num_heads=3, **CPU)),
    "gin_sum_eps": lambda: (
        jnn.GINConv(learn_eps=True, init_eps=0.1),
        tnn.GINConv(learn_eps=True, init_eps=0.1, **CPU)),
    "gin_max": lambda: (jnn.GINConv(aggregator_type="max"),
                        tnn.GINConv(aggregator_type="max", **CPU)),
    "gin_mean_mlp": lambda: (
        jnn.GINConv(apply_func=fnn.Dense(5), aggregator_type="mean"),
        tnn.GINConv(apply_func=dense(F, 5, **CPU), aggregator_type="mean",
                    **CPU)),
    "sgconv": lambda: (jnn.SGConv(5, k=2), tnn.SGConv(F, 5, k=2, **CPU)),
    "appnp": lambda: (jnn.APPNPConv(k=3), tnn.APPNPConv(k=3, **CPU)),
    "tagconv": lambda: (jnn.TAGConv(5, k=2), tnn.TAGConv(F, 5, k=2, **CPU)),
    "chebconv": lambda: (jnn.ChebConv(5, k=3),
                         tnn.ChebConv(F, 5, k=3, **CPU)),
    "edgeconv": lambda: (jnn.EdgeConv(5), tnn.EdgeConv(F, 5, **CPU)),
    "gated": lambda: (jnn.GatedGraphConv(8, n_steps=2),
                      tnn.GatedGraphConv(F, 8, n_steps=2, **CPU)),
    "agnn": lambda: (jnn.AGNNConv(), tnn.AGNNConv(**CPU)),
    "agnn_fixed_beta": lambda: (jnn.AGNNConv(init_beta=0.5, learn_beta=False),
                                tnn.AGNNConv(0.5, learn_beta=False, **CPU)),
    "gatv2": lambda: (jnn.GATv2Conv(4, num_heads=2, residual=True),
                      tnn.GATv2Conv(F, 4, num_heads=2, residual=True, **CPU)),
    "gatv2_shared": lambda: (
        jnn.GATv2Conv(4, num_heads=2, share_weights=True),
        tnn.GATv2Conv(F, 4, num_heads=2, share_weights=True, **CPU)),
    "pna": lambda: (jnn.PNAConv(6, num_towers=2, delta=1.3),
                    tnn.PNAConv(F, 6, num_towers=2, delta=1.3, **CPU)),
    "pna_sum_var": lambda: (
        jnn.PNAConv(6, aggregators=("sum", "var"), scalers=("identity",
                                                           "attenuation")),
        tnn.PNAConv(F, 6, aggregators=("sum", "var"),
                    scalers=("identity", "attenuation"), **CPU)),
}
SELF_LOOP = ("sgconv", "appnp", "tagconv", "chebconv")


@pytest.mark.parametrize("name", sorted(CASES))
def test_conv_matches_reference(name):
    gj, gt = graphs(self_loop=name in SELF_LOOP)
    jm, tm = CASES[name]()
    run(jm, tm, gj, gt, [rand((N, F), 3)])


def test_chebconv_lambda_max_matches_reference():
    gj, gt = graphs(self_loop=True)
    lam = jdgl.laplacian_lambda_max(gj)[0]
    assert abs(tdgl.laplacian_lambda_max(gt)[0] - lam) < 1e-6
    run(jnn.ChebConv(5, k=3), tnn.ChebConv(F, 5, k=3, **CPU), gj, gt,
        [rand((N, F), 3), (lam, lam)])


def test_gated_graph_conv_etypes_matches_reference():
    gj, gt = graphs()
    et = np.random.default_rng(2).integers(0, 3, E)
    run(jnn.GatedGraphConv(8, n_steps=3, n_etypes=3),
        tnn.GatedGraphConv(F, 8, n_steps=3, n_etypes=3, **CPU), gj, gt,
        [rand((N, F), 3), (jnp.asarray(et), torch.tensor(et))])


@pytest.mark.parametrize("agg", ["mean", "sum", "max"])
def test_nnconv_matches_reference(agg):
    gj, gt = graphs()
    run(jnn.NNConv(F, 3, edge_func=fnn.Dense(F * 3), aggregator_type=agg),
        tnn.NNConv(F, 3, dense(2, F * 3, **CPU), aggregator_type=agg, **CPU),
        gj, gt, [rand((N, F), 3), edge_feats(gt, 2)], grad_of=(0, 1))


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_gmmconv_matches_reference(agg):
    gj, gt = graphs()
    run(jnn.GMMConv(F, 4, dim=2, n_kernels=3, aggregator_type=agg),
        tnn.GMMConv(F, 4, 2, 3, aggregator_type=agg, **CPU), gj, gt,
        [rand((N, F), 3), edge_feats(gt, 2)], grad_of=(0, 1))


def test_cfconv_matches_reference():
    gj, gt = graphs()
    run(jnn.CFConv(hidden_feats=8, out_feats=5), tnn.CFConv(F, 3, 8, 5, **CPU),
        gj, gt, [rand((N, F), 3), edge_feats(gt, 3)], grad_of=(0, 1))


def test_atomic_conv_matches_reference():
    gj, gt = graphs(10, 30, seed=9)
    z = np.random.default_rng(3).choice([1.0, 6.0, 8.0], size=(10, 1))
    dist = np.random.default_rng(4).uniform(0.5, 4.0, (30, 1))
    kw = dict(interaction_cutoffs=(3.0, 3.0), rbf_kernel_means=(1.0, 2.0),
              rbf_kernel_scaling=(1.0, 1.0), features_to_use=(1.0, 6.0, 8.0))
    out = run(jnn.AtomicConv(**kw), tnn.AtomicConv(**kw, **CPU), gj, gt,
              [z.astype(np.float32), dist.astype(np.float32)], grad_of=(1,))
    assert out[0].shape == (10, 6)


def test_egat_conv_matches_reference():
    gj, gt = graphs()
    run(jnn.EGATConv(4, 3, num_heads=2), tnn.EGATConv(F, 5, 4, 3, 2, **CPU),
        gj, gt, [rand((N, F), 3), edge_feats(gt, 5)], grad_of=(0, 1))


def test_edgegat_conv_matches_reference():
    gj, gt = graphs()
    run(jnn.EdgeGATConv(4, num_heads=2), tnn.EdgeGATConv(F, 3, 4, 2, **CPU),
        gj, gt, [rand((N, F), 3), edge_feats(gt, 3)], grad_of=(0, 1))


@pytest.mark.parametrize("project", [False, True])
def test_gcn2_conv_matches_reference(project):
    gj, gt = graphs()
    run(jnn.GCN2Conv(layer=2, alpha=0.2, lambda_=1.0,
                     project_initial_features=project),
        tnn.GCN2Conv(F, layer=2, alpha=0.2, lambda_=1.0,
                     project_initial_features=project, **CPU),
        gj, gt, [rand((N, F), 3), rand((N, F), 5)], grad_of=(0, 1))


def test_gcn2_conv_identity_limit():
    """alpha 0 and a huge layer: beta ~ 0, so the output is the smoothed
    input ``D_in^-1/2 A D_out^-1/2 X`` (the reference's check, rtol and
    atol 1e-3)."""
    gt = tdgl.add_self_loop(tdgl.rand_graph(10, 30, seed=5, **CPU))
    x = rand((10, 6), 5)
    conv = tnn.GCN2Conv(6, layer=1000000, alpha=0.0, lambda_=1.0, **CPU)
    assert conv.beta < 1e-5
    out = conv(gt, torch.tensor(x), torch.tensor(x)).detach().numpy()
    e = gt.num_edges()
    src, dst = gt.src[:e].numpy(), gt.dst[:e].numpy()
    a = np.zeros((10, 10), np.float32)
    np.add.at(a, (dst, src), 1.0)
    din, dout = np.maximum(a.sum(1), 1.0), np.maximum(a.sum(0), 1.0)
    ref = np.diag(din ** -0.5) @ a @ np.diag(dout ** -0.5) @ x
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_pna_sum_identity_scaler_math():
    """One tower of sum and identity: ``mixing(tower_0([h || A h]))``,
    held to numpy (rtol and atol 1e-4, the reference's check)."""
    gt = tdgl.rand_graph(8, 24, seed=7, **CPU)
    x = rand((8, 4), 7)
    conv = tnn.PNAConv(4, 4, aggregators=("sum",), scalers=("identity",),
                       residual=False, **CPU)
    out = conv(gt, torch.tensor(x)).detach().numpy()
    e = gt.num_edges()
    a = np.zeros((8, 8), np.float32)
    np.add.at(a, (gt.dst[:e].numpy(), gt.src[:e].numpy()), 1.0)
    inp = np.concatenate([x, a @ x], -1)
    t0, mix = conv.tower_0, conv.mixing
    ref = (inp @ t0.weight.detach().numpy().T + t0.bias.detach().numpy()) \
        @ mix.weight.detach().numpy().T + mix.bias.detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_pna_degree_scalers_follow_reference_at_zero_in_degree():
    """A node without in-edges: its degree clamps to 1, so amplification
    is log(2) / delta and attenuation delta / log(2), in both packages."""
    src, dst = np.array([0, 1, 2, 2]), np.array([1, 2, 1, 3])
    gj = jdgl.graph((src, dst), num_nodes=5)
    gt = tdgl.graph((src, dst), num_nodes=5, **CPU)
    assert int(gt.in_degrees()[0]) == 0 and int(gt.in_degrees()[4]) == 0
    run(jnn.PNAConv(4, delta=0.7), tnn.PNAConv(4, 4, delta=0.7, **CPU),
        gj, gt, [rand((5, 4), 8)])


def test_hgt_conv_matches_reference():
    gj, gt = graphs(14, 60, seed=21)
    rng = np.random.default_rng(21)
    nt, et = rng.integers(0, 2, 14), rng.integers(0, 3, 60)
    run(jnn.HGTConv(in_size=8, head_size=4, num_heads=2, num_ntypes=2,
                    num_etypes=3),
        tnn.HGTConv(8, 4, 2, 2, 3, **CPU), gj, gt,
        [rand((14, 8), 3), (jnp.asarray(nt), torch.tensor(nt)),
         (jnp.asarray(et), torch.tensor(et))], tol=dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("norm", ["both", "right", "none"])
def test_dense_graph_conv_matches_reference(norm):
    adj = (np.random.default_rng(6).random((N, N)) < 0.3).astype(np.float32)
    run(jnn.DenseGraphConv(4, norm=norm),
        tnn.DenseGraphConv(F, 4, norm=norm, **CPU), jnp.asarray(adj),
        torch.tensor(adj), [rand((N, F), 3)])


def test_dense_sage_and_cheb_match_reference():
    adj = (np.random.default_rng(6).random((N, N)) < 0.3).astype(np.float32)
    ja, ta = jnp.asarray(adj), torch.tensor(adj)
    run(jnn.DenseSAGEConv(4), tnn.DenseSAGEConv(F, 4, **CPU), ja, ta,
        [rand((N, F), 3)])
    for k in (1, 3):
        run(jnn.DenseChebConv(4, k=k), tnn.DenseChebConv(F, 4, k=k, **CPU),
            ja, ta, [rand((N, F), 3), (1.6, 1.6)])


def test_dense_graph_conv_matches_sparse():
    """The reference's check: DenseGraphConv on the adjacency equals
    GraphConv on the graph with the same weight and bias (1e-4)."""
    gt = tdgl.rand_graph(N, E, seed=1, **CPU)
    e = gt.num_edges()
    a = np.zeros((N, N), np.float32)
    np.add.at(a, (gt.dst[:e].numpy(), gt.src[:e].numpy()), 1.0)
    sparse = tdgl.nn.GraphConv(F, 4, **CPU)
    dconv = tnn.DenseGraphConv(F, 4, **CPU)
    dconv.weight.load_state_dict(sparse.weight.state_dict())
    x = torch.tensor(rand((N, F), 1))
    np.testing.assert_allclose(dconv(torch.tensor(a), x).detach().numpy(),
                               sparse(gt, x).detach().numpy(), rtol=1e-4,
                               atol=1e-4)


# Convs whose g-SpMMs the hub engine serves (copy_lhs sum/mean, u_mul_e,
# copy_e sum), on a graph with a hub layout: the port's hub engine against
# the reference's oracle.
HUB_CASES = {
    "gin": (lambda: (jnn.GINConv(), tnn.GINConv(**CPU)), False, []),
    "sgconv": (lambda: (jnn.SGConv(5, k=2), tnn.SGConv(F, 5, k=2, **CPU)),
               True, []),
    "appnp": (lambda: (jnn.APPNPConv(k=4), tnn.APPNPConv(k=4, **CPU)), True,
              []),
    "dotgat": (lambda: (jnn.DotGatConv(4, num_heads=2),
                        tnn.DotGatConv(F, 4, num_heads=2, **CPU)), False, []),
    "agnn": (lambda: (jnn.AGNNConv(), tnn.AGNNConv(**CPU)), False, []),
    "gatv2": (lambda: (jnn.GATv2Conv(4, num_heads=2),
                       tnn.GATv2Conv(F, 4, num_heads=2, **CPU)), False, []),
    "gated": (lambda: (jnn.GatedGraphConv(8, n_steps=2),
                       tnn.GatedGraphConv(F, 8, n_steps=2, **CPU)), False,
              []),
    "pna": (lambda: (jnn.PNAConv(6, aggregators=("mean", "sum")),
                     tnn.PNAConv(F, 6, aggregators=("mean", "sum"), **CPU)),
            False, []),
    "gcn2": (lambda: (jnn.GCN2Conv(layer=3), tnn.GCN2Conv(F, layer=3, **CPU)),
             True, ["feat0"]),
    "cfconv": (lambda: (jnn.CFConv(hidden_feats=8, out_feats=5),
                        tnn.CFConv(F, 3, 8, 5, **CPU)), False, ["efeat"]),
    "edgegat": (lambda: (jnn.EdgeGATConv(1, num_heads=1),
                         tnn.EdgeGATConv(F, 3, 1, 1, **CPU)), False,
                ["efeat"]),
}


@pytest.mark.parametrize("name", sorted(HUB_CASES))
def test_conv_on_hub_engine_matches_reference(name):
    make, self_loop, extra = HUB_CASES[name]
    gj, gt = hub_graphs(self_loop)
    n = gt.num_nodes()
    inputs = [rand((n, F), 3)]
    if "feat0" in extra:
        inputs.append(rand((n, F), 5))
    if "efeat" in extra:
        inputs.append(edge_feats(gt, 3))
    jm, tm = make()
    run(jm, tm, gj, gt, inputs, grad_of=tuple(range(len(inputs))),
        engine="hub", tol=dict(rtol=1e-4, atol=1e-4))


def _blocks():
    """The reference's sampled block: 4 in-edges of 8 seeds of a 30-node
    graph, the same draw in both packages."""
    gj, gt = graphs(30, 120, seed=9)
    seeds = np.arange(8)
    fj = jdgl.sampling.sample_neighbors(gj, seeds, 4,
                                        rng=np.random.default_rng(9))
    ft = tdgl.sampling.sample_neighbors(gt, seeds, 4,
                                        rng=np.random.default_rng(9))
    return jdgl.to_block(fj, seeds), tdgl.to_block(ft, seeds)


@pytest.mark.parametrize("name", ["gatv2", "edgeconv", "pna_minmax"])
def test_convs_on_blocks_match_reference(name):
    bj, bt = _blocks()
    assert bt.num_src_nodes() == bj.num_src_nodes()
    make = {
        "gatv2": lambda: (jnn.GATv2Conv(4, num_heads=2),
                          tnn.GATv2Conv(6, 4, num_heads=2, **CPU)),
        "edgeconv": lambda: (jnn.EdgeConv(5), tnn.EdgeConv(6, 5, **CPU)),
        "pna_minmax": lambda: (
            jnn.PNAConv(6, aggregators=("max", "min")),
            tnn.PNAConv(6, 6, aggregators=("max", "min"), **CPU)),
    }[name]
    jm, tm = make()
    x = rand((bt.num_src_nodes(), 6), 9)
    if name == "edgeconv":  # the (src, dst) pair the block gives
        xd = x[: bt.num_dst_nodes()]
        params = jax.tree.map(np.asarray, jm.init(KEY, bj, (x, xd)))
        tm.load_state_dict(from_jax_params(params))
        want = jm.apply(params, bj, (jnp.asarray(x), jnp.asarray(xd)))
        got = tm(bt, (torch.tensor(x), torch.tensor(xd)))
        close(got, want)
        return
    out = run(jm, tm, bj, bt, [x])
    assert out[0].shape[0] == bt.num_dst_nodes()


def test_gru_cell_mapping():
    """A lone flax GRUCell and ``torch.nn.GRUCell`` with its parameters
    carried: the same step, and flax's hidden bias lands on n only."""
    cell = fnn.GRUCell(features=5)
    h, x = rand((4, 5), 1), rand((4, 3), 2)
    p = jax.tree.map(np.asarray, cell.init(KEY, jnp.asarray(h),
                                           jnp.asarray(x)))
    p["params"]["hn"]["bias"] = rand((5,), 3)
    for g in ("ir", "iz", "in"):
        p["params"][g]["bias"] = rand((5,), 4 + len(g))
    want, _ = cell.apply(p, jnp.asarray(h), jnp.asarray(x))
    tc = torch.nn.GRUCell(3, 5)
    sd = from_jax_params(p)
    tc.load_state_dict(sd)
    assert torch.all(sd["bias_hh"][:10] == 0)
    close(tc(torch.tensor(x), torch.tensor(h)), want, tol=dict(rtol=1e-5,
                                                               atol=1e-6))


@pytest.mark.parametrize("mode", ["cat", "max", "lstm"])
def test_jumping_knowledge_matches_reference(mode):
    """Both LSTM directions of ``'lstm'`` carried (``lstm_cells.0`` and
    ``.1``); values and the grads of every layer input and parameter."""
    feats = [rand((10, 4), i) for i in range(3)]
    jk = jnn.JumpingKnowledge(mode=mode)
    tk = tnn.JumpingKnowledge(mode, in_feats=4, **CPU)
    jf = [jnp.asarray(f) for f in feats]
    params = jax.tree.map(np.asarray, jax.jit(jk.init)(KEY, jf))
    sd = from_jax_params(params)
    if mode == "lstm":
        assert {k.split(".")[0] for k in sd} == {"lstm_cells", "att"}
        assert not torch.equal(sd["lstm_cells.0.weight_hh_l0"],
                               sd["lstm_cells.1.weight_hh_l0"])
    tk.load_state_dict(sd)
    ct = rand((10, 12 if mode == "cat" else 4), 7)

    def loss(p, fs):
        return jnp.sum(jk.apply(p, fs) * ct)

    want = jax.jit(jk.apply)(params, jf)
    gp, gf = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jf)
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    got = tk(tf)
    (got * torch.tensor(ct)).sum().backward()
    close(got, want)
    for a, b in zip(tf, gf):
        close(a.grad, b)
    jg = from_jax_params(jax.tree.map(np.asarray, gp))
    for k, p in tk.named_parameters():
        if p.requires_grad:
            close(p.grad, jg[k], k)


def test_label_propagation_matches_reference():
    src = np.array([0, 1, 2, 0, 1, 2, 3, 4, 5, 3, 4, 5])
    dst = np.array([1, 2, 0, 2, 0, 1, 4, 5, 3, 5, 3, 4])
    gj = jdgl.graph((src, dst), num_nodes=6)
    gt = tdgl.graph((src, dst), num_nodes=6, **CPU)
    labels = np.array([0, 0, 0, 1, 1, 1])
    mask = np.array([True, False, False, True, False, False])
    for norm in ("sym", "rw"):
        want = jnn.LabelPropagation(k=10, alpha=0.9, norm_type=norm).apply(
            {}, gj, jnp.asarray(labels), jnp.asarray(mask))
        got = tnn.LabelPropagation(k=10, alpha=0.9, norm_type=norm)(
            gt, torch.tensor(labels), torch.tensor(mask))
        close(got, want, norm)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), labels)


def test_sequential_and_weight_basis_match_reference():
    gj, gt = graphs()
    run(jnn.Sequential([jnn.GraphConv(8), fnn.relu, jnn.GraphConv(4)]),
        tnn.Sequential([tdgl.nn.GraphConv(F, 8, **CPU), torch.relu,
                        tdgl.nn.GraphConv(8, 4, **CPU)]), gj, gt,
        [rand((N, F), 3)])
    wb = jnn.WeightBasis(shape=(4, 5), num_bases=2, num_outputs=7)
    p = jax.tree.map(np.asarray, wb.init(KEY))
    tw = tnn.WeightBasis((4, 5), 2, 7, **CPU)
    tw.load_state_dict(from_jax_params(p))
    close(tw(), wb.apply(p), tol=dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("layers", [1, 2])
def test_dgi_matches_reference(layers):
    """DGI's loss with the same corruption permutation, its grads, and
    the embeddings (``embed``)."""
    gj, gt = graphs(40, 200, seed=3)
    x = rand((40, F), 3)
    perm = np.random.default_rng(5).permutation(40)
    jm = jmodels.DGI(hidden=8, num_layers=layers)
    tm = tmodels.DGI(F, 8, num_layers=layers, **CPU)
    params = jax.tree.map(np.asarray, jax.jit(lambda: jm.init(
        KEY, gj, jnp.asarray(x), jnp.asarray(perm)))())
    tm.load_state_dict(from_jax_params(params))
    want, gp = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        p, gj, jnp.asarray(x), jnp.asarray(perm))))(params)
    got = tm(gt, torch.tensor(x), torch.tensor(perm))
    got.backward()
    close(got, want)
    jg = from_jax_params(jax.tree.map(np.asarray, gp))
    for k, p in tm.named_parameters():
        close(p.grad, jg[k], k)
    close(tm.embed(gt, torch.tensor(x)),
          jm.apply(params, gj, jnp.asarray(x), method=jm.embed))
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(tm(gt, torch.tensor(x), generator=gen))
