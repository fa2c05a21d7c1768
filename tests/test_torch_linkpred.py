"""Link prediction in the port against the JAX package, on the CPU:

- ``global_uniform_negative_sampling`` and ``negative_sampler.Uniform``
  draw the same pairs from the same ``default_rng(seed)``;
- ``EdgeDataLoader`` with every ``exclude`` mode (None, ``'self'``,
  ``'reverse_id'``, and ``'reverse_types'`` on a heterograph) gives the
  same pair graphs and blocks, array for array;
- the g-SDDMM sugar (``u_dot_v`` and its 30 siblings, ``copy_u``,
  ``copy_v``) within 1e-6, values and grads;
- ``layerwise_inference`` of a 2-layer GraphSAGE within 1e-5, both
  packages on their ELL engine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.data.synthetic import synthetic_mag_heterograph as jmag
from dgl1_tpu.dataloading import EdgeDataLoader as JEdgeLoader
from dgl1_tpu.dataloading import NeighborSampler as JSampler
from dgl1_tpu.dataloading import layerwise_inference as jinference
from dgl1_tpu.dataloading import negative_sampler as jneg
from dgl1_tpu.models import GraphSAGE as JGraphSAGE
from dgl1_tpu.nn.conv import SAGEConv as JSAGEConv
from dgl1_tpu.ops import sddmm as jsddmm
from dgl1_tpu.sampling import global_uniform_negative_sampling as jglobal
from dgl1_tpu_torch.dataloading import (EdgeDataLoader, NeighborSampler,
                                        layerwise_inference, negative_sampler)
from dgl1_tpu_torch.models import GraphSAGE
from dgl1_tpu_torch.ops import sddmm as tsddmm
from dgl1_tpu_torch.params import from_jax_params
from dgl1_tpu_torch.sampling import global_uniform_negative_sampling

from test_torch_neighbor import assert_block_equal, assert_hetero_equal
from torch_parity import engines, feats, powerlaw_edges, t

N = 300


@pytest.fixture(scope="module")
def bidirected():
    """A graph whose edge i + E is edge i reversed."""
    src, dst = powerlaw_edges(N, 4, seed=21)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    e = len(src)
    rev = np.concatenate([np.arange(e) + e, np.arange(e)])
    return (jdgl.graph((s2, d2), num_nodes=N),
            tdgl.graph((s2, d2), num_nodes=N, device="cpu"), rev)


def test_negative_samplers_match_reference(bidirected):
    gj, gt, _ = bidirected
    for kw in (dict(), dict(exclude_self_loops=False, max_trials=2)):
        sj = jglobal(gj, 500, rng=np.random.default_rng(1), **kw)
        st = global_uniform_negative_sampling(
            gt, 500, rng=np.random.default_rng(1), **kw)
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(np.asarray(a), b)
    src, dst = gt.src.numpy(), gt.dst.numpy()
    existing = set(zip(src.tolist(), dst.tolist()))
    assert not any(p in existing for p in zip(*[x.tolist() for x in st]))
    eids = np.arange(0, gt.num_edges(), 7)
    for k in (1, 3):
        pj = jneg.Uniform(k)(gj, eids, rng=np.random.default_rng(2))
        pt = negative_sampler.Uniform(k)(gt, eids,
                                         rng=np.random.default_rng(2))
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert negative_sampler.PerSourceUniform is negative_sampler.Uniform


@pytest.mark.parametrize("exclude", [None, "self", "reverse_id"])
def test_edge_loader_matches_reference(bidirected, exclude):
    gj, gt, rev = bidirected
    eids = np.arange(0, gt.num_edges(), 3)
    kw = dict(batch_size=100, shuffle=True, seed=4, exclude=exclude,
              reverse_eids=rev if exclude == "reverse_id" else None)
    jb = list(JEdgeLoader(gj, eids, JSampler([3, 4], static_shapes=False),
                          negative_sampler=jneg.Uniform(1), **kw))
    loader = EdgeDataLoader(gt, eids, NeighborSampler([3, 4],
                                                      static_shapes=False),
                            negative_sampler=negative_sampler.Uniform(1),
                            device="cpu", **kw)
    tb = list(loader)
    assert len(tb) == len(jb) == len(loader) == len(eids) // 100
    for (it, pt, nt, bt), (ij, pj, nj, bj) in zip(tb, jb):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert_block_equal(pj, pt, "pos")
        assert_block_equal(nj, nt, "neg")
        for b1, b2 in zip(bj, bt):
            assert_block_equal(b1, b2, "block")
    if exclude is not None:
        _, pos, _, blocks = tb[0]
        batch = np.arange(0, gt.num_edges(), 3)
        sampled = np.concatenate([b.edata["_ID"].numpy()[: b.num_edges()]
                                  for b in blocks])
        # No block of the first batch holds one of its own edges.
        order = np.random.default_rng(4).permutation(len(batch))
        own = batch[order][:100]
        assert not np.isin(sampled, own).any()
        if exclude == "reverse_id":
            assert not np.isin(sampled, rev[own]).any()


def test_hetero_edge_loader_reverse_types_matches_reference():
    hj, _ = jmag(scale=2048)
    ht, _ = tdgl.data.synthetic_mag_heterograph(scale=2048, device="cpu")
    rev = {"writes": "rev_writes", "rev_writes": "writes",
           "has_topic": "rev_has_topic", "rev_has_topic": "has_topic"}
    eids = {"writes": np.arange(0, 3878, 9),
            "has_topic": np.arange(0, 17450, 40)}
    etypes = [c[1] for c in ht.canonical_etypes]
    kw = dict(batch_size=120, seed=6, exclude="reverse_types",
              reverse_etypes=rev)
    jb = list(JEdgeLoader(hj, eids, JSampler([{e: 2 for e in etypes}],
                                             static_shapes=False),
                          negative_sampler=jneg.Uniform(2), **kw))
    tb = list(EdgeDataLoader(ht, eids, NeighborSampler(
        [{e: 2 for e in etypes}], static_shapes=False),
        negative_sampler=negative_sampler.Uniform(2), device="cpu", **kw))
    assert len(tb) == len(jb) == 7
    for (it, pt, nt_, bt), (ij, pj, nj, bj) in zip(tb, jb):
        assert set(it) == set(ij)
        for k in ij:
            np.testing.assert_array_equal(it[k].numpy(), np.asarray(ij[k]))
        for a, b in ((pj, pt), (nj, nt_)):
            assert a.canonical_etypes == b.canonical_etypes
            for c in a.canonical_etypes:
                assert_block_equal(a.rel_graphs[c], b.rel_graphs[c],
                                   f"pair {c}")
            for k in a.ntypes:
                np.testing.assert_array_equal(
                    np.asarray(a.nframes[k]["_ID"]), b.nframes[k]["_ID"])
        for b1, b2 in zip(bj, bt):
            assert_hetero_equal(b1, b2)


_SUGAR = sorted(n for n in tsddmm.__all__ if n != "gsddmm")


@pytest.mark.parametrize("name", _SUGAR)
def test_sddmm_sugar_matches_reference(bidirected, name):
    gj, gt, _ = bidirected
    assert hasattr(jsddmm, name) and getattr(tdgl.ops, name) is getattr(
        tsddmm, name)
    n_e = gt.num_edges()
    sizes = {"u": N, "v": N, "e": n_e}
    if name in ("copy_u", "copy_v"):
        args = [feats(N, 5, seed=3)]
    else:
        lhs, _, rhs = name.split("_")
        args = [feats(sizes[lhs], 5, seed=3, shift=2.0),
                feats(sizes[rhs], 5, seed=4, shift=2.0)]
    w = feats(n_e, 1 if "dot" in name else 5, seed=5)

    def fj(*a):
        return jnp.sum(getattr(jsddmm, name)(gj, *a) * jnp.asarray(w))

    out_j = getattr(jsddmm, name)(gj, *[jnp.asarray(a) for a in args])
    grads_j = jax.grad(fj, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    xs = [t(a).requires_grad_(True) for a in args]
    out_t = getattr(tsddmm, name)(gt, *xs)
    (out_t * t(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    # A node operand's grad sums its edges' terms in another order in each
    # package: both within 1e-6 of the float64 sum of the terms' absolute
    # values (an edge operand's grad is one term).
    for x, g, bound in zip(xs, grads_j, _grad_abs_sums(gt, name, args, w)):
        err = np.abs(x.grad.numpy().astype(np.float64) - np.asarray(g))
        assert (err <= 1e-6 * bound + 1e-30).all(), (name, err.max())


def _grad_abs_sums(g, name, args, w):
    """Per operand, the float64 sum over edges of the absolute values of
    the grad's per-edge terms: the op on operands gathered to the edges,
    whose grads are those terms, scattered back by absolute value."""
    src, dst = (x.long() for x in g.edges())
    if name in ("copy_u", "copy_v"):
        targets, op = [name[-1]], "copy_lhs"
    else:
        lhs, op, rhs = name.split("_")
        targets = [lhs, rhs]
    index = {"u": src, "v": dst, "e": None}
    xe = []
    for a, tg in zip(args, targets):
        a64 = torch.from_numpy(a).double()
        xe.append((a64 if index[tg] is None else a64[index[tg]])
                  .requires_grad_(True))
    out = tsddmm.gsddmm(g, op, xe[0], xe[1] if len(xe) > 1 else None,
                        "e", "e")
    (out * torch.from_numpy(w).double()).sum().backward()
    bounds = []
    for a, tg, x in zip(args, targets, xe):
        terms = x.grad.abs()
        if index[tg] is not None:
            terms = torch.zeros(a.shape, dtype=torch.float64).index_add_(
                0, index[tg], terms)
        bounds.append(terms.numpy())
    return bounds


def test_layerwise_inference_matches_reference(bidirected):
    gj, gt, _ = bidirected
    x = feats(N, 12, seed=7)
    model_j = JGraphSAGE(8, 6, num_layers=2, dropout=0.0)
    params = model_j.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    model_t = GraphSAGE(12, 8, 6, num_layers=2, dropout=0.0, device="cpu")
    model_t.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    p = params["params"]

    def jlayer(i, out, act):
        def fn(blk, h):
            y = JSAGEConv(out).apply({"params": p[f"layer{i}"]}, blk, h)
            return fnn.relu(y) if act else y
        return fn

    def tlayer(i, act):
        def fn(blk, h):
            y = model_t.layers[i](blk, h)
            return torch.relu(y) if act else y
        return fn

    with engines("ell", "ell"):
        out_j = jinference(gj, jnp.asarray(x),
                           [jlayer(0, 8, True), jlayer(1, 6, False)],
                           batch_size=150)
        with torch.no_grad():
            out_t = layerwise_inference(gt, t(x), [tlayer(0, True),
                                                   tlayer(1, False)],
                                        batch_size=150)
            full = model_t(gt, t(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    # The same model's full-graph forward gives the same output.
    np.testing.assert_allclose(out_t.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
