"""The hub and attention kernels on the card against their plain torch
versions, and the hub engine and the fused attention against the oracle
engine on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports no JAX, so it
runs on a machine without it:

    python -m pytest -o addopts="" --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.ops import attn_kernels as AK
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops.engine_ell import ell_stack

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _graph(dev, mixed):
    rng = np.random.default_rng(0)
    n, e = 3000, 40000
    src = rng.integers(0, n, e)
    dst = np.concatenate([rng.zipf(1.7, e // 2) % n,
                          rng.integers(0, n, e - e // 2)])
    loops = np.arange(n)
    kw = dict(hub=500, hub_dense_floor=10000) if mixed else \
        dict(hub=2000, hub_dense_floor=1)
    return tdgl.graph((np.concatenate([src, loops]),
                       np.concatenate([dst, loops])), num_nodes=n,
                      device=dev, **kw)


def _close(a, b):
    torch.testing.assert_close(a.cpu(), b.cpu(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_kernels_match_plain_versions(dev, mixed):
    g = _graph(dev, mixed)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, f = g.num_nodes(), 40
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn(n, f, device=dev, generator=gen)
    c = hub["dense_c"]
    _close(K.dense_fwd(c, u), K.dense_fwd_torch(c, u))
    ct = torch.randn(c.shape[1], f, device=dev, generator=gen)
    _close(K.dense_bwd(c, ct, n), K.dense_bwd_torch(c, ct, n))
    tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                     "copy_lhs", "sum", u, None).contiguous()
    args = (c, ct, tail, hub["gb_starts"], hub["gb_desc"], n)
    _close(K.dense_bwd_fused(*args), K.dense_bwd_fused_torch(*args))
    merged = torch.randn(m.n_tail_rows + m.n_groups * 128, f, device=dev,
                         generator=gen)
    xa = (merged, hub["x_starts"], hub["x_desc"], n)
    _close(K.expand(*xa), K.expand_torch(*xa))
    if mixed:
        assert m.n_groups > m.n_dense
        nb = m.n_groups - m.n_dense
        _close(K.chunk_sum(hub["part_fwd"], u, nb),
               K.chunk_sum_torch(hub["part_fwd"], u, nb))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("red", ["sum", "mean"])
def test_hub_engine_matches_oracle(dev, mixed, red):
    """Values and grad_u; the hub rows sum ~20k terms in another order, so
    the tolerance is 1e-4 of the same sums over absolute values."""
    g = _graph(dev, mixed)
    gen = torch.Generator(device=dev).manual_seed(1)
    u = torch.randn(g.num_nodes(), 24, device=dev, generator=gen)
    w = torch.randn(g.num_nodes(), 24, device=dev, generator=gen)

    def run(engine, x0, w0):
        tdgl.ops.set_engine(engine)
        try:
            x = x0.clone().requires_grad_(True)
            y = tdgl.ops.gspmm(g, "copy_lhs", red, x, None)
            (gx,) = torch.autograd.grad((y * w0).sum(), x)
        finally:
            tdgl.ops.set_engine("auto")
        return y.detach(), gx

    hub, oracle = run("hub", u, w), run("xla", u, w)
    scales = run("xla", u.abs(), w.abs())
    for a, b, s in zip(hub, oracle, scales):
        assert bool(((a - b).abs() <= 1e-4 * s + 1e-5).all())


def _sum_close(name, a, b, scale):
    """|a - b| <= 1e-4 * (the same sum over absolute values) + 1e-5."""
    err = (a - b).abs()
    assert bool((err <= 1e-4 * scale + 1e-5).all()), (name, float(err.max()))


@pytest.mark.parametrize("drop", [0.0, 0.6])
@pytest.mark.parametrize("h,d", [(8, 32), (1, 40), (50, 4)])
@pytest.mark.parametrize("mixed", [False, True])
def test_attention_kernels_match_plain_versions(dev, mixed, h, d, drop):
    g = _graph(dev, mixed)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, f, gr = g.num_nodes(), h * d, m.n_groups * 128
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, shift=0.0):
        return torch.randn(*shape, device=dev, generator=gen) + shift

    el, ft = rnd(n, h), rnd(n, f)
    er_g, lse_g, rho_g, ct_g = rnd(gr, h), rnd(gr, h, shift=3.0), \
        rnd(gr, h), rnd(gr, f)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    lf, lb = hub["full_fwd"], hub["full_bwd"]
    fwd = AK.attn_fwd(lf, el, er_g, ft, h, d, 0.2, drop, seed, m.n_groups)
    ref = AK.attn_fwd_torch(lf, el, er_g, ft, h, d, 0.2, drop, seed,
                            m.n_groups)
    scale = AK.attn_fwd_torch(lf, el, er_g, ft.abs(), h, d, 0.2, drop, seed,
                              m.n_groups)
    torch.cuda.synchronize()
    _sum_close("num", fwd[0], ref[0], scale[0])
    _sum_close("den", fwd[1], ref[1], ref[1])
    assert torch.equal(fwd[2], ref[2])
    args = (lb, el, er_g, lse_g, rho_g, ft, ct_g, h, d, 0.2, drop, seed,
            m.n_win)
    got, want = AK.attn_bwd_src(*args), AK.attn_bwd_src_torch(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("gft", "gel", "gerp"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    p = want[2]
    _sum_close("ger", AK.ger_reduce(lb, p, m.n_groups),
               AK.ger_reduce_torch(lb, p, m.n_groups),
               AK.ger_reduce_torch(lb, p.abs(), m.n_groups))


@pytest.mark.parametrize("drop", [0.0, 0.6])
def test_fused_attention_matches_plain_on_the_card(dev, drop):
    """gat_attention values and grads with the kernels against the same op
    on CPU tensors (the plain versions), same inputs and seed."""
    g = _graph(dev, True)
    gc = g.to("cpu")
    n, h, d = g.num_nodes(), 4, 16
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(n, h, generator=gen), torch.randn(n, h, generator=gen),
          torch.randn(n, h, d, generator=gen)]
    w = torch.randn(n, h, d, generator=gen)
    seed = torch.tensor([12345], dtype=torch.int32)
    res = []
    for graph, device in ((g, dev), (gc, "cpu")):
        ins = [x.to(device).requires_grad_(True) for x in xs]
        out = tdgl.ops.gat_attention(graph, *ins, 0.2, drop, seed.to(device))
        (out * w.to(device)).sum().backward()
        res.append([out.detach().cpu()] + [x.grad.cpu() for x in ins])
    for name, a, b in zip(("out", "el", "er", "ft"), *res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
