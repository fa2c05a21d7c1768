"""The hub (K1-K5), attention (K6-K8, K7 g-major), tile and block-dense
(K11) kernels on the card against their plain torch versions, in float32
and in the bf16 matmul mode, and the hub engine (copy_u, u_mul_e,
copy_e), the fused attention, the tile engine, the block-dense engine and
the block-dense attention against the oracle engine or the plain versions
on the card; a GAT layer with heads too wide for the fused kernels.

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


def _edges():
    """3000 nodes: 40,000 edges into half Zipf, half uniform destinations,
    then a self-loop per node."""
    rng = np.random.default_rng(0)
    n, e = 3000, 40000
    src = rng.integers(0, n, e)
    dst = np.concatenate([rng.zipf(1.7, e // 2) % n,
                          rng.integers(0, n, e - e // 2)])
    loops = np.arange(n)
    return np.concatenate([src, loops]), np.concatenate([dst, loops]), n


def _hub_kw(mixed):
    return dict(hub=500, hub_dense_floor=10000) if mixed else \
        dict(hub=2000, hub_dense_floor=1)


def _graph(dev, mixed):
    src, dst, n = _edges()
    return tdgl.graph((src, dst), num_nodes=n, device=dev, **_hub_kw(mixed))


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


@pytest.mark.parametrize("he,rep", [(1, 40), (1, 128), (8, 32), (4, 3),
                                    (64, 1), (40, 1), (65, 1)])
@pytest.mark.parametrize("mixed", [False, True])
def test_weighted_kernels_match_plain_versions(dev, mixed, he, rep):
    """K2 mul (over full_fwd and the window-major full_bwd) and rhs, and
    K5 mul, within 1e-4 of their float64 plain versions relative to the
    same sums over absolute values (hub rows sum ~20k terms); K5 rhs, a
    copy, exactly. K2 rhs also in the bf16 mode (the float32 kernel
    failing the same check) and with e2 cut short, whose slots past it
    are skipped; he = 65 takes two stripes."""
    g = _graph(dev, mixed)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, gr, f = g.num_nodes(), m.n_groups * 128, he * rep
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    u, e2, ct, ct_h = rnd(n, f), rnd(g.num_edges(), he), rnd(gr, f), \
        rnd(gr, he)
    lf, lb = hub["full_fwd"], hub["full_bwd"]

    def f64(*xs):
        return [x.double() if x is not None else None for x in xs]

    for mode, lay, inp, n_out in (("mul", lf, u, m.n_groups),
                                  ("mul", lb, ct, m.n_win),
                                  ("rhs", lf, None, m.n_groups)):
        r = rep if mode == "mul" else 1
        got = K.chunk_weighted(mode, lay, e2, inp, n_out, he, r)
        want = K.chunk_weighted_torch(mode, lay, *f64(e2, inp), n_out, he, r)
        scale = K.chunk_weighted_torch(
            mode, lay, *f64(e2.abs(), None if inp is None else inp.abs()),
            n_out, he, r)
        torch.cuda.synchronize()
        _sum_close(f"chunk_{mode}", got, want, scale)
    e2_short = e2[: g.num_edges() // 2]
    rhs = ("rhs", lf, e2_short, None, m.n_groups, he, 1)
    got = K.chunk_weighted(*rhs)
    want = K.chunk_weighted_torch("rhs", lf, *f64(e2_short), None,
                                  m.n_groups, he, 1)
    scale = K.chunk_weighted_torch("rhs", lf, *f64(e2_short.abs()), None,
                                   m.n_groups, he, 1)
    torch.cuda.synchronize()
    _sum_close("chunk_rhs, e2 cut short", got, want, scale)
    rhs = ("rhs", lf, e2, None, m.n_groups, he, 1)
    got = K.chunk_weighted(*rhs, bf16=True)
    want = K.chunk_weighted_torch("rhs", lf, *f64(e2), None, m.n_groups, he,
                                  1, bf16=True)
    scale = K.chunk_weighted_torch("rhs", lf, *f64(e2.abs()), None,
                                   m.n_groups, he, 1, bf16=True)
    torch.cuda.synchronize()
    _bf16_close("chunk_rhs.bf16", got, K.chunk_weighted(*rhs), want, scale)
    got = K.edge_grad("mul", lf, u, ct, he, rep)
    want = K.edge_grad_torch("mul", lf, *f64(u, ct), he, rep)
    scale = K.edge_grad_torch("mul", lf, *f64(u.abs(), ct.abs()), he, rep)
    torch.cuda.synchronize()
    _sum_close("edge_grad_mul", got, want, scale)
    assert torch.equal(K.edge_grad("rhs", lf, None, ct_h, he, 1),
                       K.edge_grad_torch("rhs", lf, None, ct_h, he, 1))


def test_wrappers_count_only_real_launches(dev):
    """A wrapper with nothing to compute (no chunk, a zero width) returns
    its zero-filled output without a launch, and its counter stays; a
    real launch adds one."""
    g = _graph(dev, False)
    lf = g.hub_dst["full_fwd"]
    empty = {k: v[:0] for k, v in lf.items()}
    e2 = torch.ones(g.num_edges(), 2, device=dev)
    ct = torch.ones(g.hub_dst_meta.n_groups * 128, 2, device=dev)
    K.reset_launches()
    out = K.chunk_weighted("rhs", empty, e2, None, 1, 2, 1)
    assert out.shape == (128, 2) and not out.any()
    assert K.edge_grad("rhs", empty, None, ct, 2, 1).shape == (0, 2)
    assert K.chunk_weighted("rhs", lf, e2[:, :0], None, 1, 0, 1).shape == \
        (128, 0)
    assert not K.chunk_sum(empty, e2, 1).any()
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
    K.chunk_weighted("rhs", lf, e2, None, g.hub_dst_meta.n_groups, 2, 1)
    assert K.LAUNCHES["chunk_rhs"] == 1 and sum(K.LAUNCHES.values()) == 1


@pytest.mark.parametrize("op", ["mul", "copy_rhs"])
@pytest.mark.parametrize("mixed", [False, True])
def test_weighted_hub_engine_matches_plain_on_the_card(dev, mixed, op):
    """gspmm u_mul_e (per head, H=4, D=6) and copy_e on the hub engine
    with the kernels against the same engine on CPU tensors (the plain
    versions): values, grad_u and grad_e within 1e-4 of the same sums
    over absolute values."""
    g = _graph(dev, mixed)
    gc = g.to("cpu")
    gen = torch.Generator().manual_seed(6)
    n, ne = g.num_nodes(), g.num_edges()
    u = torch.randn(n, 4, 6, generator=gen)
    e = torch.randn(ne, 4, 1, generator=gen)
    w = torch.randn(n, 4, 6 if op == "mul" else 1, generator=gen)

    def run(graph, device, uu, ee, ww):
        ins = [x.to(device).requires_grad_(True) for x in (uu, ee)]
        tdgl.ops.set_engine("hub")
        try:
            out = tdgl.ops.gspmm(graph, op, "sum",
                                 ins[0] if op == "mul" else None, ins[1])
            grads = torch.autograd.grad((out * ww.to(device)).sum(),
                                        ins if op == "mul" else ins[1:])
        finally:
            tdgl.ops.set_engine("auto")
        return [out.detach().cpu()] + [x.cpu() for x in grads]

    got = run(g, dev, u, e, w)
    want = run(gc, "cpu", u, e, w)
    scale = run(gc, "cpu", u.abs(), e.abs(), w.abs())
    for name, a, b, s in zip(("out", "grad_u", "grad_e"), got, want, scale):
        if op == "copy_rhs" and name == "grad_u":
            name = "grad_e"
        _sum_close(name, a, b, s)


def _sampled_blocks(dev):
    """Two sampled blocks (fanouts [10, 25], 128 seeds of them 120 real)
    of the smoke-scale mini-batch graph, on the card."""
    from dgl1_tpu_torch.dataloading import NeighborSampler

    g, _, _, train = tdgl.data.minibatch_graph("smoke")
    _, _, blocks = NeighborSampler([10, 25]).sample_blocks(
        g, train[:128], rng=np.random.default_rng(0), num_real=120)
    return [b.to(dev) for b in blocks]


@pytest.mark.parametrize("f", [1, 37, 128, 300])
@pytest.mark.parametrize("direction", ["tdst", "tsrc"])
def test_tile_kernels_match_plain_versions(dev, direction, f):
    """K9 within 1e-5 of its float64 plain version relative to the same
    sum over |msg| (float32 rounding of at most a row's 25 slots), K10
    bit for bit, on padded layouts with
    padding tiles and row blocks with no edges; padding slots hold NaN to
    show they are never read."""
    from dgl1_tpu_torch.ops import tile_kernels as TK

    for b in _sampled_blocks(dev):
        tiles = getattr(b, direction)
        n_rb = tiles["block_mask"].shape[0]
        gen = torch.Generator(device=dev).manual_seed(f)
        msg = torch.randn(tiles["lid"].numel(), f, device=dev, generator=gen)
        msg[tiles["lid"].reshape(-1) < 0] = float("nan")
        args = (tiles["rows"], tiles["first"], tiles["lid"])
        got = TK.tile_sum(*args, msg, n_rb)
        want = TK.tile_sum_torch(*args, msg.double(), n_rb)
        scale = TK.tile_sum_torch(*args, msg.abs().double(), n_rb)
        torch.cuda.synchronize()
        assert bool(((got.double() - want).abs() <= 1e-5 * scale
                     + 1e-6).all())
        ints = torch.randint(-3, 4, msg.shape, device=dev,
                             generator=gen).float()
        ints[::97] = float("inf")
        for is_max in (True, False):
            a = TK.tile_minmax(is_max, *args, ints, n_rb)
            e = TK.tile_minmax_torch(is_max, *args, ints, n_rb)
            torch.cuda.synchronize()
            assert torch.equal(a, e)


def _tile_case(tiles, f, mode, dev, seed):
    """(src, idx) for K9/K10 on ``tiles``: a row per slot (``msg``) or the
    sampled block's source rows read through ``gather`` (``gather``), one
    real slot's index below 0 (clamped to row 0). Padding slots' rows hold
    NaN: in gather mode their index points at an extra row of NaN."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = tiles["lid"].reshape(-1) < 0
    if mode == "msg":
        src = torch.randn(pad.numel(), f, device=dev, generator=gen)
        src[pad] = float("nan")
        return src, None
    idx = tiles["gather"].clone()
    n = int(idx.max()) + 1
    src = torch.randn(n + 1, f, device=dev, generator=gen)
    src[n] = float("nan")
    idx[pad] = n
    idx[int((~pad).nonzero()[0])] = -3
    return src, idx


@pytest.mark.parametrize("f", [1, 40, 256, 602])
@pytest.mark.parametrize("mode", ["gather", "msg"])
@pytest.mark.parametrize("direction", ["tdst", "tsrc"])
def test_tile_kernels_both_modes_match_plain_versions(dev, direction, mode,
                                                      f):
    """K9 within 1e-5 of its float64 plain version relative to the same
    sum over |src|, the same bits on a second run; K10 max and min bit for
    bit on integer-valued rows with infinities, in both modes, on both
    sampled blocks and the 3000-node graph: block 1's forward layout has a
    single row block (fewer than 8), the sampled layouts trailing padding
    tiles and row blocks with no edges, the graph's forward layout a row
    block of 21 tiles (hub rows whose slots run over several tiles, more
    than a block stages at once). Outputs come from a pool of NaNs, so an
    element the kernel skips shows."""
    from dgl1_tpu_torch.ops import tile_kernels as TK

    for i, b in enumerate(_sampled_blocks(dev) + [_graph(dev, False)]):
        tiles = getattr(b, direction)
        n_rb = tiles["block_mask"].shape[0]
        args = (tiles["rows"], tiles["first"], tiles["lid"])
        src, idx = _tile_case(tiles, f, mode, dev, seed=f + i)
        _nan_pool(dev, n_rb * 128 * f)
        got = TK.tile_sum(*args, src, n_rb, idx)
        again = TK.tile_sum(*args, src, n_rb, idx)
        want = TK.tile_sum_torch(*args, src.double(), n_rb, idx)
        scale = TK.tile_sum_torch(*args, src.abs().double(), n_rb, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert bool(((got.double() - want).abs() <= 1e-5 * scale
                     + 1e-6).all()), (i, direction)
        gen = torch.Generator(device=dev).manual_seed(i)
        ints = torch.randint(-3, 4, src.shape, device=dev,
                             generator=gen).float()
        ints[::97] = float("inf")
        ints[5::89] = float("-inf")
        ints[torch.isnan(src)] = float("nan")
        for is_max in (True, False):
            _nan_pool(dev, n_rb * 128 * f)
            a = TK.tile_minmax(is_max, *args, ints, n_rb, idx)
            e = TK.tile_minmax_torch(is_max, *args, ints, n_rb, idx)
            torch.cuda.synchronize()
            assert torch.equal(a, e), (i, direction, is_max)


def test_tile_plan_fills_the_card_on_the_card(dev):
    """The plans the sampled blocks' layouts get launch and agree with the
    plain version at every row count a block may own: the same layout at
    1, 2, 4, ..., 128 row blocks' worth of rows (tile_plan's choice
    replaced)."""
    from dgl1_tpu_torch.ops import tile_kernels as TK

    b = _sampled_blocks(dev)[0]
    tiles = b.tdst
    n_rb = tiles["block_mask"].shape[0]
    args = (tiles["rows"], tiles["first"], tiles["lid"])
    src, idx = _tile_case(tiles, 40, "gather", dev, seed=3)
    want = TK.tile_sum_torch(*args, src.double(), n_rb, idx)
    scale = TK.tile_sum_torch(*args, src.abs().double(), n_rb, idx)
    real_plan = TK.tile_plan
    try:
        for rpb in (1, 2, 4, 8, 16, 32, 64, 128):
            TK.tile_plan = lambda *a, **k: real_plan(*a, **k)._replace(
                rows_per_block=rpb)
            got = TK.tile_sum(*args, src, n_rb, idx)
            torch.cuda.synchronize()
            assert bool(((got.double() - want).abs() <= 1e-5 * scale
                         + 1e-6).all()), rpb
    finally:
        TK.tile_plan = real_plan


@pytest.mark.parametrize("f", [16, 64, 349])
def test_tile_sum_on_sampled_hetero_relations(dev, f):
    """K9 on the reverse tiles (``tsrc``) of a sampled hetero block's
    relations, as the sampled R-GCN's backward runs it (the cotangent of
    the dst rows read through the layout's ``gather``): every relation of
    the output block with edges within 1e-5 of its float64 plain version
    relative to the sum over absolute values; a relation with no dst node
    (the output layer seeds papers only) gives zeros without a launch."""
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.ops import tile_kernels as TK

    hg, split = tdgl.data.synthetic_mag_heterograph(scale=64, device="cpu")
    fan = {c[1]: 10 for c in hg.canonical_etypes}
    _, _, blocks = NeighborSampler([fan, fan]).sample_blocks(
        hg, {"paper": split["train"][:512]}, rng=np.random.default_rng(0))
    out_block = blocks[1].to(dev)
    gen = torch.Generator(device=dev).manual_seed(f)
    n_empty = 0
    for c, rel in out_block.rel_graphs.items():
        tiles = rel.tsrc
        n_rb = tiles["block_mask"].shape[0]
        args = (tiles["rows"], tiles["first"], tiles["lid"])
        ct = torch.randn(rel.num_dst_nodes(), f, device=dev, generator=gen)
        TK.reset_launches()
        got = TK.tile_sum(*args, ct, n_rb, tiles["gather"])
        torch.cuda.synchronize()
        assert got.shape == (n_rb * 128, f)
        if rel.num_dst_nodes() == 0:
            n_empty += 1
            assert TK.LAUNCHES["tile_sum"] == 0 and not got.any(), c
            continue
        assert TK.LAUNCHES["tile_sum"] == 1
        want = TK.tile_sum_torch(*args, ct.double(), n_rb, tiles["gather"])
        scale = TK.tile_sum_torch(*args, ct.abs().double(), n_rb,
                                  tiles["gather"])
        assert bool(((got.double() - want).abs() <= 1e-5 * scale
                     + 1e-6).all()), c
    assert n_empty == 4


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("op", ["copy_lhs", "mul"])
def test_tile_engine_matches_plain_on_the_card(dev, op, red):
    """The tile engine (K9/K10) on a sampled block against the same
    engine on CPU tensors (the plain versions): values and grads."""
    b = _sampled_blocks(dev)[0]
    bc = b.to("cpu")
    gen = torch.Generator().manual_seed(4)
    u = torch.randint(-3, 4, (b.num_src_nodes(), 8), generator=gen).float()
    e = torch.randint(1, 4, (b.num_edges_padded(), 8), generator=gen).float()
    w = torch.randn(b.num_dst_nodes(), 8, generator=gen)
    res = []
    for graph, device in ((b, dev), (bc, "cpu")):
        uu = u.to(device).requires_grad_(True)
        ee = e.to(device).requires_grad_(op == "mul")
        tdgl.ops.set_engine("tile")
        try:
            out = tdgl.ops.gspmm(graph, op, red, uu,
                                 ee if op == "mul" else None)
            (out * w.to(device)).sum().backward()
        finally:
            tdgl.ops.set_engine("auto")
        res.append([out.detach().cpu(), uu.grad.cpu()]
                   + ([ee.grad.cpu()] if op == "mul" else []))
    for a, c in zip(*res):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


_BDENSE = ("coo", "csr", "csc", "ell", "bdense")


def _bdense_graph(dev, heavy=False):
    """A geometric graph of 20,001 nodes (a ragged last block row); with
    ``heavy``, 300 more copies of one edge, so a count passes 256 and the
    blocks are float32."""
    g = tdgl.data.geometric_graph(20_001, 8, seed=1, device="cpu")
    src, dst = (x.numpy() for x in g.edges())
    if heavy:
        src = np.concatenate([src, np.full(300, 5)])
        dst = np.concatenate([dst, np.full(300, 7)])
    return tdgl.graph((src, dst), num_nodes=20_001, formats=_BDENSE,
                      device=dev)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("f", [1, 8, 40, 128, 200, 512])
@pytest.mark.parametrize("transpose", [False, True])
def test_block_mm_matches_plain_version(dev, transpose, f, heavy):
    """K11, forward and transpose, within 1e-5 of its float64 plain version
    relative to the same sums over |x| (float32 sums of at most 3 x 128
    terms); F=1, 40 and 200 are ragged against the 8-column MMA tiles and
    the 64/128-column stripes, 512 takes four stripes, and the heavy
    graph's float32 counts go through three bf16 planes."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK

    g = _bdense_graph(dev, heavy)
    bd, n = g.bdense, g.num_nodes()
    assert bd["a"].dtype == (torch.float32 if heavy else torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(f)
    x = torch.randn(n, f, device=dev, generator=gen)
    if transpose:
        args = (True, bd["ab"], bd["col_ptr"], bd["rbb"])
    else:
        args = (False, bd["a"], bd["row_ptr"], bd["cb"])
    BK.reset_launches()
    got = BK.block_mm(*args, x, n)
    assert BK.LAUNCHES["block_bwd" if transpose else "block_fwd"] == 1
    want = BK.block_mm_torch(*args, x.double(), n)
    scale = BK.block_mm_torch(*args, x.abs().double(), n)
    torch.cuda.synchronize()
    assert got.shape == (n, f) and got.dtype == torch.float32
    assert bool(((got.double() - want).abs() <= 1e-5 * scale + 1e-6).all())


def _crafted_blocks(dev, dtype, seed=0):
    """Five count blocks over four output block rows whose runs hold 3, 0,
    1 and 1 blocks (n_out ragged, the last input block partly past x):
    block 0 a checkerboard of wholly full and wholly empty 16 x 16
    sub-tiles, block 1 full, block 2 one nonzero count, block 3 all zeros,
    block 4 5% nonzero. Counts up to 256 as bf16, up to 1000 as float32."""
    rng = np.random.default_rng(seed)
    cmax = 256 if dtype == torch.bfloat16 else 1000

    def counts():
        return rng.integers(1, cmax + 1, (128, 128)).astype(np.float32)

    a = np.zeros((5, 128, 128), np.float32)
    board = np.add.outer(np.arange(8), np.arange(8)) % 2 == 0
    a[0] = np.kron(board, np.ones((16, 16), np.float32)) * counts()
    a[1] = counts()
    a[2, 37, 101] = cmax
    a[4] = (rng.random((128, 128)) < 0.05) * counts()
    return (torch.tensor(a.reshape(5 * 128, 128), device=dev).to(dtype),
            torch.tensor([0, 3, 3, 4, 5], dtype=torch.int32, device=dev),
            torch.tensor([2, 0, 1, 3, 2], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [1, 8, 40, 128, 200])
@pytest.mark.parametrize("transpose", [False, True])
def test_block_mm_sub_tiles_and_runs(dev, transpose, f, dtype):
    """K11 on hand-made blocks (see _crafted_blocks): skipped and full
    sub-tiles side by side, an empty run (its rows are zeros), a run of 3
    blocks, an all-zero block, within 1e-5 of the float64 plain version
    relative to the same sums over |x|."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK

    a, ptr, ib = _crafted_blocks(dev, dtype, seed=f)
    n_out, n_in = 4 * 128 - 5, 3 * 128 + 50
    x = torch.randn(n_in, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(f))
    got = BK.block_mm(transpose, a, ptr, ib, x, n_out)
    want = BK.block_mm_torch(transpose, a, ptr, ib, x.double(), n_out)
    scale = BK.block_mm_torch(transpose, a, ptr, ib, x.abs().double(), n_out)
    torch.cuda.synchronize()
    assert got.shape == (n_out, f)
    assert bool(((got.double() - want).abs() <= 1e-5 * scale + 1e-6).all())
    assert bool((got[128: 256] == 0).all())


@pytest.mark.parametrize("red", ["sum", "mean"])
def test_bdense_engine_matches_plain_on_the_card(dev, red):
    """copy_u through "auto" on the card takes the block-dense engine (K11
    launches, no other kernel) and agrees with the same engine on CPU
    tensors: values and grad_u within 1e-5 of the same sums over |u|."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK
    from dgl1_tpu_torch.ops import tile_kernels as TK

    g = _bdense_graph(dev)
    gc = g.to("cpu")
    gen = torch.Generator().manual_seed(7)
    u = torch.randn(g.num_nodes(), 24, generator=gen)
    w = torch.randn(g.num_nodes(), 24, generator=gen)

    def run(graph, device, engine, uu, ww):
        x = uu.to(device).requires_grad_(True)
        tdgl.ops.set_engine(engine)
        try:
            out = tdgl.ops.gspmm(graph, "copy_lhs", red, x, None)
            (gx,) = torch.autograd.grad((out * ww.to(device)).sum(), x)
        finally:
            tdgl.ops.set_engine("auto")
        return out.detach().cpu(), gx.cpu()

    for m in (K, AK, BK, TK):
        m.reset_launches()
    got = run(g, dev, "auto", u, w)
    torch.cuda.synchronize()
    assert {k: v for k, v in BK.LAUNCHES.items() if v} == {"block_fwd": 1,
                                                           "block_bwd": 1}
    assert not any(v for m in (K, AK, TK) for v in m.LAUNCHES.values())
    want = run(gc, "cpu", "bdense", u, w)
    scale = run(gc, "cpu", "bdense", u.abs(), w.abs())
    for a, b, s in zip(got, want, scale):
        assert bool(((a - b).abs() <= 1e-5 * s + 1e-6).all())


def test_bdense_attention_matches_plain_on_the_card(dev):
    """bdense_gat_attention values and grads on the card against the same
    op on CPU tensors."""
    g = _bdense_graph(dev)
    gc = g.to("cpu")
    n, h, d = g.num_nodes(), 4, 16
    gen = torch.Generator().manual_seed(8)
    xs = [torch.randn(n, h, generator=gen), torch.randn(n, h, generator=gen),
          torch.randn(n, h, d, generator=gen)]
    w = torch.randn(n, h, d, generator=gen)
    res = []
    for graph, device in ((g, dev), (gc, "cpu")):
        ins = [x.to(device).requires_grad_(True) for x in xs]
        out = tdgl.ops.bdense_gat_attention(graph, *ins)
        (out * w.to(device)).sum().backward()
        res.append([out.detach().cpu()] + [x.grad.cpu() for x in ins])
    for name, a, b in zip(("out", "el", "er", "ft"), *res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


# A value rounded to bfloat16 from an exp computed in float32 on the card
# and in float64 by the plain version can land on the neighbouring bf16
# value (at most 2^-7 of it apart), a product of it rounded again on
# another, and K6's rescale factors add a third. Such a flip stays within
# 1e-4 of its row's sum over absolute values unless the row has few terms,
# so where exp values are rounded at most FLIP_SHARE of the elements may
# pass 1e-4, each within BF16_FLIPS.
FLIP_SHARE = 1e-3
BF16_FLIPS = 3 * 2.0 ** -7


def _bf16_close(name, got, f32, want, scale, flips=False):
    """``got`` (bf16 mode) within 1e-4 of ``scale`` of its float64 plain
    version in bf16 mode (with ``flips``, all but FLIP_SHARE of its
    elements, and those within BF16_FLIPS of ``scale``); the float32
    kernel's output, where it differs from ``got``, must fail the same
    check (it does not round where the plain version does), and differ
    from ``got`` by more than 1e-4 relative somewhere."""
    tol = 1e-4 * scale + 1e-5
    allowed = int(FLIP_SHARE * got.numel()) if flips else 0
    err = (got.double() - want).abs()
    n_past = int((err > tol).sum())
    cap = tol + (BF16_FLIPS * scale if flips else 0.0)
    assert n_past <= allowed and bool((err <= cap).all()), (
        name, n_past, allowed, float(err.max()))
    n_f32 = int(((f32.double() - want).abs() > tol).sum())
    assert torch.equal(got, f32) or n_f32 > allowed, (name, n_f32, allowed)
    assert bool(((got - f32).abs() > 1e-4 * f32.abs()).any()), name


def _f64(*xs):
    return [x.double() if isinstance(x, torch.Tensor) and
            x.is_floating_point() else x for x in xs]


def test_hub_kernels_bf16_match_plain_versions(dev):
    """K1, K2 (plain, mul, rhs), K4a/b and K5 (mul, rhs) in the bf16 mode
    against their float64 plain versions in the same mode (the same
    rounded operands, so only the order of the sums differs); each bf16
    launch counts under its own name."""
    g = _graph(dev, True)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, f, gr = g.num_nodes(), 40, m.n_groups * 128
    gen = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    c, u, ct = hub["dense_c"], rnd(n, f), rnd(hub["dense_c"].shape[1], f)
    tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                     "copy_lhs", "sum", u, None).contiguous()
    nb = m.n_groups - m.n_dense
    e2, ctg, cth = rnd(g.num_edges(), 4), rnd(gr, f), rnd(gr, 4)
    lf = hub["full_fwd"]
    cases = {
        "dense_fwd": (K.dense_fwd, K.dense_fwd_torch, (c, u), (c, u.abs())),
        "dense_bwd": (K.dense_bwd, K.dense_bwd_torch, (c, ct, n),
                      (c, ct.abs(), n)),
        "dense_bwd_fused": (
            K.dense_bwd_fused, K.dense_bwd_fused_torch,
            (c, ct, tail, hub["gb_starts"], hub["gb_desc"], n),
            (c, ct.abs(), tail.abs(), hub["gb_starts"], hub["gb_desc"], n)),
        "chunk_sum": (K.chunk_sum, K.chunk_sum_torch,
                      (hub["part_fwd"], u, nb), (hub["part_fwd"], u.abs(),
                                                 nb)),
        "chunk_mul": (K.chunk_weighted, K.chunk_weighted_torch,
                      ("mul", lf, e2, u, m.n_groups, 4, 10),
                      ("mul", lf, e2.abs(), u.abs(), m.n_groups, 4, 10)),
        "chunk_rhs": (K.chunk_weighted, K.chunk_weighted_torch,
                      ("rhs", lf, e2, None, m.n_groups, 4, 1),
                      ("rhs", lf, e2.abs(), None, m.n_groups, 4, 1)),
        "edge_grad_mul": (K.edge_grad, K.edge_grad_torch,
                          ("mul", lf, u, ctg, 4, 10),
                          ("mul", lf, u.abs(), ctg.abs(), 4, 10)),
        "edge_grad_rhs": (K.edge_grad, K.edge_grad_torch,
                          ("rhs", lf, None, cth, 4, 1),
                          ("rhs", lf, None, cth.abs(), 4, 1)),
    }
    for name, (kern, plain, args, abs_args) in cases.items():
        K.reset_launches()
        got = kern(*args, bf16=True)
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {
            f"{name}.bf16": 1}, name
        want = plain(*_f64(*args), bf16=True)
        scale = plain(*_f64(*abs_args), bf16=True)
        torch.cuda.synchronize()
        _bf16_close(name, got, kern(*args), want, scale)


def _attn_inputs(g, dev, h, d):
    m = g.hub_dst_meta
    n, f, gr = g.num_nodes(), h * d, m.n_groups * 128
    gen = torch.Generator(device=dev).manual_seed(10)

    def rnd(*shape, shift=0.0):
        return torch.randn(*shape, device=dev, generator=gen) + shift

    return (rnd(n, h), rnd(gr, h), rnd(gr, h, shift=3.0), rnd(gr, h),
            rnd(n, f), rnd(gr, f))


@pytest.mark.parametrize("h,d", [(8, 32), (50, 4)])
def test_attention_kernels_bf16_match_plain_versions(dev, h, d):
    """K6, K7 src and K7 g-major in the bf16 mode against their float64
    plain versions in the same mode, within 1e-4 of the same sums over
    |ft| and |ct| but for the rounded exp values' flips (FLIP_SHARE);
    (50, 4) has 3H > 128, where lse and rho are rounded too."""
    g = _graph(dev, True)
    hub, m = g.hub_dst, g.hub_dst_meta
    el, er_g, lse_g, rho_g, ft, ct_g = _attn_inputs(g, dev, h, d)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    lf, lb = hub["full_fwd"], hub["full_bwd"]
    fa = (lf, el, er_g, ft, h, d, 0.2, 0.6, seed, m.n_groups)
    AK.reset_launches()
    got = AK.attn_fwd(*fa, bf16=True)
    want = AK.attn_fwd_torch(*_f64(*fa), bf16=True)
    scale = AK.attn_fwd_torch(*_f64(lf, el, er_g, ft.abs(), *fa[4:]),
                              bf16=True)
    f32 = AK.attn_fwd(*fa)
    torch.cuda.synchronize()
    _bf16_close("num", got[0], f32[0], want[0], scale[0], flips=True)
    _bf16_close("den", got[1], f32[1], want[1], want[1], flips=True)
    assert torch.equal(got[2], f32[2])
    for lay, kern, plain, n_out in (
            (lb, AK.attn_bwd_src, AK.attn_bwd_src_torch, m.n_win),
            (lf, AK.attn_bwd_grp, AK.attn_bwd_grp_torch, m.n_groups)):
        args = (lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, 0.2, 0.6, seed,
                n_out)
        abs_args = (lay, el, er_g, lse_g, -rho_g.abs(), ft.abs(),
                    ct_g.abs(), *args[7:])
        got, f32 = kern(*args, bf16=True), kern(*args)
        want = plain(*_f64(*args), bf16=True)
        scale = plain(*_f64(*abs_args), bf16=True)
        torch.cuda.synchronize()
        for i, w in enumerate(want if isinstance(want, tuple) else (want,)):
            a = got[i] if isinstance(got, tuple) else got
            b = f32[i] if isinstance(f32, tuple) else f32
            s = scale[i] if isinstance(scale, tuple) else scale
            _bf16_close(f"{kern.__name__}[{i}]", a, b, w, s, flips=True)
    assert {k: v for k, v in AK.LAUNCHES.items() if v} == {
        "attn_fwd.bf16": 1, "attn_fwd": 1, "attn_bwd_src.bf16": 1,
        "attn_bwd_src": 1, "attn_bwd_grp.bf16": 1, "attn_bwd_grp": 1}


def _repeated_pairs_graph(dev, mixed):
    """_graph's edges plus 100 copies of the edge 5 -> the heaviest
    destination, so one (hub row, source row) pair holds 100 slots, and
    without any edge out of node 11 (its self-loop too), so its window row
    has no slot."""
    src, dst, n = _edges()
    heavy = int(np.bincount(dst, minlength=n).argmax())
    src = np.concatenate([src, np.full(100, 5)])
    dst = np.concatenate([dst, np.full(100, heavy)])
    keep = src != 11
    return tdgl.graph((src[keep], dst[keep]), num_nodes=n, device=dev,
                      **_hub_kw(mixed))


@pytest.mark.parametrize("h,d", [(8, 32), (1, 384), (2, 256), (4, 160)])
@pytest.mark.parametrize("mixed", [False, True])
def test_attn_bwd_src_repeated_pairs(dev, mixed, h, d):
    """K7 at dropout 0.6 on runs of equal (hub row, source row) slots (one
    of 100, whose per-slot masks differ), with a source row of no slot
    (zeros), within 1e-4 of its float64 plain version relative to the
    same sums over |ft|, |ct| and -|rho|."""
    g = _repeated_pairs_graph(dev, mixed)
    m, lb = g.hub_dst_meta, g.hub_dst["full_bwd"]
    rows_g, rows_w, valid = K._chunk_rows(lb)
    _, runs = torch.unique(torch.stack([rows_g[valid], rows_w[valid]]),
                           dim=1, return_counts=True)
    assert int(runs.max()) >= 64
    assert not bool((rows_w[valid] == 11).any())
    el, er_g, lse_g, rho_g, ft, ct_g = _attn_inputs(g, dev, h, d)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    args = (lb, el, er_g, lse_g, rho_g, ft, ct_g, h, d, 0.2, 0.6, seed,
            m.n_win)
    AK.reset_launches()
    got = AK.attn_bwd_src(*args)
    assert AK.LAUNCHES["attn_bwd_src"] == 1
    want = AK.attn_bwd_src_torch(*_f64(*args))
    scale = AK.attn_bwd_src_torch(*_f64(lb, el, er_g, lse_g, -rho_g.abs(),
                                        ft.abs(), ct_g.abs(), *args[7:]))
    torch.cuda.synchronize()
    for name, a, b, s in zip(("gft", "gel", "gerp"), got, want, scale):
        _sum_close(name, a.double(), b, s)
    assert not bool(got[0][11].any()) and not bool(got[1][11].any())


@pytest.mark.parametrize("h,d", [(1, 384), (2, 256)])
def test_attn_bwd_src_small_chunks_wide_heads(dev, h, d):
    """K7 on full_bwd cut into chunks of 16 slots (64 a layout chunk), so a
    batch of wide heads would take more chunks than shared memory holds, at
    dropout 0.6, within 1e-4 of its float64 plain version."""
    g = _repeated_pairs_graph(dev, True)
    m, lb = g.hub_dst_meta, g.hub_dst["full_bwd"]
    cut = lb["a"].shape[0] // lb["in_id"].shape[0] // 16
    lay = {k: lb[k] for k in ("a", "b", "eid")}
    lay.update({k: lb[k].repeat_interleave(cut) for k in ("in_id", "out_id")})
    el, er_g, lse_g, rho_g, ft, ct_g = _attn_inputs(g, dev, h, d)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    args = (lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, 0.2, 0.6, seed,
            m.n_win)
    got = AK.attn_bwd_src(*args)
    want = AK.attn_bwd_src_torch(*_f64(*args))
    scale = AK.attn_bwd_src_torch(*_f64(lay, el, er_g, lse_g, -rho_g.abs(),
                                        ft.abs(), ct_g.abs(), *args[7:]))
    torch.cuda.synchronize()
    for name, a, b, s in zip(("gft", "gel", "gerp"), got, want, scale):
        _sum_close(name, a.double(), b, s)


def test_attn_bwd_src_refuses_chunks_it_cannot_sort(dev):
    """A chunk of more than MAX_SRC_CHUNK slots raises a ValueError that
    names the rule, before any launch."""
    g = _graph(dev, False)
    lb = g.hub_dst["full_bwd"]
    n = 2 * AK.MAX_SRC_CHUNK
    lay = {k: lb[k][:n] for k in ("a", "b", "eid")}
    lay.update({k: lb[k][:1] for k in ("in_id", "out_id")})
    el, er_g, lse_g, rho_g, ft, ct_g = _attn_inputs(g, dev, 8, 32)
    AK.reset_launches()
    with pytest.raises(ValueError, match="at most 1024 slots"):
        AK.attn_bwd_src(lay, el, er_g, lse_g, rho_g, ft, ct_g, 8, 32, 0.2,
                        n_win=g.hub_dst_meta.n_win)
    assert not any(AK.LAUNCHES.values())


@pytest.mark.parametrize("transpose", [False, True])
def test_block_mm_bf16_matches_plain_version(dev, transpose):
    """K11 in the bf16 mode, float32 counts (rounded: one passes 256), within
    1e-5 of its float64 plain version in the same mode."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK

    g = _bdense_graph(dev, heavy=True)
    bd, n = g.bdense, g.num_nodes()
    x = torch.randn(n, 40, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11))
    args = ((True, bd["ab"], bd["col_ptr"], bd["rbb"]) if transpose
            else (False, bd["a"], bd["row_ptr"], bd["cb"]))
    BK.reset_launches()
    got = BK.block_mm(*args, x, n, bf16=True)
    name = "block_bwd" if transpose else "block_fwd"
    assert {k: v for k, v in BK.LAUNCHES.items() if v} == {f"{name}.bf16": 1}
    want = BK.block_mm_torch(*args, x.double(), n, bf16=True)
    scale = BK.block_mm_torch(*args, x.abs().double(), n, bf16=True)
    torch.cuda.synchronize()
    tol = 1e-5 * scale + 1e-6
    assert bool(((got.double() - want).abs() <= tol).all())
    # The float32 kernel does not round x: it fails the same check.
    assert bool(((BK.block_mm(*args, x, n).double() - want).abs()
                 > tol).any())


def _gmajor_case(dev, kind, h, d):
    """K7 g-major's inputs on the mixed hub graph's full_fwd (five groups)
    or on _fwd_layout cut into 16-slot chunks (three groups, each
    block's run of chunks crossing group changes, windows over three or
    more chunks, long runs of one (b, a) pair, an all-padding chunk, a cut
    last window). Returns (args without drop and seed, n_groups)."""
    if kind == "chunks16":
        lay, n_src, n_groups = _fwd_layout(dev, chunk=16, seed=h + d)
        gen = torch.Generator(device=dev).manual_seed(h * d)

        def rnd(*shape, shift=0.0):
            return torch.randn(*shape, device=dev, generator=gen) + shift

        gr = n_groups * 128
        ins = (rnd(n_src, h), rnd(gr, h), rnd(gr, h, shift=3.0), rnd(gr, h),
               rnd(n_src, h * d), rnd(gr, h * d))
    else:
        g = _graph(dev, True)
        lay, n_groups = g.hub_dst["full_fwd"], g.hub_dst_meta.n_groups
        ins = _attn_inputs(g, dev, h, d)
    return (lay, *ins, h, d, 0.2), n_groups


@pytest.mark.parametrize("drop", [0.0, 0.6])
@pytest.mark.parametrize("h,d,bf16", [(8, 32, False), (8, 32, True),
                                      (2, 32, False), (1, 40, False),
                                      (5, 3, False), (5, 3, True),
                                      (2, 256, False)])
@pytest.mark.parametrize("kind", ["graph", "chunks16"])
def test_gmajor_kernel_matches_plain_version(dev, kind, h, d, bf16, drop):
    """K7 g-major within 1e-4 of its float64 plain version relative to the
    same sums over |ft|, |ct| and -|rho| (hub rows sum ~20k terms), at
    several heads a stripe with ct rows through L1 (8, 32) or staged (2,
    32), one head of two lanes, d not a multiple of 4 (the scalar path)
    and one batch staged at a time (d = 256); in the
    bf16 mode (at the shapes with 3,000 outputs or more, so that
    FLIP_SHARE allows the few rounded values that flip) with the flips,
    the float32 kernel failing the same check. Every element is written
    (the output comes from torch.empty over a pool of NaNs): rows no slot
    names are exactly 0."""
    (lay, el, er_g, lse_g, rho_g, ft, ct_g, *hd), n_groups = _gmajor_case(
        dev, kind, h, d)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    args = (lay, el, er_g, lse_g, rho_g, ft, ct_g, *hd, drop, seed, n_groups)
    name = "attn_bwd_grp.bf16" if bf16 else "attn_bwd_grp"
    AK.reset_launches()
    _nan_pool(dev, n_groups * 128 * h)
    got = AK.attn_bwd_grp(*args, bf16=bf16)
    assert {k: v for k, v in AK.LAUNCHES.items() if v} == {name: 1}
    want = AK.attn_bwd_grp_torch(*_f64(*args), bf16=bf16)
    scale = AK.attn_bwd_grp_torch(*_f64(lay, el, er_g, lse_g, -rho_g.abs(),
                                        ft.abs(), ct_g.abs(), *args[7:]),
                                  bf16=bf16)
    torch.cuda.synchronize()
    if bf16:
        _bf16_close("ger", got, AK.attn_bwd_grp(*args), want, scale,
                    flips=True)
    else:
        _sum_close("ger", got.double(), want, scale)
    rows_out = K._chunk_rows(lay)[1][K._chunk_rows(lay)[2]]
    idle = torch.ones(n_groups * 128, dtype=torch.bool, device=dev)
    idle[rows_out] = False
    assert not bool(got[idle].any())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["graph", "chunks16"])
def test_gmajor_kernel_gives_the_same_bits_twice(dev, kind, bf16):
    """K7 g-major sums in a fixed order (per-warp partials in warp order,
    per-block slots in block order): a second run gives the same bits, as
    the reference's in-order sweep does."""
    (lay, *rest), n_groups = _gmajor_case(dev, kind, 8, 32)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    args = (lay, *rest, 0.6, seed, n_groups)
    first = AK.attn_bwd_grp(*args, bf16=bf16)
    assert torch.equal(first, AK.attn_bwd_grp(*args, bf16=bf16))


def test_gmajor_kernel_on_an_empty_layout(dev):
    """A layout without chunks: every row of grad_er is 0 (the output
    comes from torch.empty over a pool of NaNs), written by the fold
    alone."""
    (lay, *rest), _ = _gmajor_case(dev, "graph", 8, 32)
    empty = {k: v[:0] for k, v in lay.items()}
    _nan_pool(dev, 2 * 128 * 8)
    AK.reset_launches()
    got = AK.attn_bwd_grp(empty, *rest, 0.0, None, 2)
    torch.cuda.synchronize()
    assert got.shape == (256, 8) and not bool(got.any())
    assert {k: v for k, v in AK.LAUNCHES.items() if v} == {"attn_bwd_grp": 1}


def test_wide_head_gat_layer_falls_through_on_the_card(dev):
    """GATConv(in, 512, num_heads=1) on a hub graph: heads wider than the
    kernels' 384 features decline the fused attention, so no attention
    kernel launches and the layer matches the same layer on the CPU. The
    weights are drawn here at the scale the tolerance was set for (fc
    xavier normal with gain sqrt 2): at GATConv's own init, 3.3x larger
    at 16 inputs, the gradients of ``sum(out ** 2)`` grow ~36x, and
    float32 summation order alone moves a few elements past atol 1e-4."""
    g = _graph(dev, True)
    gc = g.to("cpu")
    conv = tdgl.nn.GATConv(16, 512, num_heads=1, device="cpu")
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        torch.nn.init.xavier_normal_(conv.fc.weight, gain=2 ** 0.5,
                                     generator=gen)
        for p in (conv.attn_l, conv.attn_r):
            p.normal_(0.0, (2.0 / 513) ** 0.5, generator=gen)
    x = torch.randn(g.num_nodes(), 16,
                    generator=torch.Generator().manual_seed(13))
    res = []
    for graph, device in ((g, dev), (gc, "cpu")):
        layer = conv.to(device)
        layer.zero_grad()
        xx = x.to(device).requires_grad_(True)
        AK.reset_launches()
        out = layer(graph, xx)
        (out ** 2).sum().backward()
        assert not any(AK.LAUNCHES.values())
        res.append([out.detach().cpu(), xx.grad.cpu()]
                   + [p.grad.cpu() for p in layer.parameters()])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# The edges of K4's row walk and K2 mul's staged walk, on layouts made
# here so that every edge is present at any card size.
# ----------------------------------------------------------------------

_CMAX = {torch.int8: 127, torch.bfloat16: 256, torch.float32: 1000}


def _dense_case(dev, ctype, kd, f, n_out, rows_pad, seed=0):
    """A count matrix (rows_pad, kd) of type ``ctype``: about 5% small
    counts, a few up to the type's largest (int8 127, bf16 256, float32
    1000), a fifth of the rows without any; rows past n_out nonzero too
    (the kernels must not read them); tail rows for a third of the first
    n_out rows through packed descriptors, as the layout emits them."""
    from dgl1_tpu_torch.hub_format import DENSE_RB, EXPAND_PACK

    rng = np.random.default_rng(seed)
    c = np.where(rng.random((rows_pad, kd)) < 0.05,
                 rng.integers(1, 4, (rows_pad, kd)), 0).astype(np.float32)
    big = rng.random((rows_pad, kd)) < 0.002
    c[big] = rng.integers(1, _CMAX[ctype] + 1, int(big.sum()))
    c[rng.random(rows_pad) < 0.2] = 0
    rows = np.sort(rng.choice(n_out, n_out // 3, replace=False))
    t_row = rng.permutation(rows.size)
    desc = (rows % DENSE_RB) * EXPAND_PACK + t_row
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        rows // DENSE_RB, minlength=rows_pad // DENSE_RB))])

    def on(x, dtype):
        return torch.as_tensor(x).to(dtype).to(dev).contiguous()

    return (on(c, ctype), on(rng.normal(size=(kd, f)), torch.float32),
            on(rng.normal(size=(rows.size, f)), torch.float32),
            on(starts, torch.int32), on(desc, torch.int32))


@pytest.mark.parametrize("ctype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("f", [1, 33, 40, 128, 200])
def test_dense_bwd_row_walk_edges(dev, f, ctype):
    """K4a and K4b against their float64 plain versions at widths of one
    to several stripes, one and two dense groups (kd 128, 256), n_out not
    a multiple of any row block; rows without a count store zeros, or
    their tail row exactly."""
    for kd in (128, 256):
        n_out = 2500
        c, ct, tail, gs, gd = _dense_case(dev, ctype, kd, f, n_out, 3072,
                                          seed=kd + f)
        for fused in (True, False):
            args = (c, ct, tail, gs, gd) if fused else (c, ct)
            kern = K.dense_bwd_fused if fused else K.dense_bwd
            plain = K.dense_bwd_fused_torch if fused else K.dense_bwd_torch
            got = kern(*args, n_out)
            want = plain(*_f64(*args), n_out)
            scale = plain(*_f64(*(x.abs() if x.is_floating_point() else x
                                  for x in args)), n_out)
            torch.cuda.synchronize()
            _sum_close(f"dense_bwd fused={fused} kd={kd}", got.double(),
                       want, scale)
            empty = ~(c[:n_out] != 0).any(dim=1)
            base = want - (K.dense_bwd_torch(*_f64(c, ct), n_out)
                           if fused else 0)
            assert torch.equal(got[empty].double(), base[empty])


def test_dense_bwd_row_walk_full_descriptor_blocks(dev):
    """K4a at 600,000 rows, where a block owns a whole DENSE_RB
    descriptor block, against its float64 plain version."""
    n_out = 600_000
    c, ct, tail, gs, gd = _dense_case(dev, torch.int8, 128, 40, n_out,
                                      600 * 1024, seed=3)
    args = (c, ct, tail, gs, gd)
    got = K.dense_bwd_fused(*args, n_out)
    want = K.dense_bwd_fused_torch(*_f64(*args), n_out)
    scale = K.dense_bwd_fused_torch(*_f64(c, ct.abs(), tail.abs(), gs, gd),
                                    n_out)
    torch.cuda.synchronize()
    _sum_close("dense_bwd_fused 600k", got.double(), want, scale)


@pytest.mark.parametrize("ctype", [torch.int8, torch.bfloat16,
                                   torch.float32])
def test_dense_bwd_row_walk_bf16(dev, ctype):
    """K4a and K4b in the bf16 mode (two dense groups, F=40) against their
    float64 plain versions in the same mode; the float32 kernels fail the
    same check."""
    n_out = 2500
    c, ct, tail, gs, gd = _dense_case(dev, ctype, 256, 40, n_out, 3072,
                                      seed=7)
    for kern, plain, args, abs_args in (
            (K.dense_bwd_fused, K.dense_bwd_fused_torch,
             (c, ct, tail, gs, gd), (c, ct.abs(), tail.abs(), gs, gd)),
            (K.dense_bwd, K.dense_bwd_torch, (c, ct), (c, ct.abs()))):
        got = kern(*args, n_out, bf16=True)
        want = plain(*_f64(*args), n_out, bf16=True)
        scale = plain(*_f64(*abs_args), n_out, bf16=True)
        torch.cuda.synchronize()
        _bf16_close(kern.__name__, got, kern(*args, n_out), want, scale)


def _chunk_case(dev, order, n_chunks=1500, chunk=1024, n_e=50_000, seed=0):
    """A chunk layout of n_chunks chunks: with ``order`` "fwd" as full_fwd
    (slots sorted by destination, long runs of b, a new input window every
    3 chunks, a new output block every 50), with "bwd" as full_bwd (one
    input window, b random at every slot, a new output window every 4
    chunks). Every 7th chunk is all padding, 1% of the slots name an edge
    outside e2, and the last input window is cut at 60 rows (slots past
    it are skipped). Returns (layout, n_in rows, output blocks)."""
    rng = np.random.default_rng(seed)
    shape = (n_chunks, chunk)
    a = rng.integers(0, 128, shape)
    b = rng.integers(0, 128, shape)
    if order == "fwd":
        b = np.sort(b, axis=1)
        in_id, out_id = np.arange(n_chunks) // 3, np.arange(n_chunks) // 50
    else:
        in_id, out_id = np.zeros(n_chunks, np.int64), np.arange(n_chunks) // 4
    pad = rng.random(shape) < 0.2
    pad[::7] = True
    a[pad], b[pad] = -1, -1
    eid = rng.integers(0, n_e, shape)
    eid[rng.random(shape) < 0.01] = n_e + 5
    lay = {k: torch.as_tensor(v.reshape(-1) if v.ndim > 1 else v,
                              dtype=torch.int32).to(dev)
           for k, v in (("a", a), ("b", b), ("eid", eid), ("in_id", in_id),
                        ("out_id", out_id))}
    return lay, int(in_id.max()) * 128 + 60, int(out_id.max()) + 2


@pytest.mark.parametrize("he,rep", [(1, 40), (1, 128), (8, 32), (3, 5)])
@pytest.mark.parametrize("order", ["fwd", "bwd"])
def test_chunk_mul_staged_walk_edges(dev, order, he, rep):
    """K2 mul against its float64 plain version on full_fwd- and
    full_bwd-like layouts long enough that every block's run of chunks
    changes input window and output block, with all-padding chunks, edge
    ids outside e2 and a cut last window; in the bf16 mode too."""
    lay, n_in, n_out = _chunk_case(dev, order, seed=he * rep)
    gen = torch.Generator(device=dev).manual_seed(he + rep)
    e2 = torch.randn(50_000, he, device=dev, generator=gen)
    inp = torch.randn(n_in, he * rep, device=dev, generator=gen)
    args = ("mul", lay, e2, inp, n_out, he, rep)
    want = K.chunk_weighted_torch(*_f64(*args))
    scale = K.chunk_weighted_torch("mul", lay, *_f64(e2.abs(), inp.abs()),
                                   n_out, he, rep)
    got = K.chunk_weighted(*args)
    torch.cuda.synchronize()
    _sum_close(f"chunk_mul {order}", got.double(), want, scale)
    got16 = K.chunk_weighted(*args, bf16=True)
    want16 = K.chunk_weighted_torch(*_f64(*args), bf16=True)
    scale16 = K.chunk_weighted_torch("mul", lay, *_f64(e2.abs(), inp.abs()),
                                     n_out, he, rep, bf16=True)
    torch.cuda.synchronize()
    _bf16_close(f"chunk_mul.bf16 {order}", got16, got, want16, scale16)


@pytest.mark.parametrize("he,rep,shift", [(1, 40, 1), (1, 128, 2)])
def test_chunk_mul_input_off_16_bytes(dev, he, rep, shift):
    """K2 mul copies input rows 16 bytes at a time: an input view that
    starts ``shift`` floats past a 16-byte boundary gives what its float64
    plain version gives (widths not a multiple of 4: he=3, rep=5 above)."""
    lay, n_in, n_out = _chunk_case(dev, "fwd", n_chunks=300, seed=rep)
    gen = torch.Generator(device=dev).manual_seed(rep)
    e2 = torch.randn(50_000, he, device=dev, generator=gen)
    flat = torch.randn(n_in * he * rep + shift, device=dev, generator=gen)
    inp = flat[shift:].view(n_in, he * rep)
    assert inp.data_ptr() % 16 == 4 * shift
    args = ("mul", lay, e2, inp, n_out, he, rep)
    want = K.chunk_weighted_torch(*_f64(*args))
    scale = K.chunk_weighted_torch("mul", lay, *_f64(e2.abs(), inp.abs()),
                                   n_out, he, rep)
    got = K.chunk_weighted(*args)
    torch.cuda.synchronize()
    _sum_close(f"chunk_mul shift {shift}", got.double(), want, scale)


def test_chunk_mul_refuses_layouts_it_cannot_load(dev):
    """K2 mul raises, naming the input, for chunks over 1024 slots or not
    a multiple of 4 and for a layout array off a 16-byte boundary; it
    launches nothing."""
    e2 = torch.randn(100, 1, device=dev)
    inp = torch.randn(128, 8, device=dev)
    before = dict(K.LAUNCHES)
    for chunk in (2048, 6):
        lay = {k: torch.zeros(2 * chunk, dtype=torch.int32, device=dev)
               for k in ("a", "b", "eid")}
        lay |= {k: torch.zeros(2, dtype=torch.int32, device=dev)
                for k in ("in_id", "out_id")}
        with pytest.raises(ValueError, match="chunks of at most 1024"):
            K.chunk_weighted("mul", lay, e2, inp, 1, 1, 8)
    lay = {k: torch.zeros(2048, dtype=torch.int32, device=dev)
           for k in ("a", "b", "eid")}
    lay |= {k: torch.zeros(2, dtype=torch.int32, device=dev)
            for k in ("in_id", "out_id")}
    lay["eid"] = torch.zeros(2049, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.chunk_weighted("mul", lay, e2, inp, 1, 1, 8)
    assert K.LAUNCHES == before


# ----------------------------------------------------------------------
# The edges of K1's column walk and K2 plain's staged walk.
# ----------------------------------------------------------------------

def _fwd_counts(dev, ctype, kd, rows_pad, seed=0):
    """A count matrix (rows_pad, kd) of type ``ctype``: about 5% small
    counts, a few up to 127 (int8), 256 (bf16) or 300 (float32), a fifth
    of the rows without any, an all-zero 128-row tile (rows 128..255) and
    one row whose 128 counts of the first group are all nonzero."""
    rng = np.random.default_rng(seed)
    c = np.where(rng.random((rows_pad, kd)) < 0.05,
                 rng.integers(1, 4, (rows_pad, kd)), 0).astype(np.float32)
    big = rng.random((rows_pad, kd)) < 0.002
    c[big] = rng.integers(1, min(_CMAX[ctype], 300) + 1, int(big.sum()))
    c[rng.random(rows_pad) < 0.2] = 0
    c[128:256] = 0
    c[300, :128] = rng.integers(1, 5, 128)
    return torch.as_tensor(c).to(ctype).to(dev).contiguous()


def _fwd_check(name, c, u, bf16=False):
    got = K.dense_fwd(c, u, bf16=bf16)
    want = K.dense_fwd_torch(c, u.double(), bf16=bf16)
    scale = K.dense_fwd_torch(c, u.abs().double(), bf16=bf16)
    torch.cuda.synchronize()
    if bf16:
        _bf16_close(name, got, K.dense_fwd(c, u), want, scale)
    else:
        _sum_close(name, got.double(), want, scale)
    return got


@pytest.mark.parametrize("ctype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("f", [1, 3, 40, 64, 128, 200])
def test_dense_fwd_column_walk_edges(dev, f, ctype):
    """K1 against its float64 plain version at widths of one to several
    stripes, one and two dense groups (kd 128, 256), with all-zero rows,
    an all-zero tile, a row of 128 nonzero counts, the type's largest
    counts and ``u`` shorter than the count matrix (its missing rows read
    as zero); one launch a call."""
    for kd in (128, 256):
        c = _fwd_counts(dev, ctype, kd, 3072, seed=kd + f)
        gen = torch.Generator(device=dev).manual_seed(f)
        u = torch.randn(2900, f, device=dev, generator=gen)
        K.reset_launches()
        got = _fwd_check(f"dense_fwd kd={kd}", c, u)
        assert K.LAUNCHES["dense_fwd"] == 1
        assert got.shape == (kd, f)


@pytest.mark.parametrize("f", [40, 128])
def test_dense_fwd_column_walk_long_runs(dev, f):
    """K1 at 150,000 rows, where every block walks a run of several tiles
    (the double-buffered rows and counts), against its float64 plain
    version."""
    c = _fwd_counts(dev, torch.int8, 128, 150_016, seed=f)
    gen = torch.Generator(device=dev).manual_seed(f)
    u = torch.randn(150_000, f, device=dev, generator=gen)
    _fwd_check("dense_fwd 150k", c, u)


@pytest.mark.parametrize("ctype", [torch.int8, torch.bfloat16,
                                   torch.float32])
def test_dense_fwd_column_walk_bf16(dev, ctype):
    """K1 in the bf16 mode (two dense groups, F=40 and 128: counts over
    256 and U rounded) against its float64 plain version in the same mode;
    the float32 kernel fails the same check."""
    c = _fwd_counts(dev, ctype, 256, 3072, seed=11)
    gen = torch.Generator(device=dev).manual_seed(11)
    for f in (40, 128):
        u = torch.randn(3000, f, device=dev, generator=gen)
        _fwd_check(f"dense_fwd.bf16 f={f}", c, u, bf16=True)


def _plain_layout(lay):
    return {k: lay[k] for k in ("a", "b", "in_id", "out_id")}


def _sum_check(name, lay, inp, n_out, bf16=False):
    got = K.chunk_sum(lay, inp, n_out, bf16=bf16)
    want = K.chunk_sum_torch(lay, inp.double(), n_out, bf16=bf16)
    scale = K.chunk_sum_torch(lay, inp.abs().double(), n_out, bf16=bf16)
    torch.cuda.synchronize()
    if bf16:
        _bf16_close(name, got, K.chunk_sum(lay, inp, n_out), want, scale)
    else:
        _sum_close(name, got.double(), want, scale)
    return got


@pytest.mark.parametrize("chunk", [1024, 256])
@pytest.mark.parametrize("f", [1, 3, 40, 128, 200])
@pytest.mark.parametrize("order", ["fwd", "bwd"])
def test_chunk_sum_staged_walk_edges(dev, order, f, chunk):
    """K2 plain against its float64 plain version on part_fwd- and
    part_bwd-like layouts (see _chunk_case) long enough that every block's
    run of chunks changes input window and output block, with all-padding
    chunks, a cut last window and chunks of 1024 or 256 slots; the output
    block no chunk covers stays zero; in the bf16 mode too."""
    lay, n_in, n_out = _chunk_case(dev, order, n_chunks=1500 * 1024 // chunk,
                                   chunk=chunk, seed=f + chunk)
    lay = _plain_layout(lay)
    gen = torch.Generator(device=dev).manual_seed(f)
    inp = torch.randn(n_in, f, device=dev, generator=gen)
    K.reset_launches()
    got = _sum_check(f"chunk_sum {order}", lay, inp, n_out)
    assert K.LAUNCHES["chunk_sum"] == 1
    assert not bool(got[(n_out - 1) * 128:].any())
    _sum_check(f"chunk_sum.bf16 {order}", lay, inp, n_out, bf16=True)


def test_chunk_sum_empty_layout_launches_nothing(dev):
    """An empty layout gives zeros of the output's shape, no launch."""
    lay = {k: torch.zeros(0, dtype=torch.int32, device=dev)
           for k in ("a", "b", "in_id", "out_id")}
    K.reset_launches()
    out = K.chunk_sum(lay, torch.randn(300, 40, device=dev), 3)
    assert out.shape == (384, 40) and not bool(out.any())
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("f,shift", [(40, 1), (128, 2), (3, 0)])
def test_walks_take_inputs_off_16_bytes(dev, f, shift):
    """K1 and K2 plain copy input rows 16 bytes at a time: an input view
    that starts ``shift`` floats past a 16-byte boundary, or whose width
    is not a multiple of 4, gives what its float64 plain version gives."""
    gen = torch.Generator(device=dev).manual_seed(f)
    lay, n_in, n_out = _chunk_case(dev, "fwd", n_chunks=300, seed=f)
    flat = torch.randn(n_in * f + shift, device=dev, generator=gen)
    inp = flat[shift:].view(n_in, f)
    assert inp.data_ptr() % 16 == 4 * shift
    _sum_check(f"chunk_sum shift {shift}", _plain_layout(lay), inp, n_out)
    c = _fwd_counts(dev, torch.int8, 128, 3072, seed=f)
    flat = torch.randn(3000 * f + shift, device=dev, generator=gen)
    _fwd_check(f"dense_fwd shift {shift}", c, flat[shift:].view(3000, f))


def test_walks_refuse_layouts_they_cannot_load(dev):
    """K2 plain raises for chunks over 1024 slots or not a multiple of 4
    and for ``a`` or ``b`` off a 16-byte boundary; K1 for a count matrix
    off a 16-byte boundary or whose width is not a multiple of 4. Neither
    launches."""
    inp = torch.randn(128, 8, device=dev)
    before = dict(K.LAUNCHES)
    for chunk in (2048, 6):
        lay = {k: torch.zeros(2 * chunk, dtype=torch.int32, device=dev)
               for k in ("a", "b")}
        lay |= {k: torch.zeros(2, dtype=torch.int32, device=dev)
                for k in ("in_id", "out_id")}
        with pytest.raises(ValueError, match="chunks of at most 1024"):
            K.chunk_sum(lay, inp, 1)
    lay = {k: torch.zeros(2048, dtype=torch.int32, device=dev)
           for k in ("a", "b")}
    lay |= {k: torch.zeros(2, dtype=torch.int32, device=dev)
            for k in ("in_id", "out_id")}
    lay["b"] = torch.zeros(2049, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.chunk_sum(lay, inp, 1)
    c = torch.zeros(1024 * 128 + 1, dtype=torch.int8, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.dense_fwd(c.view(1024, 128), inp)
    with pytest.raises(ValueError, match="multiple of 4 columns"):
        K.dense_fwd(torch.zeros(1024, 126, dtype=torch.int8, device=dev),
                    inp)
    assert K.LAUNCHES == before


def _fwd_layout(dev, chunk=1024, seed=0):
    """A forward (group-major) chunk layout built on the host, as the
    builders lay one out: runs of (group, window) in order, each padded to
    whole chunks, within a run the slots in runs of equal hub row b (the
    rows in no order) and source rows a at random. Three groups; runs
    spanning up to five chunks (a window over three or more); one run of a
    single slot; a block of 300 equal (b, a) slots in a row and 200 more
    copies of another pair spread through their b run; an all-padding
    chunk; the last window cut at 80 rows. Returns (layout, n_src,
    n_groups)."""
    rng = np.random.default_rng(seed)
    plan = [(0, 0, 3 * 1024 + 17), (0, 1, 40), (0, 3, 2048),
            (0, 7, 5 * 1024 - 3), (1, 2, 700), (1, 7, 3 * 1024 + 5),
            (2, 0, 1), (2, 5, 1024)]
    n_src = 7 * 128 + 80
    cols = {k: [] for k in ("a", "b", "in_id", "out_id")}
    for i, (g, w, n) in enumerate(plan):
        k = int(rng.integers(1, min(n, 12) + 1))
        cuts = np.sort(rng.choice(np.arange(1, n), k - 1, replace=False)) \
            if k > 1 else np.zeros(0, np.int64)
        lens = np.diff(np.concatenate([[0], cuts, [n]]))
        b = np.repeat(rng.permutation(128)[:k], lens)
        a = rng.integers(0, 128 if w < 7 else 80, n)
        if i == 0:
            a[500:800], b[500:800] = 5, b[500]
            run = np.flatnonzero(b == b[2000])
            a[rng.choice(run, min(200, run.size), replace=False)] = 9
        pad = -n % 1024 + (1024 if i == 3 else 0)
        cols["a"].append(np.concatenate([a, np.full(pad, -1)]))
        cols["b"].append(np.concatenate([b, np.full(pad, -1)]))
        n_ch = (n + pad) // 1024
        cols["in_id"].append(np.full(n_ch, w))
        cols["out_id"].append(np.full(n_ch, g))
    lay = {k: np.concatenate(v) for k, v in cols.items()}
    cut = 1024 // chunk
    lay["in_id"] = np.repeat(lay["in_id"], cut)
    lay["out_id"] = np.repeat(lay["out_id"], cut)
    lay["eid"] = rng.permutation(lay["a"].size)
    return ({k: torch.as_tensor(v, dtype=torch.int32).to(dev)
             for k, v in lay.items()}, n_src, 3)


def _attn_fwd_check(lay, n_src, n_groups, dev, h, d, drop, bf16=False):
    """K6 on ``lay`` against its float64 plain version: num and den within
    1e-4 of the sums over |ft| (and den's own), mraw bit for bit; in the
    bf16 mode with the rounded exp values' flips (FLIP_SHARE), the float32
    kernel failing the same check."""
    gen = torch.Generator(device=dev).manual_seed(h * d)
    el = torch.randn(n_src, h, device=dev, generator=gen)
    er_g = torch.randn(n_groups * 128, h, device=dev, generator=gen)
    ft = torch.randn(n_src, h * d, device=dev, generator=gen)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    args = (lay, el, er_g, ft, h, d, 0.2, drop, seed, n_groups)
    AK.reset_launches()
    got = AK.attn_fwd(*args, bf16=bf16)
    assert AK.LAUNCHES["attn_fwd.bf16" if bf16 else "attn_fwd"] == 1
    want = AK.attn_fwd_torch(*_f64(*args), bf16=bf16)
    scale = AK.attn_fwd_torch(*_f64(lay, el, er_g, ft.abs(), *args[4:]),
                              bf16=bf16)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2].float())
    if bf16:
        f32 = AK.attn_fwd(*args)
        torch.cuda.synchronize()
        _bf16_close("num", got[0], f32[0], want[0], scale[0], flips=True)
        _bf16_close("den", got[1], f32[1], want[1], want[1], flips=True)
    else:
        _sum_close("num", got[0].double(), want[0], scale[0])
        _sum_close("den", got[1].double(), want[1], want[1])
    return got


@pytest.mark.parametrize("chunk", [1024, 16])
@pytest.mark.parametrize("drop", [0.0, 0.6])
@pytest.mark.parametrize("h,d", [(8, 32), (1, 40), (50, 4), (2, 256),
                                 (4, 160), (1, 384), (5, 3)])
def test_attn_fwd_staged_walk_edges(dev, h, d, drop, chunk):
    """K6 on _fwd_layout's chunks of 1024 or 16 slots (a window over three
    or more chunks, a block's run changing group, an all-padding chunk,
    long runs of one (b, a) pair, a cut last window) at every head shape
    the plan cuts differently: several heads a stripe, one narrow head,
    per-head arrays that halve the stripe, heads wider than 128 columns in
    128-column pieces, and d not a multiple of 4."""
    lay, n_src, n_groups = _fwd_layout(dev, chunk=chunk, seed=h + d)
    got = _attn_fwd_check(lay, n_src, n_groups, dev, h, d, drop)
    # Rows no slot names stay zero (group 2 names few rows).
    rows_out = K._chunk_rows(lay)[1][K._chunk_rows(lay)[2]]
    idle = torch.ones(n_groups * 128, dtype=torch.bool, device=dev)
    idle[rows_out] = False
    assert not bool(got[0][idle].any()) and not bool(got[1][idle].any())


@pytest.mark.parametrize("h,d,drop", [(8, 32, 0.0), (8, 32, 0.6),
                                      (1, 40, 0.0)])
def test_attn_fwd_bf16_staged_walk(dev, h, d, drop):
    """K6 in the bf16 mode (layer 1 at dropout 0 and 0.6, layer 2) on
    _fwd_layout, whose groups' running maxima move from chunk to chunk, so
    the segmented products of the online rescale cross segment and group
    boundaries."""
    lay, n_src, n_groups = _fwd_layout(dev, chunk=16, seed=d)
    _attn_fwd_check(lay, n_src, n_groups, dev, h, d, drop, bf16=True)


def test_attn_fwd_on_the_repeated_pairs_graph(dev):
    """K6 on a builder's layout where one (hub row, source row) pair holds
    100 slots, at dropout 0.6, against its float64 plain version."""
    g = _repeated_pairs_graph(dev, True)
    m = g.hub_dst_meta
    _attn_fwd_check(g.hub_dst["full_fwd"], g.num_nodes(), m.n_groups, dev, 8, 32,
               0.6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("he", [1, 8, 40, 64, 65])
def test_chunk_rhs_walk_edges(dev, he, bf16):
    """K2 rhs on _fwd_layout cut into 16-slot chunks (each block's run of
    chunks crossing group changes, windows over three or more chunks, rows
    whose runs outlast a pass, an all-padding chunk) against its float64
    plain version, with e2 a third short (the slots past it skipped), in
    float32 and in the bf16 mode (the float32 kernel failing the bf16
    check); where he is a multiple of 4, also e2 4 bytes off a 16-byte
    boundary (the 4-byte loads)."""
    lay, _, n_groups = _fwd_layout(dev, chunk=16, seed=he)
    n_e = 2 * lay["a"].shape[0] // 3
    gen = torch.Generator(device=dev).manual_seed(he)
    e2s = [torch.randn(n_e, he, device=dev, generator=gen)]
    if he % 4 == 0 and not bf16:
        e2s.append(torch.randn(n_e * he + 1, device=dev,
                               generator=gen)[1:].view(n_e, he))
    name = "chunk_rhs.bf16" if bf16 else "chunk_rhs"
    for e2 in e2s:
        args = ("rhs", lay, e2, None, n_groups, he, 1)
        K.reset_launches()
        got = K.chunk_weighted(*args, bf16=bf16)
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {name: 1}
        want = K.chunk_weighted_torch(*_f64(*args), bf16=bf16)
        scale = K.chunk_weighted_torch("rhs", lay, e2.abs().double(), None,
                                       n_groups, he, 1, bf16=bf16)
        torch.cuda.synchronize()
        if bf16:
            _bf16_close(name, got, K.chunk_weighted(*args), want, scale)
        else:
            _sum_close(name, got.double(), want, scale)


def _nan_pool(dev, n):
    """Leaves a freed block of NaNs in the caching allocator, so that the
    next torch.empty of up to n floats shows any element a kernel skips."""
    torch.full((n,), float("nan"), device=dev)


@pytest.mark.parametrize("he,rep", [(1, 128), (1, 40), (1, 3), (8, 32),
                                    (2, 12)])
@pytest.mark.parametrize("kind", ["graph", "mixed", "chunks16"])
def test_edge_grad_mul_staged_walk_edges(dev, kind, he, rep):
    """K5 mul against its float64 plain version on the hub graph's
    full_fwd, the mixed graph's (five groups), and _fwd_layout cut into
    16-slot chunks (windows over three or more chunks, runs of one (b, a)
    pair, an all-padding chunk, rows past u's end), in float32 and in the
    bf16 mode; every padding slot is exactly 0 although the output comes
    from torch.empty."""
    if kind == "chunks16":
        lay, n_u, n_groups = _fwd_layout(dev, chunk=16, seed=rep)
    else:
        g = _graph(dev, kind == "mixed")
        lay, n_u, n_groups = (g.hub_dst["full_fwd"], g.num_nodes(),
                              g.hub_dst_meta.n_groups)
    f = he * rep
    gen = torch.Generator(device=dev).manual_seed(f)
    u = torch.randn(n_u - 3, f, device=dev, generator=gen)
    ct = torch.randn(n_groups * 128, f, device=dev, generator=gen)
    rows_in, rows_out, valid = K._chunk_rows(lay)
    pad = ~(valid & (rows_in < u.shape[0]))
    for bf16 in (False, True):
        args = ("mul", lay, u, ct, he, rep)
        _nan_pool(dev, lay["a"].shape[0] * he)
        K.reset_launches()
        got = K.edge_grad(*args, bf16=bf16)
        assert K.LAUNCHES["edge_grad_mul.bf16" if bf16 else
                          "edge_grad_mul"] == 1
        want = K.edge_grad_torch(*_f64(*args), bf16=bf16)
        scale = K.edge_grad_torch("mul", lay, *_f64(u.abs(), ct.abs()), he,
                                  rep, bf16=bf16)
        torch.cuda.synchronize()
        assert not bool(got[pad].any()) and bool(torch.isfinite(got).all())
        if bf16:
            _bf16_close(f"edge_grad_mul.bf16 {kind}", got,
                        K.edge_grad(*args), want, scale)
        else:
            _sum_close(f"edge_grad_mul {kind}", got.double(), want, scale)


def _expand_inputs(dev, g, f, epilogue, seed=0):
    """Merged rows and the epilogue operands of K3 at width f: "u" a weight
    a row times u's row, "w" f weights a row alone, "heads" 3 weights a row
    spread over f / 3 columns each, times u's row."""
    hub, m, n = g.hub_dst, g.hub_dst_meta, g.num_nodes()
    gen = torch.Generator(device=dev).manual_seed(seed)
    merged = torch.randn(m.n_tail_rows + m.n_groups * 128, f, device=dev,
                         generator=gen)
    u = torch.randn(n + 5, f, device=dev, generator=gen)
    he = {"u": 1, "w": f, "heads": 3}.get(epilogue, 0)
    w = torch.randn(n, he, device=dev, generator=gen) if he else None
    diag = () if w is None else (w,) if epilogue == "w" else (w, u)
    return merged, (hub["x_starts"], hub["x_desc"], n), diag


@pytest.mark.parametrize("epilogue", [None, "u", "w", "heads"])
@pytest.mark.parametrize("f", [1, 3, 37, 40, 64, 128, 201, 1500])
@pytest.mark.parametrize("mixed", [False, True])
def test_expand_write_pass_edges(dev, mixed, f, epilogue):
    """K3 against its plain version in float32 on the card, bit for bit
    (a copy, and the epilogue rounds as torch does), at widths that are
    and are not a multiple of 4 floats and wider than a block's stride,
    with and without each epilogue; every element is written although the
    output comes from torch.empty over a pool of NaNs."""
    if epilogue == "heads" and f % 3:
        f = f * 3
    g = _graph(dev, mixed)
    merged, xa, diag = _expand_inputs(dev, g, f, epilogue)
    _nan_pool(dev, g.num_nodes() * f)
    K.reset_launches()
    got = K.expand(merged, *xa, *diag)
    assert K.LAUNCHES["expand"] == 1
    want = K.expand_torch(merged, *xa, *diag)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("which", ["merged", "diag_u"])
@pytest.mark.parametrize("f", [40, 128])
def test_expand_operands_off_16_bytes(dev, f, which):
    """A merged block or a diag_u off a 16-byte boundary takes K3's scalar
    loads, with the same values."""
    g = _graph(dev, False)
    merged, xa, (w, u) = _expand_inputs(dev, g, f, "u", seed=1)
    if which == "merged":
        merged = torch.cat([merged.new_zeros(1), merged.reshape(-1)])[1:]
        merged = merged.view(-1, f)
    else:
        u = torch.cat([u.new_zeros(1), u.reshape(-1)])[1:].view(-1, f)
    assert (merged if which == "merged" else u).data_ptr() % 16
    _nan_pool(dev, g.num_nodes() * f)
    got = K.expand(merged, *xa, w, u)
    torch.cuda.synchronize()
    assert torch.equal(got, K.expand_torch(merged, *xa, w, u))


def _ger_layout(dev, sizes, seed=0):
    """gperm / gout of hand-made groups of ``sizes`` chunks (gout sorted,
    gperm a random permutation), on the card."""
    rng = np.random.default_rng(seed)
    gout = np.repeat(np.arange(len(sizes)), sizes)
    gperm = rng.permutation(len(gout))
    return {"gperm": torch.tensor(gperm, dtype=torch.int32, device=dev),
            "gout": torch.tensor(gout, dtype=torch.int32, device=dev)}


@pytest.mark.parametrize("h", [1, 2, 3, 8, 9, 50])
@pytest.mark.parametrize("sizes", [(5292,), (1100, 0, 900, 40, 1, 2300),
                                   (3, 0, 2), (0, 0), (700,) * 9])
def test_ger_reduce_two_passes(dev, sizes, h):
    """K8 against its float64 plain version: one group over every pass-1
    block (arxiv's shape), groups split between blocks and held by one, an
    empty group, fewer chunks than blocks, no chunk at all; every element
    written over a pool of NaNs (zeros for empty groups), the same bits on
    a second run, and a gerp off a 16-byte boundary copied first."""
    lay = _ger_layout(dev, sizes)
    n_groups, n = len(sizes), sum(sizes)
    gen = torch.Generator(device=dev).manual_seed(h)
    p = torch.randn(n * 128, h, device=dev, generator=gen)
    _nan_pool(dev, n_groups * 128 * h)
    AK.reset_launches()
    got = AK.ger_reduce(lay, p, n_groups)
    assert AK.LAUNCHES["ger_reduce"] == 1
    want = AK.ger_reduce_torch(lay, p.double(), n_groups)
    scale = AK.ger_reduce_torch(lay, p.abs().double(), n_groups)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _sum_close("ger", got.double(), want, scale)
    empty = torch.tensor(sizes, device=dev).repeat_interleave(128) == 0
    assert not bool(got[empty].any())
    assert torch.equal(AK.ger_reduce(lay, p, n_groups), got)
    off = torch.cat([p.new_zeros(1), p.reshape(-1)])[1:].view(-1, h)
    assert off.data_ptr() % 16 or n == 0
    assert torch.equal(AK.ger_reduce(lay, off, n_groups), got)


@pytest.mark.parametrize("mixed", [False, True])
def test_ger_reduce_on_the_hub_layouts(dev, mixed):
    """K8 on the hub graph's and the mixed graph's backward layouts at
    the GAT widths (H = 8 and 1) over a pool of NaNs."""
    g = _graph(dev, mixed)
    lb, m = g.hub_dst["full_bwd"], g.hub_dst_meta
    for h in (8, 1):
        gen = torch.Generator(device=dev).manual_seed(h)
        p = torch.randn(lb["gperm"].shape[0] * 128, h, device=dev,
                        generator=gen)
        _nan_pool(dev, m.n_groups * 128 * h)
        got = AK.ger_reduce(lb, p, m.n_groups)
        torch.cuda.synchronize()
        _sum_close("ger", got.double(),
                   AK.ger_reduce_torch(lb, p.double(), m.n_groups),
                   AK.ger_reduce_torch(lb, p.abs().double(), m.n_groups))


def _typed_layouts(dev):
    """The identity relation layouts (3 relations) and the relation-
    stacked union block (4 relations) of ``powerlaw_graph(4000, 26)``, on
    the card: hub slots and tail rows a relation does not touch are
    phantoms that read zeros; the union block is bipartite with 4 x 4000
    sources."""
    g = tdgl.data.powerlaw_graph(4000, 26, seed=2, device="cpu")
    et = np.random.default_rng(0).integers(0, 4, g.num_edges())
    rel, _ = tdgl.typed_subgraphs(g, et % 3, 3, identity=True)
    gu, _ = tdgl.typed_union_graph(g, et, 4)
    assert all(r.hub_dst_meta.identity_expand for r in rel)
    assert gu.hub_dst_meta.identity_expand and gu.hub_dst_meta.n_dense
    return [r.to(dev) for r in rel] + [gu.to(dev)]


@pytest.mark.parametrize("f", [1, 40, 64])
def test_dense_kernels_on_typed_layouts(dev, f):
    """K1 and K4a on each identity relation layout and the union block
    against their float64 plain versions, then the copy_u sum and its
    grad through the hub engine against the oracle."""
    for i, g in enumerate(_typed_layouts(dev)):
        hub, m = g.hub_dst, g.hub_dst_meta
        n_src, n_dst = g.num_src_nodes(), g.num_dst_nodes()
        gen = torch.Generator(device=dev).manual_seed(i)
        u = torch.randn(n_src, f, device=dev, generator=gen)
        c = hub["dense_c"]
        _sum_close(f"K1[{i}]", K.dense_fwd(c, u).double(),
                   K.dense_fwd_torch(c, u.double()),
                   K.dense_fwd_torch(c, u.abs().double()))
        ct = torch.randn(c.shape[1], f, device=dev, generator=gen)
        ct_full = torch.randn(n_dst, f, device=dev, generator=gen)
        tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                         "copy_lhs", "sum", ct_full, None).contiguous()
        gs, gd = hub["gb_starts"], hub["gb_desc"]
        _sum_close(f"K4a[{i}]",
                   K.dense_bwd_fused(c, ct, tail, gs, gd, n_src).double(),
                   K.dense_bwd_fused_torch(c, ct.double(), tail.double(),
                                           gs, gd, n_src),
                   K.dense_bwd_fused_torch(c, ct.abs().double(),
                                           tail.abs().double(), gs, gd,
                                           n_src))
        K.reset_launches()

        def run(engine, x0, w0):
            tdgl.ops.set_engine(engine)
            try:
                x = x0.clone().requires_grad_(True)
                y = tdgl.ops.gspmm(g, "copy_lhs", "sum", x, None)
                (gx,) = torch.autograd.grad((y * w0).sum(), x)
            finally:
                tdgl.ops.set_engine("auto")
            return y.detach(), gx

        w = torch.randn(n_dst, f, device=dev, generator=gen)
        hubbed = run("hub", u, w)
        assert K.LAUNCHES["dense_fwd"] == 1 and K.LAUNCHES["expand"] == 0
        assert K.LAUNCHES["dense_bwd_fused"] == 1
        for name, a, b, s in zip(("fwd", "grad"), hubbed, run("xla", u, w),
                                 run("xla", u.abs(), w.abs())):
            _sum_close(f"{name}[{i}]", a, b, s)


def test_dgmg_graphed_step_matches_eager(dev):
    """``train_dgmg``'s CUDA-graph replay of the step against the same
    steps taken eagerly from the same weights and batches: every loss and
    the final weights within float32 rounding."""
    from dgl1_tpu_torch.examples import train_dgmg as M

    args = M.parse_args(["--iters", "8", "--hidden", "8", "--batch", "4",
                         "--samples", "2"])
    data, model = M.build(args, dev)
    eager = M.DGMG(args.hidden, args.n_max, device=dev)
    eager.load_state_dict(model.state_dict())
    got = M.train(args, data, model, dev)["losses"]
    data["rng"] = np.random.default_rng(0)
    opt = torch.optim.Adam(eager.parameters(), lr=args.lr)
    want = []
    for _ in range(args.iters):
        opt.zero_grad()
        loss = M.step_loss(args, data, eager, M.make_batch(args, data))
        loss.backward()
        opt.step()
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for (k, a), b in zip(model.state_dict().items(),
                         eager.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_dist_trainer_refuses_more_parts_than_cards(dev):
    """A distributed trainer on the card with more parts than cards exits
    before any work (NCCL places one rank a card), naming both counts."""
    from dgl1_tpu_torch.examples import train_dist

    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"need {n + 1} devices, have {n}"):
        train_dist.main(["--parts", str(n + 1), "--nodes", "600"])
