"""The port's tile layout, tile kernels' plain versions and tile engine
against the JAX package.

- ``_build_tiles``, ``_pad_tiles``, ``static_tile_bound`` and
  ``_build_ell_uniform`` give the reference's arrays exactly, on the
  native path and on the numpy path.
- ``tile_sum_torch`` / ``tile_minmax_torch`` against the reference's
  ``_segment_sum_tiles`` / ``_segment_minmax_tiles`` run in interpret
  mode, on layouts with several tiles per row block, row blocks with no
  edges and padding tiles. Rows of tile-less row blocks are left out: the
  reference never writes them. Max/min agree exactly (non-finite values
  included); sums of integer-valued messages are exact in float32. The
  same in gather mode (the source rows read through the layout's
  ``gather`` or ``eid``) on both directions of a sampled block, against
  the reference fed the gathered messages its glue builds.
- The copy ops hand K9/K10 their operand and the layout's index, never a
  per-slot message tensor (the ELL engine's reverse sum too).
- Engine ``"tile"`` against the reference's engine ``"pallas"`` forced by
  name, every op x sum/mean/max/min, values and grads, on integer-valued
  features so that ties occur: rtol 1e-5, atol 1e-5 (``div`` divides,
  everything else is exact in float32).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import _native as jnative
from dgl1_tpu.ops.engine_pallas import (_segment_minmax_tiles,
                                        _segment_sum_tiles)
from dgl1_tpu_torch import _native as tnative
from dgl1_tpu_torch.ops import tile_kernels as TK

from torch_parity import engines, skewed_edges, t

# The packages export a function ``graph`` that hides the module.
jgraph = importlib.import_module("dgl1_tpu.graph")
tgraph = importlib.import_module("dgl1_tpu_torch.graph")

T, R = 1024, 128


def _sorted_targets(seed, num_target=700, pad=37):
    """Target-sorted (target, gather, eid) with a row block of three
    tiles, an empty row block and a ragged last block, plus ``pad``
    trailing sentinel entries past the real edges."""
    rng = np.random.default_rng(seed)
    tgt = np.concatenate([rng.integers(0, 128, 300),
                          rng.integers(128, 256, 2500),
                          rng.integers(384, num_target, 900)])
    order = np.argsort(tgt, kind="stable")
    tgt = tgt[order]
    gat = rng.integers(0, 5000, tgt.size)
    eid = rng.permutation(tgt.size)
    n = tgt.size
    tail = np.full(pad, num_target)
    return (np.concatenate([tgt, tail]).astype(np.int32),
            np.concatenate([gat, np.zeros(pad, int)]).astype(np.int32),
            np.concatenate([eid, np.zeros(pad, int)]).astype(np.int32),
            n, num_target)


@pytest.fixture(params=["native", "numpy"])
def builder_path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "lib", lambda: None)
        monkeypatch.setattr(tnative, "lib", lambda: None)
    else:
        assert jnative.lib() is not None and tnative.lib() is not None
    return request.param


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        np.testing.assert_array_equal(x, np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_builders_match_reference(builder_path, seed):
    tgt, gat, eid, n, nt = _sorted_targets(seed)
    want = jgraph._build_tiles(tgt, gat, eid, n, nt)
    got = tgraph._build_tiles(tgt, gat, eid, n, nt)
    _assert_tree_equal(got, want)
    assert not got["block_mask"][2] and got["lid"].shape[0] >= 5
    bound = tgraph.static_tile_bound(n + 37, nt)
    assert bound == jgraph.static_tile_bound(n + 37, nt)
    _assert_tree_equal(tgraph._pad_tiles(got, bound, nt),
                       jgraph._pad_tiles(want, bound, nt))
    # No edges at all: one all-padding tile.
    _assert_tree_equal(tgraph._build_tiles(tgt, gat, eid, 0, nt),
                       jgraph._build_tiles(tgt, gat, eid, 0, nt))


def test_uniform_ell_and_graph_layouts_match_reference(builder_path):
    rng = np.random.default_rng(3)
    n_dst, k = 50, 5
    deg = rng.integers(0, k + 1, n_dst)
    deg[7] = 0
    indptr = np.zeros(n_dst + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    nbr = rng.integers(0, 400, int(deg.sum())).astype(np.int32)
    eid = rng.permutation(int(deg.sum())).astype(np.int32)
    m1, a1 = tgraph._build_ell_uniform(indptr, nbr, eid, n_dst, k)
    m2, a2 = jgraph._build_ell_uniform(indptr, nbr, eid, n_dst, k)
    assert m1 == m2 == ((6, n_dst),)
    _assert_tree_equal(a1, a2)
    # A whole graph: both tile directions and the CSR/CSC they come from.
    src, dst = skewed_edges()
    gj = jdgl.graph((src, dst), num_nodes=300)
    gt = tdgl.graph((src, dst), num_nodes=300, device="cpu")
    for k in ("csr_indptr", "csr_dst", "csr_eid", "csr_src", "csc_indptr",
              "csc_src", "csc_eid", "csc_dst"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k))[:3000])
    _assert_tree_equal(gt.tdst, gj.tdst)
    _assert_tree_equal(gt.tsrc, gj.tsrc)


def _layout(seed):
    """A padded layout from the builder and its row-block count."""
    tgt, gat, eid, n, nt = _sorted_targets(seed)
    tiles = jgraph._pad_tiles(jgraph._build_tiles(tgt, gat, eid, n, nt),
                              jgraph.static_tile_bound(n, nt) + 3, nt)
    return tiles, max(-(-nt // R), 1)


def _messages(tiles, seed, ident, specials=False):
    rng = np.random.default_rng(seed)
    n_slots = tiles["lid"].size
    msg = rng.integers(-4, 5, (n_slots, R)).astype(np.float32)
    if specials:
        idx = rng.integers(0, n_slots, (3, 40))
        msg[idx[0], rng.integers(0, R, 40)] = np.inf
        msg[idx[1], rng.integers(0, R, 40)] = -np.inf
        msg[idx[2], rng.integers(0, R, 40)] = np.nan
    pad = tiles["lid"].reshape(-1) < 0
    msg[pad] = ident  # the reference's glue fills padding slots
    return msg


def _plain_args(tiles):
    return (t(tiles["rows"]), t(tiles["first"]), t(tiles["lid"]))


def _defined_rows(tiles, n_rb):
    return np.repeat(tiles["block_mask"], R)[: n_rb * R]


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_sum_torch_matches_reference(seed):
    tiles, n_rb = _layout(seed)
    msg = _messages(tiles, seed + 10, 0.0)
    want = np.asarray(_segment_sum_tiles(
        jnp.asarray(tiles["rows"]), jnp.asarray(tiles["first"]),
        jnp.asarray(tiles["lid"]), jnp.asarray(msg), n_rb))
    got = TK.tile_sum_torch(*_plain_args(tiles), t(msg), n_rb).numpy()
    rows = _defined_rows(tiles, n_rb)
    np.testing.assert_array_equal(got[rows], want[rows])
    assert not got[~rows].any()
    # Narrow messages: the same columns, no padding to 128 lanes; the
    # wrapper takes the plain version on CPU tensors.
    narrow = TK.tile_sum(*_plain_args(tiles), t(msg[:, :37]), n_rb).numpy()
    np.testing.assert_array_equal(narrow, got[:, :37])


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_minmax_torch_matches_reference(is_max, seed):
    tiles, n_rb = _layout(seed)
    ident = -np.inf if is_max else np.inf
    msg = _messages(tiles, seed + 20, ident, specials=True)
    want = np.asarray(_segment_minmax_tiles(
        is_max, jnp.asarray(tiles["rows"]), jnp.asarray(tiles["first"]),
        jnp.asarray(tiles["lid"]), jnp.asarray(msg), n_rb))
    got = TK.tile_minmax_torch(is_max, *_plain_args(tiles), t(msg),
                               n_rb).numpy()
    rows = _defined_rows(tiles, n_rb)
    np.testing.assert_array_equal(got[rows], want[rows])
    assert np.all(got[~rows] == ident)
    narrow = TK.tile_minmax(is_max, *_plain_args(tiles), t(msg[:, :37]),
                            n_rb).numpy()
    np.testing.assert_array_equal(narrow, got[:, :37])


@pytest.fixture(scope="module")
def sampled_block():
    """Block 1 of a smoke-scale sampled batch (fanouts [10, 25], 128
    seeds): its forward tiles are one row block of 5 tiles, its reverse
    tiles 26 row blocks, 8 with edges, and trailing padding tiles."""
    from dgl1_tpu_torch.dataloading import NeighborSampler

    g, _, _, train = tdgl.data.minibatch_graph("smoke")
    _, _, blocks = NeighborSampler([10, 25]).sample_blocks(
        g, train[:128], rng=np.random.default_rng(0), num_real=120)
    b = blocks[1]
    assert int(b.tsrc["block_mask"].sum()) < b.tsrc["block_mask"].shape[0]
    assert int(b.tsrc["lid"][-1, 0]) < 0
    return b


@pytest.mark.parametrize("red", ["sum", "max", "min"])
@pytest.mark.parametrize("f", [1, 3, 130])
@pytest.mark.parametrize("direction,key", [("tdst", "gather"),
                                           ("tsrc", "eid")])
def test_tile_plain_gather_mode_matches_reference(sampled_block, direction,
                                                  key, f, red):
    """The plain versions in gather mode (``src`` read through the
    layout's ``gather`` or ``eid``) against the reference's
    ``_segment_sum_tiles`` / ``_segment_minmax_tiles`` in interpret mode
    on ``msg = src[clip(idx)]`` built in numpy as ``_tiled_reduce`` /
    ``_tiled_minmax`` build it: padding slots zeroed (sum) or the identity
    (max/min), columns padded to 128 lanes. Padding slots' indices point
    at a row of NaN, which neither version may read; one real slot's index
    is below 0 and one past the end (both clipped). Integer-valued rows
    with infinities: every result is exact."""
    tiles = getattr(sampled_block, direction)
    n_rb = tiles["block_mask"].shape[0]
    lid = tiles["lid"].numpy()
    pad = lid.reshape(-1) < 0
    idx = tiles[key].numpy().copy()
    n = int(idx.max()) + 1
    rng = np.random.default_rng(f)
    src = rng.integers(-4, 5, (n + 2, f)).astype(np.float32)
    if red != "sum":
        src[rng.integers(0, n, 5), rng.integers(0, f, 5)] = np.inf
        src[rng.integers(0, n, 5), rng.integers(0, f, 5)] = -np.inf
    src[n] = np.nan
    idx[pad] = n
    real = np.flatnonzero(~pad)
    idx[real[3]], idx[real[-2]] = -2, n + 5
    ident = {"sum": 0.0, "max": -np.inf, "min": np.inf}[red]
    f_pad = -(-f // R) * R
    msg = np.full((pad.size, f_pad), ident, np.float32)
    msg[~pad, :f] = src[np.clip(idx, 0, n + 1)][~pad]
    ref_args = (jnp.asarray(tiles["rows"].numpy()),
                jnp.asarray(tiles["first"].numpy()), jnp.asarray(lid),
                jnp.asarray(msg), n_rb)
    args = (*_plain_args(tiles), t(src), n_rb, t(idx))
    if red == "sum":
        want = _segment_sum_tiles(*ref_args)
        got = TK.tile_sum_torch(*args)
    else:
        want = _segment_minmax_tiles(red == "max", *ref_args)
        got = TK.tile_minmax_torch(red == "max", *args)
    rows = np.repeat(tiles["block_mask"].numpy(), R)
    np.testing.assert_array_equal(got.numpy()[rows],
                                  np.asarray(want)[rows, :f])
    assert np.all(got.numpy()[~rows] == ident)


@pytest.mark.parametrize("engine,op,red", [
    ("tile", "copy_lhs", "sum"), ("tile", "copy_lhs", "mean"),
    ("tile", "copy_lhs", "max"), ("tile", "copy_lhs", "min"),
    ("tile", "copy_rhs", "sum"), ("tile", "copy_rhs", "max"),
    ("ell", "copy_lhs", "mean")])
def test_copy_ops_read_no_message_tensor(sampled_block, monkeypatch, engine,
                                         op, red):
    """Every K9/K10 call of a copy op, forward and backward (the ELL
    engine's reverse sum over ``tsrc`` included), hands the kernel its
    operand's rows and the layout's index: no tensor with a row per slot
    exists; the result still matches the oracle engine."""
    calls = []

    def spy(fn):
        def wrapped(*a):
            calls.append((a[-3].shape[0], a[-1] is not None))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(TK, "tile_sum", spy(TK.tile_sum))
    monkeypatch.setattr(TK, "tile_minmax", lambda is_max, *a: spy(
        lambda *b: TK.tile_minmax_torch(is_max, *b))(*a))
    b = sampled_block
    n_slots = b.tdst["lid"].numel()
    rng = np.random.default_rng(2)
    x = rng.normal(size=((b.num_src_nodes() if op == "copy_lhs"
                          else b.num_edges_padded()), 5))
    w = t(rng.normal(size=(b.num_dst_nodes(), 5)).astype(np.float32))
    res = []
    for name in (engine, "xla"):
        xt = t(x.astype(np.float32)).requires_grad_(True)
        tdgl.ops.set_engine(name)
        try:
            out = tdgl.ops.gspmm(b, op, red, *((xt, None) if op == "copy_lhs"
                                               else (None, xt)))
            (out * w).sum().backward()
        finally:
            tdgl.ops.set_engine("auto")
        res.append((out.detach(), xt.grad))
    assert calls and all(has_idx and rows < n_slots
                         for rows, has_idx in calls), calls
    for a, c in zip(*res):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def test_tile_wrappers_check_their_inputs():
    tiles, n_rb = _layout(0)
    rows, first, lid = _plain_args(tiles)
    msg = torch.zeros(lid.numel(), 8)
    with pytest.raises(ValueError, match="one row per tile slot"):
        TK.tile_sum(rows, first, lid, msg[:-1], n_rb)
    with pytest.raises(TypeError, match="dtype"):
        TK.tile_sum(rows.long(), first, lid, msg, n_rb)
    with pytest.raises(TypeError, match="dtype"):
        TK.tile_minmax(True, rows, first, lid, msg.double(), n_rb)
    with pytest.raises(ValueError, match="contiguous"):
        TK.tile_sum(rows, first, lid, msg.t().contiguous().t(), n_rb)
    idx = torch.zeros(lid.numel(), dtype=torch.int32)
    with pytest.raises(ValueError, match="one entry per tile slot"):
        TK.tile_sum(rows, first, lid, msg[:5], n_rb, idx[:-1])
    with pytest.raises(TypeError, match="dtype"):
        TK.tile_minmax(False, rows, first, lid, msg[:5], n_rb, idx.long())
    with pytest.raises(ValueError, match="no row to gather"):
        TK.tile_sum(rows, first, lid, msg[:0], n_rb, idx)
    assert TK.LAUNCHES == {"tile_sum": 0, "tile_minmax": 0}


N = 300
_OPS = ["copy_lhs", "copy_rhs", "add", "sub", "mul", "div"]


@pytest.fixture(scope="module")
def skewed():
    src, dst = skewed_edges()
    gj = jdgl.graph((src, dst), num_nodes=N)
    gt = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    # A row block with several tiles and row blocks with none.
    assert int(torch.bincount(gt.tdst["rows"]).max()) >= 2
    return gj, gt, len(src)


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("op", _OPS)
def test_tile_engine_matches_reference_pallas_engine(skewed, op, red):
    gj, gt, e_cnt = skewed
    rng = np.random.default_rng(7)
    f = 6
    u = rng.integers(-3, 4, (N, f)).astype(np.float32)
    e = rng.integers(1, 4, (e_cnt, f)).astype(np.float32)
    w = rng.normal(size=(N, f)).astype(np.float32)
    has_u, has_e = op != "copy_rhs", op != "copy_lhs"

    def jloss(uu, ee):
        out = jdgl.ops.gspmm(gj, op, red, uu if has_u else None,
                             ee if has_e else None)
        return jnp.sum(out * w), out

    with engines("pallas", "tile"):
        (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(u),
                                                         jnp.asarray(e))
        tu, te = t(u).requires_grad_(has_u), t(e).requires_grad_(has_e)
        got = tdgl.ops.gspmm(gt, op, red, tu if has_u else None,
                             te if has_e else None)
        (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if has_u:
        np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jg[0]),
                                   rtol=1e-5, atol=1e-5)
    if has_e:
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[1]),
                                   rtol=1e-5, atol=1e-5)
    if red in ("max", "min") and has_u and op == "copy_lhs":
        # Integer features tie: some destinations split their cotangent.
        ties = jdgl.ops.gspmm(gj, "copy_rhs", "sum", None, jnp.asarray(
            (u[np.asarray(gj.src)] == np.asarray(want)[np.asarray(gj.dst)])
            .astype(np.float32)))
        assert float(jnp.max(ties)) > 1


def test_tile_engine_declines_what_it_does_not_cover():
    src, dst = skewed_edges()
    g = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    from dgl1_tpu_torch.ops.engine_tile import gspmm_tile

    u = torch.ones(N, 2)
    assert gspmm_tile(g, "copy_lhs", "prod", u, None) is None
    assert gspmm_tile(g, "copy_lhs", "sum", u.long(), None) is None
    assert gspmm_tile(g, "mul", "sum", u, None) is None
    g2 = tdgl.graph((src, dst), num_nodes=N, formats=("csr", "ell"),
                    device="cpu")
    assert g2.tdst is None and gspmm_tile(g2, "copy_lhs", "max", u,
                                          None) is None
