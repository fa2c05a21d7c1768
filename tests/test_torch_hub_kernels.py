"""Each hub kernel's plain torch version (the wrapper on CPU tensors)
against the reference's Pallas call in interpret mode, on the same
arrays.

Tolerance of the sums (K1, K2, K4): the reference's and the port's
float32 outputs are each held against the same sum in float64, within
REL times the float64 sum over absolute values (``|C|^T |u|`` for K1).
The two packages add in orders that depend on the CPU's matmul blocking,
so a fixed absolute tolerance fails on sums of hundreds: at 1e-5 one
element of 1,280 missed by 2.0e-4 on a sum of ~700, with both packages
within 1.1e-7 of the abs sum. K3 copies rows, so it must agree
exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgl1_tpu.ops import engine_hub as ref
from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.ops import hub_kernels as K

from torch_parity import feats, make, t

REL = 1e-6
F = 10
F_PAD = 128


def _pad(x, rows, cols=F_PAD):
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _held(what, got, want64, abs64):
    """Elementwise ``|got - want64| <= REL * abs64`` (see the module)."""
    err = np.abs(np.asarray(got, np.float64) - want64)
    bad = err > REL * abs64
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} elements past "
        f"{REL} of the abs sum; max err {err.max()}")


def _both_held(got, want, want64, abs64):
    _held("port", got, want64, abs64)
    _held("reference", want, want64, abs64)


def _f64(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _lay(hub, name):
    return {k: jnp.asarray(v) for k, v in hub[name].items()}


def _tlay(hub, name):
    return {k: t(v) for k, v in hub[name].items()}


@pytest.fixture(scope="module", params=[("mixed", True), ("dense", False),
                                        ("powerlaw", True)])
def case(request):
    name, loops = request.param
    gj, _ = make(name, self_loops=loops)
    hub, m = gj.hub_dst, gj.hub_dst_meta
    return gj, hub, m


def test_dense_fwd_matches_reference(case):
    g, hub, m = case
    c = hub["dense_c"]
    u = _pad(feats(g.num_nodes(), F), c.shape[0])
    want = np.asarray(ref._dense_fwd_call(jnp.asarray(c), jnp.asarray(u)))
    got = K.dense_fwd(t(c, np.float32).to(K_dtype(c)), t(u))
    c64 = np.asarray(c).astype(np.float64)
    want64 = c64.T @ u.astype(np.float64)
    abs64 = np.abs(c64).T @ np.abs(u).astype(np.float64)
    _both_held(got.numpy(), want, want64, abs64)
    # Unpadded operands give the same values (the kernels mask edges).
    got2 = K.dense_fwd(t(c, np.float32).to(K_dtype(c)),
                       t(feats(g.num_nodes(), F)))
    _both_held(got2.numpy(), want[:, :F], want64[:, :F], abs64[:, :F])


def K_dtype(c):
    return {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(
        np.asarray(c).dtype.name, torch.float32)


def _covered(lay_out_id, n_out_blocks):
    blocks = np.unique(np.asarray(lay_out_id))
    rows = (blocks[:, None] * BLK + np.arange(BLK)[None]).reshape(-1)
    return rows[rows < n_out_blocks * BLK]


def test_chunk_sum_fwd_matches_reference():
    g, _ = make("mixed")
    hub, m = g.hub_dst, g.hub_dst_meta
    assert m.n_groups > m.n_dense
    u = _pad(feats(g.num_nodes(), F), hub["dense_c"].shape[0])
    n_out = m.n_groups - m.n_dense
    want = np.asarray(ref._chunk_call("plain", _lay(hub, "part_fwd"), None,
                                      None, jnp.asarray(u), n_out, F_PAD))
    lay = _tlay(hub, "part_fwd")
    got = K.chunk_sum(lay, t(u), n_out).numpy()
    want64 = K.chunk_sum_torch(lay, _f64(u), n_out).numpy()
    abs64 = K.chunk_sum_torch(lay, _f64(np.abs(u)), n_out).numpy()
    rows = _covered(hub["part_fwd"]["out_id"], n_out)
    _both_held(got[rows], want[rows], want64[rows], abs64[rows])


@pytest.mark.parametrize("name", ["mixed", "chunked"])
def test_chunk_sum_bwd_matches_reference(name):
    g, _ = make(name)
    hub, m = g.hub_dst, g.hub_dst_meta
    n_in = (m.n_groups - m.n_dense) * BLK
    ct = _pad(feats(n_in, F, seed=4), n_in)
    want = np.asarray(ref._chunk_call("plain", _lay(hub, "part_bwd"), None,
                                      None, jnp.asarray(ct), m.n_win, F_PAD))
    lay = _tlay(hub, "part_bwd")
    got = K.chunk_sum(lay, t(ct), m.n_win).numpy()
    want64 = K.chunk_sum_torch(lay, _f64(ct), m.n_win).numpy()
    abs64 = K.chunk_sum_torch(lay, _f64(np.abs(ct)), m.n_win).numpy()
    rows = _covered(hub["part_bwd"]["out_id"], m.n_win)
    assert len(rows)
    _both_held(got[rows], want[rows], want64[rows], abs64[rows])


def test_expand_matches_reference(case):
    g, hub, m = case
    n_merged = m.n_tail_rows + m.n_groups * BLK
    m_pad = -(-n_merged // 32) * 32
    merged = _pad(feats(n_merged, F, seed=5), m_pad)
    want = np.asarray(ref._expand_call(
        jnp.asarray(merged), jnp.asarray(hub["x_starts"]),
        jnp.asarray(hub["x_desc"]), g.num_nodes()))
    got = K.expand(t(merged), t(hub["x_starts"]), t(hub["x_desc"]),
                   g.num_nodes())
    np.testing.assert_array_equal(got.numpy(), want)
    # The fill-gather through t_inv computes the same function.
    t_inv = np.asarray(hub["t_inv"]).astype(np.int64)
    gather = np.where((t_inv < m_pad)[:, None],
                      merged[np.minimum(t_inv, m_pad - 1)], 0.0)
    np.testing.assert_array_equal(got.numpy(), gather)


def _tail2(g, hub, m):
    n_rows = int(sum(n for _, n in m.tail_meta_src))
    m_tail_pad = -(-max(n_rows, 1) // 32) * 32
    return _pad(feats(n_rows, F, seed=6), m_tail_pad)


def test_dense_bwd_fused_matches_reference(case):
    g, hub, m = case
    c = hub["dense_c"]
    assert len(hub["gb_desc"]) > 0
    ct = _pad(feats(m.n_dense * BLK, F, seed=7), m.n_dense * BLK)
    tail2 = _tail2(g, hub, m)
    want = np.asarray(ref._dense_bwd_fused_call(
        jnp.asarray(c), jnp.asarray(ct), jnp.asarray(tail2),
        jnp.asarray(hub["gb_starts"]), jnp.asarray(hub["gb_desc"])))
    tc = t(c, np.float32).to(K_dtype(c))
    desc = (t(hub["gb_starts"]), t(hub["gb_desc"]))
    got = K.dense_bwd_fused(tc, t(ct), t(tail2), *desc)
    c64 = _f64(np.asarray(c).astype(np.float64))
    want64 = K.dense_bwd_fused_torch(c64, _f64(ct), _f64(tail2),
                                     *desc).numpy()
    abs64 = K.dense_bwd_fused_torch(c64.abs(), _f64(np.abs(ct)),
                                    _f64(np.abs(tail2)), *desc).numpy()
    _both_held(got.numpy(), want, want64, abs64)
    n = g.num_nodes()
    got2 = K.dense_bwd_fused(tc, t(ct[:, :F]), t(tail2[:, :F]), *desc, n)
    _both_held(got2.numpy(), want[:n, :F], want64[:n, :F], abs64[:n, :F])


def test_dense_bwd_matches_reference(case):
    g, hub, m = case
    c = hub["dense_c"]
    ct = _pad(feats(m.n_dense * BLK, F, seed=8), m.n_dense * BLK)
    want = np.asarray(ref._dense_bwd_call(jnp.asarray(c), jnp.asarray(ct)))
    got = K.dense_bwd(t(c, np.float32).to(K_dtype(c)), t(ct))
    c64 = np.asarray(c).astype(np.float64)
    _both_held(got.numpy(), want, c64 @ ct.astype(np.float64),
               np.abs(c64) @ np.abs(ct).astype(np.float64))


def test_wrappers_check_inputs_and_count_only_launches():
    K.reset_launches()
    c = torch.zeros((1024, 128), dtype=torch.int8)
    u = torch.ones((1000, 4))
    assert K.dense_fwd(c, u).shape == (128, 4)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain version ran
    with pytest.raises(TypeError):
        K.dense_fwd(c, u.double())
    with pytest.raises(ValueError):
        K.dense_fwd(c, torch.ones((2000, 4)))
    with pytest.raises(ValueError):
        K.dense_bwd(c, torch.ones((128, 4)).t())
    with pytest.raises(TypeError):
        K.expand(torch.ones((3, 4)), torch.zeros(3, dtype=torch.int64),
                 torch.zeros(3, dtype=torch.int32), 10)


@pytest.mark.parametrize("f,shift", [(1, 0), (3, 1), (40, 0), (40, 2),
                                     (128, 3)])
def test_rows16_pads_rows_for_16_byte_copies(f, shift):
    """K1 and K2 copy input rows 16 bytes at a time: ``_rows16`` hands an
    input on as it is when its rows are a multiple of 4 floats on a
    16-byte boundary, else a zero-padded copy of a width that is."""
    flat = torch.arange(7 * f + shift, dtype=torch.float32)
    x = flat[shift:].view(7, f)
    y, ld = K._rows16(x)
    assert ld % 4 == 0 and ld >= f and y.shape == (7, ld)
    assert y.data_ptr() % 16 == 0
    assert torch.equal(y[:, :f], x) and not bool(y[:, f:].any())
    if f % 4 == 0 and x.data_ptr() % 16 == 0:
        assert y is x


@pytest.mark.parametrize("chunk,ok", [(1024, True), (256, True), (4, True),
                                      (2048, False), (6, False)])
def test_walkable_names_the_layout_rule(chunk, ok):
    """The staged chunk walk takes chunks of at most 1024 slots, a
    multiple of 4, with its slot arrays on 16-byte boundaries; anything
    else raises a ValueError naming the rule."""
    lay = {k: torch.zeros(2 * chunk, dtype=torch.int32) for k in ("a", "b")}
    if ok:
        K._walkable("K2", lay, chunk, ("a", "b"))
    else:
        with pytest.raises(ValueError, match="chunks of at most 1024"):
            K._walkable("K2", lay, chunk, ("a", "b"))
    lay["b"] = torch.zeros(2 * chunk + 1, dtype=torch.int32)[1:]
    with pytest.raises(ValueError, match="16-byte boundary|chunks of"):
        K._walkable("K2", lay, chunk, ("a", "b"))


def test_chunk_walk_variants_source_applies():
    """``tools/chunk_walk_variants.py`` times the chunk walk's choices on
    a card from a variant of ``hub_kernels.cu`` made by replacing fixed
    snippets: each must still be found once, the variant keeps every C
    entry and adds its switch, and a source without a snippet raises."""
    from dgl1_tpu_torch import cuda_build
    from dgl1_tpu_torch.tools.chunk_walk_variants import variant_source

    src = cuda_build.SOURCES["hub_kernels"].read_text()
    out = variant_source(src)
    for entry in cuda_build._SIGNATURES["hub_kernels"]:
        assert out.count(f"int {entry}(") == 1, entry
    assert "int hub_chunk_walk_variant(int hist_warp, int rows_owned)" in out
    assert "HIST_WARP" not in src and "ROWS_OWNED" not in src
    with pytest.raises(ValueError, match="no longer holds"):
        variant_source(src.replace("chunk_walk_kernel(", "walk_kernel(", 1))
