"""The port's layout builders against the reference's: every hub_dst and
ELL array and every HubMeta field equal for the same edges."""

import numpy as np
import pytest
import torch

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.hub_format import DENSE_RB, EXPAND_PACK, EXPAND_RB

from torch_parity import both_graphs, make, skewed_edges

_TORCH_OF = {"int8": torch.int8, "bfloat16": torch.bfloat16,
             "float32": torch.float32}


def _assert_tree_equal(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            _assert_tree_equal(ref[k], port[k], f"{path}/{k}")
        return
    r = np.asarray(ref)
    assert isinstance(port, torch.Tensor), path
    if r.dtype.name in _TORCH_OF and r.dtype.name != "float32":
        assert port.dtype == _TORCH_OF[r.dtype.name], path
    p = port.float().numpy() if port.dtype == torch.bfloat16 \
        else port.numpy()
    assert r.shape == p.shape, path
    np.testing.assert_array_equal(r.astype(np.float64),
                                  p.astype(np.float64), err_msg=path)


def _assert_graphs_equal(gj, gt):
    assert gj.hub_dst_meta == gt.hub_dst_meta
    assert gj.ell_dst_meta == gt.ell_dst_meta
    assert gj.ell_src_meta == gt.ell_src_meta
    for name in ("src", "dst", "csr_indptr", "csr_dst", "csr_eid",
                 "csc_indptr", "csc_src", "csc_eid", "csc_dst"):
        _assert_tree_equal(getattr(gj, name), getattr(gt, name), name)
    _assert_tree_equal(gj.ell_dst, gt.ell_dst, "ell_dst")
    _assert_tree_equal(gj.ell_src, gt.ell_src, "ell_src")
    if gj.hub_dst is None:
        assert gt.hub_dst is None
    else:
        _assert_tree_equal(gj.hub_dst, gt.hub_dst, "hub_dst")


@pytest.mark.parametrize("name,self_loops,relabel", [
    ("chunked", False, False), ("dense", False, False),
    ("mixed", False, False), ("mixed", True, False),
    ("powerlaw", False, False), ("powerlaw", False, True),
    ("powerlaw", True, False),
])
def test_layout_matches_reference(name, self_loops, relabel):
    gj, gt = make(name, self_loops=self_loops, relabel=relabel)
    assert gt.hub_dst_meta is not None
    _assert_graphs_equal(gj, gt)
    if self_loops:
        assert gt.hub_dst_meta.has_diag
    if relabel:
        assert gt.hub_dst_meta.identity_expand
        np.testing.assert_array_equal(np.asarray(gj.ndata["_ID"]),
                                      gt.ndata["_ID"].numpy())


@pytest.mark.parametrize("mult,dtype", [(100, torch.int8),
                                        (200, torch.bfloat16),
                                        (300, torch.float32)])
def test_dense_counts_dtype(mult, dtype):
    """Counts <= 127 are int8, 128..256 bf16 (float32 in numpy until the
    tensor is made), beyond that float32 — as the reference stores them."""
    src, dst = skewed_edges()
    src = np.concatenate([src, np.full(mult, 5)])
    dst = np.concatenate([dst, np.full(mult, 7)])
    gj, gt = both_graphs(src, dst, 300, hub=300, hub_dense_floor=1)
    assert gt.hub_dst["dense_c"].dtype == dtype
    assert float(gt.hub_dst["dense_c"].float().max()) >= mult
    _assert_graphs_equal(gj, gt)


def test_cora_scale_graph_has_no_hub_layout():
    gj = jdgl.data.synthetic_classification_graph(
        num_nodes=2708, num_classes=7, feat_dim=16, seed=0)
    gt = tdgl.data.synthetic_classification_graph(
        num_nodes=2708, num_classes=7, feat_dim=16, seed=0, device="cpu")
    assert gj.hub_dst_meta is None and gt.hub_dst_meta is None
    _assert_graphs_equal(gj, gt)
    for k in ("feat", "label", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(np.asarray(gj.ndata[k]),
                                      gt.ndata[k].numpy())


@pytest.mark.parametrize("name", ["mixed", "powerlaw"])
def test_descriptor_rows_unique_per_block(name):
    """The expand and fused-backward kernels write each descriptor's row
    without atomics: no row may appear twice in a block."""
    _, gt = make(name, self_loops=True)
    hub = gt.hub_dst
    for starts, desc, rb in ((hub["x_starts"], hub["x_desc"], EXPAND_RB),
                             (hub["gb_starts"], hub["gb_desc"], DENSE_RB)):
        s = starts.numpy().astype(np.int64)
        d = desc.numpy().astype(np.int64)
        assert len(d) > 0
        n_blocks = -(-gt.num_nodes() // rb)
        for b in range(n_blocks):
            rows = d[s[b]:s[b + 1]] // EXPAND_PACK
            assert len(np.unique(rows)) == len(rows)
            assert (rows < rb).all()


def test_numpy_fallback_matches_native(monkeypatch):
    """The ELL and CSR/CSC builders give the same arrays without the C++
    library."""
    from dgl1_tpu_torch import _native

    src, dst = skewed_edges(seed=3)
    native = tdgl.graph((src, dst), num_nodes=300, hub=300, device="cpu")
    monkeypatch.setattr(_native, "lib", lambda: None)
    plain = tdgl.graph((src, dst), num_nodes=300, hub=300, device="cpu")
    for name in ("csr_indptr", "csr_dst", "csr_eid", "csc_indptr",
                 "csc_src", "csc_eid", "csc_dst"):
        assert torch.equal(getattr(native, name), getattr(plain, name))
    assert native.ell_dst_meta == plain.ell_dst_meta
    assert native.hub_dst_meta == plain.hub_dst_meta
    for k in ("idx", "eid", "inv_perm"):
        assert torch.equal(native.ell_dst[k], plain.ell_dst[k])
        assert torch.equal(native.ell_src[k], plain.ell_src[k])


def test_graph_to_keeps_metadata():
    _, gt = make("mixed")
    g2 = gt.to("cpu")
    assert g2.hub_dst_meta == gt.hub_dst_meta
    assert g2.num_edges() == gt.num_edges()
    assert torch.equal(g2.hub_dst["part_fwd"]["a"],
                       gt.hub_dst["part_fwd"]["a"])
    assert torch.equal(g2.in_degrees().long(), torch.bincount(
        gt.dst[: gt.num_edges()].long(), minlength=gt.num_nodes()))
    assert tdgl.resolve_device("cpu").type == "cpu"


_SRC4, _DST4 = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])


@pytest.mark.parametrize("args,kw", [
    ((4, 8), {}),                                  # pad_edges_to, by place
    ((4,), {"pad_edges_to": 8}),
    ((4, None, 3), {}),                            # pad_edges_multiple
    ((4,), {"pad_edges_multiple": 16}),            # at least one multiple
    ((4, None, 2), {}),                            # already a multiple
    ((4, 5, 3), {}),                               # pad_edges_to wins
    ((4, None, None, True), {}),                   # device_arrays
    ((), {}),
])
def test_graph_takes_the_reference_positional_order(args, kw):
    """``graph(data, num_nodes, pad_edges_to, pad_edges_multiple,
    device_arrays, hub, hub_dense_floor, formats)`` in both packages, by
    position and by keyword: the same real and padded edge counts, edge
    arrays and edge mask. ``graph((src, dst), 4, 8)`` pads to 8 edges."""
    gj = jdgl.graph((_SRC4, _DST4), *args, **kw)
    gt = tdgl.graph((_SRC4, _DST4), *args, device="cpu", **kw)
    assert gt.num_edges() == gj.num_edges() == 4
    assert gt.num_edges_padded() == gj.num_edges_padded()
    for k in ("src", "dst", "csc_src", "csc_eid"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k)), k)
    # The port keeps no mask where no edge is padding.
    mask_t = (np.ones(4, bool) if gt.edge_mask is None
              else gt.edge_mask.numpy())
    np.testing.assert_array_equal(mask_t, np.asarray(gj.edge_mask))
    if args[1:2] == (8,):
        assert gt.num_edges_padded() == 8


def test_graph_hub_arguments_by_position():
    """``hub`` and ``hub_dense_floor`` in the reference's places (sixth and
    seventh) build the same hub layout as by keyword."""
    src, dst = skewed_edges()
    gj = jdgl.graph((src, dst), 300, None, None, False, 300, 1000)
    gt = tdgl.graph((src, dst), 300, None, None, False, 300, 1000,
                    device="cpu")
    assert gt.hub_dst_meta == tdgl.graph(
        (src, dst), num_nodes=300, hub=300, hub_dense_floor=1000,
        device="cpu").hub_dst_meta
    _assert_graphs_equal(gj, gt)
