"""The port's sampling pipeline against the JAX package, bit for bit.

- the sampling-only parent (``graph(formats=("csc",))``) and the smoke
  scale of ``tools/bench_minibatch.py``'s generator equal the reference's;
- ``sample_block_fused`` and ``NeighborSampler([10, 25])`` give the same
  blocks for the same seed: every array of COO, CSC, CSR, the uniform ELL,
  both padded tile layouts, the id maps and the real counts;
- ``NodeDataLoader(num_workers=2, prefetch=2, seed=0)`` gives the same
  batch sequence, blocks and last-batch mask;
- what is not ported yet raises NotImplementedError.
"""

import numpy as np
import pytest
import torch

import dgl1_tpu_torch as tdgl
from dgl1_tpu.dataloading import NeighborSampler as JSampler
from dgl1_tpu.dataloading import NodeDataLoader as JLoader
from dgl1_tpu.sampling.fused import sample_block_fused as jsample
from dgl1_tpu_torch import _native as tnative
from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
from dgl1_tpu_torch.sampling import sample_block_fused

from tools.bench_minibatch import build_graph

_ARRAYS = ("src", "dst", "edge_mask", "csr_indptr", "csr_dst", "csr_eid",
           "csr_src", "csc_indptr", "csc_src", "csc_eid", "csc_dst")


@pytest.fixture(scope="module")
def parents():
    gj, fj, cj, tj = build_graph("smoke")
    gt, ft, ct, tt = tdgl.data.minibatch_graph("smoke")
    assert (fj, cj) == (ft, ct) == (32, 7)
    np.testing.assert_array_equal(tt, tj)
    return gj, gt, tt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_block(bt, bj):
    assert bt.is_block and bj.is_block
    assert (bt.num_src_nodes(), bt.num_dst_nodes()) == (
        bj.num_src_nodes(), bj.num_dst_nodes())
    assert bt.num_edges() == bj.num_real_edges()
    assert bt.num_edges_padded() == bj.num_edges_padded()
    assert bt.meta == {k: bj.meta[k] for k in ("num_real_src",
                                              "num_real_dst")}
    for k in _ARRAYS:
        np.testing.assert_array_equal(_np(getattr(bt, k)),
                                      _np(getattr(bj, k)), err_msg=k)
    for k in ("tdst", "tsrc", "ell_dst"):
        a, b = getattr(bt, k), getattr(bj, k)
        assert set(a) == set(b)
        for kk in a:
            np.testing.assert_array_equal(_np(a[kk]), _np(b[kk]),
                                          err_msg=f"{k}.{kk}")
    assert bt.ell_dst_meta == bj.ell_dst_meta
    assert bt.ell_src is None and bj.ell_src is None
    for d_t, d_j in ((bt.srcdata, bj.srcdata), (bt.dstdata, bj.dstdata),
                     (bt.edata, bj.edata)):
        np.testing.assert_array_equal(_np(d_t["_ID"]), _np(d_j["_ID"]))


def test_csc_only_parent_matches_reference(parents):
    gj, gt, _ = parents
    assert gt.num_nodes() == gj.num_nodes() == 20_000
    assert gt.num_edges() == gj.num_edges() == 200_000
    for k in ("src", "dst", "csc_indptr", "csc_src", "csc_eid", "csc_dst"):
        np.testing.assert_array_equal(_np(getattr(gt, k)),
                                      _np(getattr(gj, k)), err_msg=k)
    # The sampling-only parent skips CSR and every engine layout.
    for k in ("csr_indptr", "csr_dst", "tdst", "tsrc", "ell_dst", "ell_src",
              "hub_dst"):
        assert getattr(gt, k) is None, k
    with pytest.raises(ValueError, match="without CSR"):
        gt.out_degrees()


@pytest.mark.parametrize("fanout,n_real", [(10, 200), (25, 256), (3, 1)])
def test_sample_block_fused_matches_reference(parents, fanout, n_real):
    gj, gt, train = parents
    seeds = np.concatenate([train[:n_real],
                            np.full(256 - n_real, train[n_real - 1])])
    kw = dict(pad_src_to=256 * (fanout + 1), pad_edges_to=256 * fanout)
    bj = jsample(gj, seeds, n_real, fanout,
                 rng=np.random.default_rng(42), **kw)
    bt = sample_block_fused(gt, seeds, n_real, fanout,
                            rng=np.random.default_rng(42), **kw)
    assert_same_block(bt, bj)
    assert 0 < bt.num_edges() <= n_real * fanout
    assert bt.device.type == "cpu"


def test_neighbor_sampler_matches_reference(parents):
    gj, gt, train = parents
    seeds = train[:300]
    ij, oj, blocks_j = JSampler([10, 25]).sample_blocks(
        gj, seeds, rng=np.random.default_rng(5), num_real=290)
    it, ot, blocks_t = NeighborSampler([10, 25]).sample_blocks(
        gt, seeds, rng=np.random.default_rng(5), num_real=290)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_array_equal(ot, np.asarray(oj))
    assert len(blocks_t) == 2
    for bt, bj in zip(blocks_t, blocks_j):
        assert_same_block(bt, bj)
    # Static bounds: (300 * 26 * 11, 300 * 26 * 10) for block 0.
    assert blocks_t[0].num_src_nodes() == 300 * 26 * 11
    assert blocks_t[0].num_edges_padded() == 300 * 26 * 10


def test_node_dataloader_matches_reference(parents):
    gj, gt, train = parents
    kw = dict(batch_size=1024, shuffle=True, seed=0, num_workers=2,
              prefetch=2)
    jb = list(JLoader(gj, train, JSampler([10, 25]), **kw))
    loader = NodeDataLoader(gt, train, NeighborSampler([10, 25]),
                            device="cpu", **kw)
    tb = list(loader)
    assert len(tb) == len(jb) == len(loader) == 4
    for (it, ot, bt, mt), (ij, oj, bj, mj) in zip(tb, jb):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        for b1, b2 in zip(bt, bj):
            assert_same_block(b1, b2)
    # The short last batch: 4000 - 3 * 1024 real seeds, then padding.
    assert int(tb[-1][3].sum()) == 4000 - 3 * 1024
    assert len(loader.sample_s) == 4
    # Inline sampling (prefetch=0) gives another batch order but the same
    # shapes; the seed set is covered once.
    inline = list(NodeDataLoader(gt, train, NeighborSampler([10, 25]),
                                 batch_size=1024, seed=0, prefetch=0,
                                 device="cpu"))
    seen = np.concatenate([o[m].numpy() for _, o, _, m in inline])
    np.testing.assert_array_equal(np.sort(seen), np.sort(train))


def test_unported_sampling_paths_raise(parents, monkeypatch):
    _, gt, train = parents
    with pytest.raises(NotImplementedError, match="negative"):
        NeighborSampler([-1, 10])
    with pytest.raises(NotImplementedError):
        NeighborSampler([10], replace=True)
    with pytest.raises(NotImplementedError):
        NeighborSampler([10], prob="w")
    s = NeighborSampler([10])
    with pytest.raises(NotImplementedError, match="exclude_eids"):
        s.sample_blocks(gt, train[:8], exclude_eids=np.arange(3))
    with pytest.raises(NotImplementedError, match="heterographs"):
        s.sample_blocks(gt, {"user": train[:8]})
    monkeypatch.setattr(tnative, "lib", lambda: None)
    with pytest.raises(NotImplementedError, match="native"):
        s.sample_blocks(gt, train[:8])


def test_blocks_move_to_the_loader_device(parents):
    _, gt, train = parents
    (inp, out, blocks, mask), = list(NodeDataLoader(
        gt, train[:64], NeighborSampler([2, 3]), batch_size=64, seed=1,
        device="cpu"))
    assert inp.dtype == out.dtype == torch.int64 and mask.dtype == torch.bool
    b = blocks[1].to("cpu")
    assert b.is_block and b.meta == blocks[1].meta
    assert b.tsrc["lid"].shape == blocks[1].tsrc["lid"].shape
    assert torch.equal(b.srcdata["_ID"], blocks[1].srcdata["_ID"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NodeDataLoader(gt, train, NeighborSampler([2]))
