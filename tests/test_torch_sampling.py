"""The port's sampling pipeline against the JAX package, bit for bit.

- the sampling-only parent (``graph(formats=("csc",))``) and the smoke
  scale of ``tools/bench_minibatch.py``'s generator equal the reference's;
- ``sample_block_fused`` and ``NeighborSampler([10, 25])`` give the same
  blocks for the same seed: every array of COO, CSC, CSR, the uniform ELL,
  both padded tile layouts, the id maps and the real counts;
- ``NodeDataLoader(num_workers=2, prefetch=2, seed=0)`` gives the same
  batch sequence, blocks and last-batch mask;
- the paths that raised before the numpy sampler was ported (negative
  fanouts, ``replace``, ``prob``, ``exclude_eids``, heterographs,
  ``static_shapes=False``, no native library) give the reference's blocks.
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

import jax.numpy as jnp

import dgl1_tpu as jdgl
from dgl1_tpu import _native as jnative
from test_torch_neighbor import assert_block_equal, assert_hetero_equal
from tools.bench_minibatch import build_graph
# The reference's sampler needs its native library, loaded under a lock.
from torch_parity import reference_native  # noqa: F401

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


def test_static_shapes_matches_reference(parents):
    """``static_shapes=`` as the reference takes it: True (its default)
    gives the reference's padded blocks; False, the numpy sampler's
    unpadded path, the reference's unpadded blocks. The same holds for
    ``MultiLayerNeighborSampler``."""
    from dgl1_tpu_torch.dataloading import MultiLayerNeighborSampler

    gj, gt, train = parents
    seeds = train[:64]
    _, _, blocks_j = JSampler([10, 25], static_shapes=True).sample_blocks(
        gj, seeds, rng=np.random.default_rng(8), num_real=60)
    for cls in (NeighborSampler, MultiLayerNeighborSampler):
        s = cls([10, 25], static_shapes=True)
        assert s.static_shapes is True
        _, _, blocks_t = s.sample_blocks(
            gt, seeds, rng=np.random.default_rng(8), num_real=60)
        for bt, bj in zip(blocks_t, blocks_j):
            assert_same_block(bt, bj)
        s = cls([10, 25], static_shapes=False)
        assert s.static_shapes is False
        _, _, unpadded_t = s.sample_blocks(
            gt, seeds, rng=np.random.default_rng(8), num_real=60)
        _, _, unpadded_j = JSampler([10, 25], static_shapes=False) \
            .sample_blocks(gj, seeds, rng=np.random.default_rng(8),
                           num_real=60)
        for bt, bj in zip(unpadded_t, unpadded_j):
            assert_block_equal(bj, bt, "unpadded")
            assert bt.num_edges_padded() == bt.num_edges()


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
    """What raised NotImplementedError before the numpy sampler was ported
    now samples the reference's blocks: a negative fanout, ``replace``,
    ``prob``, ``exclude_eids``, a heterograph, and a process without the
    native library (the numpy path there, in both packages)."""
    gj, gt, train = parents
    seeds = train[:40]

    def same(kw, g=(gj, gt), seed_nodes=seeds, **call):
        rj = JSampler(**kw).sample_blocks(
            g[0], seed_nodes, rng=np.random.default_rng(3), **call)
        rt = NeighborSampler(**kw).sample_blocks(
            g[1], seed_nodes, rng=np.random.default_rng(3), **call)
        for bj, bt in zip(rj[2], rt[2]):
            if isinstance(bt, tdgl.HeteroGraph):
                assert_hetero_equal(bj, bt)
            else:
                assert_block_equal(bj, bt, str(kw))
        return rt

    same(dict(fanouts=[-1, 10]))
    same(dict(fanouts=[10], replace=True))
    w = np.random.default_rng(4).random(gt.num_edges()).astype(np.float32)
    gj.edata["w"], gt.edata["w"] = jnp.asarray(w), torch.from_numpy(w)
    try:
        same(dict(fanouts=[10], prob="w"))
    finally:
        del gj.edata["w"], gt.edata["w"]
    _, _, (b,) = same(dict(fanouts=[10]), exclude_eids=np.arange(0, 200_000,
                                                                 2))
    assert not (b.edata["_ID"].numpy()[: b.num_edges()] % 2 == 0).any()
    src, dst = gt.src.numpy()[:5000], gt.dst.numpy()[:5000]
    c = ("user", "follows", "user")
    hg = (jdgl.heterograph({c: (src, dst)}, num_nodes_dict={"user": 20000}),
          tdgl.heterograph({c: (src, dst)}, num_nodes_dict={"user": 20000},
                           device="cpu"))
    same(dict(fanouts=[3, 2]), g=hg, seed_nodes={"user": seeds})
    monkeypatch.setattr(tnative, "lib", lambda: None)
    monkeypatch.setattr(jnative, "lib", lambda: None)
    same(dict(fanouts=[10, 25]), num_real=35)


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
