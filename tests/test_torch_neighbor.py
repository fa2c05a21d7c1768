"""The port's numpy sampler and block builders against the JAX package,
array for array, on the CPU:

- ``sample_neighbors`` (homogeneous and hetero, ``edge_dir='out'``,
  ``prob``, ``replace``, fanout -1) and ``select_topk`` draw the same edges
  from the same ``default_rng(seed)``;
- ``to_block``, ``to_block_hetero``, ``block(uniform_ell_k=)``,
  ``node_subgraph`` and ``compact_graphs`` give the same ids, edges,
  masks, ELL and tile arrays;
- ``NeighborSampler`` on the numpy path (``exclude_eids``, ``prob``,
  ``replace``, ``static_shapes=False``, negative fanouts, heterographs)
  and ``MultiLayerFullNeighborSampler`` give the same blocks, with the
  fused path switched off in both packages where it would apply;
- a seed given twice keeps two dst rows, as the fused sampler keeps
  them (the reference's numpy path merges them and overflows its
  uniform ELL).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import transform as jtransform
from dgl1_tpu.data.synthetic import synthetic_mag_heterograph as jmag
from dgl1_tpu.dataloading import neighbor_sampler as jns
from dgl1_tpu.sampling import neighbor as jneighbor
from dgl1_tpu_torch import transform as ttransform
from dgl1_tpu_torch.dataloading import neighbor_sampler as tns
from dgl1_tpu_torch.sampling import neighbor as tneighbor

from torch_parity import powerlaw_edges, t

N = 400
_EDGE_ARRAYS = ("src", "dst", "csr_indptr", "csr_dst", "csr_eid", "csr_src",
                "csc_indptr", "csc_src", "csc_eid", "csc_dst")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _tree_equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}.{k}")
        return
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=what)


def assert_block_equal(bj, bt, what="block", csr=True):
    """Every array of a reference graph or block and the port's: COO,
    CSR, CSC, the edge mask (the reference keeps an all-True one where
    the port has None), ELL, tiles, id maps and the real counts. With
    ``csr`` False (a frontier built with ``formats=("coo",)``) the port
    has no CSR, which the reference always builds."""
    assert (bj.num_src_nodes(), bj.num_dst_nodes()) == (
        bt.num_src_nodes(), bt.num_dst_nodes()), what
    assert bj.num_edges_padded() == bt.num_edges_padded(), what
    real = bj.meta.get("num_real_edges", bj.num_edges())
    assert bt.num_edges() == real, what
    if "num_real_edges" in bt.meta:  # block(uniform_ell_k=) sets it
        assert bt.meta["num_real_edges"] == real, what
    for k in _EDGE_ARRAYS:
        if not csr and k.startswith("csr"):
            assert getattr(bt, k) is None, (what, k)
            continue
        _tree_equal(getattr(bj, k), getattr(bt, k), f"{what}.{k}")
    mj = np.asarray(bj.edge_mask)
    mt = (np.ones(bt.num_edges_padded(), bool) if bt.edge_mask is None
          else bt.edge_mask.numpy())
    np.testing.assert_array_equal(mj, mt, err_msg=f"{what}.edge_mask")
    for k in ("ell_dst", "ell_src", "tdst", "tsrc"):
        _tree_equal(getattr(bj, k), getattr(bt, k), f"{what}.{k}")
    assert bj.ell_dst_meta == bt.ell_dst_meta, what
    assert bj.ell_src_meta == bt.ell_src_meta, what
    for k in ("num_real_src", "num_real_dst"):
        assert bj.meta.get(k) == bt.meta.get(k), (what, k)
    frames = ((bj.srcdata, bt.srcdata), (bj.dstdata, bt.dstdata),
              (bj.edata, bt.edata)) if bj.is_block else (
        (bj.ndata, bt.ndata), (bj.edata, bt.edata))
    for fj, ft in frames:
        assert ("_ID" in fj) == ("_ID" in ft), what
        if "_ID" in fj:
            np.testing.assert_array_equal(_np(fj["_ID"]), _np(ft["_ID"]),
                                          err_msg=f"{what}._ID")


def assert_hetero_equal(hj, ht, what="hetero", csr=True):
    assert hj.canonical_etypes == ht.canonical_etypes
    assert hj.ntypes == ht.ntypes
    for c in hj.canonical_etypes:
        assert_block_equal(hj.rel_graphs[c], ht.rel_graphs[c], f"{what}{c}",
                           csr)
    assert hj.meta == ht.meta
    if hj.is_block:
        for nt in hj.srctypes:
            assert hj.num_src_nodes(nt) == ht.num_src_nodes(nt)
            np.testing.assert_array_equal(
                _np(hj.srcframes[nt]["_ID"]), _np(ht.srcframes[nt]["_ID"]))
        for nt in hj.dsttypes:
            np.testing.assert_array_equal(
                _np(hj.nframes[nt]["_ID"]), _np(ht.nframes[nt]["_ID"]))


@pytest.fixture(scope="module")
def homo():
    src, dst = powerlaw_edges(N, 6, seed=11)
    gj = jdgl.graph((src, dst), num_nodes=N)
    gt = tdgl.graph((src, dst), num_nodes=N, device="cpu")
    w = np.random.default_rng(12).random(len(src)).astype(np.float32)
    gj.edata["w"] = jnp.asarray(w)
    gt.edata["w"] = t(w)
    seeds = np.random.default_rng(13).choice(N, 60, replace=False)
    return gj, gt, seeds


@pytest.fixture(scope="module")
def mag():
    hj, sj = jmag(scale=2048)
    ht, st = tdgl.data.synthetic_mag_heterograph(scale=2048, device="cpu")
    np.testing.assert_array_equal(np.asarray(sj["train"]), st["train"])
    return hj, ht, st["train"]


@pytest.fixture
def numpy_path(monkeypatch):
    """The fused sampler off in both packages."""
    monkeypatch.setattr(jns, "supports_fused", lambda *a: False)
    monkeypatch.setattr(tns, "supports_fused", lambda *a: False)


@pytest.mark.parametrize("kw", [
    dict(fanout=3), dict(fanout=5, replace=True), dict(fanout=4, prob="w"),
    dict(fanout=-1), dict(fanout=3, edge_dir="out"), dict(fanout=0)])
def test_sample_neighbors_matches_reference(homo, kw):
    gj, gt, seeds = homo
    fj = jneighbor.sample_neighbors(gj, seeds, rng=np.random.default_rng(1),
                                    **kw)
    ft = tneighbor.sample_neighbors(gt, seeds, rng=np.random.default_rng(1),
                                    **kw)
    assert ft.device.type == "cpu"
    assert_block_equal(fj, ft, f"frontier {kw}")
    if kw.get("fanout", 0) > 0 and "replace" not in kw:
        deg = np.bincount(_np(ft.dst)[: ft.num_edges()]
                          if kw.get("edge_dir") != "out"
                          else _np(ft.src)[: ft.num_edges()], minlength=N)
        assert deg.max() <= kw["fanout"]


@pytest.mark.parametrize("fanout", [3, {"cites": 2, "writes": 4,
                                        "rev_has_topic": 1,
                                        "rev_writes": 2,
                                        "has_topic": 3,
                                        "affiliated_with": 1,
                                        "rev_affiliated_with": 0}])
@pytest.mark.parametrize("edge_dir", ["in", "out"])
def test_hetero_sample_neighbors_matches_reference(mag, fanout, edge_dir):
    hj, ht, train = mag
    nodes = {"paper": train[:40], "author": np.arange(0, 554, 11)}
    fj = jneighbor.sample_neighbors(hj, nodes, fanout, edge_dir=edge_dir,
                                    rng=np.random.default_rng(4))
    ft = tneighbor.sample_neighbors(ht, nodes, fanout, edge_dir=edge_dir,
                                    rng=np.random.default_rng(4))
    assert_hetero_equal(fj, ft, "frontier", csr=False)


@pytest.mark.parametrize("edge_dir,ascending", [("in", False),
                                                ("out", True)])
def test_select_topk_matches_reference(homo, edge_dir, ascending):
    gj, gt, seeds = homo
    sj = jneighbor.select_topk(gj, 2, "w", nodes=seeds, edge_dir=edge_dir,
                               ascending=ascending)
    st = tneighbor.select_topk(gt, 2, "w", nodes=seeds, edge_dir=edge_dir,
                               ascending=ascending)
    assert_block_equal(sj, st, "topk")


def test_block_uniform_ell_k_matches_reference():
    rng = np.random.default_rng(2)
    dst = np.repeat(np.arange(50), rng.integers(0, 6, 50))
    src = rng.integers(0, 300, len(dst))
    for pad in (None, 400):
        bj = jdgl.block((src, dst), 300, 64, pad_edges_to=pad,
                        uniform_ell_k=5)
        bt = tdgl.block((src, dst), 300, 64, pad_edges_to=pad,
                        uniform_ell_k=5, device="cpu")
        assert_block_equal(bj, bt, f"uniform pad={pad}")
        assert bt.ell_dst_meta == ((6, 64),)
    with pytest.raises(ValueError, match="uniform ELL width"):
        tdgl.block((src, dst), 300, 64, uniform_ell_k=2, device="cpu")
    # An empty relation of a hetero block: no dst node, no edge.
    e = np.zeros(0, np.int64)
    bt = tdgl.block((e, e), 300, 0, pad_edges_to=0, uniform_ell_k=10,
                    device="cpu")
    assert_block_equal(jdgl.block((e, e), 300, 0, pad_edges_to=0,
                                  uniform_ell_k=10), bt, "empty")


@pytest.mark.parametrize("pad", [False, True])
def test_to_block_matches_reference(homo, pad):
    gj, gt, seeds = homo
    fj = jneighbor.sample_neighbors(gj, seeds[:50], 4,
                                    rng=np.random.default_rng(3))
    ft = tneighbor.sample_neighbors(gt, seeds[:50], 4,
                                    rng=np.random.default_rng(3))
    kw = (dict(num_real_dst=50, pad_src_to=60 * 5, pad_edges_to=60 * 4,
               uniform_k=4) if pad else {})
    bj = jtransform.to_block(fj, seeds, **kw) if pad else \
        jtransform.to_block(fj, seeds[:50])
    bt = ttransform.to_block(ft, seeds, **kw) if pad else \
        ttransform.to_block(ft, seeds[:50])
    assert_block_equal(bj, bt, "to_block")
    assert bt.meta["num_real_dst"] == 50
    bj2 = jtransform.to_block(fj, seeds[:50], include_dst_in_src=False)
    bt2 = ttransform.to_block(ft, seeds[:50], include_dst_in_src=False)
    assert_block_equal(bj2, bt2, "to_block without dst")


def test_to_block_hetero_matches_reference(mag):
    hj, ht, train = mag
    nodes = {"paper": train[:30], "author": np.arange(5, 300, 7)}
    fj = jneighbor.sample_neighbors(hj, nodes, 3,
                                    rng=np.random.default_rng(6))
    ft = tneighbor.sample_neighbors(ht, nodes, 3,
                                    rng=np.random.default_rng(6))
    dst = {"paper": np.concatenate([train[:30], [train[29]] * 2]),
           "author": nodes["author"]}
    real = {"paper": 30, "author": len(nodes["author"])}
    bj = jtransform.to_block(fj, dst, num_real_dst=real)
    bt = ttransform.to_block(ft, dst, num_real_dst=real)
    assert_hetero_equal(bj, bt, "to_block_hetero")
    # The relations into institution and field_of_study have no dst node.
    assert bt[("author", "affiliated_with", "institution")].num_dst_nodes() \
        == 0


def test_node_subgraph_and_compact_graphs_match_reference(homo):
    gj, gt, seeds = homo
    sj = jtransform.node_subgraph(gj, seeds)
    st = ttransform.node_subgraph(gt, seeds)
    assert_block_equal(sj, st, "node_subgraph")
    np.testing.assert_array_equal(np.asarray(sj.edata["w"]),
                                  st.edata["w"].numpy())
    mask = np.zeros(N, bool)
    mask[seeds] = True
    assert_block_equal(jtransform.node_subgraph(gj, mask),
                       ttransform.node_subgraph(gt, mask), "mask")
    rng = np.random.default_rng(8)
    a = (rng.integers(0, 30, 40) * 3, rng.integers(0, 30, 40) * 3)
    b = (rng.integers(0, 20, 25) * 5, rng.integers(0, 20, 25) * 5)
    gsj = [jdgl.graph(x, num_nodes=120) for x in (a, b)]
    gst = [tdgl.graph(x, num_nodes=120, device="cpu") for x in (a, b)]
    for cj, ct in zip(jtransform.compact_graphs(gsj),
                      ttransform.compact_graphs(gst)):
        assert_block_equal(cj, ct, "compact")
    assert_block_equal(jtransform.compact_graphs(gsj[0]),
                       ttransform.compact_graphs(gst[0]), "compact one")


@pytest.mark.parametrize("kw,num_real", [
    (dict(fanouts=[3, 4]), 55), (dict(fanouts=[3, 4], replace=True), 60),
    (dict(fanouts=[2, 3], prob="w"), 58),
    (dict(fanouts=[3, 4], static_shapes=False), 60),
    (dict(fanouts=[-1, 3]), 57)])
def test_numpy_sampler_matches_reference(homo, numpy_path, kw, num_real):
    gj, gt, seeds = homo
    ij, oj, bjs = jns.NeighborSampler(**kw).sample_blocks(
        gj, seeds, rng=np.random.default_rng(9), num_real=num_real)
    it, ot, bts = tns.NeighborSampler(**kw).sample_blocks(
        gt, seeds, rng=np.random.default_rng(9), num_real=num_real)
    np.testing.assert_array_equal(np.asarray(ij), it)
    np.testing.assert_array_equal(np.asarray(oj), ot)
    for i, (bj, bt) in enumerate(zip(bjs, bts)):
        assert_block_equal(bj, bt, f"block {i} {kw}")


def test_exclude_eids_matches_reference(homo):
    gj, gt, seeds = homo
    exc = np.arange(0, gt.num_edges(), 3)
    for fanouts in ([3, 4], [-1]):
        rj = jns.NeighborSampler(fanouts).sample_blocks(
            gj, seeds, rng=np.random.default_rng(10), exclude_eids=exc)
        rt = tns.NeighborSampler(fanouts).sample_blocks(
            gt, seeds, rng=np.random.default_rng(10), exclude_eids=exc)
        for bj, bt in zip(rj[2], rt[2]):
            assert_block_equal(bj, bt, f"exclude {fanouts}")
            eid = bt.edata["_ID"].numpy()[: bt.num_edges()]
            assert not np.isin(eid, exc).any()


def test_full_neighbor_sampler_matches_reference(homo):
    gj, gt, seeds = homo
    rj = jns.MultiLayerFullNeighborSampler(2).sample_blocks(gj, seeds[:20])
    rt = tns.MultiLayerFullNeighborSampler(2).sample_blocks(gt, seeds[:20])
    np.testing.assert_array_equal(np.asarray(rj[0]), rt[0])
    for bj, bt in zip(rj[2], rt[2]):
        assert_block_equal(bj, bt, "full")
        assert bt.ell_dst is not None and bt.tdst is None
    # Every in-edge of the seeds is in the output block.
    deg = gt.in_degrees().numpy()[seeds[:20]]
    assert rt[2][1].num_edges() == int(deg.sum())


@pytest.mark.parametrize("exclude", [False, True])
def test_hetero_sampler_matches_reference(mag, exclude):
    hj, ht, train = mag
    etypes = [c[1] for c in ht.canonical_etypes]
    fanouts = [{e: 3 for e in etypes}, {e: 2 for e in etypes}]
    seeds = {"paper": np.concatenate([train[:30], [train[29]] * 2])}
    exc = ({"cites": np.arange(0, 34900, 2), "writes": np.arange(100)}
           if exclude else None)
    ij, oj, bjs = jns.NeighborSampler(fanouts).sample_blocks(
        hj, seeds, rng=np.random.default_rng(14), num_real=30,
        exclude_eids=exc)
    it, ot, bts = tns.NeighborSampler(fanouts).sample_blocks(
        ht, seeds, rng=np.random.default_rng(14), num_real=30,
        exclude_eids=exc)
    assert set(ij) == set(it)
    for nt in ij:
        np.testing.assert_array_equal(np.asarray(ij[nt]), it[nt])
    for i, (bj, bt) in enumerate(zip(bjs, bts)):
        assert_hetero_equal(bj, bt, f"hetero block {i}")
    # At the output layer only papers have seeds: every relation into
    # another type is an empty block with no dst node.
    for c, rel in bts[1].rel_graphs.items():
        if c[2] != "paper":
            assert rel.num_dst_nodes() == 0 and rel.num_edges_padded() == 0
    if exclude:
        eid = bts[1][("paper", "cites", "paper")].edata["_ID"].numpy()
        assert not (eid[: bts[1]["cites"].num_edges()] % 2 == 0).any()


def test_duplicate_seeds_stay_apart(homo, numpy_path):
    """Seed 7 twice: two dst rows, each with its own samples and at most
    ``fanout`` of them, and both rows reading node 7 on the source side."""
    _, gt, _ = homo
    deg = gt.in_degrees().numpy()
    v = int(np.argmax(deg))
    seeds = np.array([v, 3, v, 9])
    _, _, blocks = tns.NeighborSampler([4]).sample_blocks(
        gt, seeds, rng=np.random.default_rng(0))
    b = blocks[0]
    rows = np.diff(b.csc_indptr.numpy())
    assert rows[0] == rows[2] == min(4, deg[v]) and rows.max() <= 4
    np.testing.assert_array_equal(b.srcdata["_ID"].numpy()[:4], seeds)
    assert b.dstdata["_ID"].numpy().tolist() == seeds.tolist()
    # The reference's numpy path merges the two rows and overflows.
    with pytest.raises(ValueError, match="uniform ELL width"):
        jns.NeighborSampler([4]).sample_blocks(
            jdgl.graph((gt.src.numpy(), gt.dst.numpy()), num_nodes=N),
            seeds, rng=np.random.default_rng(0), exclude_eids=np.zeros(0))


def test_smallest_keys_equals_the_reference_sort():
    """The partition path of ``_smallest_keys`` against the reference's
    lexsort selection, with keys drawn from a few values so that ties
    cross every row's boundary."""
    rng = np.random.default_rng(0)
    degs = np.array([0, 3, 5000, 1, 9000, 4096, 7, 4095])
    seed_of_cand = np.repeat(np.arange(len(degs)), degs)
    for k in (1, 5, 40):
        counts = np.minimum(degs, k)
        for key in (rng.integers(0, 7, len(seed_of_cand)).astype(float),
                    rng.random(len(seed_of_cand))):
            order = np.lexsort((key, seed_of_cand))
            ss = seed_of_cand[order]
            pos = np.arange(len(key)) - np.searchsorted(
                ss, np.arange(len(degs)))[ss]
            keep = pos < counts[ss]
            sel, seed = tneighbor._smallest_keys(key, seed_of_cand, degs,
                                                 counts)
            np.testing.assert_array_equal(sel, order[keep])
            np.testing.assert_array_equal(seed, ss[keep])


@pytest.mark.parametrize("kw", [dict(), dict(prob="w")])
def test_hub_rows_sample_as_the_reference(kw):
    """Rows of over 4,096 in-edges (the partition path) draw the
    reference's edges."""
    rng = np.random.default_rng(5)
    dst = np.concatenate([np.zeros(6000, np.int64), np.full(4500, 7),
                          rng.integers(0, 50, 800)])
    src = rng.integers(0, 50, len(dst))
    gj = jdgl.graph((src, dst), num_nodes=50)
    gt = tdgl.graph((src, dst), num_nodes=50, device="cpu")
    w = rng.random(len(dst)).astype(np.float32)
    gj.edata["w"], gt.edata["w"] = jnp.asarray(w), t(w)
    seeds = np.array([3, 0, 7, 12, 0])
    for fanout in (10, 5000):
        fj = jneighbor.sample_neighbors(gj, seeds[:4], fanout,
                                        rng=np.random.default_rng(2), **kw)
        ft = tneighbor.sample_neighbors(gt, seeds[:4], fanout,
                                        rng=np.random.default_rng(2), **kw)
        assert_block_equal(fj, ft, f"hub rows {fanout} {kw}")
    # A repeated hub seed: each copy draws its own fanout of rows.
    nbr, seed_idx, _ = tneighbor.sample_neighbors_arrays(
        *tneighbor._csc_arrays(gt), seeds, 10, rng=np.random.default_rng(3))
    assert np.bincount(seed_idx, minlength=5).tolist()[1::3] == [10, 10]
