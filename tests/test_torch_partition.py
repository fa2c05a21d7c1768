"""The port's partitioners and partitioned host builds against the JAX
package's, array for array.

The same graphs (each package's generator at one seed) go through both
packages: the assignments of every partitioner, ``partition_graph`` /
``load_partition`` / ``load_global_feats`` on disk, the partition book and
``node_split`` / ``edge_split``, ``metis_partition``, and every array of
``build_partitioned_graph`` at P = 2 and 4 (halo with and without tiles,
vertex cut, block-dense, the hub layouts with the forced geometry, with
and without the identity relabel) are compared exactly. The count
matrices are the port's torch tensors (bfloat16 where the reference's are
ml_dtypes bfloat16) and compare as float32. ``build_hub_format`` is
called with one positional argument list in both packages
(the reference's order), with the reference's ``identity_force`` keys and
with ``force`` / ``allow_empty`` / ``gb_always`` on a 4-part build.
"""

import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import hub_format as jhf
from dgl1_tpu.data.synthetic import powerlaw_graph as j_powerlaw
from dgl1_tpu.graph import _build_ell as j_build_ell
from dgl1_tpu.parallel import graph_partition_book as jbook
from dgl1_tpu.parallel import halo as jhalo
from dgl1_tpu.parallel import hub_shard as jhub
from dgl1_tpu.parallel import partition as jpart
from dgl1_tpu_torch import hub_format as thf
from dgl1_tpu_torch.data.synthetic import powerlaw_graph as t_powerlaw
from dgl1_tpu_torch.graph import _build_ell as t_build_ell
from dgl1_tpu_torch.parallel import graph_partition_book as tbook
from dgl1_tpu_torch.parallel import halo as thalo
from dgl1_tpu_torch.parallel import partition as tpart


def _graphs(kind):
    if kind == "bidir":
        return (jdgl.to_bidirected(j_powerlaw(1500, 5, seed=4)),
                tdgl.to_bidirected(t_powerlaw(1500, 5, seed=4,
                                              device="cpu")))
    if kind == "power":
        return (j_powerlaw(2000, 5, seed=1),
                t_powerlaw(2000, 5, seed=1, device="cpu"))
    rng = np.random.default_rng(3)
    n = 1200
    s = rng.integers(0, n, n * 8)
    d = np.clip(s + rng.integers(-100, 100, n * 8), 0, n - 1)
    return (jdgl.graph((s, d), num_nodes=n),
            tdgl.graph((s, d), num_nodes=n, device="cpu"))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def assert_tree_equal(want, got, path=""):
    """Every array of a (nested) dict equal, dtype kind and all."""
    if want is None or got is None:
        assert want is None and got is None, path
        return
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}/{k}")
        return
    w, g = _host(want), _host(got)
    assert w.shape == g.shape, (path, w.shape, g.shape)
    assert w.dtype.kind == g.dtype.kind or {w.dtype.kind, g.dtype.kind} \
        <= {"i", "u"}, (path, w.dtype, g.dtype)
    np.testing.assert_array_equal(g, w, err_msg=path)


def assert_pg_equal(pj, pt):
    for f in thalo._PG_ARRAY_FIELDS:
        assert_tree_equal(getattr(pj, f), getattr(pt, f), f)
    for f in thalo._PG_STATIC_FIELDS:
        assert getattr(pj, f) == getattr(pt, f), f


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("method", ["random", "greedy", "greedy_edges",
                                    "multilevel", "metis"])
def test_partition_assignments_match_reference(method, k):
    gj, gt = _graphs("bidir")
    if method == "random":
        a = jpart.random_partition_assignment(gj, k, seed=3)
        b = tpart.random_partition_assignment(gt, k, seed=3)
    elif method.startswith("greedy"):
        kw = dict(balance_edges=method == "greedy_edges", seed=1)
        a = jpart.greedy_partition_assignment(gj, k, **kw)
        b = tpart.greedy_partition_assignment(gt, k, **kw)
    elif method == "multilevel":
        a = jpart.multilevel_partition_assignment(gj, k, seed=2)
        b = tpart.multilevel_partition_assignment(gt, k, seed=2)
    else:
        a = jpart.metis_partition_assignment(gj, k)
        b = tpart.metis_partition_assignment(gt, k)
    np.testing.assert_array_equal(b, a)
    assert b.dtype == a.dtype
    assert tpart.edge_cut_fraction(gt, b) == jpart.edge_cut_fraction(gj, a)


def test_partition_graph_round_trip_matches_reference(tmp_path):
    gj, gt = _graphs("bidir")
    n = gt.num_nodes()
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    label = rng.integers(0, 4, n).astype(np.int32)
    gj.ndata["feat"], gj.ndata["label"] = feat, label
    gt.ndata["feat"] = torch.tensor(feat)
    gt.ndata["label"] = torch.tensor(label)
    dj, dt = tmp_path / "ref", tmp_path / "port"
    pa = jpart.partition_graph(gj, "g", 3, str(dj), balance_edges=True)
    pb = tpart.partition_graph(gt, "g", 3, str(dt), balance_edges=True)
    np.testing.assert_array_equal(pb, pa)
    assert json.loads((dt / "g.json").read_text()) == json.loads(
        (dj / "g.json").read_text())
    for p in range(3):
        for f in ("graph.npz", "node_feat.npz"):
            with np.load(dj / f"part{p}" / f) as zj, \
                    np.load(dt / f"part{p}" / f) as zt:
                assert sorted(zj.files) == sorted(zt.files)
                for k in zj.files:
                    np.testing.assert_array_equal(zt[k], zj[k])
        lj, fj, bj = jpart.load_partition(str(dj), "g", p)
        lt, ft, bt = tpart.load_partition(str(dt), "g", p, device="cpu")
        np.testing.assert_array_equal(lt.src.numpy(), np.asarray(lj.src))
        np.testing.assert_array_equal(lt.dst.numpy(), np.asarray(lj.dst))
        for k in ("orig_id", "inner_node"):
            np.testing.assert_array_equal(lt.ndata[k].numpy(),
                                          np.asarray(lj.ndata[k]))
        np.testing.assert_array_equal(lt.edata["orig_id"].numpy(),
                                      np.asarray(lj.edata["orig_id"]))
        for k in fj:
            np.testing.assert_array_equal(ft[k], fj[k])
        np.testing.assert_array_equal(bt["part_assignment"],
                                      bj["part_assignment"])
    sj = jpart.load_global_feats(str(dj), "g")
    st = tpart.load_global_feats(str(dt), "g", device="cpu")
    ids = rng.integers(0, n, 50)
    for k in sj:
        np.testing.assert_array_equal(st[k].pull(ids), sj[k].pull(ids))


def test_partition_book_and_splits_match_reference():
    gj, gt = _graphs("bidir")
    part = jpart.greedy_partition_assignment(gj, 4)
    key = -np.bincount(np.asarray(gj.dst)[: gj.num_edges()],
                       minlength=gj.num_nodes())
    ids = np.random.default_rng(1).integers(0, gj.num_nodes(), 200)
    for kw in ({}, {"order_key": key}):
        bj = jbook.GraphPartitionBook(part, 4, **kw)
        bt = tbook.GraphPartitionBook(part, 4, **kw)
        np.testing.assert_array_equal(bt.nid2partid(ids), bj.nid2partid(ids))
        np.testing.assert_array_equal(bt.nid2localnid(ids),
                                      bj.nid2localnid(ids))
        for p in range(4):
            np.testing.assert_array_equal(bt.partid2nids(p),
                                          bj.partid2nids(p))
            assert bt.num_nodes(p) == bj.num_nodes(p)
            np.testing.assert_array_equal(bt.map_to_global(p, [0, 1]),
                                          bj.map_to_global(p, [0, 1]))
    mask = np.random.default_rng(2).random(gj.num_nodes()) < 0.3
    for nodes in (mask, np.flatnonzero(mask)):
        for rank in range(4):
            for kw in ({"partition_book": bj}, {"num_parts": 3},
                       {"partition_book": bj, "force_even": True}):
                tkw = dict(kw)
                if "partition_book" in tkw:
                    tkw["partition_book"] = bt
                np.testing.assert_array_equal(
                    tbook.node_split(nodes, rank=rank, **tkw),
                    jbook.node_split(nodes, rank=rank, **kw))
    owner = jhalo.vertex_cut_edge_owner(gj, part, 4)
    np.testing.assert_array_equal(
        thalo.vertex_cut_edge_owner(gt, part, 4), owner)
    emask = np.arange(gj.num_edges()) % 3 == 0
    for rank in range(4):
        np.testing.assert_array_equal(
            tbook.edge_split(emask, owner, rank),
            jbook.edge_split(emask, owner, rank))
        np.testing.assert_array_equal(
            tbook.edge_split(emask, rank=rank, num_parts=4),
            jbook.edge_split(emask, rank=rank, num_parts=4))


def test_metis_partition_subgraphs_match_reference():
    gj, gt = _graphs("band")
    sj = jpart.metis_partition(gj, 3, extra_cached_hops=1)
    st = tpart.metis_partition(gt, 3, extra_cached_hops=1)
    assert sorted(sj) == sorted(st)
    for p in sj:
        np.testing.assert_array_equal(st[p].ndata["_ID"].numpy(),
                                      np.asarray(sj[p].ndata["_ID"]))
        np.testing.assert_array_equal(st[p].ndata["inner_node"].numpy(),
                                      np.asarray(sj[p].ndata["inner_node"]))
        np.testing.assert_array_equal(st[p].src.numpy(),
                                      np.asarray(sj[p].src))


# name -> (graph, build keywords)
BUILDS = {
    "halo_tiles": ("bidir", dict()),
    "segment_int8": ("bidir", dict(tiles=False, halo_dtype="int8")),
    "vertex_cut": ("power", dict(vertex_cut=True)),
    "bdense": ("band", dict(bdense=True)),
    "bdense_vertex_cut": ("power", dict(bdense=True, vertex_cut=True)),
    "hub_mixed": ("bidir", dict(tiles=False, hub=256, hub_dense_floor=512)),
    "hub_identity": ("bidir", dict(tiles=False, hub=256,
                                   hub_dense_floor=512, hub_identity=True)),
    "hub_vertex_cut": ("power", dict(tiles=False, hub=200,
                                     vertex_cut=True)),
    # At P = 4 two parts have no hub group of their own (allow_empty).
    "hub_empty_parts": ("power", dict(tiles=False, hub=600)),
    "hub_identity_selfloop": ("selfloop", dict(tiles=False, hub=128,
                                               hub_dense_floor=256,
                                               hub_identity=True)),
}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", list(BUILDS))
def test_build_partitioned_graph_matches_reference(name, k):
    gname, kw = BUILDS[name]
    if gname == "selfloop":
        gj, gt = _graphs("bidir")
        gj, gt = jdgl.add_self_loop(gj), tdgl.add_self_loop(gt)
    else:
        gj, gt = _graphs(gname)
    kw = dict(kw)
    part = jpart.greedy_partition_assignment(gj, k, balance_edges=True)
    if kw.pop("vertex_cut", False):
        kw["edge_owner"] = jhalo.vertex_cut_edge_owner(gj, part, k)
    pj = jhalo.build_partitioned_graph(gj, part, k, **kw)
    pt = thalo.build_partitioned_graph(gt, part, k, **kw)
    assert_pg_equal(pj, pt)
    if kw.get("hub"):
        assert pt.hub_meta is not None
    if name in ("hub_mixed", "hub_identity"):
        assert pt.hub_meta.identity_expand == (name == "hub_identity")
    # The shards and the combined table of each rank.
    x = np.random.default_rng(k).normal(size=(gt.num_nodes(), 3)).astype(
        np.float32)
    xs = pt.shard_node_data(x)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(
        pj.shard_node_data(x)))
    np.testing.assert_array_equal(pt.unshard_node_data(xs).numpy(), x)
    if pt.hub_rows:
        np.testing.assert_array_equal(
            pt.shard_node_data_combined(x).numpy(),
            np.asarray(pj.shard_node_data_combined(x)))
    for p in range(k):
        comb = pt.combined_from_global(x, p).numpy()
        ids = pt.combined_ids(p)
        live = ids >= 0
        np.testing.assert_array_equal(comb[live], x[ids[live]])
        np.testing.assert_array_equal(comb[: pt.n_loc], xs[p].numpy())


def _part_csc(pt, p):
    """Part p's hub input (the build's): dst-sorted CSC of its real
    local edges in (combined source, output destination) ids."""
    real = pt.edst[p] < pt.n_out
    s = pt.esrc[p][real].astype(np.int64)
    d = pt.edst[p][real].astype(np.int64)
    n = pt.hub_rows or 1024
    order = np.argsort(d, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(d, minlength=n), out=indptr[1:])
    return indptr, s[order], order.astype(np.int64), d[order], n


def test_build_hub_format_takes_the_reference_positional_order():
    """One positional argument list (the reference's order) through both
    packages' ``build_hub_format``: the single-device build, the typed
    identity mode with the reference's ``identity_force`` dict, and on a
    4-part build the measuring pass (``allow_empty``, ``gb_always``) and
    the forced pass (``force``), each part's meta and arrays equal."""
    gj, gt = _graphs("bidir")
    part = jpart.greedy_partition_assignment(gj, 4, balance_edges=True)
    kw = dict(tiles=False, hub=256, hub_dense_floor=512)
    pt = thalo.build_partitioned_graph(gt, part, 4, **kw)
    naturals_j, naturals_t = [], []
    for p in range(4):
        indptr, s, eid, d, n = _part_csc(pt, p)
        args = (indptr, s, eid, d, n, n, len(s), pt.e_loc)
        opt = (256, 512, None, True, True)
        mj, aj = jhf.build_hub_format(*args[:8], j_build_ell, *opt)
        mt, at = thf.build_hub_format(*args[:8], t_build_ell, *opt)
        assert mt == mj
        assert_tree_equal(aj, at, f"natural part {p}")
        naturals_j.append((mj, aj))
        naturals_t.append((mt, at))
    # The forced pass with the union geometry (the reference's dict; its
    # count dtype as the port's torch dtype).
    force = {
        "n_groups": max(m.n_dense for m, _ in naturals_j)
        + max(m.n_groups - m.n_dense for m, _ in naturals_j),
        "n_dense": max(m.n_dense for m, _ in naturals_j),
        "n_full_f": max(m.n_full_f for m, _ in naturals_j),
        "n_full_b": max(m.n_full_b for m, _ in naturals_j),
        "n_part_f": max(m.n_part_f for m, _ in naturals_j),
        "n_part_b": max(m.n_part_b for m, _ in naturals_j),
        "tail_meta_dst": jhf.union_ell_meta(
            [m.tail_meta_dst for m, _ in naturals_j]),
        "tail_meta_src": jhf.union_ell_meta(
            [m.tail_meta_src for m, _ in naturals_j]),
        "t_pad": max(a["tail_src"].shape[0] for _, a in naturals_j),
        "x_desc_len": max(a["x_desc"].shape[0] for _, a in naturals_j),
        "gb_desc_len": max(a["gb_desc"].shape[0] for _, a in naturals_j),
        "has_diag": False,
        "covered": sum(m.covered for m, _ in naturals_j),
        "identity_expand": False,
    }
    dts = [a["dense_c"].dtype for m, a in naturals_t if m.n_dense]
    fj = dict(force, dense_dtype=jhub._widest_dtype(
        [a["dense_c"].dtype for m, a in naturals_j if m.n_dense]))
    ft = dict(force, dense_dtype=max(dts, key=lambda t: t.itemsize))
    assert thf.union_ell_meta([m.tail_meta_dst for m, _ in naturals_t]) \
        == force["tail_meta_dst"]
    for p in range(4):
        indptr, s, eid, d, n = _part_csc(pt, p)
        args = (indptr, s, eid, d, n, n, len(s), pt.e_loc)
        mj, aj = jhf.build_hub_format(*args, j_build_ell, 256, 512, fj)
        mt, at = thf.build_hub_format(*args, t_build_ell, 256, 512, ft)
        assert mt == mj
        assert_tree_equal(aj, at, f"forced part {p}")
        assert mt.n_groups == force["n_groups"]
    # The single-device build and the typed identity mode, positionally.
    g2j = jdgl.reorder_graph(jdgl.graph((np.asarray(gj.src),
                                         np.asarray(gj.dst)),
                                        num_nodes=gj.num_nodes(), hub=256,
                                        hub_dense_floor=512), "hub",
                             permute_config={"hub": 256,
                                             "hub_dense_floor": 512})
    m = g2j.hub_dst_meta
    assert m.identity_expand
    ident = {"n_groups": m.n_groups, "n_dense": m.n_dense,
             "tail_meta_dst": m.tail_meta_dst}
    n = g2j.num_nodes()
    e = g2j.num_edges()
    keep = np.random.default_rng(4).random(e) < 0.5
    s2, d2 = np.asarray(g2j.src)[:e][keep], np.asarray(g2j.dst)[:e][keep]
    order = np.argsort(d2, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(d2, minlength=n), out=indptr[1:])
    args = (indptr, s2[order], order.astype(np.int64), d2[order], n, n,
            len(s2), len(s2))
    for extra in ((), (None, None, None, False, False, ident)):
        mj, aj = jhf.build_hub_format(*args, j_build_ell, *extra)
        mt, at = thf.build_hub_format(*args, t_build_ell, *extra)
        assert mt == mj
        assert_tree_equal(aj, at, f"single device {bool(extra)}")
    assert mt.identity_expand


@pytest.mark.parametrize("name", ["hub_mixed", "hub_identity",
                                  "hub_empty_parts"])
def test_local_hub_layouts_drop_the_forced_noop_chunks(name):
    """``PartitionedGraph.local`` gives each part its chunk layouts without
    the forced geometry's trailing no-op chunks: every chunk has a real
    slot and the chunks stay sorted (forward by group, backward by window
    then group), as the port's chunk kernels take them."""
    gname, kw = BUILDS[name]
    gj, gt = _graphs(gname)
    part = jpart.greedy_partition_assignment(gj, 4, balance_edges=True)
    pt = thalo.build_partitioned_graph(gt, part, 4, **kw)
    m = pt.hub_meta
    trimmed = 0
    for p in range(4):
        hub = pt.local(p, "cpu").hub
        keys = ["full_fwd", "full_bwd"] + (
            ["part_fwd", "part_bwd"] if m.n_groups > m.n_dense else [])
        for key in keys:
            lay = {k: v.numpy() for k, v in hub[key].items()}
            n = lay["in_id"].shape[0]
            trimmed += pt.hub[key]["in_id"].shape[1] - n
            if n == 0:  # a part without a hub edge of its own
                assert lay["a"].shape[0] == 0
                continue
            assert (lay["a"].reshape(n, -1) >= 0).any(axis=1).all(), key
            if key.endswith("fwd"):
                assert (np.diff(lay["out_id"]) >= 0).all(), key
            else:
                order = lay["out_id"].astype(np.int64) * 1000 + lay["in_id"]
                assert (np.diff(order) >= 0).all(), key
                assert sorted(lay["gperm"].tolist()) == list(range(n))
    assert trimmed > 0


def test_attention_wrappers_take_a_layout_without_chunks():
    """A partition without a hub edge keeps no chunk: K6 and K7 return
    the plain versions' values for no slot without a launch, counted in
    ``NO_WORK``; K7 g-major and K8 give zeros (their kernels launch on
    such a layout on the card)."""
    from dgl1_tpu_torch.ops import attn_kernels as AK

    z = torch.zeros(0, dtype=torch.int32)
    lay = dict(a=z, b=z, eid=z, in_id=z, out_id=z, first=z, gperm=z,
               gout=z, gfirst=z)
    h, d, g = 2, 4, 2
    gen = torch.Generator().manual_seed(0)
    el, ft = torch.randn(300, h, generator=gen), torch.randn(
        300, h * d, generator=gen)
    er = torch.randn(g * 128, h, generator=gen)
    ct = torch.randn(g * 128, h * d, generator=gen)
    AK.reset_launches()
    num, den, mraw = AK.attn_fwd(lay, el, er, ft, h, d, 0.2, n_groups=g)
    assert not num.any() and not den.any() and (mraw == AK.NEG).all()
    gft, gel, gerp = AK.attn_bwd_src(lay, el, er, er, er, ft, ct, h, d, 0.2,
                                     n_win=3)
    assert gft.shape == (384, h * d) and not gft.any() and not gel.any()
    assert gerp.shape == (0, h)
    assert not AK.ger_reduce(lay, gerp, g).any()
    assert not AK.attn_bwd_grp(lay, el, er, er, er, ft, ct, h, d, 0.2,
                               n_groups=g).any()
    assert AK.NO_WORK == {"attn_fwd": 1, "attn_bwd_src": 1}
    assert not any(AK.LAUNCHES.values())


@pytest.mark.parametrize("name", ["halo_tiles", "vertex_cut", "bdense"])
def test_local_tiles_drop_the_cross_part_padding(name):
    """``PartitionedGraph.local`` drops the tiles the stacked build pads
    each part with (aimed at the scratch row block): every kept tile
    targets a real row block, and they are the part's own tiles."""
    gname, kw = BUILDS[name]
    gj, gt = _graphs(gname)
    kw = dict(kw)
    part = jpart.greedy_partition_assignment(gj, 4, balance_edges=True)
    if kw.pop("vertex_cut", False):
        kw["edge_owner"] = jhalo.vertex_cut_edge_owner(gj, part, 4)
    pt = thalo.build_partitioned_graph(gt, part, 4, **kw)
    dropped = 0
    for p in range(4):
        pl = pt.local(p, "cpu")
        for key in ("tiles_fwd", "tiles_rev"):
            t = {k: v.numpy() for k, v in getattr(pl, key).items()}
            full = getattr(pt, key)
            n = t["rows"].shape[0]
            assert (t["rows"] < t["block_mask"].shape[0]).all()
            np.testing.assert_array_equal(t["lid"], full["lid"][p][:n])
            assert (full["rows"][p][n:] == t["block_mask"].shape[0]).all()
            assert (full["lid"][p][n:] == -1).all()
            dropped += full["rows"].shape[1] - n
    assert dropped > 0
