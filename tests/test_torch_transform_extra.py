"""The ported transforms, the graph files, the networkx bridge and
the engine order against the reference on the same numpy inputs.

Structure compares exactly (edge lists in order, node counts, ``_ID``
fields). kNN compares each point's neighbour set; where the k-th and
(k+1)-th distances of a point tie within float32 rounding (1e-5 of the
distance), its k-th distance is compared instead (the two packages may
take either tied point). ``laplacian_lambda_max`` is held to the
reference within 1e-6 relative (``eigs`` at ``tol=1e-6`` from a random
start); ``laplacian_pe`` eigenvectors are defined up to sign, so ``|v|``
is compared where the spectrum is simple, and the column space (the
projector) where it is not, within 1e-5 (see that test for the one case
where the reference does not repeat itself). The encodings and distances
compare within 1e-6. Graph files written by either package load in the
other with every array equal."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.data import load_graphs as jload, save_graphs as jsave
from dgl1_tpu_torch.data import load_graphs as tload, save_graphs as tsave
from dgl1_tpu_torch.ops import dispatch
from torch_parity import close

CPU = dict(device="cpu")
REPO = Path(__file__).resolve().parent.parent


def rand_pair(n=12, e=40, seed=4):
    gj = jdgl.rand_graph(n, e, seed=seed)
    gt = tdgl.rand_graph(n, e, seed=seed, **CPU)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(e, 2)).astype(np.float32)
    gj.ndata["h"], gt.ndata["h"] = jnp.asarray(h), torch.tensor(h)
    gj.edata["w"], gt.edata["w"] = jnp.asarray(w), torch.tensor(w)
    return gj, gt


def same(gt, gj):
    """Node count, the real edge list in order and every field."""
    e = gj.num_edges()
    assert gt.num_src_nodes() == gj.num_src_nodes()
    assert gt.num_edges() == e
    np.testing.assert_array_equal(gt.src[:e].numpy(), np.asarray(gj.src)[:e])
    np.testing.assert_array_equal(gt.dst[:e].numpy(), np.asarray(gj.dst)[:e])
    assert set(gt.ndata) == set(gj.ndata)
    assert set(gt.edata) == set(gj.edata)
    for k in gj.ndata:
        np.testing.assert_array_equal(gt.ndata[k].numpy(),
                                      np.asarray(gj.ndata[k]), err_msg=k)
    for k in gj.edata:
        np.testing.assert_array_equal(gt.edata[k][:e].numpy(),
                                      np.asarray(gj.edata[k])[:e],
                                      err_msg=k)


STRUCTURE = {
    "add_reverse_edges": lambda m, g: m.add_reverse_edges(g),
    "add_reverse_edges_edata": lambda m, g: m.add_reverse_edges(
        g, copy_ndata=False, copy_edata=True),
    "to_simple": lambda m, g: m.to_simple(m.add_reverse_edges(g)),
    "khop_2": lambda m, g: m.khop_graph(g, 2),
    "khop_3": lambda m, g: m.khop_graph(g, 3),
    "line_graph": lambda m, g: m.line_graph(g),
    "line_graph_no_backtracking": lambda m, g: m.line_graph(
        m.add_reverse_edges(g), backtracking=False),
    "in_subgraph": lambda m, g: m.in_subgraph(g, [2, 5, 7]),
    "in_subgraph_mask": lambda m, g: m.in_subgraph(
        g, np.arange(12) % 3 == 0),
    "out_subgraph": lambda m, g: m.out_subgraph(g, [0, 1]),
    "remove_edges": lambda m, g: m.remove_edges(g, [0, 3, 39]),
    "remove_nodes": lambda m, g: m.remove_nodes(g, [0, 4]),
    "add_nodes": lambda m, g: m.add_nodes(g, 3),
    "merge": lambda m, g: m.merge([g, m.to_simple(g)]),
}


@pytest.mark.parametrize("name", sorted(STRUCTURE))
def test_structure_transform_matches_reference(name):
    gj, gt = rand_pair()
    same(STRUCTURE[name](tdgl, gt), STRUCTURE[name](jdgl, gj))


def test_add_edges_and_nodes_with_data_match_reference():
    gj, gt = rand_pair()
    wn = np.full((2, 2), 5.0, np.float32)
    same(tdgl.add_edges(gt, [0, 1], [7, 6], data={"w": torch.tensor(wn),
                                                  "z": torch.ones(2)}),
         jdgl.add_edges(gj, [0, 1], [7, 6], data={"w": jnp.asarray(wn),
                                                  "z": jnp.ones(2)}))
    hn = np.ones((3, 3), np.float32)
    same(tdgl.add_nodes(gt, 3, data={"h": torch.tensor(hn)}),
         jdgl.add_nodes(gj, 3, data={"h": jnp.asarray(hn)}))


def test_merge_fills_missing_fields_like_reference():
    gj, gt = rand_pair()
    sj = jdgl.graph(([0, 1], [2, 3]), num_nodes=14)
    st = tdgl.graph(([0, 1], [2, 3]), num_nodes=14, **CPU)
    sj.edata["v"], st.edata["v"] = jnp.ones((2, 1)), torch.ones((2, 1))
    same(tdgl.merge([gt, st]), jdgl.merge([gj, sj]))


def test_shortest_dist_matches_reference():
    gj, gt = rand_pair(n=10, e=14, seed=2)
    np.testing.assert_array_equal(tdgl.shortest_dist(gt).numpy(),
                                  np.asarray(jdgl.shortest_dist(gj)))
    for root in (0, 3):
        dt, pt = tdgl.shortest_dist(gt, root=root, return_paths=True)
        dj, pj = jdgl.shortest_dist(gj, root=root, return_paths=True)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    g = tdgl.graph(([0, 1, 2], [1, 2, 3]), num_nodes=5, **CPU)
    d, paths = tdgl.shortest_dist(g, root=0, return_paths=True)
    assert int(d[3]) == 3 and int(d[4]) == -1
    assert paths[3].tolist() == [0, 1, 2]
    with pytest.raises(NotImplementedError):
        tdgl.shortest_dist(g, return_paths=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_random_walk_pe_matches_reference(weighted):
    gj, gt = rand_pair(n=15, e=50, seed=6)
    if weighted:
        w = np.random.default_rng(1).random(50).astype(np.float32)
        gj.edata["p"], gt.edata["p"] = jnp.asarray(w), torch.tensor(w)
    name = "p" if weighted else None
    close(tdgl.random_walk_pe(gt, 5, eweight_name=name),
          jdgl.random_walk_pe(gj, 5, eweight_name=name),
          tol=dict(rtol=1e-6, atol=1e-6))
    tri = tdgl.graph(([0, 1, 2], [1, 2, 0]), num_nodes=3, **CPU)
    pe = tdgl.random_walk_pe(tri, 4).numpy()
    np.testing.assert_allclose(pe[:, 2], 1.0, atol=1e-7)
    np.testing.assert_allclose(pe[:, [0, 1, 3]], 0.0, atol=1e-7)


def _projector(v):
    return v @ v.T


@pytest.mark.parametrize("n", [30, 120])
def test_laplacian_pe_matches_reference_up_to_sign(n):
    """n = 30 takes the dense ``eigh``, 120 the sparse ``eigsh``. A random
    graph (a simple spectrum: ``|v|`` column by column) at both sizes; a
    ring (eigenvalues in pairs, so the projector onto the k = 4 columns,
    two whole eigenspaces) at 30. At 120 the ring's gaps are so small
    that ``eigsh`` from a random start does not repeat itself to 1e-2 in
    either package, so there the port's columns are held to the
    reference's own check: orthonormal and orthogonal to the constant."""
    src = np.arange(n)
    ring = (np.concatenate([src, (src + 1) % n]),
            np.concatenate([(src + 1) % n, src]))
    rng = np.random.default_rng(n)
    rnd = (rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n))
    for (s, d), k, simple in ((rnd, 3, True), (ring, 4, False)):
        pt = tdgl.laplacian_pe(tdgl.graph((s, d), num_nodes=n, **CPU),
                               k).numpy()
        assert pt.shape == (n, k)
        if not simple and n > 40:
            np.testing.assert_allclose(pt.T @ pt, np.eye(k), atol=1e-4)
            assert np.abs(pt.sum(0)).max() < 1e-3
            continue
        pj = np.asarray(jdgl.laplacian_pe(jdgl.graph((s, d), num_nodes=n),
                                          k))
        if simple:
            np.testing.assert_allclose(np.abs(pt), np.abs(pj), atol=1e-5)
        else:
            np.testing.assert_allclose(_projector(pt), _projector(pj),
                                       atol=1e-5)
    g3 = tdgl.graph((np.array([0, 1]), np.array([1, 0])), num_nodes=3, **CPU)
    assert tdgl.laplacian_pe(g3, 5, padding=True).shape == (3, 5)
    with pytest.raises(ValueError):
        tdgl.laplacian_pe(g3, 5)


def test_laplacian_lambda_max_matches_reference():
    """One graph above 64 nodes (``eigs``) and a batch of three small ones
    (dense ``eigvals``), within 1e-6 relative."""
    gj = jdgl.to_bidirected(jdgl.rand_graph(100, 400, seed=3))
    gt = tdgl.to_bidirected(tdgl.rand_graph(100, 400, seed=3, **CPU))
    np.testing.assert_allclose(tdgl.laplacian_lambda_max(gt),
                               jdgl.laplacian_lambda_max(gj), rtol=1e-6)
    bj = jdgl.batch([jdgl.to_bidirected(jdgl.rand_graph(10, 30, seed=s))
                     for s in range(3)])
    bt = tdgl.batch([tdgl.to_bidirected(tdgl.rand_graph(10, 30, seed=s,
                                                        **CPU))
                     for s in range(3)], **CPU)
    vals = tdgl.laplacian_lambda_max(bt)
    assert len(vals) == 3
    np.testing.assert_allclose(vals, jdgl.laplacian_lambda_max(bj),
                               rtol=1e-6)


def _knn_rows(g, n, k):
    e = g.num_edges()
    src = np.asarray(g.src)[:e] if not isinstance(g.src, torch.Tensor) \
        else g.src[:e].numpy()
    dst = np.asarray(g.dst)[:e] if not isinstance(g.dst, torch.Tensor) \
        else g.dst[:e].numpy()
    assert e == n * k and (dst.reshape(n, k) == np.arange(n)[:, None]).all()
    return src.reshape(n, k)


def _same_knn(rows_t, rows_j, x, k, seg=None):
    """Each point's neighbour set equal, or, where its k-th and (k+1)-th
    float32 distances tie within 1e-5, its k-th distance equal."""
    d2 = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    if seg is not None:
        d2 = np.where(seg[:, None] == seg[None], d2, np.inf)
    ties = 0
    for i in range(len(x)):
        if set(rows_t[i]) == set(rows_j[i]):
            continue
        srt = np.sort(d2[i])
        assert abs(srt[k] - srt[k - 1]) <= 1e-5 * max(srt[k], 1.0), i
        np.testing.assert_allclose(d2[i][rows_t[i]].max(),
                                   d2[i][rows_j[i]].max(), rtol=1e-5)
        ties += 1
    return ties


def test_knn_graph_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    for k in (1, 4, 40, 50):
        kk = min(k, 40)
        _same_knn(_knn_rows(tdgl.knn_graph(x, k, **CPU), 40, kk),
                  _knn_rows(jdgl.knn_graph(x, k), 40, kk), x, kk)
    # Points on a grid: many exact ties, broken toward the lower id here.
    grid = np.stack(np.meshgrid(np.arange(5), np.arange(5)), -1).reshape(
        -1, 2).astype(np.float32)
    rows = _knn_rows(tdgl.knn_graph(grid, 5, **CPU), 25, 5)
    assert _same_knn(rows, _knn_rows(jdgl.knn_graph(grid, 5), 25, 5),
                     grid, 5) >= 0
    d2 = ((grid[:, None] - grid[None]) ** 2).sum(-1)
    for i in range(25):
        order = np.lexsort((np.arange(25), d2[i]))
        assert sorted(rows[i].tolist()) == sorted(order[:5].tolist())


def test_batched_and_segmented_knn_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 3)).astype(np.float32)
    flat = x.reshape(48, 3)
    seg = np.repeat(np.arange(3), 16)
    _same_knn(_knn_rows(tdgl.knn_graph(torch.tensor(x), 5, **CPU), 48, 5),
              _knn_rows(jdgl.knn_graph(x, 5), 48, 5), flat, 5, seg)
    segs = [5, 7, 9]
    y = rng.normal(size=(21, 2)).astype(np.float32)
    seg2 = np.repeat(np.arange(3), segs)
    gt = tdgl.segmented_knn_graph(y, 6, segs, **CPU)
    rows_t = _knn_rows(gt, 21, 5)  # min(k, smallest segment)
    assert (seg2[rows_t] == seg2[:, None]).all()
    _same_knn(rows_t, _knn_rows(jdgl.segmented_knn_graph(y, 6, segs), 21,
                                5), y, 5, seg2)
    g = tdgl.nn.SegmentedKNNGraph(3, **CPU)(y, segs)
    assert g.num_edges() == 63
    assert tdgl.nn.KNNGraph(4, **CPU)(y).num_edges() == 84


def _files_graphs(pkg):
    """A graph with node, edge and label data, a block with src/dst data
    and a heterograph with node and edge frames, in ``pkg``."""
    kw = CPU if pkg is tdgl else {}
    arr = (lambda a: torch.tensor(a)) if pkg is tdgl else jnp.asarray
    rng = np.random.default_rng(2)
    g = pkg.rand_graph(6, 12, seed=1, **kw)
    g.ndata["h"] = arr(rng.normal(size=(6, 3)).astype(np.float32))
    g.edata["w"] = arr(np.arange(12, dtype=np.float32))
    b = pkg.block(([0, 1, 2], [0, 1, 1]), 3, 2, **kw)
    b.srcdata["x"] = arr(np.ones((3, 2), np.float32))
    b.dstdata["y"] = arr(np.arange(2, dtype=np.int32))
    hg = pkg.heterograph({("u", "f", "u"): ([0, 1], [1, 2]),
                          ("u", "p", "g"): ([1, 2, 2], [0, 1, 0])}, **kw)
    hg.nframes["u"]["h"] = arr(np.arange(3, dtype=np.float32)[:, None])
    hg.rel_graphs[("u", "p", "g")].edata["c"] = arr(
        np.array([1.0, 2.0, 3.0], np.float32))
    return [g, b, hg]


def _same_files(got, want):
    g, b, hg = got
    same(g, want[0])
    same(b, want[1])
    assert b.num_dst_nodes() == want[1].num_dst_nodes()
    for k in want[1].srcdata:
        np.testing.assert_array_equal(np.asarray(b.srcdata[k]),
                                      np.asarray(want[1].srcdata[k]))
    for k in want[1].dstdata:
        np.testing.assert_array_equal(np.asarray(b.dstdata[k]),
                                      np.asarray(want[1].dstdata[k]))
    hw = want[2]
    assert sorted(hg.canonical_etypes) == sorted(hw.canonical_etypes)
    for c in hw.canonical_etypes:
        rt, rj = hg.rel_graphs[c], hw.rel_graphs[c]
        e = rj.num_edges()
        np.testing.assert_array_equal(np.asarray(rt.src)[:e],
                                      np.asarray(rj.src)[:e])
        np.testing.assert_array_equal(np.asarray(rt.dst)[:e],
                                      np.asarray(rj.dst)[:e])
        for k in rj.edata:
            np.testing.assert_array_equal(np.asarray(rt.edata[k]),
                                          np.asarray(rj.edata[k]))
    for nt in hw.ntypes:
        assert hg.num_nodes(nt) == hw.num_nodes(nt)
        for k in hw.nframes[nt]:
            np.testing.assert_array_equal(np.asarray(hg.nframes[nt][k]),
                                          np.asarray(hw.nframes[nt][k]))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_graph_files_load_in_either_package(tmp_path, writer):
    """Written by one package, loaded by both: the same graphs, block,
    heterograph and labels."""
    path = str(tmp_path / "graphs.npz")
    labels = np.arange(6)
    if writer == "port":
        tsave(path, _files_graphs(tdgl), labels={"y": torch.tensor(labels)})
    else:
        jsave(path, _files_graphs(jdgl), labels={"y": labels})
    gt, lt = tload(path, **CPU)
    gj, lj = jload(path)
    np.testing.assert_array_equal(lt["y"].numpy(), np.asarray(lj["y"]))
    _same_files(gt, gj)
    _same_files(gt, _files_graphs(jdgl))
    assert tdgl.load_graphs is tload and tdgl.save_graphs is tsave


def test_save_graphs_refuses_hetero_blocks(tmp_path):
    hb = tdgl.to_block_hetero(
        tdgl.heterograph({("a", "r", "a"): ([0, 1], [1, 0])}, **CPU),
        {"a": np.array([0, 1])})
    with pytest.raises(ValueError):
        tsave(str(tmp_path / "x.npz"), hb)


def test_networkx_both_ways_match_reference():
    nx = pytest.importorskip("networkx")
    nxg = nx.karate_club_graph()
    for node in nxg.nodes:
        nxg.nodes[node]["f"] = [float(node), 1.0]
    for u, v in nxg.edges:
        nxg.edges[u, v]["wt"] = float(u + v)
    gt = tdgl.from_networkx(nxg, node_attrs=["f"], edge_attrs=["wt"], **CPU)
    gj = jdgl.from_networkx(nxg, node_attrs=["f"], edge_attrs=["wt"])
    same(gt, gj)
    assert gt.num_edges() == 2 * nxg.number_of_edges()
    dg = nx.DiGraph([(0, 1), (1, 2), (3, 0)])
    same(tdgl.from_networkx(dg, **CPU), jdgl.from_networkx(dg))
    bt = tdgl.to_networkx(gt, node_attrs=["f"], edge_attrs=["wt"])
    bj = jdgl.to_networkx(gj, node_attrs=["f"], edge_attrs=["wt"])
    assert list(bt.nodes) == list(bj.nodes)
    assert list(bt.edges(keys=True, data="id")) == \
        list(bj.edges(keys=True, data="id"))
    for (u, v, k, d) in bj.edges(keys=True, data=True):
        np.testing.assert_array_equal(bt.edges[u, v, k]["wt"], d["wt"])
    np.testing.assert_array_equal(bt.nodes[7]["f"], bj.nodes[7]["f"])


def test_package_imports_without_networkx():
    """networkx is imported inside the two converters only."""
    code = ("import sys; sys.modules['networkx'] = None\n"
            "import dgl1_tpu_torch as t\n"
            "try:\n    t.to_networkx(t.rand_graph(3, 2, device='cpu'))\n"
            "except ImportError:\n    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "ok"


def test_set_auto_order():
    old = list(dispatch._AUTO_ORDER)
    try:
        tdgl.ops.set_auto_order(["ell", "pallas", "nope"])
        assert dispatch._candidates(True) == ["ell", "tile"]
        assert dispatch._candidates(False) == []
        tdgl.ops.set_auto_order([])
        assert dispatch._candidates(True) == []
    finally:
        tdgl.ops.set_auto_order(old)
    assert dispatch._candidates(True) == ["bdense", "hub", "ell", "tile"]


_ENGINE_PROBE = r"""
import torch
import dgl1_tpu_torch as t
from dgl1_tpu_torch.ops import dispatch
g = t.rand_graph(4, 6, device="cpu")
print(t.ops.get_engine())
try:
    t.ops.gspmm(g, "copy_lhs", "sum", torch.ones(4, 2), None)
    print("ran")
except ValueError as exc:
    print("raised", "unknown engine" in str(exc))
"""


@pytest.mark.parametrize("name,want", [
    ("ell", ["ell", "ran"]), ("pallas", ["tile", "ran"]),
    ("xla", ["xla", "ran"]), ("nope", ["nope", "raised True"]),
    (None, ["auto", "ran"])])
def test_engine_environment_variable(name, want):
    """``DGL1_TPU_ENGINE`` read once at import (``pallas`` is the tile
    engine); an unknown name raises at the first dispatch."""
    env = {k: v for k, v in os.environ.items() if k != "DGL1_TPU_ENGINE"}
    if name is not None:
        env["DGL1_TPU_ENGINE"] = name
    out = subprocess.run([sys.executable, "-c", _ENGINE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, check=True)
    assert out.stdout.split("\n")[:2] == want, out.stdout


def test_top_level_names_match_reference():
    """Every name of the reference's ``__all__`` but those not ported yet
    (``geometry``, ``khop_in_subgraph``)."""
    later = {"geometry", "khop_in_subgraph"}
    missing = [n for n in jdgl.__all__ if n not in later
               and not hasattr(tdgl, n)]
    assert not missing, missing
    assert tdgl.apply_each({"a": 1}, lambda x, y: x + y, 2) == {"a": 3}
    assert tdgl.apply_each(3, lambda x: -x) == -3
    assert tdgl.hub_order is tdgl.hub_format.hub_order
    assert tdgl.distributed is tdgl.parallel
    import dgl1_tpu_torch.distributed as dist_mod
    assert dist_mod is tdgl.parallel
    assert set(tdgl.transform.__all__) >= set(jdgl.transform.__all__)
