"""The port's datasets against the JAX package's, array for array: every
synthetic fallback (both packages draw the reference's seeds), every raw
parser on the fixtures the reference's tests write
(``test_raw_parsers*.py``, ``test_datasets_extra.py``), ``split_dataset``
and ``Subset``, and a processed cache written by either package loading
in the other. Each test passes its own ``raw_dir`` under ``tmp_path``."""

import gzip
import json

import numpy as np
import pytest
import torch
from scipy import sparse as sp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from test_raw_parsers import _write_planetoid


def assert_graph_equal(gj, gt, what=""):
    assert gt.num_nodes() == gj.num_nodes(), what
    e = gj.num_edges()
    assert gt.num_edges() == e, what
    assert gt.num_edges_padded() == gj.src.shape[0], what
    for a in ("src", "dst"):
        np.testing.assert_array_equal(getattr(gt, a).numpy()[:e],
                                      np.asarray(getattr(gj, a))[:e],
                                      err_msg=what)
    assert set(gt.ndata) == set(gj.ndata), what
    for k, v in gj.ndata.items():
        np.testing.assert_array_equal(gt.ndata[k].numpy(), np.asarray(v),
                                      err_msg=f"{what} ndata {k}")
    assert set(gt.edata) == set(gj.edata), what
    for k, v in gj.edata.items():
        np.testing.assert_array_equal(gt.edata[k].numpy()[:e],
                                      np.asarray(v)[:e],
                                      err_msg=f"{what} edata {k}")


def assert_item_equal(a, b, what=""):
    """An item of a reference dataset against the port's."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_item_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, jdgl.Graph):
        assert_graph_equal(a, b, what)
    elif isinstance(b, torch.Tensor):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)


def assert_dataset_equal(dj, dt, n=None):
    assert len(dt) == len(dj)
    for i in range(len(dj) if n is None else min(n, len(dj))):
        assert_item_equal(dj[i], dt[i], f"item {i}")


# Node-classification datasets (GraphDataset subclasses): name, kwargs.
GRAPH_DATASETS = [
    ("CoraGraphDataset", {}), ("CiteseerGraphDataset", {}),
    ("PubmedGraphDataset", {}), ("RedditDataset", {}),
    ("OGBDataset", {"name": "ogbn-arxiv", "scale": 100}),
    ("OGBDataset", {"name": "ogbn-products", "scale": 2000}),
    ("FB15k237Dataset", {}), ("WN18Dataset", {}), ("AIFBDataset", {}),
    ("CoraFullDataset", {}), ("CoauthorCSDataset", {}),
    ("CoauthorPhysicsDataset", {}), ("AmazonCoBuyComputerDataset", {}),
    ("AmazonCoBuyPhotoDataset", {}),
]


@pytest.mark.parametrize("cls,kw", GRAPH_DATASETS,
                         ids=[c + kw.get("name", "")
                              for c, kw in GRAPH_DATASETS])
def test_graph_dataset_fallback_matches_reference(tmp_path, monkeypatch,
                                                  cls, kw):
    # The compressed cache takes most of a large dataset's time; its
    # round trip is test_processed_cache_loads_in_the_other_package's.
    saved = []
    for pkg in (jdgl, tdgl):
        monkeypatch.setattr(pkg.data.base, "save_graphs",
                            lambda path, graphs, labels: saved.append(path))
    dj = getattr(jdgl.data, cls)(raw_dir=str(tmp_path / "j"), **kw)
    dt = getattr(tdgl.data, cls)(raw_dir=str(tmp_path / "t"), device="cpu",
                                 **kw)
    assert dj.is_synthetic and dt.is_synthetic
    assert getattr(dt, "num_classes", None) == getattr(dj, "num_classes",
                                                       None)
    assert_dataset_equal(dj, dt)
    assert saved[1] == str(tmp_path / "t" / f"{dt.name}_processed.npz")


GRAPH_LEVEL = {
    "karate": lambda m, tmp, **d: m.KarateClubDataset(**d),
    "minigc": lambda m, tmp, **d: m.MiniGCDataset(12, 6, 14, seed=3, **d),
    "ppi": lambda m, tmp, **d: m.PPIDataset("valid", scale=8,
                                            raw_dir=str(tmp), **d),
    "tu": lambda m, tmp, **d: m.TUDataset("MUTAG", seed=1, raw_dir=str(tmp),
                                          **d),
    "gin": lambda m, tmp, **d: m.GINDataset("PTC", self_loop=True,
                                            max_graphs=12, seed=2,
                                            raw_dir=str(tmp), **d),
    "qm7b": lambda m, tmp, **d: m.QM7bDataset(6, seed=3, raw_dir=str(tmp),
                                              **d),
    "qm9": lambda m, tmp, **d: m.QM9Dataset(("mu", "gap", "Cv"), 6, seed=4,
                                            raw_dir=str(tmp), **d),
    "sbm": lambda m, tmp, **d: m.SBMMixtureDataset(3, 40, 2, pad_multiple=64,
                                                   seed=1, **d),
    "sst": lambda m, tmp, **d: m.SSTDataset("dev", num_trees=12, seed=5,
                                            raw_dir=str(tmp), **d),
}


@pytest.mark.parametrize("name", sorted(GRAPH_LEVEL))
def test_graph_level_fallback_matches_reference(tmp_path, name):
    dj = GRAPH_LEVEL[name](jdgl.data, tmp_path)
    dt = GRAPH_LEVEL[name](tdgl.data, tmp_path, device="cpu")
    assert getattr(dt, "is_synthetic", True) == getattr(dj, "is_synthetic",
                                                        True)
    assert_dataset_equal(dj, dt)
    if name == "sbm":
        for a, b in zip(dj.labels, dt.labels):
            np.testing.assert_array_equal(b, a)
    if name in ("tu", "gin"):
        assert dt.num_classes == dj.num_classes
    if name == "gin":
        assert dt.dim_nfeats == dj.dim_nfeats


# Raw-file fixtures in the formats of the reference's parser tests.
def _reddit(tmp):
    rng = np.random.default_rng(1)
    n, d = 12, 6
    np.savez(tmp / "reddit_data.npz",
             feature=rng.normal(size=(n, d)).astype(np.float32),
             label=rng.integers(0, 3, n),
             node_types=np.array([1] * 6 + [2] * 3 + [3] * 3),
             node_ids=np.arange(n))
    sp.save_npz(tmp / "reddit_graph.npz",
                sp.random(n, n, density=0.3, random_state=2, format="csr"))
    return lambda m, **d: m.RedditDataset(raw_dir=str(tmp),
                                          force_reload=True, **d)


def _ogb(tmp):
    raw = tmp / "raw"
    raw.mkdir(parents=True)
    split = tmp / "split" / "time"
    split.mkdir(parents=True)
    n, rng = 10, np.random.default_rng(3)

    def gz(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    gz(raw / "edge.csv.gz",
       np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)], 1), "%d")
    gz(raw / "node-feat.csv.gz", rng.normal(size=(n, 4)), "%.6f")
    gz(raw / "node-label.csv.gz", rng.integers(0, 5, n)[:, None], "%d")
    gz(raw / "num-node-list.csv.gz", np.array([[n]]), "%d")
    gz(split / "train.csv.gz", np.arange(6)[:, None], "%d")
    gz(split / "valid.csv.gz", np.arange(6, 8)[:, None], "%d")
    gz(split / "test.csv.gz", np.arange(8, 10)[:, None], "%d")
    return lambda m, **d: m.OGBDataset("ogbn-arxiv", raw_dir=str(tmp),
                                       force_reload=True, **d)


def _triples(tmp, dicts):
    if dicts:
        (tmp / "entities.dict").write_text("0\tc\n1\tb\n2\ta\n")
        (tmp / "relations.dict").write_text("0\tr2\n1\tr1\n")
    rows = {"train": [("a", "r1", "b"), ("b", "r2", "c"), ("a", "r1", "c")],
            "valid": [("c", "r2", "a")],
            "test": [("b", "r1", "a"), ("c", "r1", "b")]}
    for part, rr in rows.items():
        (tmp / f"{part}.txt").write_text(
            "".join(f"{h}\t{r}\t{t}\n" for h, r, t in rr))
    return lambda m, **d: m.FB15k237Dataset(raw_dir=str(tmp),
                                            force_reload=True, **d)


def _gnn_benchmark(tmp):
    rng = np.random.default_rng(0)
    n = 30
    adj = sp.random(n, n, density=0.1, random_state=0, format="csr")
    attr = sp.random(n, 5, density=0.4, random_state=1, format="csr")
    np.savez(tmp / "coauthor_cs.npz", adj_data=adj.data,
             adj_indices=adj.indices, adj_indptr=adj.indptr,
             adj_shape=np.array(adj.shape), attr_data=attr.data,
             attr_indices=attr.indices, attr_indptr=attr.indptr,
             attr_shape=np.array(attr.shape), labels=rng.integers(0, 3, n))
    return lambda m, **d: m.CoauthorCSDataset(raw_dir=str(tmp),
                                              force_reload=True, **d)


def _tu(tmp):
    (tmp / "TOY_A.txt").write_text("1, 2\n2, 3\n3, 1\n4, 5\n5, 6\n")
    (tmp / "TOY_graph_indicator.txt").write_text("1\n1\n1\n2\n2\n2\n")
    (tmp / "TOY_graph_labels.txt").write_text("7\n9\n")
    (tmp / "TOY_node_labels.txt").write_text("2\n3\n2\n3\n2\n3\n")
    (tmp / "TOY_node_attributes.txt").write_text(
        "0.5, 1.0\n0.25, 2.0\n0.125, 3.0\n1.5, 4.0\n2.5, 5.0\n3.5, 6.0\n")
    return lambda m, **d: m.TUDataset("TOY", raw_dir=str(tmp), **d)


def _ppi(tmp):
    rng = np.random.default_rng(0)
    links = [{"source": s, "target": t}
             for s, t in ((0, 1), (2, 3), (4, 5), (6, 7), (5, 6))]
    with open(tmp / "valid_graph.json", "w") as f:
        json.dump({"nodes": [{"id": i} for i in range(8)], "links": links},
                  f)
    np.save(tmp / "valid_feats.npy",
            rng.normal(size=(8, 5)).astype(np.float32))
    np.save(tmp / "valid_labels.npy",
            (rng.random((8, 3)) < 0.5).astype(np.float32))
    np.save(tmp / "valid_graph_id.npy", np.array([0] * 4 + [1] * 4))
    return lambda m, **d: m.PPIDataset(mode="valid", raw_dir=str(tmp), **d)


def _gin(tmp, degree):
    (tmp / "TOYGIN.txt").write_text(
        "2\n3 0\n0 2 1 2\n1 1 0\n1 1 0\n2 1\n2 1 1\n0 1 0\n")
    return lambda m, **d: m.GINDataset("TOYGIN", raw_dir=str(tmp),
                                       self_loop=degree,
                                       degree_as_nlabel=degree, **d)


def _qm9(tmp):
    from dgl1_tpu.data.qm import _QM9_KEYS

    rng = np.random.default_rng(1)
    R = rng.normal(size=(5, 3)).astype(np.float32)
    R[3], R[4] = [0, 0, 0], [10, 0, 0]
    arrays = {"N": np.array([3, 2]), "R": R,
              "Z": np.array([6, 1, 1, 8, 1], np.float32)}
    arrays.update({k: rng.normal(size=2).astype(np.float32)
                   for k in _QM9_KEYS})
    np.savez(tmp / "qm9_eV.npz", **arrays)
    return lambda m, **d: m.QM9Dataset(("mu", "gap"), raw_dir=str(tmp), **d)


def _qm7b(tmp):
    from scipy.io import savemat

    X = np.zeros((2, 4, 4), np.float32)
    X[0, :2, :2] = [[0.5 * 6 ** 2.4, 3.0], [3.0, 0.5]]
    X[1, :3, :3] = [[0.5 * 8 ** 2.4, 2.0, 0.0], [2.0, 0.5, 1.0],
                    [0.0, 1.0, 0.5]]
    savemat(tmp / "qm7b.mat",
            {"X": X, "T": np.arange(28, dtype=np.float32).reshape(2, 14)})
    return lambda m, **d: m.QM7bDataset(raw_dir=str(tmp), **d)


def _sst(tmp, mode):
    (tmp / "train.txt").write_text("(3 (2 It) (4 (2 's) (4 great)))\n"
                                   "(1 (2 not) (1 good))\n")
    (tmp / "dev.txt").write_text("(2 (2 It) (2 's))\n(2 (3 new) (2 It))\n")
    return lambda m, **d: m.SSTDataset(mode=mode, raw_dir=str(tmp), **d)


def _csv(tmp):
    (tmp / "nodes.csv").write_text(
        "node_id,feat,label\n2,1.0;2.0,1\n0,3.0;4.0,0\n1,5.0;6.0,1\n")
    (tmp / "edges.csv").write_text(
        "src_id,dst_id,feat,label\n0,1,0.5,1\n1,2,0.25,0\n2,0,1.5,1\n")
    return lambda m, **d: m.CSVDataset(str(tmp), **d)


def _planetoid(tmp, gap):
    _write_planetoid(tmp, "cora", gap=gap)
    return lambda m, **d: m.CoraGraphDataset(raw_dir=str(tmp),
                                             force_reload=True, **d)


RAW = {"planetoid": lambda t: _planetoid(t, False),
       "planetoid_gap": lambda t: _planetoid(t, True),
       "reddit": _reddit, "ogb": _ogb,
       "triples": lambda t: _triples(t, False),
       "triples_dicts": lambda t: _triples(t, True),
       "gnn_benchmark": _gnn_benchmark, "tu": _tu, "ppi": _ppi,
       "gin": lambda t: _gin(t, False), "gin_degree": lambda t: _gin(t, True),
       "qm9": _qm9, "qm7b": _qm7b, "sst_train": lambda t: _sst(t, "train"),
       "sst_dev": lambda t: _sst(t, "dev"), "csv": _csv}


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_parser_matches_reference(tmp_path, name):
    make = RAW[name](tmp_path)
    dj, dt = make(jdgl.data), make(tdgl.data, device="cpu")
    assert not getattr(dt, "is_synthetic", False)
    assert not getattr(dj, "is_synthetic", False)
    assert_dataset_equal(dj, dt)
    if name.startswith("triples"):
        assert dt.num_rels == dj.num_rels
    if name.startswith("sst"):
        assert dt.vocab == dj.vocab


def test_split_dataset_and_subset_match_reference():
    dj = jdgl.data.MiniGCDataset(23, 5, 9, seed=4)
    dt = tdgl.data.MiniGCDataset(23, 5, 9, seed=4, device="cpu")
    for kw in (dict(frac_list=(0.6, 0.2, 0.2)),
               dict(frac_list=(0.5, 0.3, 0.2), shuffle=True,
                    random_state=3)):
        for sj, st in zip(jdgl.data.split_dataset(dj, **kw),
                          tdgl.data.split_dataset(dt, **kw)):
            assert isinstance(st, tdgl.data.Subset)
            assert st.indices == sj.indices
            assert_dataset_equal(sj, st)
    with pytest.raises(ValueError, match="sum to 1"):
        tdgl.data.split_dataset(dt, (0.5, 0.2))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_processed_cache_loads_in_the_other_package(tmp_path, monkeypatch,
                                                    writer):
    """One package writes ``aifb_processed.npz``; the other loads it
    without generating (its ``_generate`` raises)."""
    first, second = ((jdgl, tdgl) if writer == "reference"
                     else (tdgl, jdgl))
    kw = {"device": "cpu"}
    made = first.data.AIFBDataset(raw_dir=str(tmp_path),
                                  **(kw if first is tdgl else {}))
    assert made.is_synthetic

    def refuse(self):
        raise AssertionError("generated instead of loading the cache")

    monkeypatch.setattr(second.data.AIFBDataset, "_generate", refuse)
    loaded = second.data.AIFBDataset(raw_dir=str(tmp_path),
                                     **(kw if second is tdgl else {}))
    assert loaded.is_synthetic
    dj, dt = (made, loaded) if writer == "reference" else (loaded, made)
    assert_dataset_equal(dj, dt)
