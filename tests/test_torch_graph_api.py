"""The port's ``Graph`` DGL surface against the JAX package's on the same
edges, on a graph and on a block: the queries (host answers compared
exactly), the DGL names, ``formats()``, ``clone``/``local_var``,
``rand_bipartite`` and ``from_scipy``, and the top-level names."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl

KINDS = ["graph", "block"]


def pair(kind):
    rng = np.random.default_rng(11)
    if kind == "graph":
        s = rng.integers(0, 20, 70)
        d = rng.integers(0, 20, 70)
        s[:4], d[:4] = (4, 4, 9, 2), (7, 7, 5, 2)  # a repeat, a self-loop
        return (jdgl.graph((s, d), num_nodes=20),
                tdgl.graph((s, d), num_nodes=20, device="cpu"))
    s = rng.integers(0, 20, 60)
    d = rng.integers(0, 8, 60)
    s[:4], d[:4] = (4, 4, 9, 2), (7, 7, 5, 2)
    return (jdgl.block((s, d), num_src_nodes=20, num_dst_nodes=8),
            tdgl.block((s, d), num_src_nodes=20, num_dst_nodes=8,
                       device="cpu"))


def same(a, b):
    """Equal answers, arrays (of either package) or tuples of them."""
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


QUERIES = {
    "edges": lambda g: g.edges(),
    "edges_srcdst": lambda g: g.edges(order="srcdst"),
    "all_edges": lambda g: g.all_edges(),
    "srcnodes": lambda g: g.srcnodes(),
    "dstnodes": lambda g: g.dstnodes(),
    "edge_ids": lambda g: g.edge_ids([4, 9], [7, 5]),
    "edge_ids_uv": lambda g: g.edge_ids([4, 9], [7, 5], return_uv=True),
    "has_edges_between": lambda g: g.has_edges_between([4, 0, 9],
                                                       [7, 0, 5]),
    "find_edges": lambda g: g.find_edges([0, 5, 17]),
    "in_edges": lambda g: g.in_edges([7, 2]),
    "in_edges_all": lambda g: g.in_edges([7, 2], form="all"),
    "out_edges": lambda g: g.out_edges([4, 1], form="eid"),
    "successors": lambda g: g.successors(4),
    "predecessors": lambda g: g.predecessors(7),
    "in_degrees": lambda g: g.in_degrees(),
    "adjacency_matrix": lambda g: g.adjacency_matrix(),
    "adj_transpose_csr": lambda g: g.adj(transpose=True,
                                         scipy_fmt="csr").toarray(),
    "is_multigraph": lambda g: g.is_multigraph(),
    "num_real_edges": lambda g: g.num_real_edges(),
    "is_padded": lambda g: g.is_padded,
    "number_of": lambda g: (g.number_of_src_nodes(),
                            g.number_of_dst_nodes(), g.number_of_edges()),
}
GRAPH_ONLY = {
    "nodes": lambda g: g.nodes(),
    "has_nodes": lambda g: g.has_nodes([0, 5, 19, 20, -1]),
    "has_nodes_scalar": lambda g: g.has_nodes(3),
    "number_of_nodes": lambda g: g.number_of_nodes(),
    "incidence_in": lambda g: g.incidence_matrix("in"),
    "incidence_out": lambda g: g.inc("out"),
    "incidence_both": lambda g: g.inc("both", scipy_fmt="coo").toarray(),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("query", sorted(QUERIES) + sorted(GRAPH_ONLY))
def test_queries_match_reference(kind, query):
    gj, gt = pair(kind)
    if query in GRAPH_ONLY:
        if kind == "block":
            with pytest.raises(ValueError):
                GRAPH_ONLY[query](gt)
            return
        fn = GRAPH_ONLY[query]
    else:
        fn = QUERIES[query]
    same(fn(gt), fn(gj))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["ntypes", "etypes", "canonical_etypes",
                                  "is_homogeneous", "long", "idtype",
                                  "create_formats_", "schemes", "formats"])
def test_dgl_names_match_reference(kind, name):
    gj, gt = pair(kind)
    if name == "long":
        assert gt.long() is gt
    elif name == "create_formats_":
        assert gt.create_formats_() is gt
    elif name == "idtype":
        assert gt.idtype == torch.int32 and str(gj.idtype) == "int32"
    elif name == "schemes":
        x = np.ones((gt.num_src_nodes(), 3), np.float32)
        w = np.ones((gt.num_edges(), 2), np.float32)
        gt.srcdata["x"], gj.srcdata["x"] = torch.tensor(x), jnp.asarray(x)
        gt.edata["w"], gj.edata["w"] = torch.tensor(w), jnp.asarray(w)
        assert ({k: v[0] for k, v in gt.edge_attr_schemes().items()}
                == {k: v[0] for k, v in gj.edge_attr_schemes().items()})
        assert ({k: v[0] for k, v in gt.node_attr_schemes().items()}
                == {k: v[0] for k, v in gj.node_attr_schemes().items()})
    elif name == "formats":
        got, want = gt.formats(), gj.formats()
        assert sorted(got["created"]) == sorted(want["created"])
        g2t, g2j = gt.formats(["csr"]), gj.formats(["csr"])
        assert g2t.ell_dst is None and g2t.tdst is None
        assert g2t.hub_dst is None and g2t.is_block == gt.is_block
        same(g2t.edges(), g2j.edges())
        assert "ell" in tdgl.graph(([0, 1], [1, 0]), device="cpu").formats(
            "ell").formats()["created"]
    else:
        assert getattr(gt, name) == getattr(gj, name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("how", ["clone", "local_var"])
def test_clone_and_local_var_keep_frames_apart(kind, how):
    _, gt = pair(kind)
    gt.edata["w"] = torch.ones(gt.num_edges())
    g2 = getattr(gt, how)()
    g2.edata["v"] = torch.zeros(gt.num_edges())
    g2.dstdata["d"] = torch.zeros(gt.num_dst_nodes())
    assert "v" not in gt.edata and "d" not in gt.dstdata
    assert "w" in g2.edata and g2.src is gt.src
    if kind == "graph":
        assert g2.dstdata is g2.ndata


@pytest.mark.parametrize("kind", KINDS)
def test_subgraph_and_reverse(kind):
    gj, gt = pair(kind)
    if kind == "block":
        with pytest.raises(ValueError):
            gt.nodes()
        same(tdgl.reverse(gt).edges(), jdgl.reverse(gj).edges())
        return
    st, sj = gt.subgraph([1, 4, 7, 9, 12]), gj.subgraph([1, 4, 7, 9, 12])
    same(st.edges(), sj.edges())
    same(st.ndata["_ID"], sj.ndata["_ID"])
    same(tdgl.reverse(gt).edges(), jdgl.reverse(gj).edges())


@pytest.mark.parametrize("ctor", ["rand_bipartite", "from_scipy"])
def test_constructors_match_reference(ctor):
    if ctor == "rand_bipartite":
        gj = jdgl.rand_bipartite(9, 5, 30, seed=3)
        gt = tdgl.rand_bipartite(9, 5, 30, seed=3, device="cpu")
        assert gt.is_block and gt.num_src_nodes() == 9
    else:
        m = sp.random(7, 7, density=0.3, random_state=2, format="csr")
        gj = jdgl.from_scipy(m)
        gt = tdgl.from_scipy(m, device="cpu")
    same(gt.edges(), gj.edges())
    same(gt.in_degrees(), gj.in_degrees())


@pytest.mark.parametrize("name", ["DGLGraph", "DGLHeteroGraph", "NID", "EID",
                                  "NTYPE", "ETYPE", "edge_softmax",
                                  "reverse", "fn", "core"])
def test_top_level_names(name):
    assert hasattr(tdgl, name) and hasattr(jdgl, name if name != "fn"
                                            else "function")
    if name in ("NID", "EID", "NTYPE", "ETYPE"):
        assert getattr(tdgl, name) == getattr(jdgl, name)
    if name == "DGLGraph":
        assert tdgl.DGLGraph is tdgl.Graph
    if name == "DGLHeteroGraph":
        assert tdgl.DGLHeteroGraph is tdgl.HeteroGraph
    if name == "fn":
        assert tdgl.fn is tdgl.function
