"""Each frozen graph family equals the program's own generator."""

import numpy as np
import pytest

from gnnbench import generators


def _edges(g):
    s, d = g.edges()
    return s.cpu().numpy(), d.cpu().numpy()


@pytest.mark.parametrize("n,deg,alpha,seed", [(500, 6, 2.1, 3), (257, 26, 1.5, 0)])
def test_powerlaw_matches_program(n, deg, alpha, seed):
    from dgl1_tpu_torch.data import powerlaw_graph

    coo = generators.generate({"family": "powerlaw", "nodes": n,
                               "avg_degree": deg, "alpha": alpha,
                               "dataset_seed": seed})
    s, d = _edges(powerlaw_graph(n, deg, alpha=alpha, seed=seed,
                                 device="cpu"))
    assert coo["num_nodes"] == n
    np.testing.assert_array_equal(coo["src"], s)
    np.testing.assert_array_equal(coo["dst"], d)


@pytest.mark.parametrize("n,deg,seed", [(700, 5, 4), (1024, 8, 0)])
def test_geometric_matches_program(n, deg, seed):
    from dgl1_tpu_torch.data import geometric_graph

    coo = generators.generate({"family": "geometric", "nodes": n,
                               "avg_degree": deg, "dataset_seed": seed})
    s, d = _edges(geometric_graph(n, deg, seed=seed, device="cpu"))
    np.testing.assert_array_equal(coo["src"], s)
    np.testing.assert_array_equal(coo["dst"], d)


def test_mag_matches_program():
    from dgl1_tpu_torch.data import synthetic_mag_heterograph

    coo = generators.generate({"family": "mag", "scale": 400,
                               "classes": 349, "dataset_seed": 7})
    hg, _ = synthetic_mag_heterograph(scale=400, device="cpu")
    assert set(coo["relations"]) == set(hg.canonical_etypes)
    for c, (src, dst) in coo["relations"].items():
        s, d = _edges(hg.rel_graphs[c])
        np.testing.assert_array_equal(src, s)
        np.testing.assert_array_equal(dst, d)
    for nt, n in coo["num_nodes"].items():
        assert hg.num_nodes(nt) == n


def test_edge_counts_and_reverses():
    """``edges`` sets the count of the power-law family and of each mag
    relation; ``reverse`` and ``undirected`` append the reverses."""
    pl = {"family": "powerlaw", "nodes": 300, "edges": 1234, "alpha": 2.1,
          "dataset_seed": 5}
    one = generators.generate(pl)
    both = generators.generate({**pl, "reverse": True})
    assert one["src"].shape == (1234,)
    np.testing.assert_array_equal(both["src"], np.r_[one["src"], one["dst"]])
    np.testing.assert_array_equal(both["dst"], np.r_[one["dst"], one["src"]])
    counts = {"writes": 900, "cites": 500, "affiliated_with": 70,
              "has_topic": 800}
    mag = generators.generate({"family": "mag", "scale": 400, "classes": 349,
                               "dataset_seed": 7, "edges": counts,
                               "undirected": ["cites"]})
    rels = {c[1]: s.shape[0] for c, (s, _) in mag["relations"].items()}
    assert rels == {"writes": 900, "rev_writes": 900, "cites": 1000,
                    "affiliated_with": 70, "rev_affiliated_with": 70,
                    "has_topic": 800, "rev_has_topic": 800}
    s, d = mag["relations"][("paper", "cites", "paper")]
    np.testing.assert_array_equal(s[500:], d[:500])
    np.testing.assert_array_equal(d[500:], s[:500])


def test_traffic_files_generate_their_graphs():
    """The committed mixes at their sizes: node and edge counts (OGB's
    published counts with the sources' reverses)."""
    from gnnbench import bench

    want = {"powerlaw": (169343, 2 * 1166243),
            "mag-full": (1939743, 2 * (7145660 + 5416271 + 1043998
                                       + 7505078))}
    for name, (n, e) in want.items():
        coo = generators.generate(bench.load_json("traffic", name))
        nodes = coo["num_nodes"]
        assert (sum(nodes.values()) if isinstance(nodes, dict) else nodes) == n
        assert generators.edge_count(coo) == e
