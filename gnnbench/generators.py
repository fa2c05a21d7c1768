"""The one graph generator that every traffic file drives.

A traffic file (``traffic/<mix>.json``) names a ``family`` and its
parameters; :func:`generate` returns the edge lists as numpy arrays,
drawn from the file's own ``dataset_seed``, so a graph is fixed the way a
dataset is. ``--seed`` never reaches it.

The families are frozen copies of the synthetic generators the program
ships (the same draws in the same order), so the yardstick stays put if
the program's copies change; ``tests/test_gnnbench_generators.py`` holds
each against the program's at a small size.

* ``powerlaw``: Zipf(``alpha``) in-degrees, uniform sources, ``edges``
  edges (``nodes * avg_degree`` without it): the power-law family.
* ``geometric``: ids are positions on a line and edges join nearby ids
  (Gaussian offsets of width ``max(avg_degree, 2)``): meshes, road
  networks, kNN graphs, no hubs.
* ``mag``: the ogbn-mag-shaped heterograph, node counts divided by
  ``scale``, 7 relations (writes, cites, affiliated_with, has_topic and
  the reverses of the three that join two types); ``edges`` gives the
  four relations' counts (without it, the program's: 7 writes an author,
  10 cites and 5 topics a paper, one affiliation an author).

Either kind may add reverses: ``reverse`` appends each edge's reverse to
a homogeneous graph, ``undirected`` lists the relations of a heterograph
that get theirs.

A homogeneous result is ``{"kind": "homo", "num_nodes": n, "src": ...,
"dst": ...}``; a heterograph ``{"kind": "hetero", "num_nodes": {type:
n}, "relations": {(src type, etype, dst type): (src, dst)}}``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate", "FAMILIES"]


def powerlaw(p: dict) -> dict:
    rng = np.random.default_rng(p["dataset_seed"])
    n = p["nodes"]
    num_edges = p["edges"] if "edges" in p else n * p["avg_degree"]
    w = np.arange(1, n + 1, dtype=np.float64) ** -p["alpha"]
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int64)
    src = rng.integers(0, n, size=num_edges)
    return {"kind": "homo", "num_nodes": n, "src": src, "dst": dst}


def geometric(p: dict) -> dict:
    rng = np.random.default_rng(p["dataset_seed"])
    n, deg = p["nodes"], p["avg_degree"]
    num_edges = n * deg
    src = rng.integers(0, n, size=num_edges)
    off = np.rint(rng.normal(0.0, max(deg, 2), num_edges)).astype(np.int64)
    off = np.where(off == 0, 1, off)
    dst = np.clip(src + off, 0, n - 1)
    return {"kind": "homo", "num_nodes": n, "src": src, "dst": dst}


def mag(p: dict) -> dict:
    rng = np.random.default_rng(p["dataset_seed"])
    scale, classes = p["scale"], p["classes"]
    n_paper = max(736_389 // scale, classes * 10)
    n_author = max(1_134_649 // scale, 100)
    n_inst = max(8_740 // max(scale // 4, 1), 20)
    n_field = max(59_965 // scale, classes)

    lab_p = rng.integers(0, classes, size=n_paper)
    lab_a = rng.integers(0, classes, size=n_author)
    lab_f = np.concatenate([np.arange(classes),
                            rng.integers(0, classes, size=n_field - classes)])

    def pick_same(pool, want, p_same=0.8):
        """Endpoints from ``pool``, biased to the wanted class."""
        order = np.argsort(pool, kind="stable")
        start = np.searchsorted(pool[order], np.arange(classes))
        count = np.bincount(pool, minlength=classes)
        same = rng.random(len(want)) < p_same
        r_same = order[start[want] + (
            rng.random(len(want)) * np.maximum(count[want], 1)
        ).astype(np.int64)]
        r_any = rng.integers(0, len(pool), size=len(want))
        return np.where(same & (count[want] > 0), r_same, r_any)

    n_edges = {"writes": n_author * 7, "cites": n_paper * 10,
               "affiliated_with": n_author, "has_topic": n_paper * 5,
               **p.get("edges", {})}
    a_w = rng.integers(0, n_author, size=n_edges["writes"])
    p_w = pick_same(lab_p, lab_a[a_w])
    p_c_src = rng.integers(0, n_paper, size=n_edges["cites"])
    p_c_dst = pick_same(lab_p, lab_p[p_c_src])
    a_af = rng.integers(0, n_author, size=n_edges["affiliated_with"])
    i_af = rng.integers(0, n_inst, size=n_edges["affiliated_with"])
    p_t = rng.integers(0, n_paper, size=n_edges["has_topic"])
    f_t = pick_same(lab_f, lab_p[p_t])
    return {"kind": "hetero",
            "num_nodes": {"paper": n_paper, "author": n_author,
                          "institution": n_inst, "field_of_study": n_field},
            "relations": {
                ("author", "writes", "paper"): (a_w, p_w),
                ("paper", "rev_writes", "author"): (p_w, a_w),
                ("paper", "cites", "paper"): (p_c_src, p_c_dst),
                ("author", "affiliated_with", "institution"): (a_af, i_af),
                ("institution", "rev_affiliated_with", "author"):
                    (i_af, a_af),
                ("paper", "has_topic", "field_of_study"): (p_t, f_t),
                ("field_of_study", "rev_has_topic", "paper"): (f_t, p_t)}}


FAMILIES = {"powerlaw": powerlaw, "geometric": geometric, "mag": mag}


def generate(traffic: dict) -> dict:
    """The edge lists of a traffic file's graph; with ``self_loops`` a
    homogeneous graph gets no loops here: each side adds its own."""
    family = traffic["family"]
    if family not in FAMILIES:
        raise ValueError(f"unknown graph family {family!r}")
    coo = FAMILIES[family](traffic)
    if traffic.get("reverse"):
        s, d = coo["src"], coo["dst"]
        coo["src"], coo["dst"] = np.concatenate([s, d]), np.concatenate([d, s])
    rels = coo.get("relations", {})
    for et in traffic.get("undirected", []):
        (c,) = [c for c in rels if c[1] == et]
        s, d = rels[c]
        rels[c] = (np.concatenate([s, d]), np.concatenate([d, s]))
    return coo


def edge_count(coo: dict) -> int:
    if coo["kind"] == "homo":
        return int(coo["src"].shape[0])
    return sum(int(s.shape[0]) for s, _ in coo["relations"].values())
