"""Random walks and PinSAGE's sampler: the port against the JAX package
on the same graphs and seeds, trace for trace and edge for edge."""

import numpy as np
import pytest
import torch

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from torch_parity import powerlaw_edges


def graphs(n=400, deg=4, seed=0):
    src, dst = powerlaw_edges(n, deg, seed=seed)
    # A few dead ends: nodes whose out-edges are dropped.
    keep = src % 17 != 3
    src, dst = src[keep], dst[keep]
    gj = jdgl.graph((src, dst), num_nodes=n)
    gt = tdgl.graph((src, dst), num_nodes=n, device="cpu")
    w = np.random.default_rng(seed + 5).uniform(0.1, 2.0, len(src))
    gj.edata["w"] = w.astype(np.float32)
    gt.edata["w"] = torch.from_numpy(w.astype(np.float32))
    return gj, gt


@pytest.mark.parametrize("restart,prob", [(0.0, None), (0.3, None),
                                          (0.0, "w"), (0.2, "w")])
def test_random_walk_matches_reference(restart, prob):
    gj, gt = graphs()
    starts = np.random.default_rng(1).integers(0, 400, 97)
    want = jdgl.sampling.random_walk(gj, starts, length=6,
                                     restart_prob=restart, prob=prob,
                                     rng=np.random.default_rng(7))
    got = tdgl.sampling.random_walk(gt, torch.from_numpy(starts), length=6,
                                    restart_prob=restart, prob=prob,
                                    rng=np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1:] == -1).any()  # some walks ended


def metapath_data(n_user, n_item, seed=3):
    rng = np.random.default_rng(seed)
    return {("user", "buys", "item"): (rng.integers(0, n_user, 120),
                                       rng.integers(0, n_item, 120)),
            ("item", "bought_by", "user"): (rng.integers(0, n_item, 110),
                                            rng.integers(0, n_user, 110))}


def test_metapath_walk_matches_reference():
    # Equal type sizes: the reference steps an ended walk from its last
    # node, of another type, which must stay in range there.
    data, nn_ = metapath_data(30, 30), {"user": 30, "item": 30}
    hj = jdgl.heterograph(data, num_nodes_dict=nn_)
    ht = tdgl.heterograph(data, num_nodes_dict=nn_, device="cpu")
    mp = ["buys", "bought_by", "buys"]
    starts = np.arange(30)
    tj, yj = jdgl.sampling.random_walk(hj, starts, metapath=mp,
                                       restart_prob=0.1,
                                       rng=np.random.default_rng(4))
    tt, yt = tdgl.sampling.random_walk(ht, starts, metapath=mp,
                                       restart_prob=0.1,
                                       rng=np.random.default_rng(4))
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(yt, yj)
    assert (tt[:, 1:] == -1).any()


def test_metapath_walk_ended_walks_on_unequal_types():
    """With 40 items and 30 users an ended walk's item id is past the
    users' range: the port keeps it ended (the reference indexes out of
    range)."""
    data = metapath_data(30, 40)
    ht = tdgl.heterograph(data, num_nodes_dict={"user": 30, "item": 40},
                          device="cpu")
    tt, _ = tdgl.sampling.random_walk(ht, np.arange(30),
                                      metapath=["buys", "bought_by", "buys"],
                                      restart_prob=0.3,
                                      rng=np.random.default_rng(4))
    ended = tt == -1
    assert ended[:, 1:].any()
    # Once ended, a walk stays ended.
    assert not (ended[:, :-1] & ~ended[:, 1:]).any()
    assert tt[:, [0, 2]].max() < 30 and tt[:, [1, 3]].max() < 40


def test_node2vec_matches_reference():
    gj, gt = graphs(n=120, deg=3, seed=2)
    starts = np.arange(0, 120, 3)
    want = jdgl.sampling.node2vec_random_walk(
        gj, starts, p=0.5, q=2.0, walk_length=5, rng=np.random.default_rng(9))
    got = tdgl.sampling.node2vec_random_walk(
        gt, starts, p=0.5, q=2.0, walk_length=5, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls,kw", [
    ("PinSAGESampler", dict(num_random_walks=16, num_neighbors=5)),
    ("RandomWalkNeighborSampler",
     dict(num_traversals=3, termination_prob=0.3, num_random_walks=8,
          num_neighbors=4)),
])
def test_pinsage_neighbours_match_reference(cls, kw):
    gj, gt = graphs(n=300, deg=5, seed=4)
    sj = getattr(jdgl.sampling, cls)(gj, seed=11, **kw)
    st = getattr(tdgl.sampling, cls)(gt, seed=11, **kw)
    for seeds in (np.arange(0, 300, 7), np.array([5, 5, 17])):
        fj, ft = sj(seeds), st(torch.from_numpy(seeds))
        e = fj.num_edges()
        assert ft.num_edges() == e and ft.num_nodes() == fj.num_nodes()
        np.testing.assert_array_equal(ft.src.numpy()[:e],
                                      np.asarray(fj.src)[:e])
        np.testing.assert_array_equal(ft.dst.numpy()[:e],
                                      np.asarray(fj.dst)[:e])
        np.testing.assert_array_equal(ft.edata["weights"].numpy(),
                                      np.asarray(fj.edata["weights"])[:e])
