"""The port's typed distributed layer (``dgl1_tpu_torch/parallel/
hetero.py``) against the JAX package's ``parallel/hetero.py`` on the
same heterographs, and against a float64 oracle.

Counterparts of the 12 tests of ``tests/test_hetero_parallel.py``: the
assignments (array for array for every partitioner, balance and
coverage), the host builds (array for array with tiles, hub and typed
identity layouts), the on-disk partitions (written by either package and
loaded by the other), ``partition_graph``'s dispatch, the ``DistGraph``
facades, and the sharded typed layer and attention, values and
gradients: at P = 1 in this process against the reference's layer on a
one-device mesh, and at P = 4 in one world of gloo ranks
(``torch_dist_worker.hetero_cases``) against the reference on a
four-device mesh (each reference call jitted), with dry run leg 9's loss
whose featureless node types learn sharded embeddings.

Tolerance: |got - want| <= 1e-4 |want| + 1e-4 max|want| over the real
rows, against the reference (float32 sums of a few dozen terms in
another order, the hub layouts' included) and against the float64
oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parity  # noqa: F401  (loads the reference's native library)
from torch_dist_worker import run_world

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.parallel import hetero as jhet
from dgl1_tpu_torch.parallel import hetero as thet

P = 4
RTOL = 1e-4


def mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("p",))


def hg_pair(seed=0, np_=200, na=120, ni=30, e=600, hub_heavy=False):
    """The same heterograph in both packages (tests/test_hetero_parallel.
    py's make_hg, or its hub-heavy graph of the hub tests)."""
    rng = np.random.default_rng(seed)
    if hub_heavy:
        data = {
            ("author", "writes", "paper"):
                (rng.integers(0, 60, e), rng.integers(0, 6, e)),
            ("paper", "cites", "paper"):
                (rng.integers(0, 100, e), rng.integers(0, 8, e)),
            ("author", "affiliated", "inst"):
                (rng.integers(0, 60, e // 2), rng.integers(0, 20, e // 2)),
        }
        counts = {"paper": 100, "author": 60, "inst": 20}
    else:
        data = {
            ("author", "writes", "paper"):
                (rng.integers(0, na, e), rng.integers(0, np_, e)),
            ("paper", "cites", "paper"):
                (rng.integers(0, np_, e), rng.integers(0, np_, e)),
            ("author", "affiliated", "inst"):
                (rng.integers(0, na, e // 2), rng.integers(0, ni, e // 2)),
            ("paper", "rev_writes", "author"):
                (rng.integers(0, np_, e), rng.integers(0, na, e)),
        }
        counts = {"paper": np_, "author": na, "inst": ni}
    return (jdgl.heterograph(data, num_nodes_dict=counts),
            tdgl.heterograph(data, num_nodes_dict=counts, device="cpu"))


def empty_pair():
    data = {("a", "r1", "b"): (np.array([0, 1, 2]), np.array([0, 1, 0])),
            ("a", "r2", "c"): (np.zeros(0, np.int64), np.zeros(0, np.int64))}
    counts = {"a": 4, "b": 2, "c": 3}
    return (jdgl.heterograph(data, num_nodes_dict=counts),
            tdgl.heterograph(data, num_nodes_dict=counts, device="cpu"))


# name -> (graph kwargs, partition method, build kwargs, norm, self weights)
BUILDS = {
    "segment": (dict(seed=1, np_=100, na=60, ni=20, e=600), "greedy", {},
                "right", True),
    "tiles": (dict(seed=1, np_=100, na=60, ni=20, e=300), "random",
              dict(tiles=True), "right", True),
    "hub": (dict(seed=9, e=1200, hub_heavy=True), "random",
            dict(hub=16, hub_dense_floor=32), "right", True),
    "hub_identity": (dict(seed=9, e=1200, hub_heavy=True), "random",
                     dict(hub=16, hub_dense_floor=32, hub_identity=True),
                     "right", True),
    # No group clears the dense floor: every hub slot is a pinned chunk,
    # so the layer's forward and backward go through K2's layouts.
    "hub_identity_chunked": (dict(seed=9, e=1200, hub_heavy=True), "random",
                             dict(hub=16, hub_dense_floor=100000,
                                  hub_identity=True), "right", True),
    "none_norm": (dict(seed=8, np_=60, na=40, ni=12, e=200), "metis", {},
                  "none", False),
}


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def assert_tree_equal(want, got, path=""):
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
    np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)


def close(what, got, want, mask=None, rtol=RTOL):
    got, want = _host(got).astype(np.float64), _host(want).astype(
        np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if mask is not None:
        sel = mask.reshape(mask.shape + (1,) * (want.ndim - mask.ndim))
        got, want = np.where(sel, got, 0.0), np.where(sel, want, 0.0)
    tol = rtol * np.abs(want) + rtol * max(float(np.abs(want).max()), 1e-30)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements off, max err "
                           f"{float(np.abs(got - want).max())}")


def builds(name, k):
    gkw, method, bkw, _, _ = BUILDS[name]
    hj, ht = hg_pair(**gkw)
    part = jhet.hetero_partition_assignment(hj, k, part_method=method)
    return (hj, ht, jhet.build_partitioned_hetero(hj, part, k, **bkw),
            thet.build_partitioned_hetero(ht, part, k, **bkw))


def layer_inputs(ht, seed=2, f_in=12, f_out=6, selfw=True):
    rng = np.random.default_rng(seed)
    feats = {nt: rng.normal(size=(ht.num_nodes(nt), f_in)).astype(
        np.float32) for nt in ht.ntypes}
    w = {c: (rng.normal(size=(f_in, f_out)) * 0.1).astype(np.float32)
         for c in ht.canonical_etypes}
    s = ({nt: (rng.normal(size=(f_in, f_out)) * 0.1).astype(np.float32)
          for nt in ht.ntypes} if selfw else None)
    return feats, w, s


def _masked_sin_j(phg, out):
    def mask(nt, v):
        m = jnp.asarray(phg.node_mask[nt])
        return m.reshape(m.shape + (1,) * (v.ndim - m.ndim))

    return sum(jnp.sum(jnp.sin(v) * mask(nt, v)) for nt, v in out.items())


def reference_layer(pj, k, feats, w, s, norm):
    """The reference's layer outputs (P, n_loc, F) and the gradients of
    the masked sum of sin over them (jitted)."""
    layer = jhet.make_sharded_rgcn_layer(pj, mesh(k), norm=norm)
    x = {nt: pj.shard_node_data(nt, jnp.asarray(v))
         for nt, v in feats.items()}

    def loss(x_, w_, s_):
        out = layer(x_, w_, s_)
        return _masked_sin_j(pj, out), out

    wj = {c: jnp.asarray(v) for c, v in w.items()}
    sj = None if s is None else {nt: jnp.asarray(v) for nt, v in s.items()}
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, wj, sj)
    return {"out": out, "gx": grads[0], "gw": grads[1],
            "gs": grads[2] if s is not None else {}}


def _coo(ht, c):
    rel = ht[c]
    e = rel.num_edges()
    return rel.src[:e].long(), rel.dst[:e].long()


def rgcn_oracle64(ht, x, w, s, norm):
    """sum_r A_r (x[src_r] W_r), 'right' normalized, + self, float64."""
    out, deg = {}, {}
    for c in ht.canonical_etypes:
        st, _, dt = c
        src, dst = _coo(ht, c)
        y = torch.zeros(ht.num_nodes(dt), w[c].shape[1],
                        dtype=torch.float64).index_add(
            0, dst, (x[st] @ w[c])[src])
        out[dt] = out[dt] + y if dt in out else y
        deg[dt] = deg.get(dt, 0) + torch.bincount(
            dst, minlength=ht.num_nodes(dt)).double()
    for nt in out:
        if norm == "right":
            out[nt] = out[nt] / deg[nt].clamp_min(1.0)[:, None]
        if s is not None:
            out[nt] = out[nt] + x[nt] @ s[nt]
    return out


def oracle_layer(ht, feats, w, s, norm):
    x = {nt: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for nt, v in feats.items()}
    w64 = {c: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for c, v in w.items()}
    s64 = (None if s is None else
           {nt: torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for nt, v in s.items()})
    out = rgcn_oracle64(ht, x, w64, s64, norm)
    sum(torch.sin(v).sum() for v in out.values()).backward()
    grad = (lambda d: {} if d is None else
            {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in d.items()})
    return {"out": {k: v.detach() for k, v in out.items()}, "gx": grad(x),
            "gw": grad(w64), "gs": grad(s64)}


def attn_oracle64(ht, el, er, ft, slope=0.2):
    m, zs = {}, {}
    for c in ht.canonical_etypes:
        st, _, dt = c
        s, t = _coo(ht, c)
        z = torch.nn.functional.leaky_relu(el[c][s] + er[dt][t], slope)
        zs[c] = (s, t, z)
        mr = torch.full((ht.num_nodes(dt), z.shape[1]), -1e30,
                        dtype=z.dtype).scatter_reduce(
            0, t[:, None].expand_as(z), z.detach(), "amax")
        m[dt] = torch.maximum(m[dt], mr) if dt in m else mr
    num, den = {}, {}
    for c in ht.canonical_etypes:
        st, _, dt = c
        s, t, z = zs[c]
        p = torch.exp(z - m[dt][t])
        n_ = torch.zeros((ht.num_nodes(dt),) + tuple(ft[c].shape[1:]),
                         dtype=z.dtype).index_add(0, t, p[:, :, None]
                                                  * ft[c][s])
        d_ = torch.zeros((ht.num_nodes(dt), z.shape[1]),
                         dtype=z.dtype).index_add(0, t, p)
        num[dt] = num[dt] + n_ if dt in num else n_
        den[dt] = den[dt] + d_ if dt in den else d_
    return {nt: num[nt] / den[nt].clamp_min(1e-30)[:, :, None]
            for nt in num}


def attn_inputs(ht, seed=13, h=2, d=6):
    rng = np.random.default_rng(seed)
    etypes = ht.canonical_etypes
    el = {c: rng.normal(size=(ht.num_nodes(c[0]), h)).astype(np.float32)
          for c in etypes}
    er = {nt: rng.normal(size=(ht.num_nodes(nt), h)).astype(np.float32)
          for nt in ht.ntypes}
    ft = {c: rng.normal(size=(ht.num_nodes(c[0]), h, d)).astype(np.float32)
          for c in etypes}
    return el, er, ft


def oracle_attn(ht, el, er, ft):
    t64 = (lambda d: {k: torch.tensor(v, dtype=torch.float64,
                                      requires_grad=True)
                      for k, v in d.items()})
    a, b, c = t64(el), t64(er), t64(ft)
    out = attn_oracle64(ht, a, b, c)
    sum(torch.sin(v).sum() for v in out.values()).backward()
    return {"out": {k: v.detach() for k, v in out.items()},
            "gel": {k: v.grad for k, v in a.items()},
            "ger": {k: v.grad for k, v in b.items()},
            "gft": {k: v.grad for k, v in c.items()}}


def reference_attn(pj, k, el, er, ft):
    layer = jhet.make_sharded_hetero_attention(pj, mesh(k))
    sh = (lambda d, key: {n: pj.shard_node_data(key(n), jnp.asarray(v))
                          for n, v in d.items()})

    def loss(a, b, c):
        out = layer(a, b, c)
        return _masked_sin_j(pj, out), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(
        sh(el, lambda n: n[0]), sh(er, lambda n: n), sh(ft, lambda n: n[0]))
    return {"out": out, "gel": g[0], "ger": g[1], "gft": g[2]}


def unshard(pt, key_of, stacked):
    return {k: pt.unshard_node_data(key_of(k), torch.as_tensor(v))
            for k, v in stacked.items()}


def check_against(name, pt, got, ref, oracle, keys):
    """``got`` {field: {key: (P, n_loc, ...)}} against the reference's
    (same layout) and the oracle's global rows."""
    for field, key_of in keys.items():
        assert set(got[field]) == set(ref[field]), (name, field)
        for k, v in got[field].items():
            if key_of is None:  # a replicated weight's gradient
                close(f"{name} {field} {k} vs reference", v, ref[field][k])
                close(f"{name} {field} {k} vs oracle", v, oracle[field][k])
                continue
            nt = key_of(k)
            close(f"{name} {field} {k} vs reference", v, ref[field][k],
                  pt.node_mask[nt])
            close(f"{name} {field} {k} vs oracle",
                  pt.unshard_node_data(nt, torch.as_tensor(v)),
                  oracle[field][k])


LAYER_KEYS = {"out": lambda k: k, "gx": lambda k: k, "gw": None, "gs": None}
ATTN_KEYS = {"out": lambda k: k, "gel": lambda k: k[0],
             "ger": lambda k: k, "gft": lambda k: k[0]}


def port_layer_p1(pt, feats, w, s, norm):
    pl = pt.local(0, "cpu")
    x = {nt: pt.shard_node_data(nt, torch.tensor(v), 0).requires_grad_(True)
         for nt, v in feats.items()}
    wt = {c: torch.tensor(v, requires_grad=True) for c, v in w.items()}
    st = (None if s is None else
          {nt: torch.tensor(v, requires_grad=True) for nt, v in s.items()})
    out = thet.make_sharded_rgcn_layer(pl, norm=norm)(x, wt, st)
    sum((torch.sin(v) * torch.as_tensor(pt.node_mask[nt][0])[:, None]).sum()
        for nt, v in out.items()).backward()
    g = (lambda d: {} if d is None else
         {k: v.grad.numpy() if v.grad is not None else np.zeros(v.shape)
          for k, v in d.items()})
    return {"out": {nt: v.detach().numpy()[None] for nt, v in out.items()},
            "gx": {nt: v[None] for nt, v in g(x).items()}, "gw": g(wt),
            "gs": g(st)}


# ----------------------------------------------------------------------
# Assignments, builds, files, facades
# ----------------------------------------------------------------------

@pytest.mark.parametrize("method", ["metis", "greedy", "multilevel",
                                    "random"])
def test_hetero_assignment_matches_reference(method):
    hj, ht = hg_pair()
    want = jhet.hetero_partition_assignment(hj, P, part_method=method)
    got = thet.hetero_partition_assignment(ht, P, part_method=method)
    assert_tree_equal(want, got)
    assert thet.hetero_edge_cut_fraction(ht, got) == \
        jhet.hetero_edge_cut_fraction(hj, want)
    for a, b in zip(thet.homogenize_structure(ht)[:2],
                    jhet.homogenize_structure(hj)[:2]):
        np.testing.assert_array_equal(a, b)


def test_hetero_assignment_balance_and_coverage():
    _, ht = hg_pair()
    part = thet.hetero_partition_assignment(ht, P, part_method="greedy")
    assert set(part) == set(ht.ntypes)
    for nt in ht.ntypes:
        assert len(part[nt]) == ht.num_nodes(nt)
    sizes = np.bincount(np.concatenate([part[nt] for nt in ht.ntypes]),
                        minlength=P)
    assert sizes.min() > 0
    rand = {nt: np.random.default_rng(1).integers(
        0, P, ht.num_nodes(nt)).astype(np.int32) for nt in ht.ntypes}
    assert thet.hetero_edge_cut_fraction(ht, part) <= \
        thet.hetero_edge_cut_fraction(ht, rand) + 0.1


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_partitioned_hetero_matches_reference(name):
    _, _, pj, pt = builds(name, P)
    for f in ("n_loc", "m_halo", "e_loc", "num_nodes", "num_parts",
              "ntypes", "etypes", "hub_rows"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("send_idx", "node_mask", "orig_ids", "in_deg", "esrc",
              "edst", "tiles_fwd", "tiles_rev", "hub"):
        assert_tree_equal(getattr(pj, f), getattr(pt, f), f)
    if pj.hub_meta is not None:
        for c in pj.etypes:
            assert pj.hub_meta[c] == pt.hub_meta[c], c
    if name.startswith("hub_identity"):
        assert all(pt.hub_meta[c].identity_expand for c in pt.etypes)
    if name == "hub_identity_chunked":
        assert all(pt.hub_meta[c].n_groups > pt.hub_meta[c].n_dense == 0
                   for c in pt.etypes)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hetero_partition_roundtrip(tmp_path, writer):
    """Partitions written by either package load in the other: every
    owned edge maps back to its original endpoints, owned nodes follow
    the assignment and features are the owners' rows."""
    hj, ht = hg_pair(seed=5, np_=60, na=40, ni=12, e=200)
    rng = np.random.default_rng(6)
    feats = {"paper": rng.normal(size=(60, 5)).astype(np.float32),
             "author": rng.normal(size=(40, 3)).astype(np.float32)}
    for nt, v in feats.items():
        hj.nframes[nt]["feat"] = jnp.asarray(v)
        ht.nframes[nt]["feat"] = torch.tensor(v)
    if writer == "port":
        part = thet.partition_hetero_graph(ht, "toy", P, str(tmp_path),
                                           part_method="greedy")
    else:
        part = jhet.partition_hetero_graph(hj, "toy", P, str(tmp_path),
                                           part_method="greedy")
    seen = {c: [] for c in ht.canonical_etypes}
    for p in range(P):
        lg, lf, book = thet.load_hetero_partition(str(tmp_path), "toy", p,
                                                  device="cpu")
        jg, jf, jbook = jhet.load_hetero_partition(str(tmp_path), "toy", p)
        assert book["hetero"]
        assert ({k: v for k, v in book.items() if k != "part_assignment"}
                == {k: v for k, v in jbook.items()
                    if k != "part_assignment"})
        assert_tree_equal(jbook["part_assignment"], book["part_assignment"])
        for c in ht.canonical_etypes:
            st, _, dt = c
            rel = lg[c]
            e = rel.num_edges()
            src_l, dst_l = rel.src[:e].numpy(), rel.dst[:e].numpy()
            np.testing.assert_array_equal(src_l,
                                          np.asarray(jg[c].src)[:e])
            nid_s = lg.nframes[st]["orig_id"].numpy()
            nid_d = lg.nframes[dt]["orig_id"].numpy()
            eid = rel.edata["orig_id"].numpy()
            fs, fd = (x.numpy() for x in ht[c].edges())
            np.testing.assert_array_equal(fs[eid], nid_s[src_l])
            np.testing.assert_array_equal(fd[eid], nid_d[dst_l])
            assert lg.nframes[dt]["inner_node"].numpy()[dst_l].all()
            seen[c].append(eid)
        for nt in ht.ntypes:
            inner = lg.nframes[nt]["inner_node"].numpy()
            nid = lg.nframes[nt]["orig_id"].numpy()
            np.testing.assert_array_equal(np.sort(nid[inner]),
                                          np.nonzero(part[nt] == p)[0])
            if nt in feats:
                np.testing.assert_allclose(lf[nt]["feat"],
                                           feats[nt][nid[inner]])
                np.testing.assert_array_equal(lf[nt]["feat"],
                                              jf[nt]["feat"])
    for c in ht.canonical_etypes:
        np.testing.assert_array_equal(np.sort(np.concatenate(seen[c])),
                                      np.arange(ht[c].num_edges()))


def test_partition_graph_dispatches_hetero(tmp_path):
    _, ht = hg_pair(seed=7, np_=40, na=30, ni=10, e=120)
    part = tdgl.parallel.partition_graph(ht, "dispatch", 2, str(tmp_path))
    assert set(part) == set(ht.ntypes)
    _, _, book = thet.load_hetero_partition(str(tmp_path), "dispatch", 0,
                                            device="cpu")
    assert book["hetero"] is True and book["part_method"] == "metis"


def test_dist_graph_hetero_facade():
    """DistGraph over a heterograph: per-ntype books and DistTensors, and
    one typed layer through the facade's plan (P = 1) against the
    oracle."""
    _, ht = hg_pair(seed=8, np_=60, na=40, ni=12, e=200)
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(60, 4)).astype(np.float32)
    ht.nframes["paper"]["feat"] = torch.tensor(feat)
    dg = tdgl.parallel.DistGraph(ht, 4)
    assert dg.hetero and dg.num_nodes("paper") == 60
    assert dg.num_edges() == ht.num_edges()
    ids = np.array([3, 17, 42])
    np.testing.assert_allclose(dg.ndata["paper"]["feat"][ids], feat[ids])
    assert dg.partitioned().num_parts == 4
    assert set(dg.get_partition_book()) == set(ht.ntypes)
    d1 = tdgl.parallel.DistGraph(ht, 1)
    feats, w, _ = layer_inputs(ht, f_in=4, f_out=4, selfw=False)
    got = port_layer_p1(d1.partitioned(), feats, w, None, "none")
    want = oracle_layer(ht, feats, w, None, "none")
    for nt, v in got["out"].items():
        close(f"facade {nt}", d1.partitioned().unshard_node_data(
            nt, torch.as_tensor(v)), want["out"][nt])


def test_dist_graph_from_hetero_partition(tmp_path):
    _, ht = hg_pair(seed=10, np_=50, na=30, ni=10, e=150)
    feat = np.random.default_rng(11).normal(size=(50, 3)).astype(np.float32)
    ht.nframes["paper"]["feat"] = torch.tensor(feat)
    thet.partition_hetero_graph(ht, "hostview", 3, str(tmp_path),
                                part_method="greedy")
    dg = tdgl.parallel.DistGraph.from_hetero_partition(
        str(tmp_path), "hostview", 1, device="cpu")
    assert dg.hetero and dg.part_id == 1
    assert dg.num_nodes("paper") == 50 and dg.num_nodes() == 90
    assert dg.num_edges("cites") == ht.num_edges("cites")
    own = dg.books["paper"].partid2nids(1)
    np.testing.assert_allclose(dg.ndata["paper"]["feat"][own], feat[own])
    with pytest.raises(ValueError):
        dg.partitioned()


def test_world_size_mismatch_raises():
    _, ht = hg_pair(seed=20, np_=30, na=20, ni=8, e=60)
    part = thet.hetero_partition_assignment(ht, 4, part_method="random")
    pl = thet.build_partitioned_hetero(ht, part, 4).local(0, "cpu")
    with pytest.raises(ValueError, match="world size"):
        thet.make_sharded_rgcn_layer(pl)
    with pytest.raises(ValueError, match="world size"):
        thet.make_sharded_hetero_attention(pl)


# ----------------------------------------------------------------------
# P = 1 in this process
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BUILDS))
def test_sharded_rgcn_layer_p1_matches_reference(name):
    hj, ht, pj, pt = builds(name, 1)
    _, _, _, norm, selfw = BUILDS[name]
    feats, w, s = layer_inputs(ht, selfw=selfw)
    got = port_layer_p1(pt, feats, w, s, norm)
    ref = reference_layer(pj, 1, feats, w, s, norm)
    oracle = oracle_layer(ht, feats, w, s, norm)
    check_against(name, pt, got, ref, oracle, LAYER_KEYS)


def test_sharded_typed_attention_p1_matches_reference():
    hj, ht = hg_pair(seed=12, np_=80, na=50, ni=16, e=350)
    part = jhet.hetero_partition_assignment(hj, 1, part_method="greedy")
    pj = jhet.build_partitioned_hetero(hj, part, 1)
    pt = thet.build_partitioned_hetero(ht, part, 1)
    el, er, ft = attn_inputs(ht)
    pl = pt.local(0, "cpu")
    t = (lambda d, key: {k: pt.shard_node_data(key(k), torch.tensor(v), 0)
                         .requires_grad_(True) for k, v in d.items()})
    a, b, c = t(el, lambda k: k[0]), t(er, lambda k: k), t(ft, lambda k: k[0])
    out = thet.make_sharded_hetero_attention(pl)(a, b, c)
    sum((torch.sin(v) * torch.as_tensor(pt.node_mask[nt][0])[:, None, None])
        .sum() for nt, v in out.items()).backward()
    got = {"out": {nt: v.detach().numpy()[None] for nt, v in out.items()},
           "gel": {k: v.grad.numpy()[None] for k, v in a.items()},
           "ger": {k: v.grad.numpy()[None] for k, v in b.items()},
           "gft": {k: v.grad.numpy()[None] for k, v in c.items()}}
    check_against("attention p1", pt, got, reference_attn(pj, 1, el, er, ft),
                  oracle_attn(ht, el, er, ft), ATTN_KEYS)


def test_hetero_empty_relation_and_isolated_dsttype():
    """A relation without edges and a destination type fed only by it
    build and run: the isolated type's rows are zero."""
    hj, ht = empty_pair()
    for k in (1, 2):
        part = jhet.hetero_partition_assignment(hj, k, part_method="random")
        pt = thet.build_partitioned_hetero(ht, part, k)
        if k == 2:
            assert_tree_equal(jhet.build_partitioned_hetero(hj, part, k).edst,
                              pt.edst)
            continue
        feats = {nt: np.ones((ht.num_nodes(nt), 4), np.float32)
                 for nt in ht.ntypes}
        w = {c: np.ones((4, 4), np.float32) for c in ht.canonical_etypes}
        got = port_layer_p1(pt, feats, w, None, "none")
        want = oracle_layer(ht, feats, w, None, "none")
        assert set(got["out"]) == {"b", "c"}
        close("b", pt.unshard_node_data("b", torch.as_tensor(
            got["out"]["b"])), want["out"]["b"])
        assert not got["out"]["c"].any()


# ----------------------------------------------------------------------
# P = 4 over gloo
# ----------------------------------------------------------------------

WORLD_LAYERS = ["segment", "tiles", "hub", "hub_identity", "none_norm"]


def _train_case(hj, ht, pj, pt):
    """Dry run leg 9's loss at test size: paper features through w_in,
    sharded embeddings for author and inst, two typed layers."""
    rng = np.random.default_rng(21)
    f_in, hid, classes = 6, 8, 5
    dense = (lambda i, o: (rng.normal(size=(i, o)) * 0.3).astype(np.float32))
    params = {"w_in": dense(f_in, hid),
              "w1": {c: dense(hid, hid) for c in ht.canonical_etypes},
              "s1": {nt: dense(hid, hid) for nt in ht.ntypes},
              "w2": {c: dense(hid, classes) for c in ht.canonical_etypes},
              "s2": {"paper": dense(hid, classes)},
              "emb": {nt: dense(ht.num_nodes(nt), hid)
                      for nt in ht.ntypes if nt != "paper"}}
    n = ht.num_nodes("paper")
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int64)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return {"name": "train", "kind": "train", "phg": pt, "params": params,
            "x": x, "y": y, "mask": mask, "mask_total": float(mask.sum())}


def train_oracle64(ht, c):
    t64 = (lambda v: torch.tensor(v, dtype=torch.float64,
                                  requires_grad=True))
    p = {k: ({kk: t64(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else t64(v)) for k, v in c["params"].items()}
    h0 = {"paper": torch.tensor(c["x"], dtype=torch.float64) @ p["w_in"],
          **p["emb"]}
    h1 = {nt: torch.relu(v) for nt, v in
          rgcn_oracle64(ht, h0, p["w1"], p["s1"], "right").items()}
    out = rgcn_oracle64(ht, h1, p["w2"], None, "right")
    logits = out["paper"] + h1["paper"] @ p["s2"]["paper"]
    ce = torch.nn.functional.cross_entropy(
        logits, torch.tensor(c["y"]), reduction="none")
    loss = (ce * torch.tensor(c["mask"], dtype=torch.float64)).sum() \
        / c["mask_total"]
    loss.backward()
    zero = (lambda v: v.grad if v.grad is not None
            else torch.zeros_like(v))
    return {"loss": float(loss.detach()),
            "gemb": {k: zero(v) for k, v in p["emb"].items()},
            "gw_in": p["w_in"].grad,
            "gw1": {k: zero(v) for k, v in p["w1"].items()},
            "gs2": {k: v.grad for k, v in p["s2"].items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every P = 4 case in one world of gloo ranks, with the reference's
    outputs on a four-device mesh and the float64 oracle's."""
    cases, refs, oracles, pts, graphs = [], {}, {}, {}, {}
    for name in WORLD_LAYERS:
        hj, ht, pj, pt = builds(name, P)
        _, _, _, norm, selfw = BUILDS[name]
        feats, w, s = layer_inputs(ht, selfw=selfw)
        cases.append({"name": name, "kind": "layer", "phg": pt,
                      "feats": feats, "w": w, "s": s, "norm": norm})
        refs[name] = reference_layer(pj, P, feats, w, s, norm)
        oracles[name] = oracle_layer(ht, feats, w, s, norm)
        pts[name] = pt
    hj, ht = hg_pair(seed=12, np_=80, na=50, ni=16, e=350)
    part = jhet.hetero_partition_assignment(hj, P, part_method="greedy")
    pj = jhet.build_partitioned_hetero(hj, part, P)
    pt = thet.build_partitioned_hetero(ht, part, P)
    el, er, ft = attn_inputs(ht)
    cases.append({"name": "attention", "kind": "attn", "phg": pt, "el": el,
                  "er": er, "ft": ft})
    refs["attention"] = reference_attn(pj, P, el, er, ft)
    oracles["attention"] = oracle_attn(ht, el, er, ft)
    pts["attention"] = pt
    hj, ht = hg_pair(seed=3, np_=80, na=50, ni=16, e=400)
    part = jhet.hetero_partition_assignment(hj, P, part_method="greedy")
    pt = thet.build_partitioned_hetero(ht, part, P)
    tc = _train_case(hj, ht, None, pt)
    cases.append(tc)
    oracles["train"] = train_oracle64(ht, tc)
    pts["train"] = pt
    out = run_world("hetero_cases", P, (cases,),
                    tmp_path_factory.mktemp("hetero"), timeout=150)
    return refs, oracles, pts, out


@pytest.mark.parametrize("name", WORLD_LAYERS + ["attention"])
def test_sharded_p4_matches_reference_and_oracle(world, name):
    refs, oracles, pts, out = world
    pt = pts[name]
    keys = ATTN_KEYS if name == "attention" else LAYER_KEYS
    got = {}
    for field, key_of in keys.items():
        got[field] = {}
        for k in out[0][name][field]:
            per_rank = [r[name][field][k] for r in out]
            if key_of is None:  # replicated: every rank holds the sum
                for v in per_rank[1:]:
                    np.testing.assert_array_equal(v, per_rank[0])
                got[field][k] = per_rank[0]
            else:
                got[field][k] = np.stack(per_rank)
    check_against(f"{name} P=4", pt, got, refs[name], oracles[name], keys)


def test_sharded_p4_train_embedding_grads_match_oracle(world):
    """Leg 9's loss at P = 4: the featureless types' embedding gradients
    come back to their owners through the exchanges' backward, each row
    once (a doubled or a missing contribution would show here and not at
    P = 1); the replicated weights' gradients are the ranks' sum."""
    _, oracles, pts, out = world
    pt, want = pts["train"], oracles["train"]
    loss = sum(r["train"]["loss"] for r in out)
    assert abs(loss - want["loss"]) <= RTOL * abs(want["loss"])
    for nt, g in want["gemb"].items():
        got = pt.unshard_node_data(nt, torch.as_tensor(np.stack(
            [r["train"]["gemb"][nt] for r in out])))
        close(f"emb {nt}", got, g)
    # author feeds two relations; inst feeds none and learns nothing.
    assert float(want["gemb"]["author"].abs().max()) > 0
    close("w_in", out[0]["train"]["gw_in"], want["gw_in"])
    for c, g in want["gw1"].items():
        close(f"w1 {c}", out[0]["train"]["gw1"][c], g)
    close("s2", out[0]["train"]["gs2"]["paper"], want["gs2"]["paper"])


def test_typed_train_step_p1_matches_reference():
    """Dry run leg 9's step at P = 1: the reference's loss and gradients
    (jitted) against ``make_typed_rgcn_train_step`` with the reference's
    parameter dict carried across by ``params.from_jax_tree``."""
    from dgl1_tpu_torch.params import from_jax_tree

    hj, ht = hg_pair(seed=3, np_=80, na=50, ni=16, e=400)
    part = jhet.hetero_partition_assignment(hj, 1, part_method="greedy")
    pj = jhet.build_partitioned_hetero(hj, part, 1)
    pt = thet.build_partitioned_hetero(ht, part, 1)
    case = _train_case(hj, ht, pj, pt)
    prm = dict(case["params"])
    prm["emb"] = {nt: pt.shard_node_data(nt, torch.tensor(v)).numpy()
                  for nt, v in prm["emb"].items()}
    layer = jhet.make_sharded_rgcn_layer(pj, mesh(1))
    x = pj.shard_node_data("paper", jnp.asarray(case["x"]))
    y = pj.shard_node_data("paper", jnp.asarray(case["y"]))
    m = pj.shard_node_data("paper", jnp.asarray(case["mask"]))

    def loss_fn(p):
        h0 = {"paper": jnp.einsum("pnf,fh->pnh", x, p["w_in"])}
        h0.update(p["emb"])
        h1 = {nt: jax.nn.relu(v) for nt, v in
              layer(h0, p["w1"], p["s1"]).items()}
        logits = layer(h1, p["w2"], p["s2"])["paper"]
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                  y[..., None], -1)[..., 0]
        return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)

    jp = jax.tree.map(jnp.asarray, prm)
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jp)

    tp = from_jax_tree(prm)
    tp["emb"] = {nt: v[0].clone() for nt, v in tp["emb"].items()}
    leaves = [v.requires_grad_(True) for k, d in tp.items() for v in (
        d.values() if isinstance(d, dict) else [d])]
    step = thet.make_typed_rgcn_train_step(
        pt.local(0, "cpu"), torch.optim.SGD(leaves, lr=0.0), 5)
    loss = step(tp, {"paper": torch.as_tensor(np.asarray(x[0]))},
                torch.as_tensor(np.asarray(y[0])),
                torch.as_tensor(np.asarray(m[0])))
    assert abs(loss - float(want_loss)) <= RTOL * abs(float(want_loss))
    close("w_in", tp["w_in"].grad, want["w_in"])
    for group in ("w1", "s1", "w2", "s2"):
        for k, v in tp[group].items():
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            close(f"{group} {k}", g, want[group][k])
    for nt, v in tp["emb"].items():
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        close(f"emb {nt}", g, want["emb"][nt][0], pt.node_mask[nt][0])
