"""The port's message-passing front end (``function``, ``core``,
``traversal``, the g-SpMM sugar, the segment ops, ``edge_softmax(norm_by=
'src')`` and ``HeteroGraph.multi_update_all``) against the JAX package's
on the same numpy inputs.

Each case of ``tests/test_core.py`` runs on both packages. The UDF
reduces are held against the reference's matching path: a port graph
with an ELL layout takes the ELL mailbox plan, as the reference does
under ``jax.jit``; a port graph without one takes exact-width host
buckets, as the reference does eagerly. Tolerance: rtol 1e-5 and atol
1e-5 in float32 unless a test says otherwise (sums of at most a few
dozen terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (loads the reference's native library)

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import core as jcore
from dgl1_tpu import function as jfn
from dgl1_tpu_torch import core as tcore
from dgl1_tpu_torch import function as tfn

TOL = dict(rtol=1e-5, atol=1e-5)
N, E, F = 12, 40, 4


def close(a, b, **kw):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(kw or TOL))


def make(n=N, e=E, seed=5, formats=None):
    """The same random graph and frames in both packages."""
    gj = jdgl.rand_graph(n, e, seed=seed)
    gt = tdgl.rand_graph(n, e, seed=seed, device="cpu", formats=formats)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.normal(size=(e, F)).astype(np.float32)
    gj.ndata["h"], gj.edata["w"] = jnp.asarray(h), jnp.asarray(w)
    gt.ndata["h"], gt.edata["w"] = torch.tensor(h), torch.tensor(w)
    return gj, gt


BUCKETS = ("csr", "csc")  # no ELL layout: the host-bucket UDF path


def test_function_names_and_fields_match_reference():
    names = [n for n in jfn.__all__]
    assert sorted(names) == sorted(tfn.__all__)
    for n in names:
        j, t = getattr(jfn, n), getattr(tfn, n)
        if callable(j) and not isinstance(j, type) and n not in (
                "BinaryMessage", "CopyMessage", "Reducer"):
            args = ("a", "b", "c")[: j.__code__.co_argcount]
            assert tuple(j(*args)) == tuple(t(*args)), n
            assert j(*args).name == t(*args).name
    assert tfn.copy_src is tfn.copy_u and tfn.copy_edge is tfn.copy_e
    assert tfn.BinaryMessage._fields == jfn.BinaryMessage._fields


def test_update_all_builtin_matches_udf_message():
    gj, gt = make()
    want = gj.update_all(jfn.u_mul_e("h", "w", "m"), jfn.sum("m", "o1"))
    got_b = gt.update_all(tfn.u_mul_e("h", "w", "m"), tfn.sum("m", "o1"))
    got_u = gt.update_all(lambda eb: {"m": eb.src["h"] * eb.data["w"]},
                          tfn.sum("m", "o2"))
    close(got_b, want)
    close(got_u, want)


@pytest.mark.parametrize("plan", ["buckets", "ell"])
def test_update_all_udf_reduce(plan):
    gj, gt = make(formats=BUCKETS if plan == "buckets" else None)
    assert (gt.ell_dst is None) == (plan == "buckets")
    builtin = gt.update_all(tfn.copy_u("h", "m"), tfn.max("m", "o1"))

    def jmax(nodes):
        return {"o2": jnp.max(nodes.mailbox["m"], axis=1)}

    def tmax(nodes):
        return {"o2": nodes.mailbox["m"].max(dim=1).values}

    if plan == "buckets":
        want = gj.update_all(jfn.copy_u("h", "m"), jmax)  # eager buckets
        close(builtin, want)
    else:
        want = jax.jit(lambda g: jcore.message_passing(
            g, jfn.copy_u("h", "m"), jmax, None)["o2"])(gj)
    close(gt.update_all(tfn.copy_u("h", "m"), tmax), want)


def test_u_dot_v_message_with_sum():
    gj, gt = make()
    want = gj.update_all(jfn.u_dot_v("h", "h", "m"), jfn.sum("m", "o"))
    close(gt.update_all(tfn.u_dot_v("h", "h", "m"), tfn.sum("m", "o")),
          want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("msg", ["e_sub_u", "e_div_u", "e_add_u",
                                 "e_mul_u", "u_sub_v", "copy_e"])
def test_message_lowerings_match_reference(msg):
    """e - u and e / u go through g-SDDMM then copy_rhs; the commuting
    e + u and e * u through g-SpMM; v-reading messages through g-SDDMM."""
    gj, gt = make()
    shift = np.abs(np.asarray(gj.ndata["h"])) + 0.5
    gj.ndata["p"], gt.ndata["p"] = jnp.asarray(shift), torch.tensor(shift)
    for red in ("sum", "mean"):
        if msg == "copy_e":
            args = ("w", "m")
        elif msg.startswith("e"):
            args = ("w", "p", "m")
        else:
            args = ("h", "h", "m")
        want = gj.update_all(getattr(jfn, msg)(*args),
                             getattr(jfn, red)("m", "o"))
        got = gt.update_all(getattr(tfn, msg)(*args),
                            getattr(tfn, red)("m", "o"))
        close(got, want, rtol=1e-4, atol=1e-4)


def test_apply_edges_builtin_and_udf():
    gj, gt = make()
    want = gj.apply_edges(jfn.u_add_v("h", "h", "s"))
    got_b = gt.apply_edges(tfn.u_add_v("h", "h", "s"))
    got_u = gt.apply_edges(lambda eb: {"s2": eb.src["h"] + eb.dst["h"]})
    close(got_b, want)
    close(got_u, want)
    assert "s" in gt.edata and "s2" in gt.edata


def test_apply_edges_subset_matches_reference():
    gj, gt = make()
    eids = np.array([1, 4, 9, 30])
    close(gt.apply_edges(tfn.u_mul_v("h", "h", "q"), eids),
          gj.apply_edges(jfn.u_mul_v("h", "h", "q"), eids))
    close(gt.edata["q"], gj.edata["q"])
    close(gt.apply_edges(lambda eb: {"w": eb.data["w"] * 2.0}, eids),
          gj.apply_edges(lambda eb: {"w": eb.data["w"] * 2.0}, eids))
    close(gt.edata["w"], gj.edata["w"])


def test_apply_node_func():
    gj, gt = make()
    for g, fn in ((gj, jfn), (gt, tfn)):
        g.update_all(fn.copy_u("h", "m"), fn.sum("m", "agg"),
                     lambda nodes: {"out": nodes.data["agg"] * 2.0})
    close(gt.ndata["out"], gj.ndata["out"])
    close(gt.ndata["out"], 2.0 * gt.ndata["agg"].numpy())


@pytest.mark.parametrize("raise_inside", [False, True])
def test_local_scope(raise_inside):
    _, gt = make()
    keys = set(gt.ndata)
    try:
        with gt.local_scope():
            gt.ndata["tmp"] = torch.zeros(N, 1)
            gt.update_all(tfn.copy_u("h", "m"), tfn.sum("m", "scratch"))
            gt.edata["w"] = gt.edata["w"] * 0
            assert "scratch" in gt.ndata
            if raise_inside:
                raise RuntimeError("inside the scope")
    except RuntimeError:
        assert raise_inside
    assert set(gt.ndata) == keys
    assert float(gt.edata["w"].abs().sum()) > 0
    lv = gt.local_var()
    lv.ndata["x"] = torch.ones(N)
    assert "x" not in gt.ndata and lv.srcdata is lv.ndata


def test_send_and_recv_subset():
    gj, gt = make()
    eids = np.array([0, 3, 7, 11])
    close(gt.send_and_recv(eids, tfn.copy_u("h", "m"), tfn.sum("m", "o")),
          gj.send_and_recv(eids, jfn.copy_u("h", "m"), jfn.sum("m", "o")))


def test_udf_reduce_compiled_matches_eager():
    """The ELL mailbox plan against the reference's jitted one (values and
    grads), the host buckets against its eager one, and a masked order
    statistic against the builtin max."""
    n, e = 150, 1800
    rng = np.random.default_rng(5)
    h = rng.normal(size=(n, 6)).astype(np.float32)
    gj = jdgl.rand_graph(n, e, seed=3)

    def jred(nodes):
        return {"out": (nodes.mailbox["m"] ** 2).sum(axis=1)}

    def tred(nodes):
        return {"out": (nodes.mailbox["m"] ** 2).sum(dim=1)}

    def jloss(g, x):
        g.ndata["h"] = x
        res = jcore.message_passing(g, jfn.copy_u("h", "m"), jred, None)
        return (res["out"] ** 2).sum(), res["out"]

    (_, want), gwant = jax.jit(jax.value_and_grad(jloss, argnums=1,
                                                  has_aux=True))(
        gj, jnp.asarray(h))
    for formats in (None, BUCKETS):
        gt = tdgl.rand_graph(n, e, seed=3, device="cpu", formats=formats)
        x = torch.tensor(h, requires_grad=True)
        gt.ndata["h"] = x
        out = tcore.message_passing(gt, tfn.copy_u("h", "m"), tred,
                                    None)["out"]
        (out ** 2).sum().backward()
        close(out, want, rtol=1e-5, atol=1e-5)
        close(x.grad, gwant, rtol=1e-5, atol=1e-3)

    def jmax(nodes):
        m = jnp.where(nodes.mailbox_mask[..., None], nodes.mailbox["m"],
                      -jnp.inf)
        out = m.max(axis=1)
        return {"out": jnp.where(jnp.isfinite(out), out, 0.0)}

    def tmax(nodes):
        m = nodes.mailbox["m"].masked_fill(~nodes.mailbox_mask[..., None],
                                           float("-inf"))
        out = m.max(dim=1).values
        return {"out": torch.where(torch.isfinite(out), out,
                                   torch.zeros_like(out))}

    gt = tdgl.rand_graph(n, e, seed=3, device="cpu")
    gt.ndata["h"] = torch.tensor(h)
    got = tcore.message_passing(gt, tfn.copy_u("h", "m"), tmax, None)["out"]
    gj.ndata["h"] = jnp.asarray(h)
    want = jax.jit(lambda g: jcore.message_passing(
        g, jfn.copy_u("h", "m"), jmax, None)["out"])(gj)
    close(got, want)
    close(got, tdgl.ops.gspmm(gt, "copy_lhs", "max", gt.ndata["h"], None))


def test_udf_reduce_compiled_degrees_and_dstdata():
    n, e = 60, 500
    rng = np.random.default_rng(2)
    h = rng.normal(size=(n, 4)).astype(np.float32)
    b = rng.normal(size=(n, 4)).astype(np.float32)
    gj = jdgl.rand_graph(n, e, seed=9)
    gt = tdgl.rand_graph(n, e, seed=9, device="cpu")

    def jfun(nodes):
        s = nodes.mailbox["m"].sum(axis=1)
        deg = jnp.maximum(nodes.degrees.astype(s.dtype), 1.0)[:, None]
        return {"out": s / deg + nodes.data["b"]}

    def tfun(nodes):
        s = nodes.mailbox["m"].sum(dim=1)
        deg = nodes.degrees.to(s.dtype).clamp_min(1.0)[:, None]
        return {"out": s / deg + nodes.data["b"]}

    gj.ndata["h"], gj.ndata["b"] = jnp.asarray(h), jnp.asarray(b)
    gt.ndata["h"], gt.ndata["b"] = torch.tensor(h), torch.tensor(b)
    want = jax.jit(lambda g: jcore.message_passing(
        g, jfn.copy_u("h", "m"), jfun, None)["out"])(gj)
    got = tcore.message_passing(gt, tfn.copy_u("h", "m"), tfun, None)["out"]
    close(got, want)
    ref = tdgl.ops.gspmm(gt, "copy_lhs", "mean", gt.ndata["h"], None) \
        + gt.ndata["b"]
    close(got, ref.numpy())


def test_apply_nodes_all_and_subset():
    gj = jdgl.rand_graph(8, 20, seed=0)
    gt = tdgl.rand_graph(8, 20, seed=0, device="cpu")
    gj.ndata["h"] = jnp.arange(8, dtype=jnp.float32)[:, None]
    gt.ndata["h"] = torch.arange(8, dtype=torch.float32)[:, None]
    for g in (gj, gt):
        g.apply_nodes(lambda nb: {"h2": nb.data["h"] * 2.0})
    close(gt.ndata["h2"], gj.ndata["h2"])
    for v in ([1, 3, 5], np.arange(8) % 3 == 0):
        gj.apply_nodes(lambda nb: {"h": nb.data["h"] + 100.0}, v)
        gt.apply_nodes(lambda nb: {"h": nb.data["h"] + 100.0}, v)
        close(gt.ndata["h"], gj.ndata["h"])


@pytest.mark.parametrize("udf", [False, True])
def test_pull_and_push_match_reference(udf):
    gj, gt = make(formats=BUCKETS if udf else None)
    red_j = (lambda nb: {"o": nb.mailbox["m"].sum(axis=1) * 3.0}) if udf \
        else jfn.sum("m", "o")
    red_t = (lambda nb: {"o": nb.mailbox["m"].sum(dim=1) * 3.0}) if udf \
        else tfn.sum("m", "o")
    for g in (gj, gt):
        g.ndata["o"] = g.ndata["h"] * 0 + 7.0

    def japply(nb):
        return {"a": nb.data["o"] + 1.0}

    def tapply(nb):
        return {"a": nb.data["o"] + 1.0}

    v = np.array([0, 2, 5, 11])
    jcore.pull(gj, v, jfn.copy_u("h", "m"), red_j, japply)
    tcore.pull(gt, v, tfn.copy_u("h", "m"), red_t, tapply)
    close(gt.ndata["o"], gj.ndata["o"])
    close(gt.ndata["a"], gj.ndata["a"])
    u = np.array([1, 4, 6])
    gj.push(u, jfn.copy_u("h", "m"), red_j, japply)
    gt.push(u, tfn.copy_u("h", "m"), red_t, tapply)
    close(gt.ndata["o"], gj.ndata["o"])
    close(gt.ndata["a"], gj.ndata["a"])


def test_filter_nodes_and_edges_match_reference():
    gj, gt = make()
    np.testing.assert_array_equal(
        gt.filter_nodes(lambda nb: nb.data["h"][:, 0] > 0).numpy(),
        np.asarray(gj.filter_nodes(lambda nb: nb.data["h"][:, 0] > 0)))
    np.testing.assert_array_equal(
        gt.filter_edges(lambda eb: eb.data["w"].sum(-1) > eb.src["h"][:, 1])
        .numpy(),
        np.asarray(gj.filter_edges(
            lambda eb: eb.data["w"].sum(-1) > eb.src["h"][:, 1])))


def _tree(n=15, seed=0):
    """A random tree, edges child -> parent (Tree-LSTM's direction)."""
    rng = np.random.default_rng(seed)
    parent = np.array([rng.integers(0, i) for i in range(1, n)])
    return np.arange(1, n), parent


def test_traversal_generators_match_reference():
    src, dst = _tree(20, seed=3)
    s = np.concatenate([src, dst[:5]])
    d = np.concatenate([dst, src[:5]])
    gj = jdgl.graph((s, d), num_nodes=20)
    gt = tdgl.graph((s, d), num_nodes=20, device="cpu")
    for name in ("bfs_nodes_generator", "bfs_edges_generator",
                 "dfs_edges_generator"):
        want = getattr(jdgl.traversal, name)(gj, [0, 7])
        got = getattr(tdgl.traversal, name)(gt, [0, 7])
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    tj = jdgl.graph(_tree(20, seed=4), num_nodes=20)
    tt = tdgl.graph(_tree(20, seed=4), num_nodes=20, device="cpu")
    for a, b in zip(tdgl.topological_nodes_generator(tt),
                    jdgl.topological_nodes_generator(tj)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["bfs", "dfs", "topo", "topo_compiled"])
def test_propagation_matches_reference(kind):
    src, dst = _tree(15)
    gj = jdgl.graph((src, dst), num_nodes=15)
    gt = tdgl.graph((src, dst), num_nodes=15, device="cpu")
    rng = np.random.default_rng(1)
    h = rng.normal(size=(15, 3)).astype(np.float32)
    gj.ndata["h"], gt.ndata["h"] = jnp.asarray(h), torch.tensor(h)

    def jred(nb):
        return {"h": nb.data["h"] + nb.mailbox["m"].sum(axis=1)}

    def tred(nb):
        return {"h": nb.data["h"] + nb.mailbox["m"].sum(dim=1)}

    def japp(nb):
        return {"h": jnp.tanh(nb.data["h"])}

    def tapp(nb):
        return {"h": torch.tanh(nb.data["h"])}

    if kind == "bfs":
        jcore.prop_nodes_bfs(gj, 3, jfn.copy_u("h", "m"), jred, japp)
        tdgl.prop_nodes_bfs(gt, 3, tfn.copy_u("h", "m"), tred, tapp)
    elif kind == "dfs":
        jcore.prop_edges_dfs(gj, 2, jfn.copy_u("h", "m"), jfn.sum("m", "h"))
        tdgl.prop_edges_dfs(gt, 2, tfn.copy_u("h", "m"), tfn.sum("m", "h"))
    elif kind == "topo":
        jcore.prop_nodes_topo(gj, jfn.copy_u("h", "m"), jred, False, japp)
        tdgl.prop_nodes_topo(gt, tfn.copy_u("h", "m"), tred, False, tapp)
    else:
        sj = jcore.topo_schedule(gj, pad_width=4)
        st = tdgl.topo_schedule(gt, pad_width=4)
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k])

        def jmsg(eb):
            return {"m": eb.src["h"] * 2.0}

        def tmsg(eb):
            return {"m": eb.src["h"] * 2.0}

        jcore.prop_nodes_topo_compiled(gj, sj, jmsg, jred, japp)
        tdgl.prop_nodes_topo_compiled(gt, st, tmsg, tred, tapp)
        # A reverse schedule propagates parent -> children.
        np.testing.assert_array_equal(
            tdgl.topo_schedule(gt, reverse=True)["ids"],
            jcore.topo_schedule(gj, reverse=True)["ids"])
    close(gt.ndata["h"], gj.ndata["h"])


SUGAR = [f"{m}_{r}" for r in ("sum", "max", "min", "mean", "prod")
         for m in ("copy_u", "copy_e", "u_add_e", "u_sub_e", "u_mul_e",
                   "u_div_e")]


@pytest.mark.parametrize("name", SUGAR)
def test_gspmm_sugar_matches_reference(name):
    assert len(SUGAR) == 30 and name in tdgl.ops.__all__
    gj, gt = make(n=30, e=200, seed=7)
    rng = np.random.default_rng(8)
    u = rng.uniform(0.5, 1.5, size=(30, F)).astype(np.float32)
    e = rng.uniform(0.5, 1.5, size=(200, F)).astype(np.float32)
    fj, ft = getattr(jdgl.ops, name), getattr(tdgl.ops, name)
    if name.startswith("copy_u"):
        want, got = fj(gj, jnp.asarray(u)), ft(gt, torch.tensor(u))
    elif name.startswith("copy_e"):
        want, got = fj(gj, jnp.asarray(e)), ft(gt, torch.tensor(e))
    else:
        want = fj(gj, jnp.asarray(u), jnp.asarray(e))
        got = ft(gt, torch.tensor(u), torch.tensor(e))
    close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min", "prod",
                                     "softmax"])
def test_segment_reduce_and_softmax_match_reference(reducer):
    rng = np.random.default_rng(3)
    seglen = np.array([3, 0, 5, 1, 0, 4])
    x = rng.normal(size=(13, 3)).astype(np.float32)
    if reducer == "softmax":
        want = jdgl.ops.segment_softmax(jnp.asarray(seglen), jnp.asarray(x))
        got = tdgl.ops.segment_softmax(torch.tensor(seglen), torch.tensor(x))
    else:
        want = jdgl.ops.segment_reduce(jnp.asarray(seglen), jnp.asarray(x),
                                       reducer)
        got = tdgl.ops.segment_reduce(torch.tensor(seglen), torch.tensor(x),
                                      reducer)
    close(got, want)


def test_edge_softmax_norm_by_src_matches_reference():
    gj, gt = make(n=20, e=90, seed=2)
    logits = np.random.default_rng(4).normal(size=(90, 2)).astype(
        np.float32)
    x = torch.tensor(logits, requires_grad=True)
    got = tdgl.edge_softmax(gt, x, norm_by="src")
    (got[:, 0] * torch.arange(90.0)).sum().backward()
    want, vjp = jax.vjp(lambda a: jdgl.edge_softmax(gj, a, norm_by="src"),
                        jnp.asarray(logits))
    ct = np.zeros((90, 2), np.float32)
    ct[:, 0] = np.arange(90)
    close(got, want)
    close(x.grad, vjp(jnp.asarray(ct))[0], rtol=1e-4, atol=1e-4)


def _hetero_pair():
    rng = np.random.default_rng(6)
    data = {("user", "follows", "user"): (rng.integers(0, 10, 40),
                                          rng.integers(0, 10, 40)),
            ("item", "bought_by", "user"): (rng.integers(0, 7, 30),
                                            rng.integers(0, 10, 30)),
            ("user", "buys", "item"): (rng.integers(0, 10, 25),
                                       rng.integers(0, 7, 25))}
    counts = {"user": 10, "item": 7}
    hj = jdgl.heterograph(data, num_nodes_dict=counts)
    ht = tdgl.heterograph(data, num_nodes_dict=counts, device="cpu")
    for nt, n in counts.items():
        x = rng.normal(size=(n, F)).astype(np.float32)
        hj.nframes[nt]["h"], ht.nframes[nt]["h"] = (jnp.asarray(x),
                                                   torch.tensor(x))
    return hj, ht


@pytest.mark.parametrize("cross", ["sum", "mean", "max", "min", "stack"])
def test_multi_update_all_cross_reducers_match_reference(cross):
    hj, ht = _hetero_pair()
    spec_j = {c: (jfn.copy_u("h", "m"), jfn.mean("m", "o"))
              for c in hj.canonical_etypes}
    spec_t = {c: (tfn.copy_u("h", "m"), tfn.mean("m", "o"))
              for c in ht.canonical_etypes}
    want = hj.multi_update_all(spec_j, cross)
    got = ht.multi_update_all(spec_t, cross)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    close(ht.nframes["user"]["o"], hj.nframes["user"]["o"])


def test_hetero_update_all_and_apply_edges_match_reference():
    hj, ht = _hetero_pair()
    close(ht.update_all(tfn.copy_u("h", "m"), tfn.sum("m", "s"))[
        ("user", "s")],
        hj.update_all(jfn.copy_u("h", "m"), jfn.sum("m", "s"))[
            ("user", "s")])
    close(ht.update_all(tfn.copy_u("h", "m"), tfn.max("m", "x"),
                        etype="buys")[("item", "x")],
          hj.update_all(jfn.copy_u("h", "m"), jfn.max("m", "x"),
                        etype="buys")[("item", "x")])
    close(ht.apply_edges(tfn.u_dot_v("h", "h", "d"), etype="follows"),
          hj.apply_edges(jfn.u_dot_v("h", "h", "d"), etype="follows"),
          rtol=1e-4, atol=1e-4)
    lv = ht.local_var()
    lv.nframes["user"]["tmp"] = torch.ones(10)
    assert "tmp" not in ht.nframes["user"]
    assert ht.number_of_src_nodes("user") == 10
    assert ht.number_of_dst_nodes("item") == 7
