"""The port's trainers (``dgl1_tpu_torch/examples``) against the
reference's scripts, and its harness (``dgl1_tpu_torch/tools/
run_examples.py``).

Parity: GCN, GAT, R-GCN (per relation and grouped), HAN and the sampled
GraphSAGE. Each builds the port's data and model with the trainer's own
``build`` on the CPU, the reference's model on the same dataset (both
built in this process from the same seeds), carries the reference's
initial weights across with ``from_jax_params`` and runs three steps of
the port's ``train`` against the reference's loss and optimizer written
out here from the script's lines, with dropout 0. Losses are held to a
relative 1e-4 (atol 1e-6) and the final logits to 1e-4 of their largest
magnitude. Both sides run in float64 (the reference under
``jax.enable_x64``, the port's model and features cast by ``double``):
in float32 Adam's normalisation turns the rounding noise of gradients
near zero into updates of the learning rate's size, which moved the
GAT's third loss by 1.4e-4 relative.

Also: ``torch.optim``'s AdamW and Adam against optax's on a three-step
trajectory. The trainers' smoke runs and the harness are in
``test_torch_examples_smoke.py``.

Datasets are built under a temporary data directory with the cache
writes of both packages stubbed out, so nothing is read from or written
to the user's data directory.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.params import from_jax_params

import torch_parity  # noqa: F401  (loads the reference's native library)

CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL1_TPU_DATA_DIR", str(tmp_path))
    for pkg in (jdgl, tdgl):
        monkeypatch.setattr(pkg.data.base, "save_graphs",
                            lambda *a, **k: None)


def trainer(name):
    return importlib.import_module(f"dgl1_tpu_torch.examples.{name}")


def carry(model, params):
    """The reference's initial weights into the port's model, both then
    in float64."""
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                          strict=True)
    model.double()
    return f64(params)


def f64(tree):
    """A float tree (or array) as float64 arrays; call under x64."""
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def no_dropout(model):
    """Attention and feature dropout of every GATConv set to 0."""
    for m in model.modules():
        if isinstance(m, tdgl.nn.GATConv):
            m.feat_drop = m.attn_drop = 0.0


def same_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def reference_steps(loss_fn, params, opt, steps=3):
    """``steps`` jitted value-and-grad steps of ``opt`` on ``loss_fn``,
    which returns (loss, logits); the losses and the logits of the
    parameters after the last update (one more call of the same compiled
    step). Call under x64."""
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss, logits

    losses = []
    for _ in range(steps + 1):
        params, state, loss, logits = step(params, state)
        losses.append(float(loss))
    return losses[:steps], logits


def jitted(fn):
    """``fn()`` compiled once: the reference's eager modules compile op
    by op, which took longer than the whole jitted call."""
    return jax.jit(fn)()


def masked_ce_j(logits, labels, mask):
    """The citation scripts' loss (``examples/train_gcn.py:62-69``)."""
    logp = jax.nn.log_softmax(logits)
    m = mask.astype(jnp.float32)
    ce = -jnp.take_along_axis(logp, labels[:, None].astype(jnp.int32),
                              axis=1)[:, 0]
    return jnp.sum(ce * m) / jnp.sum(m)


def reference_citation(name):
    ds = {"cora": jdgl.data.CoraGraphDataset,
          "pubmed": jdgl.data.PubmedGraphDataset}[name]()
    return jdgl.add_self_loop(jdgl.remove_self_loop(ds[0]))


@pytest.mark.parametrize("script", ["train_gcn", "train_gat"])
def test_citation_trainer_matches_reference(script):
    """GCN (``examples/train_gcn.py:57-76``) and GAT
    (``examples/train_gat.py:55-71``) on cora: adamw with weight decay
    5e-4, three steps."""
    mod = trainer(script)
    args = mod.parse_args(["--epochs", "3", "--dataset", "cora", "--cpu"]
                          + (["--dropout", "0"] if script == "train_gcn"
                             else []))
    data, model = mod.build(args, CPU)
    gj = reference_citation("cora")
    feat = gj.ndata["feat"]
    np.testing.assert_array_equal(data["feat"].numpy(), np.asarray(feat))
    if script == "train_gcn":
        jmodel = jdgl.models.GCN(hidden_feats=args.hidden,
                                 out_feats=data["num_classes"], dropout=0.0)
    else:
        jmodel = jdgl.models.GAT(hidden_feats=args.hidden,
                                 out_feats=data["num_classes"],
                                 heads=args.heads)
        no_dropout(model)
    params = jitted(lambda: jmodel.init(jax.random.PRNGKey(0), gj, feat))
    data["feat"] = data["feat"].double()
    with jax.enable_x64():
        params, feat = carry(model, params), f64(feat)

        def loss_fn(p):
            logits = jmodel.apply(p, gj, feat)
            return masked_ce_j(logits, gj.ndata["label"],
                               gj.ndata["train_mask"]), logits

        want, logits = reference_steps(
            loss_fn, params, optax.adamw(args.lr, weight_decay=5e-4))
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    model.eval()
    same_logits(model(data["g"], data["feat"]), logits)


@pytest.mark.parametrize("path", ["per_relation", "grouped"])
def test_rgcn_trainer_matches_reference(path):
    """R-GCN on the AIFB stand-in (``examples/train_rgcn.py:53-96``): the
    relation-sorted graph, per-relation subgraphs or the grouped GEMM,
    adam, three steps."""
    mod = trainer("train_rgcn")
    argv = ["--epochs", "3", "--cpu"]
    grouped = path == "grouped"
    data, model = mod.build(mod.parse_args(
        argv + (["--grouped-gemm"] if grouped else [])), CPU)
    ds = jdgl.data.AIFBDataset()
    g = ds[0]
    etypes = np.asarray(g.edata["etype"])
    order = np.argsort(etypes, kind="stable")
    e = g.num_edges()
    g2 = jdgl.graph((np.asarray(g.src)[:e][order],
                     np.asarray(g.dst)[:e][order]), num_nodes=g.num_nodes())
    etypes = etypes[order]
    counts = jnp.asarray(np.bincount(etypes, minlength=ds.num_rels)
                         .astype(np.int32))
    etypes_j = jnp.asarray(etypes.astype(np.int32))
    np.testing.assert_array_equal(data["etypes"].numpy(), etypes)
    rel_graphs = (None if grouped
                  else jdgl.typed_subgraphs(g2, etypes, ds.num_rels))
    labels = g.ndata["label"].astype(jnp.int32)
    jmodel = jdgl.models.RGCN(num_nodes=g.num_nodes(), hidden_feats=16,
                              out_feats=int(np.asarray(labels).max()) + 1,
                              num_rels=ds.num_rels, num_bases=0)
    kw = dict(presorted=grouped, etype_counts=counts, rel_graphs=rel_graphs)
    params = jitted(lambda: jmodel.init(jax.random.PRNGKey(0), g2, etypes_j,
                                        **kw))
    with jax.enable_x64():
        params = carry(model, params)

        def loss_fn(p):
            logits = jmodel.apply(p, g2, etypes_j, **kw)
            return masked_ce_j(logits, labels, g.ndata["train_mask"]), logits

        want, logits = reference_steps(loss_fn, params, optax.adam(1e-2))
    args = mod.parse_args(argv + (["--grouped-gemm"] if grouped else []))
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    with torch.no_grad():
        out = mod.logits(args, data, model)
    same_logits(out, logits)


def test_han_trainer_matches_reference():
    """HAN on the script's ACM-style metapath graphs
    (``examples/train_han.py:85-101``): adam 5e-3, the masked softmax
    cross entropy, three steps. Both metapath graphs have hub layouts, so
    the reference's GATConv takes its fused attention (interpret mode on
    the CPU) and the port's its plain version."""
    mod = trainer("train_han")
    args = mod.parse_args(["--epochs", "3", "--cpu"])
    data, model = mod.build(args, CPU)
    no_dropout(model)
    a = mod.acm_arrays()
    graphs = mod.metapath_graphs(jdgl, a)
    assert all(jdgl.ops.attention.can_fuse_attention(g) for g in graphs)
    feat, labels = jnp.asarray(a["feat"]), jnp.asarray(a["labels"])
    train_mask = jnp.asarray(a["train_mask"])
    jmodel = jdgl.models.HAN(num_metapaths=2, hidden_feats=args.hidden,
                             out_feats=mod.N_CLASSES, num_heads=args.heads,
                             dropout=0.4)
    params = jitted(lambda: jmodel.init(jax.random.PRNGKey(0), graphs, feat))
    data["feat"] = data["feat"].double()
    with jax.enable_x64():
        params, feat = carry(model, params), f64(feat)

        def loss_fn(p):
            logits = jmodel.apply(p, graphs, feat)
            ll = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 labels)
            return (jnp.where(train_mask, ll, 0.0).sum() / train_mask.sum(),
                    logits)

        want, logits = reference_steps(loss_fn, params, optax.adam(args.lr))
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    model.eval()
    same_logits(model(data["graphs"], data["feat"]), logits)


def test_sage_minibatch_trainer_matches_reference():
    """Sampled GraphSAGE on the small Reddit stand-in
    (``examples/train_sage_minibatch.py:67-104``): the same loader seed,
    the init batch drawn from the loader's stream, adam, one epoch of
    three batches of 4,096 seeds (fanouts 5,5, hidden 32); the final
    weights on a sampled batch of test seeds."""
    from dgl1_tpu.dataloading import NeighborSampler, NodeDataLoader

    mod = trainer("train_sage_minibatch")
    argv = ["--epochs", "1", "--batch-size", "4096", "--fanouts", "5,5",
            "--hidden", "32", "--cpu"]
    args = mod.parse_args(argv)
    data, model = mod.build(args, CPU)
    gj = jdgl.data.RedditDataset()[0]
    feat = np.asarray(gj.ndata["feat"])
    labels = np.asarray(gj.ndata["label"]).astype(np.int32)
    np.testing.assert_array_equal(data["feat"].numpy(), feat)
    train_ids = np.nonzero(np.asarray(gj.ndata["train_mask"]))[0]
    loader = NodeDataLoader(gj, train_ids, NeighborSampler([5, 5]),
                            batch_size=4096, shuffle=True, seed=0)
    assert len(loader) == 3
    inp0, _, blocks0, _ = loader.collator.collate(train_ids[:4096], 4096)
    jmodel = jdgl.models.GraphSAGE(hidden_feats=32,
                                   out_feats=int(labels.max()) + 1,
                                   num_layers=2)
    params = jitted(lambda: jmodel.init(jax.random.PRNGKey(0), blocks0,
                                        jnp.asarray(feat[inp0])))
    data["feat"] = data["feat"].double()
    feat = feat.astype(np.float64)
    opt = optax.adam(args.lr)
    with jax.enable_x64():
        params = carry(model, params)
        state = opt.init(params)

        @jax.jit
        def train_step(params, state, blocks, x, y, mask):
            def loss_fn(p):
                logp = jax.nn.log_softmax(jmodel.apply(p, blocks, x))
                ce = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
                m = mask.astype(ce.dtype)
                return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(params, updates), state, loss

        want = []
        for inp, out, blocks, mask in loader:
            params, state, loss = train_step(
                params, state, blocks, jnp.asarray(feat[inp]),
                jnp.asarray(labels[np.asarray(out)]), jnp.asarray(mask))
            want.append(float(loss))
        # The final weights on the first batch of the test seeds, sampled
        # by both packages from one seed.
        test_ids = np.nonzero(np.asarray(gj.ndata["test_mask"]))[0]
        inp, _, blocks, _ = next(iter(NodeDataLoader(
            gj, test_ids, NeighborSampler([5, 5]), batch_size=4096,
            shuffle=False, seed=5)))
        logits = jitted(lambda: jmodel.apply(params, blocks,
                                             jnp.asarray(feat[inp])))
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    tinp, _, tblocks, _ = next(iter(tdgl.dataloading.NodeDataLoader(
        data["g"], test_ids, data["sampler"], batch_size=4096,
        shuffle=False, seed=5, device=CPU)))
    np.testing.assert_array_equal(tinp.numpy(), inp)
    with torch.no_grad():
        out = model(tblocks, data["feat"].index_select(0, tinp))
    same_logits(out, logits)


INIT_IN, INIT_OUT = 500, 64


def init_pair(kind):
    """The port's module (drawn from a generator seeded 0) and the
    reference's parameters (PRNGKey 0) for ``kind``, in 500 -> 64."""
    gen = torch.Generator().manual_seed(0)
    if kind == "Dense":
        import flax.linen as fnn

        x = jnp.zeros((4, INIT_IN))
        return (tdgl.nn.conv.dense(INIT_IN, INIT_OUT, generator=gen),
                fnn.Dense(INIT_OUT).init(jax.random.PRNGKey(0), x))
    src, dst = np.arange(8), (np.arange(8) + 1) % 8
    gj = jdgl.graph((src, dst), num_nodes=8)
    x = jnp.zeros((8, INIT_IN))
    if kind.startswith("TreeLSTM"):
        # train_treelstm's widths (x_size 64), a vocabulary of 500.
        kw = dict(num_vocab=INIT_IN, x_size=INIT_OUT, h_size=INIT_OUT,
                  num_classes=5, cell_type=kind.split("-")[1])
        tok, mask = jnp.zeros(8, jnp.int32), jnp.ones(8)
        tree = jdgl.graph((np.arange(1, 8), np.arange(7) // 2), num_nodes=8)
        jm, sched = jdgl.models.TreeLSTM(**kw), jdgl.topo_schedule(tree)
        return (tdgl.models.TreeLSTM(device=CPU, generator=gen, **kw),
                jax.jit(lambda: jm.init(jax.random.PRNGKey(0), tree, tok,
                                        mask, schedule=sched))())
    if kind == "GatedGraphConv":
        # train_ggnn's shape: a 1-wide annotation into out, 2 edge types.
        et = jnp.zeros(8, jnp.int32)
        return (tdgl.nn.GatedGraphConv(1, INIT_OUT, n_steps=2, n_etypes=2,
                                       device=CPU, generator=gen),
                jdgl.nn.GatedGraphConv(INIT_OUT, n_steps=2, n_etypes=2)
                .init(jax.random.PRNGKey(0), gj, jnp.zeros((8, 1)), et))
    if kind == "GraphConv":
        pair = (tdgl.nn.GraphConv(INIT_IN, INIT_OUT, device=CPU,
                                  generator=gen),
                jdgl.nn.GraphConv(INIT_OUT))
    elif kind == "GATConv":
        pair = (tdgl.nn.GATConv(INIT_IN, 8, num_heads=8, residual=True,
                                device=CPU, generator=gen),
                jdgl.nn.GATConv(8, num_heads=8, residual=True))
    else:
        agg = kind.split("-")[1]
        pair = (tdgl.nn.SAGEConv(INIT_IN, INIT_OUT, agg, device=CPU,
                                 generator=gen),
                jdgl.nn.SAGEConv(INIT_OUT, agg))
    return pair[0], pair[1].init(jax.random.PRNGKey(0), gj, x)


INIT_KINDS = ["Dense", "GraphConv", "GATConv", "SAGEConv-mean",
              "SAGEConv-pool", "TreeLSTM-childsum", "TreeLSTM-nary",
              "GatedGraphConv"]


@pytest.mark.parametrize("kind", INIT_KINDS)
def test_init_matches_reference_scheme(kind):
    """The port's initial weights follow the reference's schemes (every
    flax ``Dense`` is lecun normal, truncated at two std): each weight of
    at least 400 elements has the standard deviation of the reference's
    draw of the same tensor within 10% (draws from other generators can
    agree only in distribution) and no element past the truncation where
    the reference's draw has none. GATConv's fc drawn as DGL's (xavier
    normal, gain sqrt 2) had 1.9x the reference's scale, which tripled
    the GAT trainer's first loss on pubmed. TreeLSTM's embedding (flax
    ``Embed``, std 1/sqrt(x_size)) was drawn N(0, 1), and GatedGraphConv's
    GRU (flax ``GRUCell``: lecun normal input and orthogonal hidden
    kernels per gate) uniform in 1/sqrt(out)."""
    check_init(*init_pair(kind))


def check_init(model, params, renames=None):
    """``model``'s initial weights against the reference's ``params``
    (see :func:`test_init_matches_reference_scheme`), flax's names mapped
    by ``renames`` (a trainer's ``REFERENCE_NAMES``)."""
    from dgl1_tpu_torch.examples import reference_state_dict

    want = reference_state_dict(jax.tree.map(np.asarray, params), renames)
    got = model.state_dict()
    checked = 0
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        if w.size < 400 or not w.std() > 0:
            continue
        t = got[name].double().numpy()
        assert t.shape == w.shape, name
        np.testing.assert_allclose(t.std(), w.std(), rtol=0.1, err_msg=name)
        bound = 2 * np.sqrt(1.0 / t.shape[-1]) / 0.87962566103423978
        if np.abs(w).max() <= bound * (1 + 1e-6):
            assert np.abs(t).max() <= bound * (1 + 1e-6), name
        checked += 1
    assert checked >= 1


@pytest.mark.parametrize("opt_name", ["adamw", "adam"])
def test_torch_optimizers_match_optax(opt_name):
    """``torch.optim.AdamW(lr, weight_decay=5e-4)`` against
    ``optax.adamw(lr, weight_decay=5e-4)`` (both decay every parameter
    and scale the decay by the learning rate) and ``torch.optim.Adam``
    against ``optax.adam`` (the same eps, outside the square root), over
    a three-step trajectory of a cubic, in float64."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3))
    target = rng.normal(size=(5, 3))
    lr = 1e-2
    opt = (optax.adamw(lr, weight_decay=5e-4) if opt_name == "adamw"
           else optax.adam(lr))
    want = []
    with jax.enable_x64():
        params = jnp.asarray(w0)
        state = opt.init(params)
        for _ in range(3):
            grads = jax.grad(lambda p: jnp.sum((p - target) ** 2 * p))(
                params)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            want.append(np.asarray(params))
    w = torch.tensor(w0, requires_grad=True)
    topt = (torch.optim.AdamW([w], lr=lr, weight_decay=5e-4)
            if opt_name == "adamw" else torch.optim.Adam([w], lr=lr))
    t = torch.tensor(target)
    for i in range(3):
        topt.zero_grad()
        ((w - t) ** 2 * w).sum().backward()
        topt.step()
        np.testing.assert_allclose(w.detach().numpy(), want[i], rtol=1e-12,
                                   atol=0)
