"""The port's graph-level trainers against the reference's scripts: GGNN
and MPNN (``dgl1_tpu_torch/examples``). Each builds the port's data and
model with the trainer's own ``build`` on the CPU, writes the script's
in-script flax model out here from its lines, carries the reference's
initial weights across (``load_reference`` with the trainer's
``REFERENCE_NAMES``) and runs the port's first epoch against the
reference's loss and optimizer on the same data, both in float64 (see
``test_torch_examples.py``). Losses are held to a relative 1e-4 (atol
1e-6), the final outputs to 1e-4 of their largest magnitude. Also the
in-script models' initial weights against the reference's, and the CPU
smoke runs of the graph-level entries of the harness and of the chem
trainer's SchNet.
"""
from __future__ import annotations

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.tools import run_examples as harness
from test_torch_examples import LOSS_TOL, check_init, same_logits
from test_torch_examples_gen import carry, reference_steps
from test_torch_examples_smoke import SMOKE_GRAPH, check_metrics, main_to_gate

import torch_parity  # noqa: F401  (loads the reference's native library)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL1_TPU_DATA_DIR", str(tmp_path))
    for pkg in (jdgl, tdgl):
        monkeypatch.setattr(pkg.data.base, "save_graphs",
                            lambda *a, **k: None)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the trainers issue many small ops, which a
    thread pool on every core (beside the suite's other workers) slowed
    65-fold (the Tree-LSTM's smoke run: 158 s against 2.4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(name):
    return importlib.import_module(f"dgl1_tpu_torch.examples.{name}")


def test_ggnn_trainer_matches_reference():
    """Reachability on 3 graphs of 16 nodes and 28 typed edges, hidden 8
    (``examples/train_ggnn.py:91-128``): adam, one epoch of the 2
    training graphs, then the logits of the held-out graph."""
    mod = trainer("train_ggnn")
    args = mod.parse_args(["--epochs", "1", "--num-graphs", "3",
                           "--hidden", "8", "--cpu"])
    data, model = mod.build(args, CPU)
    srcs, dsts, etypes, roots, labels = mod.gen_task(
        np.random.default_rng(0), args.num_graphs, args.nodes, args.edges,
        args.steps)
    graphs = [jdgl.graph((srcs[i], dsts[i]), num_nodes=args.nodes)
              for i in range(args.num_graphs)]
    x = np.zeros((args.num_graphs, args.nodes, 1))
    x[np.arange(args.num_graphs), roots, 0] = 1.0
    np.testing.assert_array_equal(data["x"].numpy(), x)
    et, y = jnp.asarray(etypes.astype(np.int32)), jnp.asarray(labels)

    jmodel = reference_ggnn(args)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), graphs[0],
                                         jnp.asarray(x[0], jnp.float32),
                                         et[0]))()
    data["x"] = data["x"].double()
    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p, g, feat, ets, lab):
            logits = jmodel.apply(p, g, feat, ets)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, lab).mean()

        want, params = reference_steps(
            loss_fn, params, optax.adam(args.lr),
            [(graphs[i], jnp.asarray(x[i]), et[i], y[i])
             for i in range(data["n_train"])])
        logits = jax.jit(jmodel.apply)(params, graphs[2], jnp.asarray(x[2]),
                                       et[2])
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    with torch.no_grad():
        out = model(data["graphs"][2], data["x"][2], data["et"][2])
    same_logits(out, logits)


def reference_mpnn(args):
    """``examples/train_chem.py:69-93``, written out."""

    def rbf_expand(dist):
        centers = jnp.linspace(0.0, args.cutoff, args.rbf)
        gamma = 1.0 / (centers[1] - centers[0]) ** 2
        return jnp.exp(-gamma * (dist - centers[None, :]) ** 2)

    class MPNN(fnn.Module):
        @fnn.compact
        def __call__(self, g):
            h = fnn.relu(fnn.Dense(args.hidden)(g.ndata["charge"] / 10.0))
            ef = rbf_expand(g.edata["dist"])
            edge_net = fnn.Sequential([
                fnn.Dense(args.hidden), fnn.relu,
                fnn.Dense(args.hidden * args.hidden)])
            conv = jdgl.nn.NNConv(in_feats=args.hidden,
                                  out_feats=args.hidden, edge_func=edge_net,
                                  aggregator_type="mean")
            gru = fnn.GRUCell(features=args.hidden)
            for _ in range(args.steps):
                m = fnn.relu(conv(g, h, ef))
                h, _ = gru(h, m)
            q = jdgl.nn.Set2Set(input_dim=args.hidden, n_iters=4)(g, h)
            q = fnn.relu(fnn.Dense(args.hidden)(q))
            return fnn.Dense(1)(q)[:, 0]

    return MPNN()


def test_mpnn_trainer_matches_reference():
    """MPNN on 20 synthetic QM9 molecules in batches of 8, hidden 8
    (``examples/train_chem.py:111-136``): the init batch drawn first,
    adam on the masked squared error of the z-scored target over the 2
    training batches, then the test batch's predictions."""
    from dgl1_tpu.dataloading import GraphDataLoader

    mod = trainer("train_chem")
    args = mod.parse_args(["--epochs", "1", "--num-molecules", "20",
                           "--batch-size", "8", "--hidden", "8", "--cpu"])
    data, model = mod.build(args, CPU)
    ds = jdgl.data.QM9Dataset(label_keys=("homo",), num_molecules=20, seed=0)
    train_ds, test_ds = jdgl.data.split_dataset(ds, (0.8, 0.2), shuffle=True,
                                                random_state=0)
    y_train = np.asarray([train_ds[i][1][0] for i in range(len(train_ds))])
    assert data["y_mu"] == float(y_train.mean())
    loader = GraphDataLoader(train_ds, batch_size=8, shuffle=True, seed=0)
    bg0 = next(iter(loader))[0]
    batches = list(loader)
    assert len(batches) == 2
    jmodel = reference_mpnn(args)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), bg0)
    mu, sigma = data["y_mu"], data["y_sigma"]
    test_bg = next(iter(GraphDataLoader(test_ds, batch_size=8)))[0]

    def x64(bg):
        """The batch's float fields in float64, the graph as it is."""
        bg.ndata["charge"] = jnp.asarray(np.asarray(bg.ndata["charge"]),
                                         jnp.float64)
        bg.edata["dist"] = jnp.asarray(np.asarray(bg.edata["dist"]),
                                       jnp.float64)
        return bg

    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p, bg, y, mask):
            pred = jmodel.apply(p, bg)[: y.shape[0]]
            yn = (y[:, 0] - mu) / sigma
            m = mask.astype(jnp.float64)
            return jnp.sum(m * (pred - yn) ** 2) / jnp.maximum(m.sum(), 1.0)

        want, params = reference_steps(
            loss_fn, params, optax.adam(args.lr),
            [(x64(bg), jnp.asarray(np.asarray(y), jnp.float64), mask)
             for bg, y, mask in batches])
        pred = jmodel.apply(params, x64(test_bg))

    class Float64:
        """The trainer's loader, each batch's float fields in float64."""

        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            for bg, y, mask in self.loader:
                bg.ndata["charge"] = bg.ndata["charge"].double()
                bg.edata["dist"] = bg.edata["dist"].double()
                yield bg, y.double(), mask

    data["loader"] = Float64(data["loader"])
    data["test_loader"] = Float64(data["test_loader"])
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    tbg = next(iter(data["test_loader"]))[0]
    with torch.no_grad():
        out = model(tbg)
    same_logits(out, pred)


def reference_ggnn(args):
    """``examples/train_ggnn.py:91-101``, written out."""

    class GGNN(fnn.Module):
        @fnn.compact
        def __call__(self, g, feat, et):
            h = jdgl.nn.GatedGraphConv(out_feats=args.hidden,
                                       n_steps=args.steps + 1,
                                       n_etypes=2)(g, feat, et)
            h = jnp.concatenate([h, feat], axis=-1)
            h = fnn.relu(fnn.Dense(args.hidden)(h))
            return fnn.Dense(2)(h)

    return GGNN()


def init_case(kind):
    """(port model, reference params) of an in-script model at the
    script's default widths, on a small input of the script's shapes."""
    mod = trainer({"mpnn": "train_chem", "ggnn": "train_ggnn",
                   "diffpool": "train_diffpool",
                   "pointcloud": "train_pointcloud",
                   "pinsage": "train_pinsage"}[kind])
    args = mod.parse_args(["--cpu"])
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    src, dst = np.arange(8), (np.arange(8) + 1) % 8
    g = jdgl.graph((src, dst), num_nodes=8)
    if kind == "mpnn":
        g.ndata["charge"] = jnp.ones((8, 1))
        g.edata["dist"] = jnp.ones((8, 1))
        model = mod.MPNN(args, device=CPU, generator=gen)
        return model, jax.jit(reference_mpnn(args).init)(key, g)
    if kind == "ggnn":
        model = mod.GGNN(args.hidden, args.steps + 1, device=CPU,
                         generator=gen)
        return model, jax.jit(reference_ggnn(args).init)(
            key, g, jnp.zeros((8, 1)), jnp.zeros(8, jnp.int32))
    if kind == "diffpool":
        bsage = fnn.vmap(jdgl.nn.DenseSAGEConv, in_axes=(0, 0), out_axes=0,
                         variable_axes={"params": None},
                         split_rngs={"params": False})

        class DiffPool(fnn.Module):
            """``examples/train_diffpool.py:64-77``."""

            @fnn.compact
            def __call__(self, adj, x, mask):
                z = jax.nn.relu(bsage(args.hidden, name="embed1")(adj, x))
                s_logit = bsage(args.clusters, name="assign1")(adj, x)
                s = jax.nn.softmax(s_logit, axis=-1) * mask[..., None]
                a2 = jnp.einsum("bnk,bnm,bml->bkl", s, adj, s)
                x2 = jnp.einsum("bnk,bnf->bkf", s, z)
                z2 = jax.nn.relu(bsage(args.hidden, name="embed2")(a2, x2))
                h = jnp.concatenate([z2.mean(axis=1), z2.max(axis=1)], -1)
                h = jax.nn.relu(fnn.Dense(args.hidden)(h))
                return fnn.Dense(8)(h)

        model = mod.DiffPool(args.hidden, args.clusters, 8, device=CPU,
                             generator=gen)
        return model, jax.jit(DiffPool().init)(
            key, jnp.zeros((2, 8, 8)), jnp.zeros((2, 8, 2)),
            jnp.ones((2, 8)))
    if kind == "pointcloud":
        class DGCNN(fnn.Module):
            """``examples/train_pointcloud.py:87-100``."""

            @fnn.compact
            def __call__(self, g, pos):
                h = fnn.relu(jdgl.nn.conv.EdgeConv(args.hidden)(g, pos))
                h = fnn.relu(jdgl.nn.conv.EdgeConv(args.hidden)(g, h))
                hg = jdgl.readout_nodes(g, h, op="max")
                hg = fnn.relu(fnn.Dense(args.hidden)(hg))
                return fnn.Dense(4)(hg)

        model = mod.DGCNN(args.hidden, 4, device=CPU, generator=gen)
        return model, jax.jit(DGCNN().init)(key, g, jnp.zeros((8, 3)))

    class PinSAGEConv(fnn.Module):
        """``examples/train_pinsage.py:84-102``."""

        @fnn.compact
        def __call__(self, frontier, x):
            w = frontier.edata["weights"]
            num = jdgl.ops.gspmm(frontier, "mul", "sum", x, w[:, None])
            den = jdgl.ops.gspmm(frontier, "copy_rhs", "sum", None,
                                 w[:, None])
            h = fnn.Dense(args.hidden)(jnp.concatenate(
                [x, num / jnp.maximum(den, 1e-6)], axis=1))
            h = fnn.Dense(args.hidden)(fnn.relu(h))
            return h / jnp.maximum(jnp.linalg.norm(h, axis=1,
                                                   keepdims=True), 1e-6)

    g.edata["weights"] = jnp.ones(8)
    model = mod.PinSAGEConv(16, args.hidden, device=CPU, generator=gen)
    return model, jax.jit(PinSAGEConv().init)(key, g, jnp.zeros((8, 16)))


@pytest.mark.parametrize("kind", ["mpnn", "ggnn", "diffpool", "pointcloud",
                                  "pinsage"])
def test_inscript_init_matches_reference_scheme(kind):
    """The scripts' in-script models at their widths: every ``Dense``
    lecun normal, the modules' own schemes inside (``NNConv``, flax's
    ``GRUCell`` per gate, ``Set2Set``'s LSTM, ``GatedGraphConv``,
    ``DenseSAGEConv``, ``EdgeConv``); held as
    ``test_torch_examples.py::test_init_matches_reference_scheme`` holds
    the modules."""
    model, params = init_case(kind)
    mod = {"mpnn": "train_chem", "ggnn": "train_ggnn",
           "diffpool": "train_diffpool", "pointcloud": "train_pointcloud",
           "pinsage": "train_pinsage"}[kind]
    check_init(model, params, trainer(mod).REFERENCE_NAMES)


EXTRA = [("train_chem.py", ["--model", "schnet", "--epochs", "1",
                            "--num-molecules", "24", "--batch-size", "8",
                            "--hidden", "8", "--steps", "1"])]


@pytest.mark.parametrize(
    "entry,argv", sorted(SMOKE_GRAPH.items()) + EXTRA,
    ids=sorted(SMOKE_GRAPH) + ["train_chem.py#schnet"])
def test_graph_trainer_main_runs_on_the_cpu(entry, argv, capsys,
                                            monkeypatch):
    """The entry end to end through ``main(argv + ['--cpu'])`` at a tiny
    size, to its gate's verdict (``main_to_gate``)."""
    mod = importlib.import_module(harness.module_of(entry))
    m, line = main_to_gate(mod, argv, monkeypatch)
    check_metrics(m, line, capsys.readouterr().out)
