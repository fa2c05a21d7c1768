"""The port's generative and sequence trainers against the reference's
scripts: the graph transformer, GCMC, the Tree-LSTM and DGMG
(``dgl1_tpu_torch/examples``). Each builds the port's data and model with
the trainer's own ``build`` on the CPU, writes the script's in-script
flax model (or params dict; the Tree-LSTM is the reference's
``models.TreeLSTM``) out here from its lines, carries the reference's
initial weights across with the trainer's ``REFERENCE_NAMES``
(``load_reference``), and runs the port's first steps (three, or the
first epoch's batches) against the reference's loss and optimizer on the
same data, both in float64 (see ``test_torch_examples.py``). Losses are
held to a relative 1e-4 (atol 1e-6), the final outputs to 1e-4 of their
largest magnitude. Also the in-script initial weights against the
reference's, and the CPU smoke runs of the generative and sequence
entries of the harness and of the Tree-LSTM's n-ary cell on the eager
loop.
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
from dgl1_tpu.graph import block as jblock
import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.examples import load_reference
from dgl1_tpu_torch.tools import run_examples as harness
from test_torch_examples import LOSS_TOL, check_init, f64, same_logits
from test_torch_examples_smoke import SMOKE_GEN, check_metrics, main_to_gate

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


def carry(mod, model, params):
    """The reference's initial weights into the port's model through the
    trainer's names, both then in float64."""
    load_reference(model, jax.tree.map(np.asarray, params),
                   getattr(mod, "REFERENCE_NAMES", None))
    model.double()
    return f64(params)


def reference_steps(step_loss, params, opt, batches):
    """One jitted value-and-grad step of ``opt`` a batch (``step_loss(p,
    *batch)``); the losses and the parameters after the last update.
    Call under x64."""
    state = opt.init(params)

    @jax.jit
    def step(params, state, *batch):
        loss, grads = jax.value_and_grad(step_loss)(params, *batch)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for b in batches:
        params, state, loss = step(params, state, *b)
        losses.append(float(loss))
    return losses, params


# --- the graph transformer (examples/train_transformer.py) ---------------

def reference_transformer(args, enc_g, dec_g, cross_g):
    """``examples/train_transformer.py:73-113``, written out."""
    L, B, V = args.seq_len, args.batch_size, args.vocab
    D, H = args.dim, args.heads
    Dh = D // H

    def graph_attention(g, q, k, v):
        logits = jdgl.ops.gsddmm(g, "dot", k, q, lhs_target="u",
                                 rhs_target="v") / np.sqrt(Dh)
        a = jdgl.ops.edge_softmax(g, logits)
        return jdgl.ops.gspmm(g, "mul", "sum", v, a)

    class MHA(fnn.Module):
        @fnn.compact
        def __call__(self, g, x_src, x_dst):
            n_s, n_d = x_src.shape[0], x_dst.shape[0]
            q = fnn.Dense(D, name="q")(x_dst).reshape(n_d, H, Dh)
            k = fnn.Dense(D, name="k")(x_src).reshape(n_s, H, Dh)
            v = fnn.Dense(D, name="v")(x_src).reshape(n_s, H, Dh)
            o = graph_attention(g, q, k, v).reshape(n_d, D)
            return fnn.Dense(D, name="o")(o)

    class Layer(fnn.Module):
        cross: bool = False

        @fnn.compact
        def __call__(self, g_self, x, g_cross=None, mem=None):
            x = fnn.LayerNorm()(x + MHA(name="self")(g_self, x, x))
            if self.cross:
                x = fnn.LayerNorm()(x + MHA(name="cross")(g_cross, mem, x))
            y = fnn.Dense(4 * D)(x)
            y = fnn.Dense(D)(fnn.relu(y))
            return fnn.LayerNorm()(x + y)

    class GraphTransformer(fnn.Module):
        @fnn.compact
        def __call__(self, src_tok, dst_tok):
            emb = fnn.Embed(V + 1, D, name="emb")
            pos = self.param("pos", fnn.initializers.normal(0.02), (L, D))
            pe = jnp.tile(pos, (B, 1))
            h_e = emb(src_tok) + pe
            h_d = emb(dst_tok) + pe
            for i in range(2):
                h_e = Layer(name=f"enc{i}")(enc_g, h_e)
            for i in range(2):
                h_d = Layer(cross=True, name=f"dec{i}")(dec_g, h_d, cross_g,
                                                         h_e)
            return fnn.Dense(V, name="out")(h_d)

    return GraphTransformer()


def test_transformer_trainer_matches_reference():
    """The reversal task on 4 sequences of 6 tokens, width 16 in 2 heads
    (``examples/train_transformer.py:115-138``): adam, three steps, then
    the logits of the next batch."""
    mod = trainer("train_transformer")
    args = mod.parse_args(["--steps", "3", "--seq-len", "6",
                           "--batch-size", "4", "--dim", "16", "--heads",
                           "2", "--cpu"])
    data, model = mod.build(args, CPU)
    L, B = args.seq_len, args.batch_size
    full_s, full_d = np.meshgrid(np.arange(L), np.arange(L))
    s, d = full_s.ravel(), full_d.ravel()
    enc_g = jdgl.batch([jdgl.graph((s, d), num_nodes=L)] * B)
    dec_g = jdgl.batch([jdgl.graph((s[s <= d], d[s <= d]),
                                   num_nodes=L)] * B)
    off = np.arange(B)[:, None] * L
    cross_g = jblock(((s[None] + off).ravel(), (d[None] + off).ravel()),
                     num_src_nodes=B * L, num_dst_nodes=B * L)
    rng = np.random.default_rng(0)
    batches = [tuple(t.numpy() for t in mod.make_batch(args, rng, CPU))
               for _ in range(5)]
    jmodel = reference_transformer(args, enc_g, dec_g, cross_g)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         *batches[0][:2]))()
    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p, src, dec_in, tgt):
            logits = jmodel.apply(p, src, dec_in)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, tgt).mean()

        want, params = reference_steps(loss_fn, params, optax.adam(args.lr),
                                       batches[1:4])
        logits = jax.jit(jmodel.apply)(params, *batches[4][:2])
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    with torch.no_grad():
        out = model(data["graphs"], *(torch.as_tensor(a)
                                      for a in batches[4][:2]))
    same_logits(out, logits)


# --- GCMC (examples/train_gcmc.py) ----------------------------------------

def reference_gcmc(U, I, R, h):
    """``examples/train_gcmc.py:76-118`` at dropout 0, written out."""

    class GCMC(fnn.Module):
        @fnn.compact
        def __call__(self, hg, u_idx, i_idx):
            emb_u = self.param("emb_u", fnn.initializers.normal(0.1), (U, h))
            emb_i = self.param("emb_i", fnn.initializers.normal(0.1), (I, h))
            out_u = jnp.zeros((U, h))
            out_i = jnp.zeros((I, h))
            for r in range(R):
                w_r = self.param(f"w{r}", fnn.initializers.glorot_uniform(),
                                 (h, h))
                rel = hg[("user", f"rate_{r}", "item")]
                out_i = out_i + jdgl.ops.gspmm(rel, "copy_lhs", "mean",
                                               emb_u @ w_r, None)
                rev = hg[("item", f"rev_rate_{r}", "user")]
                out_u = out_u + jdgl.ops.gspmm(rev, "copy_lhs", "mean",
                                               emb_i @ w_r, None)
            hu = fnn.Dense(h, name="dense_u")(fnn.relu(out_u))
            hi = fnn.Dense(h, name="dense_i")(fnn.relu(out_i))
            basis = self.param("basis", fnn.initializers.glorot_uniform(),
                               (2, h, h))
            coeff = self.param("coeff", fnn.initializers.normal(0.5), (R, 2))
            q = jnp.einsum("rb,bhk->rhk", coeff, basis)
            return jnp.einsum("eh,rhk,ek->er", hu[u_idx], q, hi[i_idx])

    return GCMC()


def test_gcmc_trainer_matches_reference():
    """60 users, 40 items, 10 ratings a user, hidden 16: the rating
    heterograph, adamw (weight decay 1e-4) on the level cross entropy,
    embedding dropout off; three steps, then the test pairs' logits."""
    mod = trainer("train_gcmc")
    args = mod.parse_args(["--epochs", "3", "--users", "60", "--items",
                           "40", "--ratings-per-user", "10", "--hidden",
                           "16", "--cpu"])
    data, model = mod.build(args, CPU)
    model.dropout = 0.0
    uu, ii, rr, tr, te = mod.ratings(args)
    rel = {}
    for r in range(args.levels):
        m = rr[tr] == r
        rel[("user", f"rate_{r}", "item")] = (uu[tr][m], ii[tr][m])
        rel[("item", f"rev_rate_{r}", "user")] = (ii[tr][m], uu[tr][m])
    hg = jdgl.heterograph(rel, num_nodes_dict={"user": args.users,
                                               "item": args.items})
    jmodel = reference_gcmc(args.users, args.items, args.levels, args.hidden)
    u_tr, i_tr, y_tr = (jnp.asarray(a) for a in (uu[tr], ii[tr],
                                                 rr[tr].astype(np.int32)))
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), hg, u_tr,
                                         i_tr))()
    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                jmodel.apply(p, hg, u_tr, i_tr), y_tr).mean()

        want, params = reference_steps(
            loss_fn, params, optax.adamw(args.lr, weight_decay=1e-4),
            [()] * 3)
        logits = jax.jit(jmodel.apply)(params, hg, jnp.asarray(uu[te]),
                                       jnp.asarray(ii[te]))
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    model.eval()
    with torch.no_grad():
        out = model(data["hg"], data["u_te"], data["i_te"])
    same_logits(out, logits)


# --- DGMG (examples/train_dgmg.py) ----------------------------------------

def reference_dgmg(N, D):
    """``examples/train_dgmg.py:76-167``: the params dict and the batch
    NLL (``lax.scan`` over the tape, ``vmap`` over the episodes), written
    out."""
    key = jax.random.PRNGKey(0)

    def dense(key, m, n):
        return jax.random.normal(key, (m, n)) * (1.0 / np.sqrt(m))

    ks = jax.random.split(key, 16)
    params = {
        "W_m": dense(ks[0], D, D),
        "W_z": dense(ks[1], 2 * D, D), "b_z": jnp.zeros(D),
        "W_r": dense(ks[2], 2 * D, D), "b_r": jnp.zeros(D),
        "W_n": dense(ks[3], 2 * D, D), "b_n": jnp.zeros(D),
        "W_gate": dense(ks[4], D, 1),
        "W_emb": dense(ks[5], D, D),
        "w_an": dense(ks[6], D, 1), "b_an": jnp.zeros(1),
        "W_init": dense(ks[7], D, D), "b_init": jnp.zeros(D),
        "W_ae": dense(ks[8], 2 * D, 1), "b_ae": jnp.zeros(1),
        "W_s1": dense(ks[9], D, D), "W_s2": dense(ks[10], D, D),
    }
    ADDNODE, ADDEDGE, CHOOSE = 0, 1, 2

    def prop(p, h, adj, mask):
        msg = (adj @ (h @ p["W_m"])) * mask[:, None]
        x = jnp.concatenate([h, msg], axis=-1)
        z = jax.nn.sigmoid(x @ p["W_z"] + p["b_z"])
        r = jax.nn.sigmoid(x @ p["W_r"] + p["b_r"])
        xn = jnp.concatenate([r * h, msg], axis=-1)
        n = jnp.tanh(xn @ p["W_n"] + p["b_n"])
        return ((1 - z) * h + z * n) * mask[:, None]

    def graph_emb(p, h, mask):
        gate = jax.nn.sigmoid(h @ p["W_gate"])[:, 0] * mask
        return (gate[:, None] * (h @ p["W_emb"])).sum(0)

    def episode_nll(p, types, labels, slots):
        def step(carry, inp):
            h, adj, mask = carry
            t, lab, cur = inp
            h = prop(p, h, adj, mask)
            hg = graph_emb(p, h, mask)
            h_cur = h[cur]
            logit_an = (hg @ p["w_an"] + p["b_an"])[0]
            nll_an = optax.sigmoid_binary_cross_entropy(
                logit_an, lab.astype(h.dtype))
            logit_ae = (jnp.concatenate([hg, h_cur]) @ p["W_ae"]
                        + p["b_ae"])[0]
            nll_ae = optax.sigmoid_binary_cross_entropy(
                logit_ae, lab.astype(h.dtype))
            scores = (h @ p["W_s1"]) @ (h_cur @ p["W_s2"])
            ok = (mask > 0) & (jnp.arange(N) != cur)
            scores = jnp.where(ok, scores, -1e30)
            nll_ch = -jax.nn.log_softmax(scores)[lab]
            nll = jnp.select([t == ADDNODE, t == ADDEDGE, t == CHOOSE],
                             [nll_an, nll_ae, nll_ch], 0.0)
            new_node = (t == ADDNODE) & (lab == 1)
            h_init = jnp.tanh(hg @ p["W_init"] + p["b_init"])
            h = jnp.where((jnp.arange(N) == cur)[:, None] & new_node,
                          h_init[None, :], h)
            mask = jnp.where(new_node, mask.at[cur].set(1.0), mask)
            upd = jnp.zeros((N, N), h.dtype).at[cur, lab].set(1.0) \
                .at[lab, cur].set(1.0)
            adj = jnp.where(t == CHOOSE, jnp.maximum(adj, upd), adj)
            return (h, adj, mask), nll

        dt = p["W_m"].dtype
        carry0 = (jnp.zeros((N, D), dt), jnp.zeros((N, N), dt),
                  jnp.zeros(N, dt))
        _, nlls = jax.lax.scan(step, carry0, (types, labels, slots))
        return nlls.sum()

    def episode_nlls(p, types, labels, slots):
        return jax.vmap(lambda t, l, s: episode_nll(p, t, l, s))(
            types, labels, slots)

    return params, episode_nlls


def test_dgmg_trainer_matches_reference():
    """Cycles of 4 to 6 nodes, hidden 8, batches of 4 tapes: adam, three
    steps, then each episode's NLL on the next batch; the tape itself
    against the script's for every size."""
    mod = trainer("train_dgmg")
    args = mod.parse_args(["--iters", "3", "--n-min", "4", "--n-max", "6",
                           "--hidden", "8", "--batch", "4", "--samples",
                           "2", "--cpu"])
    data, model = mod.build(args, CPU)
    params, episode_nlls = reference_dgmg(args.n_max, args.hidden)
    for k, v in params.items():  # the script's own draws
        np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7)
    assert mod.cycle_tape(4, 6)[:6] == [(0, 1, 0), (1, 0, 0), (0, 1, 1),
                                        (1, 1, 1), (2, 0, 1), (1, 0, 1)]
    assert all(len(t) == 4 * 6 + 1 for t in data["tapes"].values())
    rng = np.random.default_rng(0)
    probe = dict(data, rng=rng)
    batches = [tuple(t.numpy() for t in mod.make_batch(args, probe))
               for _ in range(4)]
    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p, types, labels, slots):
            return episode_nlls(p, types, labels, slots).mean()

        want, params = reference_steps(loss_fn, params, optax.adam(args.lr),
                                       batches[:3])
        nlls = jax.jit(episode_nlls)(params, *batches[3])
    got = mod.train(args, data, model, CPU)
    np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
    assert got["test"] is not None
    with torch.no_grad():
        out = torch.stack([model(*(torch.as_tensor(a[i:i + 1])
                                   for a in batches[3]))
                           for i in range(args.batch)])
    same_logits(out, nlls)


def test_treelstm_trainer_matches_reference():
    """The child-sum Tree-LSTM on the synthetic SST, batches of 8 trees
    padded to 256 nodes, x and h 8 (``examples/train_treelstm.py:78-
    129``): the compiled schedule, adam on the real nodes' cross entropy,
    the first three batches of the first epoch's order, then the logits
    of the next."""
    mod = trainer("train_treelstm")
    args = mod.parse_args(["--batch-size", "8", "--x-size", "8",
                           "--h-size", "8", "--cpu"])
    data, model = mod.build(args, CPU)
    train_set = jdgl.data.SSTDataset("train")
    jmodel = jdgl.models.TreeLSTM(num_vocab=train_set.vocab_size,
                                  x_size=8, h_size=8, num_classes=5)
    order = np.random.default_rng(0).permutation(len(train_set))
    pad = dict(pad_levels=16, pad_width=256, pad_k=4)
    node_pad = data["node_pad"]
    assert node_pad == 256
    g_static = jdgl.graph(([0], [0]), num_nodes=node_pad)

    def jbatch(ids):
        bg = jdgl.batch([train_set[int(i)] for i in ids])
        n = bg.num_nodes()
        bg = jdgl.add_nodes(bg, node_pad - n)
        return (jnp.asarray(np.asarray(bg.ndata["x"], np.int32)),
                jnp.asarray(np.asarray(bg.ndata["mask"], np.float64)),
                jnp.asarray(np.asarray(bg.ndata["y"], np.int32)),
                float(n), jdgl.topo_schedule(bg, **pad))

    ids = [order[s * 8:(s + 1) * 8] for s in range(4)]
    jb = [jbatch(i) for i in ids]
    params = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), g_static, jb[0][0],
        jnp.asarray(jb[0][1], jnp.float32), schedule=jb[0][4]))()
    with jax.enable_x64():
        params = carry(mod, model, params)

        def loss_fn(p, toks, mask, y, n_real, sched):
            logits = jmodel.apply(p, g_static, toks, mask, schedule=sched)
            logp = jax.nn.log_softmax(logits)
            ce = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
            valid = (jnp.arange(logits.shape[0]) < n_real).astype(logp.dtype)
            return jnp.sum(ce * valid) / n_real

        want, params = reference_steps(loss_fn, params, optax.adam(args.lr),
                                       jb[:3])
        logits = jax.jit(lambda p, t, m, s: jmodel.apply(
            p, g_static, t, m, schedule=s))(params, jb[3][0], jb[3][1],
                                            jb[3][4])
    # The trainer's step, in the trainer's first-epoch order.
    ds, got = data["train_set"], []
    topt = torch.optim.Adam(model.parameters(), lr=args.lr)
    first = mod.first_batch(args, data, CPU)
    tb = [first] + [mod.batch_of(args, data, [ds[int(i)] for i in b])
                    for b in ids[1:]]
    np.testing.assert_array_equal(first[1].numpy(), np.asarray(jb[0][0]))
    for b in tb[:3]:
        topt.zero_grad()
        loss = mod.step_loss(args, data, model, b)
        loss.backward()
        topt.step()
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    g, toks, mask, _, _, _, sched = tb[3]
    with torch.no_grad():
        out = model(g, toks, mask.double(), sched)
    same_logits(out, logits)


def test_dgmg_init_is_the_reference_draw():
    """The port's DGMG weights are the script's own draws
    (``examples/train_dgmg.py:74-93``: ``jax.random.normal`` under
    ``split(PRNGKey(0), 16)``, times 1/sqrt(rows)) at the script's widths,
    within a float32 ulp (XLA's ``erf_inv`` and the port's numpy one may
    round the last bit apart)."""
    mod = trainer("train_dgmg")
    args = mod.parse_args(["--cpu"])
    _, model = mod.build(args, CPU)
    params, _ = reference_dgmg(args.n_max, args.hidden)
    got = model.state_dict()
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def init_case(kind):
    """(port model, reference params, renames) of an in-script model at
    the script's default widths."""
    if kind == "gcmc":
        mod = trainer("train_gcmc")
        args = mod.parse_args(["--cpu"])
        data, model = mod.build(args, CPU)
        uu, ii, rr, tr, _ = mod.ratings(args)
        rel = {}
        for r in range(args.levels):
            m = rr[tr] == r
            rel[("user", f"rate_{r}", "item")] = (uu[tr][m], ii[tr][m])
            rel[("item", f"rev_rate_{r}", "user")] = (ii[tr][m], uu[tr][m])
        hg = jdgl.heterograph(rel, num_nodes_dict={"user": args.users,
                                                   "item": args.items})
        jm = reference_gcmc(args.users, args.items, args.levels, args.hidden)
        u, i = jnp.asarray(uu[tr]), jnp.asarray(ii[tr])
        return model, jax.jit(lambda: jm.init(jax.random.PRNGKey(0), hg, u,
                                              i))(), None
    mod = trainer("train_transformer")
    args = mod.parse_args(["--cpu"])
    data, model = mod.build(args, CPU)
    L, B = args.seq_len, args.batch_size
    s, d = (a.ravel() for a in np.meshgrid(np.arange(L), np.arange(L)))
    g = jdgl.batch([jdgl.graph((s, d), num_nodes=L)] * B)
    jm = reference_transformer(args, g, g, g)
    tok = jnp.zeros(B * L, jnp.int32)
    return model, jax.jit(lambda: jm.init(jax.random.PRNGKey(0), tok,
                                          tok))(), mod.REFERENCE_NAMES


@pytest.mark.parametrize("kind", ["gcmc", "transformer"])
def test_inscript_init_matches_reference_scheme(kind):
    """The in-script schemes at the scripts' widths: GCMC's normal 0.1
    embeddings and glorot-uniform rating and basis weights
    (``examples/train_gcmc.py:80-112``), the transformer's ``Embed`` and
    normal(0.02) positions (``examples/train_transformer.py:102-103``),
    every ``Dense`` lecun normal; held as
    ``test_torch_examples.py::test_init_matches_reference_scheme``
    holds the modules."""
    check_init(*init_case(kind))


EXTRA = [("train_treelstm.py", ["--epochs", "1", "--batch-size", "64",
                                "--x-size", "8", "--h-size", "8", "--cell",
                                "nary", "--eager"])]


@pytest.mark.parametrize(
    "entry,argv", sorted(SMOKE_GEN.items()) + EXTRA,
    ids=sorted(SMOKE_GEN) + ["train_treelstm.py#nary-eager"])
def test_generative_trainer_main_runs_on_the_cpu(entry, argv, capsys,
                                                 monkeypatch):
    """The entry end to end through ``main(argv + ['--cpu'])`` at a tiny
    size, to its gate's verdict (``main_to_gate``)."""
    mod = importlib.import_module(harness.module_of(entry))
    m, line = main_to_gate(mod, argv, monkeypatch)
    check_metrics(m, line, capsys.readouterr().out)
