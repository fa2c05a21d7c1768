"""LGNN and the Tree-LSTM of the port against the JAX package's, with the
reference's parameters carried by ``from_jax_params``: logits and the
gradients of ``sum(logits * ct)`` (a fixed random cotangent) with respect
to every parameter (and to ``pm_pd`` for LGNN); the port's Tree-LSTM
eager and compiled (``topo_schedule``), both cells, each against the
reference's compiled path, jitted (its eager path spends ~30 s compiling
one op at a time on the CPU; the reference's own tests hold the two
equal).

Tolerances, float32: ``torch_parity.MODULE_TOL`` (rtol 1e-4, atol 1e-5),
sums in another order than XLA's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu.models import LGNN as JLGNN
from dgl1_tpu.models import TreeLSTM as JTreeLSTM
from dgl1_tpu_torch.models import LGNN, TreeLSTM
from dgl1_tpu_torch.params import from_jax_params

from torch_parity import close, engines, module_pair, rand


@pytest.mark.parametrize("radius,layers", [(2, 2), (3, 1)])
def test_lgnn_matches_reference(radius, layers):
    kw = dict(avg_deg=4.0, pq=2.0, seed=1, pad_multiple=64)
    dj = jdgl.data.SBMMixtureDataset(2, 40, 2, **kw)
    dt = tdgl.data.SBMMixtureDataset(2, 40, 2, device="cpu", **kw)
    gj, lgj, pmj = dj[1]
    gt, lgt, pmt = dt[1]
    module_pair(JLGNN(hidden=6, communities=2, num_layers=layers,
                      radius=radius),
                LGNN(hidden=6, communities=2, num_layers=layers,
                     radius=radius, device="cpu"),
                gj, gt, [(lgj, lgt), np.asarray(pmj)], grad_of=(1,))


def trees(n_trees=5):
    dj = jdgl.data.SSTDataset("train", num_trees=n_trees, seed=2)
    dt = tdgl.data.SSTDataset("train", num_trees=n_trees, seed=2,
                              device="cpu")
    return (jdgl.batch([dj[i] for i in range(n_trees)]),
            tdgl.batch([dt[i] for i in range(n_trees)], device="cpu"),
            dj.vocab_size)


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("cell", ["childsum", "nary"])
def test_treelstm_matches_reference(cell, compiled):
    bgj, bgt, vocab = trees()
    kw = dict(num_vocab=vocab, x_size=8, h_size=6, num_classes=5,
              cell_type=cell)
    jm, tm = JTreeLSTM(**kw), TreeLSTM(device="cpu", **kw).eval()
    tok, mask = bgj.ndata["x"], bgj.ndata["mask"]
    sj = jdgl.topo_schedule(bgj)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda: jm.init(jax.random.PRNGKey(0), bgj, tok, mask,
                        schedule=sj))())
    tm.load_state_dict(from_jax_params(params), strict=True)
    st = tdgl.topo_schedule(bgt) if compiled else None
    ct = rand((bgt.num_nodes(), 5), 7)

    def loss(p):
        out = jm.apply(p, bgj, tok, mask, schedule=sj)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    with engines("xla", "xla"):
        got = tm(bgt, bgt.ndata["x"], bgt.ndata["mask"], schedule=st)
        (got * torch.from_numpy(ct)).sum().backward()
    close(got, want, "logits")
    jg = from_jax_params(jax.tree.map(np.asarray, grads))
    tg = dict(tm.named_parameters())
    assert set(tg) == set(jg)
    for k, p in tg.items():
        close(p.grad, jg[k], k)
    assert set(bgt.ndata) == {"x", "y", "mask"}  # the recurrence's frames
