"""Shared inputs of the port's parity tests (``test_torch_*.py``): edge
lists and features made with numpy from a seed, handed to both the JAX
package and ``dgl1_tpu_torch``.

Importing this module also makes sure the reference's native library is
loaded in this process (:func:`reference_native`): several parity tests
compare the port's native sampler and layout builders with the
reference's, whose numpy fallbacks draw other random streams.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl
from dgl1_tpu import _native as jnative
from dgl1_tpu_torch.params import from_jax_params

N, E = 300, 3000


def reference_native():
    """The reference's native library (``dgl1_tpu._native.lib()``), built
    and loaded under an exclusive ``flock`` on a lock file in its cache
    directory (``DGL1_TPU_CACHE``, or ``~/.cache/dgl1_tpu``); None when
    ``DGL1_TPU_NO_NATIVE`` is set.

    The reference compiles into one temporary name shared by every
    process (``graph_builder_<hash>.so.tmp``) and renames it into place.
    Test workers that start on a cold cache race there: a loser's rename
    raises, and ``lib()`` caches None for the rest of the process, so the
    reference silently takes its numpy fallbacks. Under the lock only one
    process builds at a time; a process whose first try failed retries
    ``_compile()`` (three tries, a second apart) and stores the library
    where ``lib()`` returns it."""
    if os.environ.get("DGL1_TPU_NO_NATIVE"):
        return None
    cache = Path(os.environ.get("DGL1_TPU_CACHE",
                                os.path.expanduser("~/.cache/dgl1_tpu")))
    cache.mkdir(parents=True, exist_ok=True)
    with open(cache / "graph_builder.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if jnative.lib() is not None:
            return jnative.lib()
        for attempt in range(3):
            try:
                jnative._LIB = jnative._compile()
                return jnative._LIB
            except (OSError, subprocess.CalledProcessError):
                if attempt < 2:
                    time.sleep(1.0)
    return None


reference_native()

# min_group_edges, dense_floor: the tier combinations of tests/test_hub.py
CONFIGS = {
    "chunked": (300, 1 << 40),
    "dense": (300, 1),
    "mixed": (300, 1000),
}


def skewed_edges(n=N, e=E, seed=0):
    """Half Zipf + half uniform destinations (tests/test_hub.py's
    make_skewed): a dense hub head, a mid group and a spread-out tail."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e)
    dst = np.concatenate([
        rng.zipf(1.7, size=e // 2) % n,
        rng.integers(0, n, size=e - e // 2),
    ]).astype(np.int64)
    rng.shuffle(dst)
    return src, dst


def powerlaw_edges(n, avg_degree, alpha=2.1, seed=0):
    """The edges of ``data.synthetic.powerlaw_graph`` (both packages)."""
    rng = np.random.default_rng(seed)
    num_edges = n * avg_degree
    ranks = np.arange(1, n + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -alpha)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int64)
    src = rng.integers(0, n, size=num_edges)
    return src, dst


def both_graphs(src, dst, n, self_loops=False, relabel=False, **kw):
    """The same graph in both packages (port on the CPU). Self-loops go
    through ``add_self_loop`` at the default hub floors, else they are
    appended to the edge list so the given floors still apply."""
    if self_loops and kw:
        loops = np.arange(n)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    gj = jdgl.graph((src, dst), num_nodes=n, **kw)
    gt = tdgl.graph((src, dst), num_nodes=n, device="cpu", **kw)
    if self_loops and not kw:
        gj, gt = jdgl.add_self_loop(gj), tdgl.add_self_loop(gt)
    if relabel:
        cfg = {k: kw[k] for k in ("hub", "hub_dense_floor") if k in kw}
        gj = jdgl.reorder_graph(gj, node_permute_algo="hub",
                                permute_config=cfg or None)
        gt = tdgl.reorder_graph(gt, node_permute_algo="hub",
                                permute_config=cfg or None)
    return gj, gt


# name -> (edges, n, graph kwargs, self_loops, relabel)
GRAPHS = {
    "chunked": lambda: (skewed_edges(), N, dict(hub=300,
                                                hub_dense_floor=1 << 40)),
    "dense": lambda: (skewed_edges(), N, dict(hub=300, hub_dense_floor=1)),
    "mixed": lambda: (skewed_edges(), N, dict(hub=300, hub_dense_floor=1000)),
    "powerlaw": lambda: (powerlaw_edges(1 << 12, 8), 1 << 12, {}),
}


def make(name, self_loops=False, relabel=False):
    (src, dst), n, kw = GRAPHS[name]()
    return both_graphs(src, dst, n, self_loops=self_loops, relabel=relabel,
                       **kw)


def feats(n, f, seed=1, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)) + shift).astype(np.float32)


@contextlib.contextmanager
def engines(name_j, name_t):
    """Force the reference's and the port's engines, then restore."""
    old_j = jdgl.ops.get_engine()
    old_t = tdgl.ops.get_engine()
    jdgl.ops.set_engine(name_j)
    tdgl.ops.set_engine(name_t)
    try:
        yield
    finally:
        jdgl.ops.set_engine(old_j)
        tdgl.ops.set_engine(old_t)


MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(a, b, err_msg="", tol=None):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), err_msg=err_msg,
                               **(tol or MODULE_TOL))


def module_pair(jmod, tmod, gj, gt, inputs, grad_of=(0,), tol=None,
                engine=None):
    """A reference (flax) module and the port's with its parameters
    carried by ``from_jax_params``, the port's in eval mode and on
    ``engine`` (the oracle when None), the reference's jitted on its
    oracle, both on ``inputs`` (numpy arrays, or (jax, torch) pairs for
    the other inputs); the outputs, the grads of ``sum(out * ct)`` (a
    fixed random cotangent) of the inputs in ``grad_of`` and of every
    parameter compared. Returns the port's outputs."""
    jin = [a[0] if isinstance(a, tuple) else jnp.asarray(a) for a in inputs]
    tin = [a[1] if isinstance(a, tuple) else torch.tensor(a) for a in inputs]
    params = jax.tree.map(np.asarray, jax.jit(
        lambda *x: jmod.init(jax.random.PRNGKey(0), gj, *x))(*jin))
    tmod.load_state_dict(from_jax_params(params), strict=True)
    tmod.eval()  # no dropout: the reference's deterministic default

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    shapes = jax.eval_shape(lambda p, *x: jmod.apply(p, gj, *x), params,
                            *jin)
    cts = [rand(o.shape, 100 + i) for i, o in enumerate(outs(shapes))]

    def loss(p, *gx):
        xs = list(jin)
        for i, x in zip(grad_of, gx):
            xs[i] = x
        out = outs(jmod.apply(p, gj, *xs))
        return sum(jnp.sum(o * c) for o, c in zip(out, cts)), out

    # One jitted call: the reference's eager ops compile one by one.
    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(grad_of))), has_aux=True))(
        params, *[jin[i] for i in grad_of])
    for i in grad_of:
        tin[i].requires_grad_(True)
    with engines("xla", engine or "xla"):
        got = outs(tmod(gt, *tin))
        sum((o * torch.tensor(c)).sum() for o, c in zip(got, cts)).backward()
    for k, (a, b) in enumerate(zip(got, want)):
        close(a, b, f"out {k}", tol)
    for i, gx in zip(grad_of, grads[1:]):
        close(tin[i].grad, gx, f"grad of input {i}", tol)
    jg = from_jax_params(jax.tree.map(np.asarray, grads[0]))
    tp = {k: p for k, p in tmod.named_parameters() if p.requires_grad}
    assert set(tp) <= set(jg), set(tp) - set(jg)
    for k, p in tp.items():
        close(p.grad, jg[k], k, tol)
    return got


def t(x, dtype=None):
    """numpy (or jax) array -> CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=dtype, order="C"))
