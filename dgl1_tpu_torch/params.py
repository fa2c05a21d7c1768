"""Parameter conversion from the JAX package's flax trees."""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["from_jax_params", "from_jax_tree"]


_LSTM_GATES = ("i", "f", "g", "o")  # torch.nn.LSTM's gate order


def _is_lstm_cell(tree) -> bool:
    keys = set(tree.keys())
    return all(f"{s}{gate}" in keys for s in "ih" for gate in _LSTM_GATES)


def _lstm_leaves(cell):
    """flax ``OptimizedLSTMCell`` parameters as ``torch.nn.LSTM``'s: gate
    g's input kernel ``i{g}`` (in, f) and hidden kernel ``h{g}`` (f, f)
    become rows of ``weight_ih_l0`` / ``weight_hh_l0`` (4f, .) in the
    order i, f, g, o; the hidden side's biases become ``bias_hh_l0``, and
    ``bias_ih_l0`` is zero (flax has no input-side bias)."""
    def kernel(name):
        return np.asarray(cell[name]["kernel"], dtype=np.float32).T

    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32)
                           for g in _LSTM_GATES])
    yield ("weight_ih_l0",), np.concatenate(
        [kernel(f"i{g}") for g in _LSTM_GATES])
    yield ("weight_hh_l0",), np.concatenate(
        [kernel(f"h{g}") for g in _LSTM_GATES])
    yield ("bias_ih_l0",), np.zeros_like(b_hh)
    yield ("bias_hh_l0",), b_hh


_GRU_GATES = ("r", "z", "n")  # torch.nn.GRUCell's gate order


def _is_gru_cell(tree) -> bool:
    keys = set(tree.keys())
    return all(f"{s}{gate}" in keys for s in "ih" for gate in _GRU_GATES)


def _gru_leaves(cell):
    """flax ``GRUCell`` parameters as ``torch.nn.GRUCell``'s: the input
    kernels ``ir``, ``iz``, ``in`` (in, f) and the hidden kernels ``hr``,
    ``hz``, ``hn`` (f, f) become ``weight_ih`` / ``weight_hh`` (3f, .) in
    the order r, z, n; flax's input biases become ``bias_ih`` and its one
    hidden bias (``hn``) the n part of ``bias_hh``, whose r and z parts are
    zero (flax has no hidden bias there)."""
    def kernel(name):
        return np.asarray(cell[name]["kernel"], dtype=np.float32).T

    b_hn = np.asarray(cell["hn"]["bias"], np.float32)
    yield ("weight_ih",), np.concatenate(
        [kernel(f"i{g}") for g in _GRU_GATES])
    yield ("weight_hh",), np.concatenate(
        [kernel(f"h{g}") for g in _GRU_GATES])
    yield ("bias_ih",), np.concatenate(
        [np.asarray(cell[f"i{g}"]["bias"], np.float32) for g in _GRU_GATES])
    yield ("bias_hh",), np.concatenate(
        [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])


def _flatten(tree, prefix=()):
    """(path, array, mapped) leaves; a recurrent cell (at any depth, the
    top included) yields its torch tensors already mapped."""
    cell = (_lstm_leaves if _is_lstm_cell(tree)
            else _gru_leaves if _is_gru_cell(tree) else None)
    if cell is not None:
        for path, arr in cell(tree):
            yield prefix + path, arr, True
        return
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v, False


_RENAMES = ((r"^layers?_?(\d+)$", r"layers.\1"),
            (r"^mods_(.+)$", r"mods.\1"),
            (r"^OptimizedLSTMCell_(\d+)$", r"lstm_cells.\1"),
            (r"^(ChildSum|NAry)TreeLSTMCell_0$", "cell"))


def _rename(name: str) -> str:
    for pattern, repl in _RENAMES:
        name = re.sub(pattern, repl, name)
    return name


def from_jax_params(params) -> "OrderedDict[str, torch.Tensor]":
    """A ``state_dict`` for the port's module from a flax parameter tree
    given as numpy arrays (with or without the top ``'params'`` key).

    Names map ``layer{i}`` and ``layers_{i}`` (a flax list attribute,
    ``Sequential``'s) -> ``layers.{i}``, ``HeteroGraphConv``'s
    ``mods_{etype}`` -> ``mods.{etype}``, the Tree-LSTM's auto-named cell
    (``ChildSumTreeLSTMCell_0``, ``NAryTreeLSTMCell_0``) -> ``cell``
    (LGNN's ``layer{i}/g_core|lg_core/theta_*|bn`` and ``classify`` need
    only the general rules), a ``Dense`` ``kernel`` ->
    ``weight``, an ``Embed`` ``embedding`` -> ``weight`` and a
    ``LayerNorm`` ``scale`` -> ``weight``; an
    ``OptimizedLSTMCell`` (``SAGEConv('lstm')``'s ``lstm``) becomes a
    ``torch.nn.LSTM``'s four tensors (:func:`_lstm_leaves`), and the
    cells flax names itself (``OptimizedLSTMCell_{i}``, the two
    directions of ``JumpingKnowledge('lstm')``) ``lstm_cells.{i}``; a
    ``GRUCell`` (``GatedGraphConv``'s ``gru``) becomes a
    ``torch.nn.GRUCell``'s four tensors (:func:`_gru_leaves`); the other
    names (``emb_{t}``, ``fc_{t}``, ``gat_{i}``, ``semantic``,
    ``predict``, ``l0``/``l1`` of ``models.HeteroRGCN``, ...) are the
    port's own. A flax ``Dense`` kernel is (in, out) and
    ``nn.Linear.weight`` is (out, in), so kernels are transposed; an
    embedding table is (num, dim) in both. A flat dict of arrays keeps
    its names and orientation: the sharded trainers' weights
    (``parallel.train.init_gcn_params``' ``w1``/``b1``/``w2``/``b2``, the
    sharded GAT layer's ``W``/``al``/``ar``, the tensor-parallel ``w1``/
    ``w2``) multiply as ``x @ w`` in both packages."""
    if "params" in params:
        params = params["params"]
    out = OrderedDict()
    for path, value, done in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        names = [_rename(p) for p in path]
        if done:
            pass
        elif names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        elif names[-1] in ("embedding", "scale"):
            names[-1] = "weight"
        out[".".join(names)] = torch.tensor(arr)
    return out


def from_jax_tree(params, device=None):
    """A nested dict of arrays (numpy or jax) as the same nesting of
    float32 tensors, keys kept as they are (canonical-etype tuples, node
    types): the typed sharded trainers' parameter dict (dry run leg 9's
    ``w1``/``w2`` keyed by canonical etype, ``s1``/``s2`` by node type,
    ``w_in`` and ``emb``), whose weights multiply as ``x @ w`` in both
    packages, so nothing is transposed. ``device`` None keeps them on
    the CPU."""
    if hasattr(params, "items"):
        return {k: from_jax_tree(v, device) for k, v in params.items()}
    out = torch.tensor(np.asarray(params, dtype=np.float32))
    return out if device is None else out.to(device)
