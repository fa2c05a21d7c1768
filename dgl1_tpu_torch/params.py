"""Parameter conversion from the JAX package's flax trees."""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["from_jax_params"]


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


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            if _is_lstm_cell(v):
                for path, arr in _lstm_leaves(v):
                    yield prefix + (k,) + path, arr, True
            else:
                yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v, False


def from_jax_params(params) -> "OrderedDict[str, torch.Tensor]":
    """A ``state_dict`` for the port's module from a flax parameter tree
    given as numpy arrays (with or without the top ``'params'`` key).

    Names map ``layer{i}`` -> ``layers.{i}``, ``HeteroGraphConv``'s
    ``mods_{etype}`` -> ``mods.{etype}``, a ``Dense`` ``kernel`` ->
    ``weight`` and an ``Embed`` ``embedding`` -> ``weight``; an
    ``OptimizedLSTMCell`` (``SAGEConv('lstm')``'s ``lstm``) becomes a
    ``torch.nn.LSTM``'s four tensors (:func:`_lstm_leaves`); the other
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
        names = [re.sub(r"^mods_(.+)$", r"mods.\1",
                        re.sub(r"^layer(\d+)$", r"layers.\1", p))
                 for p in path]
        if done:
            pass
        elif names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        elif names[-1] == "embedding":
            names[-1] = "weight"
        out[".".join(names)] = torch.tensor(arr)
    return out
