"""Parameter conversion from the JAX package's flax trees."""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(params) -> "OrderedDict[str, torch.Tensor]":
    """A ``state_dict`` for the port's module from a flax parameter tree
    given as numpy arrays (with or without the top ``'params'`` key).

    Names map ``layer{i}`` -> ``layers.{i}``, ``HeteroGraphConv``'s
    ``mods_{etype}`` -> ``mods.{etype}``, a ``Dense`` ``kernel`` ->
    ``weight`` and an ``Embed`` ``embedding`` -> ``weight``; the other
    names (``emb_{t}``, ``fc_{t}``, ``gat_{i}``, ``semantic``,
    ``predict``, ...) are the port's own. A flax ``Dense`` kernel is (in,
    out) and ``nn.Linear.weight`` is (out, in), so kernels are
    transposed; an embedding table is (num, dim) in both."""
    if "params" in params:
        params = params["params"]
    out = OrderedDict()
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        names = [re.sub(r"^mods_(.+)$", r"mods.\1",
                        re.sub(r"^layer(\d+)$", r"layers.\1", p))
                 for p in path]
        if names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        elif names[-1] == "embedding":
            names[-1] = "weight"
        out[".".join(names)] = torch.tensor(arr)
    return out
