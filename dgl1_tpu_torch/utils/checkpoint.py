"""Checkpoints (the port's ``dgl1_tpu/utils/checkpoint.py``): a nested
structure of arrays as one npz in the reference's layout, ``leaf_{i}`` in
the order JAX flattens it (dict keys sorted, lists and tuples in order)
and ``__meta__`` (JSON: ``num_leaves``, ``step``, ``treedef``), so either
package loads the other's file."""

from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    return [tree]


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(_describe(v) for v in tree)
        return f"[{body}]" if isinstance(tree, list) else f"({body})"
    return "None" if tree is None else "*"


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors or
    arrays) and ``step`` to ``path`` (``.npz`` appended by numpy)."""
    leaves = _leaves(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"treedef": _describe(tree), "step": step,
                    "num_leaves": len(leaves)}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _fill(like, it):
    if isinstance(like, dict):
        vals = {k: _fill(like[k], it) for k in sorted(like)}
        return type(like)((k, vals[k]) for k in like)
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, it) for v in like)
    if like is None:
        return None
    arr = next(it)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """``(tree, step)`` from a file of either package, in the structure
    of ``like``: a leaf that is a tensor there comes back as a tensor on
    its device, any other leaf as a numpy array."""
    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    if len(leaves) != len(_leaves(like)):
        raise ValueError(f"the file has {len(leaves)} leaves, the "
                         f"template {len(_leaves(like))}")
    return _fill(like, iter(leaves)), meta["step"]
