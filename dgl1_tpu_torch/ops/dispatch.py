"""Engine dispatch for g-SpMM (the port's ``dgl1_tpu/ops/dispatch.py``).

Engines: ``"xla"`` (the oracle, always available), ``"ell"``, ``"hub"``
and ``"tile"``. ``"auto"`` tries ``hub``, ``ell``, then ``tile`` on CUDA
tensors and uses the oracle on the CPU, as the reference uses its oracle
off the TPU. An
engine returns ``None`` for a call it does not cover and dispatch falls
through. The starting engine is ``"auto"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_ENGINE = "auto"

# name -> gspmm fn; the fn returns None when the call is not covered.
_ENGINES: Dict[str, Callable] = {}

_AUTO_ORDER = ["hub", "ell", "tile"]


def set_engine(name: str) -> None:
    global _ENGINE
    if name not in ("auto", "xla") and name not in _ENGINES:
        raise ValueError(f"unknown engine {name!r}")
    _ENGINE = name


def get_engine() -> str:
    return _ENGINE


def register_engine(name: str, gspmm_fn: Callable) -> None:
    _ENGINES[name] = gspmm_fn


def _candidates(on_cuda: bool) -> List[str]:
    if _ENGINE == "xla":
        return []
    if _ENGINE == "auto":
        return [n for n in _AUTO_ORDER if n in _ENGINES] if on_cuda else []
    return [_ENGINE] if _ENGINE in _ENGINES else []


def dispatch_gspmm(g, op, reduce_op, u, e):
    """Try the engines in order; None if all decline."""
    x = u if u is not None else e
    for name in _candidates(x is not None and x.is_cuda):
        out = _ENGINES[name](g, op, reduce_op, u, e)
        if out is not None:
            return out
    return None
