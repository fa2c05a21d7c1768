"""Engine dispatch for g-SpMM (the port's ``dgl1_tpu/ops/dispatch.py``).

Engines: ``"xla"`` (the oracle, always available), ``"bdense"``,
``"hub"``, ``"ell"`` and ``"tile"``. ``"auto"`` tries ``bdense``, ``hub``,
``ell``, then ``tile`` on CUDA tensors (the reference's order, with the
tile engine last) and uses the oracle on the CPU, as the reference uses
its oracle off the TPU. An
engine returns ``None`` for a call it does not cover and dispatch falls
through. The starting engine is ``DGL1_TPU_ENGINE`` as it stood at import
(``"auto"`` when unset); an unknown name there raises at the first
dispatch, where the reference would fall silently to the oracle
(``"pallas"``, the reference's name for the tile engine, means
``"tile"``).
:func:`set_auto_order` replaces the order ``"auto"`` tries. The engine
that takes a call runs in a ``dispatch.<engine>`` span (an attempt its
engine declines is left out of the record).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

from dgl1_tpu_torch.utils.profiler import span

# The reference's name for the tile engine.
_ALIASES = {"pallas": "tile"}

_ENGINE = os.environ.get("DGL1_TPU_ENGINE", "auto")
_ENGINE = _ALIASES.get(_ENGINE, _ENGINE)

# name -> gspmm fn; the fn returns None when the call is not covered.
_ENGINES: Dict[str, Callable] = {}

_AUTO_ORDER = ["bdense", "hub", "ell", "tile"]


def set_engine(name: str) -> None:
    global _ENGINE
    name = _ALIASES.get(name, name)
    if name not in ("auto", "xla") and name not in _ENGINES:
        raise ValueError(f"unknown engine {name!r}")
    _ENGINE = name


def get_engine() -> str:
    return _ENGINE


def set_auto_order(order: List[str]) -> None:
    """The engines ``"auto"`` tries on CUDA tensors, in order; names that
    are not registered are skipped, as the reference skips them."""
    global _AUTO_ORDER
    _AUTO_ORDER = [_ALIASES.get(n, n) for n in order]


def register_engine(name: str, gspmm_fn: Callable) -> None:
    _ENGINES[name] = gspmm_fn


def _candidates(on_cuda: bool) -> List[str]:
    if _ENGINE == "xla":
        return []
    if _ENGINE == "auto":
        return [n for n in _AUTO_ORDER if n in _ENGINES] if on_cuda else []
    if _ENGINE not in _ENGINES:
        raise ValueError(f"unknown engine {_ENGINE!r} (DGL1_TPU_ENGINE); "
                         f"known: auto, xla, {', '.join(sorted(_ENGINES))}")
    return [_ENGINE]


def dispatch_gspmm(g, op, reduce_op, u, e):
    """Try the engines in order; None if all decline."""
    x = u if u is not None else e
    for name in _candidates(x is not None and x.is_cuda):
        with span("dispatch." + name) as sp:
            out = _ENGINES[name](g, op, reduce_op, u, e)
            if out is None:
                sp.drop()
        if out is not None:
            return out
    return None
