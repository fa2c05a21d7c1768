"""Builtin message and reduce functions (the port's
``dgl1_tpu/function``; parity: ``python/dgl/function/message.py`` and
``reducer.py``). They are symbolic: ``core.py`` matches them and lowers
them to one g-SpMM or g-SDDMM call instead of building per-edge tensors.

The generated surface, with the reference's names and namedtuple fields:

* ``copy_u(u, out)``, ``copy_e(e, out)`` (aliases ``copy_src``/``copy_edge``)
* ``{u,v,e}_{add,sub,mul,div,dot}_{u,v,e}`` for every ordered pair of
  distinct targets, e.g. ``u_mul_e``, ``u_dot_v``, ``e_div_v`` …
* reducers ``sum``, ``max``, ``min``, ``mean``, ``prod``
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

__all__ = [
    "copy_u",
    "copy_e",
    "copy_src",
    "copy_edge",
    "sum",
    "max",
    "min",
    "mean",
    "prod",
    "BinaryMessage",
    "CopyMessage",
    "Reducer",
    "TargetCode",
]


class TargetCode:
    """Operand targets (``python/dgl/function/base.py :: TargetCode``)."""

    SRC = "u"
    DST = "v"
    EDGE = "e"


class CopyMessage(NamedTuple):
    """``copy_u`` / ``copy_e`` style message function."""

    target: str  # 'u' or 'e'
    in_field: str
    out_field: str

    @property
    def name(self):
        return f"copy_{self.target}"


class BinaryMessage(NamedTuple):
    """``lhs <op> rhs`` message function, e.g. ``u_mul_e('h','w','m')``."""

    binary_op: str  # add/sub/mul/div/dot
    lhs: str  # u/v/e
    rhs: str  # u/v/e
    lhs_field: str
    rhs_field: str
    out_field: str

    @property
    def name(self):
        return f"{self.lhs}_{self.binary_op}_{self.rhs}"


class Reducer(NamedTuple):
    """Builtin reducer, e.g. ``fn.sum('m', 'h')``."""

    op: str  # sum/max/min/mean/prod
    msg_field: str
    out_field: str

    @property
    def name(self):
        return self.op


def copy_u(u: str, out: str) -> CopyMessage:
    return CopyMessage(TargetCode.SRC, u, out)


def copy_e(e: str, out: str) -> CopyMessage:
    return CopyMessage(TargetCode.EDGE, e, out)


# Reference aliases (0.4-era names).
copy_src = copy_u
copy_edge = copy_e


def _make_reducer(op: str):
    def reducer(msg: str, out: str) -> Reducer:
        return Reducer(op, msg, out)

    reducer.__name__ = op
    reducer.__doc__ = f"Builtin reducer ``{op}`` over incoming messages."
    return reducer


sum = _make_reducer("sum")  # noqa: A001 (dgl.function.sum)
max = _make_reducer("max")  # noqa: A001
min = _make_reducer("min")  # noqa: A001
mean = _make_reducer("mean")
prod = _make_reducer("prod")


def _make_binary(lhs: str, op: str, rhs: str):
    def message(lhs_field: str, rhs_field: str, out: str) -> BinaryMessage:
        return BinaryMessage(op, lhs, rhs, lhs_field, rhs_field, out)

    message.__name__ = f"{lhs}_{op}_{rhs}"
    message.__doc__ = (
        f"Builtin message function computing ``{lhs}.{{lhs_field}} {op} "
        f"{rhs}.{{rhs_field}}`` per edge."
    )
    return message


_module = sys.modules[__name__]
_TARGETS = ("u", "v", "e")
_BINARY_OPS = ("add", "sub", "mul", "div", "dot")
for _lhs in _TARGETS:
    for _rhs in _TARGETS:
        if _lhs == _rhs:
            continue
        for _op in _BINARY_OPS:
            _name = f"{_lhs}_{_op}_{_rhs}"
            setattr(_module, _name, _make_binary(_lhs, _op, _rhs))
            __all__.append(_name)
