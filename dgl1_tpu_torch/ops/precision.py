"""Compute precision of the hand-written kernels' operands (the port's
``dgl1_tpu/ops/precision.py``).

``"f32"`` (the default) computes in float32 throughout. ``"bf16"`` rounds
to bfloat16 (round to nearest even) exactly the operands that the
reference casts to its compute dtype ``dt`` before a matmul, and keeps
float32 accumulation; tensors in and out stay float32, so the mode moves
no byte count. Each kernel's docstring (``hub_kernels``, ``attn_kernels``,
``bdense_kernels``) lists the values it rounds. K3, K8, K9 and K10, the
ELL, tile and oracle engines and the block-dense attention take no
``dt`` in the reference and stay float32.

Set it per process with :func:`set_matmul_precision` or the variable
``DGL1_TPU_MATMUL_PRECISION=bf16`` (an invalid value falls back to
``"f32"``), or for a block with :func:`matmul_precision`. The engines read
the mode when a forward runs and their backward uses the same mode.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

__all__ = ["set_matmul_precision", "get_matmul_precision",
           "matmul_precision", "round_bf16", "rounding"]

_VALID = ("f32", "bf16")
_precision = os.environ.get("DGL1_TPU_MATMUL_PRECISION", "f32")
if _precision not in _VALID:
    _precision = "f32"


def set_matmul_precision(value: str) -> None:
    global _precision
    if value not in _VALID:
        raise ValueError(f"matmul precision must be one of {_VALID}")
    _precision = value


def get_matmul_precision() -> str:
    return _precision


@contextmanager
def matmul_precision(value: str):
    old = get_matmul_precision()
    set_matmul_precision(value)
    try:
        yield
    finally:
        set_matmul_precision(old)


def round_bf16(x):
    """``x`` rounded to float32, then to bfloat16 (nearest even), and back
    to its dtype: the value a kernel's ``__float2bfloat16_rn`` gives for
    the float32 it holds. A float64 plain version thus rounds a product
    of float32 operands (exact in float64) as the kernel does."""
    return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)


def rounding(bf16: bool):
    """:func:`round_bf16` in the bf16 mode, else the identity: the plain
    versions' rounding points."""
    return round_bf16 if bf16 else (lambda x: x)
