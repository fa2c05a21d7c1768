"""The port's trainers: one module per script of the reference's
``examples/``, each run as ``python -m dgl1_tpu_torch.examples.<name>``
with the script's flags, names and defaults (``--cpu`` runs on the CPU;
without it the trainer runs on ``cuda`` and raises where there is no
card).

Each module is split as ``parse_args(argv)``, ``build(args, device) ->
(data, model)``, ``train(args, data, model, device) -> dict`` and
``gate(args, data, metrics) -> str``; ``main(argv)`` runs them through
:func:`run`. ``train`` returns ``losses`` (the loss of every step, before
its update), ``step_ms`` (each step's host time, ending where its loss is
read back), ``val`` and ``test`` (the metrics the script reports: best
validation accuracy and the test accuracy at it, or the script's own
final metric under ``test``; None where it has none). ``gate`` returns the
line it prints, raises ``SystemExit`` where the script's gate fails, and
says "no gate" where the script enforces none.

This module holds what the trainers share.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.nn.functional as F

from dgl1_tpu_torch.graph import resolve_device

__all__ = ["run", "device_of", "masked_ce", "accuracy", "literature_gate",
           "first_of", "NO_GATE", "Stepper", "load_reference",
           "reference_state_dict"]

NO_GATE = "no gate"


def device_of(args) -> torch.device:
    """The CPU under ``--cpu``; else ``cuda``, which raises without a
    card."""
    return torch.device("cpu") if args.cpu else resolve_device(None)


def run(mod, argv=None) -> dict:
    """``mod``'s trainer end to end: parse, build, train, gate. Returns
    the metrics with ``wall_s`` (build and train) and ``gate`` (the gate's
    line); a failed gate raises ``SystemExit`` with its message."""
    args = mod.parse_args(argv)
    dev = device_of(args)
    t0 = time.perf_counter()
    data, model = mod.build(args, dev)
    metrics = mod.train(args, data, model, dev)
    metrics["wall_s"] = time.perf_counter() - t0
    metrics["gate"] = mod.gate(args, data, metrics)
    print(metrics["gate"])
    return metrics


def masked_ce(logits, labels, mask, floor: Optional[float] = None):
    """``sum(ce * m) / sum(m)`` over the rows of ``mask`` (the scripts'
    loss); ``floor`` bounds the denominator from below where the script
    does (``jnp.maximum(sum(m), floor)``)."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    m = mask.to(ce.dtype)
    den = m.sum() if floor is None else m.sum().clamp_min(floor)
    return (ce * m).sum() / den


def accuracy(pred, labels, mask) -> float:
    """Share of the rows of ``mask`` whose prediction is the label."""
    m = mask.to(torch.float32)
    correct = (pred == labels.long()).to(torch.float32)
    return float((correct * m).sum() / m.sum().clamp_min(1.0))


def literature_gate(best_test: float, gate: Optional[float],
                    synthetic: bool, what: str) -> str:
    """The citation scripts' gate: on real data only, ``best_test`` must
    reach ``gate`` (already less its tolerance)."""
    if gate is None or synthetic:
        return NO_GATE + (" on synthetic data" if synthetic else "")
    if best_test < gate:
        raise SystemExit(f"ACCURACY GATE FAILED: {what} test "
                         f"{best_test:.4f} < {gate:.4f}")
    return f"accuracy gate passed ({best_test:.4f} >= {gate:.4f})"


def reference_state_dict(params, renames=None) -> dict:
    """The reference script's flax parameter tree (numpy arrays) as the
    port's ``state_dict``: :func:`~dgl1_tpu_torch.params.from_jax_params`,
    then each part of a name that is a key of ``renames`` takes that
    key's value in its place (flax's auto names to the port's)."""
    from dgl1_tpu_torch.params import from_jax_params

    renames = renames or {}
    return {".".join(renames.get(part, part) for part in k.split(".")): v
            for k, v in from_jax_params(params).items()}


def load_reference(model, params, renames=None):
    """Load :func:`reference_state_dict` of ``params`` into ``model``."""
    model.load_state_dict(reference_state_dict(params, renames), strict=True)
    return model


def first_of(batches):
    """The first item of ``batches``; its iterator is closed after, which
    stops a loader's worker threads."""
    it = iter(batches)
    try:
        return next(it)
    finally:
        if hasattr(it, "close"):
            it.close()


class Stepper:
    """Records each step's loss and host time: ``start()`` before the
    step, ``done(loss)`` after its update (reading the loss back ends the
    step's device work)."""

    def __init__(self):
        self.losses, self.step_ms = [], []
        self._t0 = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def done(self, loss) -> float:
        v = float(loss.detach()) if isinstance(loss, torch.Tensor) \
            else float(loss)
        self.step_ms.append((time.perf_counter() - self._t0) * 1e3)
        self.losses.append(v)
        return v

    def metrics(self, **kw) -> dict:
        out = {"losses": self.losses, "step_ms": self.step_ms, "val": None,
               "test": None}
        out.update(kw)
        return out
