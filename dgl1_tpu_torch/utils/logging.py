"""Structured jsonl metrics logger: one json object a training step
(the port's ``dgl1_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import time
from typing import Optional, TextIO

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """``log(**metrics)`` counts a step and, every ``every`` steps, writes
    ``{"step", "t", **metrics}`` (``t`` seconds since construction,
    tensors and numpy scalars as floats) to the file at ``path``
    (appended) and/or ``stream``."""

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[TextIO] = None, every: int = 1):
        self._fh = open(path, "a") if path else None
        self._stream = stream
        self._every = every
        self._step = 0
        self._t0 = time.perf_counter()

    def log(self, **metrics):
        self._step += 1
        if self._step % self._every:
            return
        rec = {"step": self._step,
               "t": round(time.perf_counter() - self._t0, 4)}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in metrics.items()})
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._stream:
            print(line, file=self._stream)

    def close(self):
        if self._fh:
            self._fh.close()
