"""Faults planted under the program's timed path, for the tests and the
calibration that show the check fails them; the benchmark's runs never
use them. Each is a function of the model returning a context manager
under which the program's steps run broken."""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def unchanged(model):
    """A step that returns its state unchanged: Adam at a zero rate (its
    moments still move, so the first gradient can be read)."""
    adam = torch.optim.Adam

    class StuckAdam(adam):
        def __init__(self, params, lr=1e-3, **kw):
            super().__init__(params, lr=0.0, **kw)

    torch.optim.Adam = StuckAdam
    try:
        yield
    finally:
        torch.optim.Adam = adam


@contextmanager
def half_batch(model):
    """Half of the batch left out: the loss's mean over the first half of
    the rows only."""
    fn = torch.nn.functional
    ce = fn.cross_entropy

    def half(logits, labels, *args, **kw):
        m = logits.shape[0] // 2
        return ce(logits[:m], labels[:m], *args, **kw)

    fn.cross_entropy = half
    try:
        yield
    finally:
        fn.cross_entropy = ce


@contextmanager
def tf32_on(model):
    """The program with the card's TF32 matmuls switched on."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
LOWER_PRECISION = {"program_tf32": tf32_on}
