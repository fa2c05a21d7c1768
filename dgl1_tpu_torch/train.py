"""Trainers: the full-graph step of ``tools/bench_models.py`` (forward,
softmax cross-entropy over all nodes, backward, Adam) and the sampled
mini-batch step of ``tools/bench_minibatch.py`` /
``examples/train_sage_minibatch.py``."""

from __future__ import annotations

import itertools
import time

import torch
import torch.nn.functional as F

__all__ = ["train", "train_sampled"]


def train(graph, feat, labels, model, steps: int = 5, lr: float = 1e-2,
          generator=None, **model_kwargs) -> dict:
    """Run ``steps`` Adam steps of ``model`` on the whole graph, calling
    ``model(graph, feat=feat, generator=generator, **model_kwargs)``
    (``feat`` None for a featureless model; R-GCN takes ``etypes``,
    ``presorted``, ``etype_counts`` or ``rel_graphs`` here). Returns
    ``{"losses": [...], "step_s": [...]}``: the loss before each update
    and the host time of each step, which ends in a device sync."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        logits = model(graph, feat=feat, generator=generator,
                       **model_kwargs)
        loss = F.cross_entropy(logits, labels.long())
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if labels.is_cuda:
            torch.cuda.synchronize(labels.device)
        step_s.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": step_s}


def train_sampled(batches, feat, labels, model, steps=None, lr: float = 1e-3,
                  generator=None) -> dict:
    """Adam steps of ``model`` over sampled mini-batches.

    ``batches`` yields ``(input_nodes, output_nodes, blocks, seed_mask)``
    on ``feat``'s device (a ``NodeDataLoader``, or a list of such
    batches); at most ``steps`` are taken (None: all). Each step gathers
    the input rows of the device-resident ``feat``, takes the
    cross-entropy over the real seeds only (the mask drops the padding of
    a short last batch), and takes one Adam step.

    Returns ``{"losses", "step_s", "wait_s", "sample_ms"}``: the loss
    before each update; the host time of each step from the batch in hand
    to a device sync; the time each step waited for its batch; and, when
    ``batches`` is a ``NodeDataLoader``, the host ms its workers spent on
    each batch taken (sampling, layouts, copy to the device)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    losses, step_s, wait_s = [], [], []
    sample_s = getattr(batches, "sample_s", None)
    first_sample = len(sample_s) if sample_s is not None else 0
    it = iter(batches)
    for _ in (itertools.count() if steps is None else range(steps)):
        t0 = time.perf_counter()
        try:
            inp, out, blocks, mask = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        x = feat.index_select(0, inp)
        y = labels.index_select(0, out).long()
        logits = model(blocks, x, generator=generator)
        ce = F.cross_entropy(logits, y, reduction="none")
        m = mask.to(ce.dtype)
        loss = (ce * m).sum() / m.sum().clamp(min=1.0)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if feat.is_cuda:
            torch.cuda.synchronize(feat.device)
        step_s.append(time.perf_counter() - t1)
        wait_s.append(t1 - t0)
    if hasattr(it, "close"):
        it.close()  # stops a loader's worker threads
    sample_ms = ([s * 1e3 for s in sample_s[first_sample:]]
                 if sample_s is not None else [])
    return {"losses": losses, "step_s": step_s, "wait_s": wait_s,
            "sample_ms": sample_ms}
