"""Trainers: the full-graph step of ``tools/bench_models.py`` (forward,
softmax cross-entropy over all nodes, backward, Adam), the sampled
mini-batch step of ``tools/bench_minibatch.py`` /
``examples/train_sage_minibatch.py`` and the sampled heterograph R-GCN
step of ``examples/train_rgcn_sampled.py`` (dense Adam beside the
embedding tables' sparse Adam).

Each step is the span ``train.step`` (``utils/profiler.py``) holding
``train.zero_grad``, ``train.forward``, ``train.loss``,
``train.backward``, ``train.optimizer`` and ``train.readback`` (the
loss's read-back and the device sync); the sampled trainers' wait for a
batch is ``train.wait``. A call made while tracing is on leaves one
record."""

from __future__ import annotations

import itertools
import time

import torch
import torch.nn.functional as F

from dgl1_tpu_torch.optim import (sparse_adam_init, sparse_adam_update,
                                  take_rows)
from dgl1_tpu_torch.utils.profiler import BACKWARD, STEP, span, train_record

__all__ = ["train", "train_sampled", "train_sampled_rgcn", "embed_ids"]


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
    with train_record(labels.device):
        for _ in range(steps):
            t0 = time.perf_counter()
            with span(STEP):
                with span("train.zero_grad"):
                    opt.zero_grad(set_to_none=True)
                with span("train.forward"):
                    logits = model(graph, feat=feat, generator=generator,
                                   **model_kwargs)
                with span("train.loss"):
                    loss = F.cross_entropy(logits, labels.long())
                with span(BACKWARD):
                    loss.backward()
                with span("train.optimizer"):
                    opt.step()
                with span("train.readback"):
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
    with train_record(feat.device):
        for _ in (itertools.count() if steps is None else range(steps)):
            t0 = time.perf_counter()
            try:
                with span("train.wait"):
                    inp, out, blocks, mask = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            with span(STEP):
                with span("train.zero_grad"):
                    opt.zero_grad(set_to_none=True)
                with span("train.forward"):
                    x = feat.index_select(0, inp)
                    logits = model(blocks, x, generator=generator)
                with span("train.loss"):
                    y = labels.index_select(0, out).long()
                    ce = F.cross_entropy(logits, y, reduction="none")
                    m = mask.to(ce.dtype)
                    loss = (ce * m).sum() / m.sum().clamp(min=1.0)
                with span(BACKWARD):
                    loss.backward()
                with span("train.optimizer"):
                    opt.step()
                with span("train.readback"):
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


def embed_ids(inp: dict, blocks, tables: dict) -> dict:
    """The input ids of each embedded node type with the padding tail
    (past ``blocks[0].meta['num_real_src']``) set to the table's size, out
    of range: a gather reads zeros there and the sparse update drops it,
    so the padding (which repeats id 0) never touches a real row."""
    out = {}
    for nt, table in tables.items():
        ids = inp[nt].clone()
        ids[blocks[0].meta["num_real_src"][nt]:] = table.shape[0]
        out[nt] = ids
    return out


def train_sampled_rgcn(batches, feat, labels, model, tables: dict,
                       states=None, steps=None, lr: float = 1e-2,
                       sparse_lr: float = 5e-2, ntype: str = "paper"
                       ) -> dict:
    """Steps of a sampled heterograph model (``models.HeteroRGCN``) over
    ``batches`` of ``({ntype: input ids}, {ntype: output ids}, blocks,
    mask)``, with a fifth item, the ``ntype`` input rows, when ``feat`` is
    None (a loader's ``pull_features``); else ``feat`` holds them on the
    device. The other node types read learned rows of ``tables`` (one
    tensor a type, updated in place by sparse Adam at ``sparse_lr``,
    state ``states`` or fresh); the model's parameters take Adam at
    ``lr``. The loss is the cross-entropy over the real seeds (the
    mask). At most ``steps`` steps (None: all).

    Returns ``{"losses", "step_s", "wait_s", "sample_ms", "pull_ms",
    "states"}`` as :func:`train_sampled`, with the loader's feature-pull
    ms per batch and the sparse Adam states."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    states = (states if states is not None
              else {nt: sparse_adam_init(t) for nt, t in tables.items()})
    model.train()
    losses, step_s, wait_s = [], [], []
    sample_s = getattr(batches, "sample_s", None)
    pull_s = getattr(batches, "pull_s", None)
    first = (len(sample_s) if sample_s is not None else 0,
             len(pull_s) if pull_s is not None else 0)
    it = iter(batches)
    with train_record(labels.device):
        for _ in (itertools.count() if steps is None else range(steps)):
            t0 = time.perf_counter()
            try:
                with span("train.wait"):
                    item = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            with span(STEP):
                inp, out, blocks, mask = item[:4]
                with span("train.zero_grad"):
                    opt.zero_grad(set_to_none=True)
                with span("train.forward"):
                    x_in = (item[4] if feat is None
                            else feat.index_select(0, inp[ntype]))
                    ids = embed_ids(inp, blocks, tables)
                    rows = {nt: take_rows(tables[nt], ids[nt])
                            .requires_grad_(True) for nt in tables}
                    logits = model(blocks, {ntype: x_in, **rows})
                with span("train.loss"):
                    ce = F.cross_entropy(
                        logits, labels.index_select(0, out[ntype]).long(),
                        reduction="none")
                    m = mask.to(ce.dtype)
                    loss = (ce * m).sum() / m.sum().clamp(min=1.0)
                with span(BACKWARD):
                    loss.backward()
                with span("train.optimizer"):
                    opt.step()
                    for nt in tables:
                        sparse_adam_update(tables[nt], states[nt], ids[nt],
                                           rows[nt].grad, lr=sparse_lr)
                with span("train.readback"):
                    losses.append(float(loss.detach()))
                    if logits.is_cuda:
                        torch.cuda.synchronize(logits.device)
            step_s.append(time.perf_counter() - t1)
            wait_s.append(t1 - t0)
    if hasattr(it, "close"):
        it.close()

    def ms(xs, start):
        return [s * 1e3 for s in xs[start:]] if xs is not None else []

    return {"losses": losses, "step_s": step_s, "wait_s": wait_s,
            "sample_ms": ms(sample_s, first[0]),
            "pull_ms": ms(pull_s, first[1]), "states": states}
