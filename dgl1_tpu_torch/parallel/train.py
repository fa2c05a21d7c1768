"""Partitioned full-graph GCN training (the multi-device path).

The port's counterpart of ``dgl1_tpu/parallel/train.py``: node features
are sharded by partition, one rank a part; each layer is one halo
exchange and a local reduce (``sharded_ops``); the dense projections run
on each rank's rows; the parameters are replicated and their gradients
summed over the ranks (the reference's ``shard_map`` transpose does this
for it). The loss is the global masked mean: each rank's masked sum over
the all-reduced mask count, summed over the ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from dgl1_tpu_torch.parallel.halo import LocalPartition
from dgl1_tpu_torch.parallel.sharded_ops import (
    allreduce_grads, fill_halo_combined, make_sharded_gcn_matvec,
    make_sharded_gcn_matvec_combined)

__all__ = ["init_gcn_params", "make_gcn_train_step", "make_gcn_predict",
           "make_dp_sampled_step"]


def init_gcn_params(in_feats: int, hidden: int, num_classes: int,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32):
    """``{"w1", "b1", "w2", "b2"}``: Glorot-uniform kernels (in, out) and
    zero biases, each a leaf that requires grad on ``device`` (None:
    cuda). The same names and shapes as the reference's dict, so
    ``params.from_jax_params`` carries its weights across."""
    from dgl1_tpu_torch.graph import resolve_device

    dev = resolve_device(device)

    def glorot(i, o):
        lim = (6.0 / (i + o)) ** 0.5
        w = (torch.rand((i, o), generator=generator, dtype=dtype) * 2 - 1)
        return (w * lim).to(dev).requires_grad_(True)

    return {
        "w1": glorot(in_feats, hidden),
        "b1": torch.zeros((hidden,), dtype=dtype,
                          device=dev).requires_grad_(True),
        "w2": glorot(hidden, num_classes),
        "b2": torch.zeros((num_classes,), dtype=dtype,
                          device=dev).requires_grad_(True),
    }


def _global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    y = x.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(y, group=group)
    return y


def make_gcn_train_step(pl: LocalPartition, optimizer: torch.optim.Optimizer,
                        num_classes: int, combined: bool = False,
                        prefilled: bool = False, group=None):
    """``(step, loss_fn)`` for a 2-layer GCN on this rank's part.

    ``step(params, x, labels, mask) -> loss`` runs the forward, the
    backward, the gradient all-reduce and ``optimizer.step()`` (the
    optimizer owns ``params``' tensors) and returns the global loss, a
    float. ``loss_fn(params, x, labels, mask)`` is this rank's term of the
    global loss (the ranks' terms sum to it). x (n_loc, F), labels and
    mask (n_loc,).

    ``combined=True``: activations stay in the [owned | halo | pad]
    layout, x (R, F) from ``pg.shard_node_data_combined``; needs a hub
    build. ``prefilled=True`` (combined only): x's halo slots were filled
    once (``sharded_ops.fill_halo_combined``), so the first layer skips
    its halo update. That trusts x's halo slots to hold the owners'
    current rows: fill again after every change of x. With
    ``DGL1_TPU_CHECK_PREFILL=1`` each step checks the standing halo
    against a fresh fill (one more exchange a step).
    """
    if prefilled and not combined:
        raise ValueError("prefilled=True requires combined=True")
    if combined:
        matvec = make_sharded_gcn_matvec_combined(pl, group)
        matvec_first = (make_sharded_gcn_matvec_combined(
            pl, group, halo_filled=True) if prefilled else matvec)
    else:
        matvec = matvec_first = make_sharded_gcn_matvec(pl, group)

    def loss_fn(params, x, labels, mask):
        h = matvec_first(x)
        h = torch.relu(h @ params["w1"] + params["b1"])
        h = matvec(h)
        logits = h @ params["w2"] + params["b2"]
        if combined:
            logits = logits[: pl.n_loc]
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(1, labels.long().clamp(0, num_classes - 1)[:, None])
        ce = torch.where((labels >= 0)[:, None] & (labels < num_classes)[
            :, None], ce, torch.zeros_like(ce))[:, 0]
        m = mask.to(logits.dtype)
        count = _global_sum(m.sum(), group).clamp_min(1.0)
        return (ce * m).sum() / count

    check = prefilled and os.environ.get("DGL1_TPU_CHECK_PREFILL")
    fill = fill_halo_combined(pl, group) if check else None

    def step(params, x, labels, mask):
        if check:
            fresh = fill(x)
            if not torch.allclose(fresh[pl.n_loc:], x[pl.n_loc:],
                                  atol=1e-6):
                raise AssertionError(
                    "prefilled=True but x's halo slots are stale (they "
                    "differ from a fresh fill_halo_combined): fill again "
                    "after every feature change, or build with "
                    "prefilled=False")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, labels, mask)
        loss.backward()
        allreduce_grads(params.values(), group)
        optimizer.step()
        return float(_global_sum(loss, group))

    return step, loss_fn


def make_gcn_predict(pl: LocalPartition, group=None):
    """``predict(params, x) -> (n_loc,)`` argmax class ids of this rank's
    rows (the eval counterpart of :func:`make_gcn_train_step`)."""
    matvec = make_sharded_gcn_matvec(pl, group)

    @torch.no_grad()
    def predict(params, x):
        h = torch.relu(matvec(x) @ params["w1"] + params["b1"])
        logits = matvec(h) @ params["w2"] + params["b2"]
        return logits.argmax(dim=-1)

    return predict


def make_dp_sampled_step(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer, group=None):
    """The data-parallel sampled step (the reference's DistDGL-shaped loop):
    each rank trains ``model`` (replicated) on its own partition's seeds,
    and the gradients and the loss are averaged over the ranks.

    ``step(blocks, x, labels, mask) -> loss``: ``model(blocks, x)``
    logits for the seeds, cross-entropy over the real seeds (``mask``),
    the backward, the gradient mean over the ranks and
    ``optimizer.step()``; returns the mean loss over the ranks, a float.
    """
    world = dist.get_world_size(group) if dist.is_initialized() else 1

    def step(blocks, x, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        logits = model(blocks, x)
        ce = torch.nn.functional.cross_entropy(logits, labels.long(),
                                               reduction="none")
        m = mask.to(ce.dtype)
        loss = (ce * m).sum() / m.sum().clamp(min=1.0)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        allreduce_grads(params, group)
        for p in params:
            p.grad /= world
        optimizer.step()
        return float(_global_sum(loss, group)) / world

    return step
