"""Tensor parallelism (model-axis weight sharding) for wide GNN layers.

The port's counterpart of ``dgl1_tpu/parallel/tp.py``. g-SpMM is
feature-parallel (each feature column aggregates on its own), so a
Megatron pair composes with the graph aggregation at no extra exchange:
W1 is column-parallel (each rank holds a block of its output columns),
the aggregation runs on that rank's columns, and W2 is row-parallel, its
partial products closed by one all-reduce. The reference lets XLA place
that collective from the shardings; here it is explicit.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.parallel.sharded_ops import all_reduce_sum

__all__ = ["shard_params_tp", "make_tp_gcn_layer"]


def _block(n: int, rank: int, world: int):
    if n % world:
        raise ValueError(f"hidden width {n} does not split over {world} "
                         f"ranks")
    step = n // world
    return slice(rank * step, (rank + 1) * step)


def shard_params_tp(w1: torch.Tensor, w2: torch.Tensor, rank: int,
                    world: int):
    """This rank's Megatron pair: W1 (in, H) column-sharded to its
    (in, H/world) block, W2 (H, out) row-sharded to its (H/world, out)
    block (copies)."""
    cols = _block(w1.shape[1], rank, world)
    return w1[:, cols].clone(), w2[cols].clone()


class _CopyToRanks(torch.autograd.Function):
    """Identity forward; the backward sums the replicated input's
    cotangent over the ranks (each rank's columns feed the loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        import torch.distributed as dist

        ct = ct.clone()
        if dist.is_initialized():
            dist.all_reduce(ct, group=ctx.group)
        return ct, None


def make_tp_gcn_layer(g, group=None, activation=torch.relu):
    """``layer(w1, w2, x) -> y = act(A (x W1)) W2`` with the hidden axis
    sharded over the ranks of ``group`` (A = copy_u sum over ``g``;
    normalization is the caller's). ``x`` and ``y`` are replicated; w1 and
    w2 are this rank's blocks (:func:`shard_params_tp`); the only exchange
    is the all-reduce closing W2's contraction."""
    from dgl1_tpu_torch.ops import gspmm

    def layer(w1, w2, x):
        h = _CopyToRanks.apply(x, group) @ w1
        h = activation(gspmm(g, "copy_lhs", "sum", h, None))
        return all_reduce_sum(h @ w2, group)

    return layer
