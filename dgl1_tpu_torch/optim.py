"""Learned node embeddings and row-sparse optimizers (the port's
``dgl1_tpu/optim.py``): ``NodeEmbedding``, sparse Adam and sparse
Adagrad as functions on tensors.

A mini-batch step gathers the rows it needs, takes their gradients, and
updates only those rows. Ids follow the reference's index modes, made
explicit because torch's scatters have none (an id out of range is a
device-side assert on a card):

* writes (``mode="drop"``): an id in [-N, 0) counts from the end, any
  other id out of [0, N) is dropped;
* reads (``mode="clip"``): an id is clamped into [0, N - 1];
* a repeated id adds to ``step`` and to the table once per occurrence,
  and its moments take the values of its last occurrence, as XLA's
  scatter sets them.

The updates write into ``table`` and the state in place and return them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dgl1_tpu_torch.graph import resolve_device

__all__ = ["NodeEmbedding", "SparseAdamState", "sparse_adam_init",
           "sparse_adam_update", "sparse_adagrad_init",
           "sparse_adagrad_update", "take_rows"]


def _read_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``mode="clip"``: ids clamped into [0, n - 1]."""
    return ids.long().clamp(0, n - 1)


def _write_ids(ids: torch.Tensor, n: int):
    """``mode="drop"``: the normalized ids and the mask of those kept."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids, (ids >= 0) & (ids < n)


def _last_of_each(ids: torch.Tensor, keep: torch.Tensor, n: int):
    """Positions of the kept ids' last occurrences."""
    pos = keep.nonzero().squeeze(1)
    key = ids.index_select(0, pos)
    last = torch.full((n,), -1, dtype=torch.long, device=ids.device)
    last.scatter_reduce_(0, key, pos, "amax")
    return pos[last.index_select(0, key) == pos]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, mode="fill", fill_value=0)``: an id in [-N,
    0) counts from the end, any other id out of range reads a row of
    zeros (the sampled trainer's padding)."""
    n = table.shape[0]
    ids, keep = _write_ids(ids, n)
    rows = table.index_select(0, ids.clamp(0, n - 1))
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


class NodeEmbedding(NamedTuple):
    """A learnable per-node embedding table, (num_nodes, dim)."""

    table: torch.Tensor

    @staticmethod
    def create(num_nodes: int, dim: int, scale: Optional[float] = None, *,
               generator: Optional[torch.Generator] = None,
               device=None) -> "NodeEmbedding":
        """Rows uniform in [-scale, scale] (default ``1 / sqrt(dim)``),
        drawn on the generator's device (the CPU when None) and moved to
        ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        if scale is None:
            scale = 1.0 / math.sqrt(dim)
        gen_dev = generator.device if generator is not None else "cpu"
        t = torch.empty((num_nodes, dim), device=gen_dev)
        t.uniform_(-scale, scale, generator=generator)
        return NodeEmbedding(t.to(dev))

    def __call__(self, ids):
        return self.table.index_select(0, _read_ids(ids, len(self.table)))


class SparseAdamState(NamedTuple):
    m: torch.Tensor     # (num_nodes, dim) first moment
    v: torch.Tensor     # (num_nodes, dim) second moment
    step: torch.Tensor  # (num_nodes,) int32 updates of each row


def sparse_adam_init(table: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(
        m=torch.zeros_like(table), v=torch.zeros_like(table),
        step=torch.zeros((table.shape[0],), dtype=torch.int32,
                         device=table.device))


@torch.no_grad()
def sparse_adam_update(table: torch.Tensor, state: SparseAdamState,
                       ids: torch.Tensor, row_grads: torch.Tensor,
                       lr: float = 1e-3, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, SparseAdamState]:
    """Row-sparse Adam (DGL's ``SparseAdam``): ``ids`` (B,) and their
    gradients ``row_grads`` (B, dim); each row's own step count drives its
    bias correction. Ids as the module docstring says."""
    n = table.shape[0]
    wid, keep = _write_ids(ids, n)
    kept = wid[keep]
    state.step.index_add_(0, kept, torch.ones_like(kept, dtype=torch.int32))
    rid = _read_ids(ids, n)
    t = state.step.index_select(0, rid).to(row_grads.dtype)[:, None]
    m_rows = beta1 * state.m.index_select(0, rid) + (1 - beta1) * row_grads
    v_rows = (beta2 * state.v.index_select(0, rid)
              + (1 - beta2) * row_grads ** 2)
    m_hat = m_rows / (1 - torch.pow(beta1, t))
    v_hat = v_rows / (1 - torch.pow(beta2, t))
    delta = lr * m_hat / (torch.sqrt(v_hat) + eps)
    table.index_add_(0, kept, -delta[keep])
    last = _last_of_each(wid, keep, n)
    dst = wid.index_select(0, last)
    state.m.index_copy_(0, dst, m_rows.index_select(0, last))
    state.v.index_copy_(0, dst, v_rows.index_select(0, last))
    return table, state


def sparse_adagrad_init(table: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(table)


@torch.no_grad()
def sparse_adagrad_update(table: torch.Tensor, accum: torch.Tensor,
                          ids: torch.Tensor, row_grads: torch.Tensor,
                          lr: float = 1e-2, eps: float = 1e-10
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sparse Adagrad (DGL's ``SparseAdagrad``) over ``ids`` (B,) with
    gradients ``row_grads`` (B, dim); ids as the module docstring says."""
    n = table.shape[0]
    wid, keep = _write_ids(ids, n)
    acc_rows = accum.index_select(0, _read_ids(ids, n)) + row_grads ** 2
    delta = lr * row_grads / (torch.sqrt(acc_rows) + eps)
    table.index_add_(0, wid[keep], -delta[keep])
    last = _last_of_each(wid, keep, n)
    accum.index_copy_(0, wid.index_select(0, last),
                      acc_rows.index_select(0, last))
    return table, accum
