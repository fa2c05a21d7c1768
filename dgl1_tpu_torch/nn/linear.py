"""Typed and heterogeneous linear layers (the port's
``dgl1_tpu/nn/linear.py``): ``TypedLinear``, ``HeteroLinear`` and
``HeteroEmbedding``."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import resolve_device
from dgl1_tpu_torch.nn.conv import _init_on, _xavier_uniform, dense
from dgl1_tpu_torch.ops.segment import gather_mm, segment_mm

__all__ = ["TypedLinear", "HeteroLinear", "HeteroEmbedding", "dense"]


class TypedLinear(nn.Module):
    """Per-type linear map ``y_i = x_i @ W[type_i]``, with ``W`` (T, in,
    out) per type or, under ``regularizer='basis'``, ``einsum('tb,bio->tio',
    coeff, basis)`` over ``num_bases`` shared bases. Rows sorted by type
    (``sorted_by_type=True``) take ``segment_mm``, one GEMM per type; any
    order takes ``gather_mm``. Parameters ``weight`` or ``basis`` and
    ``coeff``, as the reference names and shapes them (flax's
    xavier-uniform init)."""

    def __init__(self, in_size: int, out_size: int, num_types: int,
                 regularizer: Optional[str] = None, num_bases: int = 0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if regularizer not in (None, "basis"):
            raise ValueError(f"unsupported regularizer {regularizer!r}")
        dev = resolve_device(device)
        self.in_size, self.out_size = in_size, out_size
        self.num_types, self.regularizer = num_types, regularizer

        def param(*shape):
            return nn.Parameter(
                _xavier_uniform(shape, generator).to(dev))

        if regularizer == "basis":
            self.basis = param(num_bases, in_size, out_size)
            self.coeff = param(num_types, num_bases)
        else:
            self.weight = param(num_types, in_size, out_size)

    def _weights(self):
        if self.regularizer == "basis":
            return torch.einsum("tb,bio->tio", self.coeff, self.basis)
        return self.weight

    def forward(self, x, x_type, sorted_by_type: bool = False):
        w = self._weights()
        if sorted_by_type:
            counts = torch.bincount(torch.as_tensor(x_type).long(),
                                    minlength=self.num_types)
            return segment_mm(x, w, counts)
        return gather_mm(x, w, x_type)


class HeteroLinear(nn.Module):
    """A dense map per node type over a feature dict: ``in_sizes`` maps a
    type to its input width; types missing from the input are skipped.
    Submodules ``fc_<type>`` (``nn.Linear``, :func:`dense`), the
    reference's names."""

    def __init__(self, in_sizes: Dict[str, int], out_size: int,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.types = list(in_sizes)
        for t, n_in in in_sizes.items():
            setattr(self, f"fc_{t}", dense(n_in, out_size, bias, dev,
                                           generator))

    def forward(self, feat_dict: Dict[str, torch.Tensor]):
        return {t: getattr(self, f"fc_{t}")(feat_dict[t])
                for t in self.types if t in feat_dict}


class HeteroEmbedding(nn.Module):
    """An embedding table per node type (``num_embeddings`` maps a type to
    its size), rows drawn from a normal of std ``1/sqrt(dim)`` as flax's
    ``Embed`` draws them. Called with a dict of id tensors; types missing
    from it are skipped. Submodules ``emb_<type>`` (``nn.Embedding``),
    the reference's names."""

    def __init__(self, num_embeddings: Dict[str, int], embedding_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.types = list(num_embeddings)
        std = 1.0 / math.sqrt(embedding_dim)
        for t, n in num_embeddings.items():
            emb = nn.Embedding(n, embedding_dim, device=dev)
            with torch.no_grad():
                emb.weight.copy_(_init_on(
                    emb.weight.shape, generator,
                    lambda w: nn.init.normal_(w, std=std,
                                              generator=generator)))
            setattr(self, f"emb_{t}", emb)

    def forward(self, ids_dict: Dict[str, torch.Tensor]):
        return {t: getattr(self, f"emb_{t}")(ids_dict[t])
                for t in self.types if t in ids_dict}

    def weights(self) -> Dict[str, torch.Tensor]:
        """Each type's whole table (the features of every node)."""
        return {t: getattr(self, f"emb_{t}").weight for t in self.types}
