"""``HeteroGraphConv``: a module per relation, results combined per
destination type (the port's ``dgl1_tpu/nn/hetero.py``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dgl1_tpu_torch.utils.profiler import span

__all__ = ["HeteroGraphConv"]

_AGGREGATES = ("sum", "mean", "max", "min", "stack")


class HeteroGraphConv(nn.Module):
    """``mods`` maps an edge-type name to the module run on that relation
    (called as ``mod(rel_graph, feat, **mod_kwargs)``); results landing on
    one destination type are combined by ``aggregate``: ``sum``, ``mean``,
    ``max``, ``min`` (elementwise over the relations, in canonical order)
    or ``stack`` (a new axis 1). When the destination type has inputs the
    module gets the pair ``(inputs[srctype], inputs[dsttype][:num_dst])``:
    on a hetero block the destination nodes are the first rows of their
    type's source side. Each relation runs in a ``hetero.rel`` span
    (``src``, ``etype``, ``dst``). Parameters ``mods.<etype>.*``;
    :func:`dgl1_tpu_torch.params.from_jax_params` maps the reference's
    ``mods_<etype>`` onto them."""

    def __init__(self, mods: Dict[str, nn.Module], aggregate: str = "sum"):
        super().__init__()
        if aggregate not in _AGGREGATES:
            raise ValueError(f"unknown aggregate {aggregate!r}")
        self.mods = nn.ModuleDict(mods)
        self.aggregate = aggregate

    def forward(self, hg, inputs: Dict[str, torch.Tensor], mod_kwargs=None):
        mod_kwargs = mod_kwargs or {}
        per_dst: Dict[str, list] = {}
        for c in hg.canonical_etypes:
            srctype, etype, dsttype = c
            if etype not in self.mods or srctype not in inputs:
                continue
            rel = hg.rel_graphs[c]
            with span("hetero.rel", src=srctype, etype=etype, dst=dsttype):
                if dsttype in inputs:
                    feat = (inputs[srctype],
                            inputs[dsttype][: rel.num_dst_nodes()])
                else:
                    feat = inputs[srctype]
                out = self.mods[etype](rel, feat,
                                       **mod_kwargs.get(etype, {}))
            per_dst.setdefault(dsttype, []).append(out)
        results = {}
        for dsttype, outs in per_dst.items():
            if self.aggregate == "stack":
                results[dsttype] = torch.stack(outs, dim=1)
                continue
            v = outs[0]
            for w in outs[1:]:
                if self.aggregate in ("sum", "mean"):
                    v = v + w
                elif self.aggregate == "max":
                    v = torch.maximum(v, w)
                else:
                    v = torch.minimum(v, w)
            results[dsttype] = v / len(outs) if self.aggregate == "mean" \
                else v
        return results
