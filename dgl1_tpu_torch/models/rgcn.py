"""R-GCN entity classification (the port's ``dgl1_tpu/models/rgcn.py``),
and the sampled heterograph R-GCN of ``examples/train_rgcn_sampled.py``."""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import RelGraphConv, _xavier_uniform
from dgl1_tpu_torch.utils.profiler import span

__all__ = ["RGCN", "HeteroRGCN"]


class RGCN(nn.Module):
    """``num_layers`` RelGraphConv layers (``layers.{i}``, the reference's
    ``layer{i}``), relu between them, basis regularised when
    ``num_bases > 0``. With ``in_feats`` None the model is featureless: a
    learned ``embed`` (num_nodes, hidden) stands in for the input, as in
    the reference. :meth:`forward` takes the reference's arguments and
    hands ``etypes``, ``presorted``, ``etype_counts``, ``rel_graphs`` and
    ``union_graph`` to every layer."""

    def __init__(self, num_nodes: int, hidden_feats: int, out_feats: int,
                 num_rels: int, num_bases: int = 0, num_layers: int = 2,
                 self_loop: bool = True, dropout: float = 0.0,
                 in_feats: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed = None
        if in_feats is None:
            self.embed = nn.Parameter(_xavier_uniform(
                (num_nodes, hidden_feats), generator).to(dev))
            in_feats = hidden_feats
        reg = "basis" if num_bases > 0 else None
        self.layers = nn.ModuleList(
            RelGraphConv(in_feats if i == 0 else hidden_feats,
                         out_feats if i == num_layers - 1 else hidden_feats,
                         num_rels, regularizer=reg, num_bases=num_bases,
                         self_loop=self_loop, dropout=dropout,
                         activation=torch.relu if i != num_layers - 1
                         else None, device=dev, generator=generator)
            for i in range(num_layers))

    def forward(self, g: Graph, etypes=None, feat=None, *,
                presorted: bool = False, etype_counts=None, rel_graphs=None,
                union_graph=None, generator=None):
        h = self.embed if feat is None else feat
        for layer in self.layers:
            h = layer(g, h, etypes, presorted=presorted,
                      etype_counts=etype_counts, rel_graphs=rel_graphs,
                      union_graph=union_graph, generator=generator)
        return h


class HeteroRGCN(nn.Module):
    """The sampled R-GCN of ``examples/train_rgcn_sampled.py`` on a
    heterograph: two ``HeteroGraphConv({etype: GraphConv})`` layers,
    ``l0`` (each relation from its source type's width, ``in_feats[st]``,
    to ``hidden_feats``) and ``l1`` (to ``out_feats``), relu between
    them, on the two blocks of a sampled batch. ``forward(blocks, x)``
    takes ``{ntype: input rows}`` and returns the logits of
    ``out_ntype``'s dst nodes; each layer runs in a ``model.layer`` span
    (``index``). :meth:`jax_state_dict` maps the example's flax
    parameters onto this module."""

    def __init__(self, canonical_etypes, in_feats: dict, hidden_feats: int,
                 out_feats: int, out_ntype: str = "paper", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from dgl1_tpu_torch.nn import GraphConv, HeteroGraphConv

        dev = resolve_device(device)
        self.out_ntype = out_ntype
        self.l0 = HeteroGraphConv({
            et: GraphConv(in_feats[st], hidden_feats, device=dev,
                          generator=generator)
            for st, et, _ in canonical_etypes})
        self.l1 = HeteroGraphConv({
            et: GraphConv(hidden_feats, out_feats, device=dev,
                          generator=generator)
            for _, et, _ in canonical_etypes})

    def forward(self, blocks, x: dict):
        with span("model.layer", index=0):
            h = {k: torch.relu(v) for k, v in self.l0(blocks[0], x).items()}
        with span("model.layer", index=1):
            return self.l1(blocks[1], h)[self.out_ntype]

    @staticmethod
    def jax_state_dict(params, canonical_etypes):
        """A ``state_dict`` from the example's flax tree. The example
        builds its ``GraphConv``s inside its own compact call, so flax
        names them ``GraphConv_{i}`` in the order built: ``l0``'s
        relations in canonical order, then ``l1``'s; the rest is
        :func:`dgl1_tpu_torch.params.from_jax_params`."""
        from dgl1_tpu_torch.params import from_jax_params

        etypes = [c[1] for c in canonical_etypes]
        out = OrderedDict()
        for name, value in from_jax_params(params).items():
            m = re.match(r"GraphConv_(\d+)\.(.+)$", name)
            if m is not None:
                layer, j = divmod(int(m.group(1)), len(etypes))
                name = f"l{layer}.mods.{etypes[j]}.{m.group(2)}"
            out[name] = value
        return out
