"""LGNN, the line-graph neural network for community detection (the
port's ``dgl1_tpu/models/lgnn.py``; Chen et al., supervised community
detection with line-graph GNNs).

Paired updates on a graph and its non-backtracking line graph, coupled
through the dense (N, 2E) incidence factor ``Pm+Pd``, with multi-scale
adjacency powers: each hop is a ``copy_lhs`` mean g-SpMM."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgl1_tpu_torch.graph import Graph, resolve_device
from dgl1_tpu_torch.nn.conv import _layer_norm, dense
from dgl1_tpu_torch.ops import gspmm

__all__ = ["LGNN", "LGNNLayer", "LGNNCore"]


class LGNNCore(nn.Module):
    """One half of an LGNN layer: ``theta_x`` of x, ``theta_deg`` of
    degree times x, ``theta_a{j}`` of the mean-normalised A^(2^j) hops
    (1, then 2, 4, ... more hops of the running product), ``theta_pmpd``
    of the partner graph's lifted signal, summed; the first half of the
    columns linear and the second through a ReLU, then the LayerNorm
    ``bn``. ``in_feats`` is x's width, ``partner_feats`` the lifted
    signal's."""

    def __init__(self, in_feats: int, partner_feats: int, out_feats: int,
                 radius: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.out_feats, self.radius = out_feats, radius

        def lin(n_in):
            return dense(n_in, out_feats, device=dev, generator=generator)

        self.theta_x = lin(in_feats)
        self.theta_deg = lin(in_feats)
        for j in range(radius):
            setattr(self, f"theta_a{j}", lin(in_feats))
        self.theta_pmpd = lin(partner_feats)
        self.bn = _layer_norm(out_feats, dev)

    def forward(self, g: Graph, x, pmpd_partner):
        result = self.theta_x(x)
        deg = g.in_degrees().to(x.dtype)[:, None]
        result = result + self.theta_deg(deg * x)
        ax = x
        for j in range(self.radius):
            for _ in range(2 ** j if j else 1):
                ax = gspmm(g, "copy_lhs", "mean", ax, None)
            result = result + getattr(self, f"theta_a{j}")(ax)
        result = result + self.theta_pmpd(pmpd_partner)
        half = self.out_feats // 2
        result = torch.cat([result[:, :half], torch.relu(result[:, half:])],
                           dim=1)
        return self.bn(result)


class LGNNLayer(nn.Module):
    """The coupled (graph, line graph) update: ``g_core`` lifts the line
    graph's signal with ``pm_pd @ y``, ``lg_core`` the graph's new signal
    with ``pm_pd.T @ next_x``."""

    def __init__(self, in_x: int, in_y: int, out_feats: int,
                 radius: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.g_core = LGNNCore(in_x, in_y, out_feats, radius, device,
                               generator)
        self.lg_core = LGNNCore(in_y, out_feats, out_feats, radius, device,
                                generator)

    def forward(self, g: Graph, lg: Graph, x, y, pm_pd):
        next_x = self.g_core(g, x, pm_pd @ y)
        next_y = self.lg_core(lg, y, pm_pd.t() @ next_x)
        return next_x, next_y


class LGNN(nn.Module):
    """``LGNN(hidden, communities)``: ``num_layers`` LGNN layers over the
    in-degrees of both graphs, then ``classify``, community logits a
    node. Forward: ``(g, lg, pm_pd)`` as ``SBMMixtureDataset`` gives
    them."""

    def __init__(self, hidden: int = 16, communities: int = 2,
                 num_layers: int = 3, radius: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [1] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            LGNNLayer(dims[i], dims[i], hidden, radius, dev, generator)
            for i in range(num_layers))
        self.classify = dense(hidden, communities, device=dev,
                              generator=generator)

    def forward(self, g: Graph, lg: Graph, pm_pd):
        # The degrees in pm_pd's float type (float32 from the dataset).
        x = g.in_degrees().to(pm_pd.dtype)[:, None]
        y = lg.in_degrees().to(pm_pd.dtype)[:, None]
        for layer in self.layers:
            x, y = layer(g, lg, x, y, pm_pd)
        return self.classify(x)
