"""Explainability (the port's ``dgl1_tpu/nn/explain.py``):
``khop_in_subgraph`` and ``GNNExplainer``."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph

__all__ = ["GNNExplainer", "khop_in_subgraph"]


def khop_in_subgraph(g: Graph, node, k: int):
    """The ``k``-hop in-neighbourhood subgraph around ``node``
    (``dgl.khop_in_subgraph``): ``(subgraph, new_center_id)``, nodes in
    id order, the old ids in ``ndata['_ID']`` / ``edata['_ID']``. The
    hops are boolean masks over the host COO; the subgraph is placed on
    ``g``'s device."""
    from dgl1_tpu_torch.transform import _coo, node_subgraph

    src, dst = _coo(g)
    n = g.num_nodes()
    seen = np.zeros((n,), dtype=bool)
    seen[int(node)] = True
    frontier = seen.copy()
    for _ in range(k):
        reached = np.zeros((n,), dtype=bool)
        reached[src[frontier[dst]]] = True
        frontier = reached & ~seen
        if not frontier.any():
            break
        seen |= frontier
    nodes = np.nonzero(seen)[0]
    sg = node_subgraph(g, nodes)
    return sg, int(np.searchsorted(nodes, int(node)))


class GNNExplainer:
    """Soft edge and feature masks that keep the model's prediction
    (``explain/gnnexplainer.py``, "GNNExplainer: Generating Explanations
    for Graph Neural Networks").

    ``model_fn(graph, feat, eweight) -> logits``: the model multiplies its
    messages by ``eweight`` (E,), as ``GraphConv(edge_weight=)`` does. The
    masks (sigmoid of logits over the padded edge count and the feature
    width, drawn ``0.1 * randn`` from ``generator``, the CPU generator
    seeded 0 when None) are optimised by ``torch.optim.Adam`` for
    ``num_epochs`` steps of the reference's loss: the prediction's
    negative log-likelihood, ``alpha1`` times the edge mask's sum,
    ``alpha2`` its mean entropy, ``beta1`` the feature mask's mean and
    ``beta2`` its mean entropy. Only the masks get gradients."""

    def __init__(self, model_fn: Callable, num_hops: int, lr: float = 0.01,
                 num_epochs: int = 100, alpha1: float = 0.005,
                 alpha2: float = 1.0, beta1: float = 1.0,
                 beta2: float = 0.1):
        self.model_fn = model_fn
        self.num_hops = num_hops
        self.lr = lr
        self.num_epochs = num_epochs
        self.alpha1, self.alpha2 = alpha1, alpha2
        self.beta1, self.beta2 = beta1, beta2

    @staticmethod
    def initial_masks(num_edges: int, num_feats: int,
                      generator: Optional[torch.Generator] = None):
        """The starting mask logits ``(edge (E,), feat (1, F))``, drawn on
        the generator's device."""
        gen = generator or torch.Generator().manual_seed(0)
        em = 0.1 * torch.randn(num_edges, generator=gen, device=gen.device)
        fm = 0.1 * torch.randn(1, num_feats, generator=gen,
                               device=gen.device)
        return em, fm

    def _loss(self, g, feat, target_fn, em_logit, fm_logit):
        em = torch.sigmoid(em_logit)
        fm = torch.sigmoid(fm_logit)
        pred_loss = target_fn(self.model_fn(g, feat * fm, em))
        eps = 1e-15
        ent_e = -(em * torch.log(em + eps)
                  + (1 - em) * torch.log(1 - em + eps)).mean()
        ent_f = -(fm * torch.log(fm + eps)
                  + (1 - fm) * torch.log(1 - fm + eps)).mean()
        return (pred_loss + self.alpha1 * em.sum() + self.alpha2 * ent_e
                + self.beta1 * fm.mean() + self.beta2 * ent_f)

    def _optimize(self, g, feat, target_fn, generator):
        em0, fm0 = self.initial_masks(g.num_edges_padded(), feat.shape[-1],
                                      generator)
        params = [m.to(feat.device, feat.dtype).requires_grad_(True)
                  for m in (em0, fm0)]
        opt = torch.optim.Adam(params, lr=self.lr)
        with torch.enable_grad():
            for _ in range(self.num_epochs):
                loss = self._loss(g, feat, target_fn, *params)
                grads = torch.autograd.grad(loss, params)
                for p, gr in zip(params, grads):
                    p.grad = gr
                opt.step()
        em, fm = (torch.sigmoid(p.detach()) for p in params)
        return fm[0], em

    def _base_target(self, g, feat, pick):
        ones = torch.ones(g.num_edges_padded(), device=feat.device,
                          dtype=feat.dtype)
        with torch.no_grad():
            return int(pick(self.model_fn(g, feat, ones)).argmax())

    def explain_node(self, node_id, g: Graph, feat,
                     generator: Optional[torch.Generator] = None):
        """``(new_center, subgraph, feat_mask (F,), edge_mask (E,))`` for
        the ``num_hops`` in-subgraph around ``node_id``."""
        sg, center = khop_in_subgraph(g, node_id, self.num_hops)
        sub_feat = feat.index_select(
            0, sg.ndata["_ID"].to(feat.device).long())
        target = self._base_target(sg, sub_feat, lambda o: o[center])

        def target_fn(logits):
            return -torch.log_softmax(logits[center], dim=-1)[target]

        fm, em = self._optimize(sg, sub_feat, target_fn, generator)
        return center, sg, fm, em[: sg.num_edges()]

    def explain_graph(self, g: Graph, feat,
                      generator: Optional[torch.Generator] = None):
        """Masks that keep a graph-level prediction: ``model_fn``'s output
        on the whole graph, flattened, is the class scores. Returns
        ``(feat_mask (F,), edge_mask (E,))``."""
        target = self._base_target(g, feat, lambda o: o.reshape(-1))

        def target_fn(logits):
            return -torch.log_softmax(logits.reshape(-1), dim=0)[target]

        fm, em = self._optimize(g, feat, target_fn, generator)
        return fm, em[: g.num_edges()]
