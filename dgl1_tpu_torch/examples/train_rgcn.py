"""R-GCN entity classification on AIFB-style data (the reference's
``examples/train_rgcn.py``). By default the typed aggregation runs one
projection and one g-SpMM per relation over static per-relation
subgraphs (``typed_subgraphs``); ``--grouped-gemm`` takes the edge-sorted
grouped-GEMM path (``segment_mm``); ``--identity`` the identity typed
layouts (``typed_subgraphs(identity=True)``). Usage:

    python -m dgl1_tpu_torch.examples.train_rgcn [--grouped-gemm]
        [--identity] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dgl1_tpu_torch.examples import (NO_GATE, Stepper, accuracy, masked_ce,
                                     run)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--num-bases", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--identity", action="store_true",
                   help="identity typed layouts: typed_subgraphs("
                        "identity=True) relabels the nodes hub-first and "
                        "pins every relation's hub layout to the shared "
                        "numbering")
    p.add_argument("--grouped-gemm", action="store_true",
                   help="per-edge grouped-GEMM path instead of the "
                        "per-relation g-SpMM path")
    return p.parse_args(argv)


def sorted_typed_graph(g, num_rels, device):
    """``g``'s edges sorted by relation (stable): the graph of the sorted
    edges, the relation of each edge and the edges of each relation."""
    import dgl1_tpu_torch as dgl

    e = g.num_edges()
    etypes = g.edata["etype"][:e].cpu().numpy()
    order = np.argsort(etypes, kind="stable")
    src = g.src[:e].cpu().numpy()[order]
    dst = g.dst[:e].cpu().numpy()[order]
    etypes = etypes[order]
    g2 = dgl.graph((src, dst), num_nodes=g.num_nodes(), device=device)
    counts = torch.as_tensor(np.bincount(etypes, minlength=num_rels)
                             .astype(np.int32), device=device)
    return g2, etypes, counts, (src, dst)


def build(args, device):
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import RGCN

    ds = dgl.data.AIFBDataset(device=device)
    g = ds[0]
    print(f"[data] aifb{'(synthetic)' if ds.is_synthetic else ''}: "
          f"{g.num_nodes()} nodes, {g.num_edges()} edges, "
          f"{ds.num_rels} relations")
    g2, etypes, counts, _ = sorted_typed_graph(g, ds.num_rels, device)
    labels = g.ndata["label"]
    train_mask, test_mask = g.ndata["train_mask"], g.ndata["test_mask"]
    if args.identity and not args.grouped_gemm:
        rel_graphs, perm = dgl.typed_subgraphs(g2, etypes, ds.num_rels,
                                               identity=True)
        n_ident = sum(1 for r in rel_graphs
                      if r.hub_dst_meta is not None
                      and r.hub_dst_meta.identity_expand)
        print(f"[identity] {n_ident}/{ds.num_rels} relations on the "
              f"identity layout")
        # Node-aligned data rides the hub-first relabel.
        pj = torch.as_tensor(perm, device=device)
        labels, train_mask, test_mask = (labels[pj], train_mask[pj],
                                         test_mask[pj])
    elif args.grouped_gemm:
        rel_graphs = None
    else:
        rel_graphs = dgl.typed_subgraphs(g2, etypes, ds.num_rels)
    num_classes = int(labels.max()) + 1
    model = RGCN(g.num_nodes(), args.hidden, num_classes, ds.num_rels,
                 num_bases=args.num_bases, device=device,
                 generator=torch.Generator().manual_seed(0))
    data = dict(g=g2, etypes=torch.as_tensor(etypes.astype(np.int64),
                                             device=device),
                counts=counts, rel_graphs=rel_graphs, labels=labels,
                train_mask=train_mask, test_mask=test_mask)
    return data, model


def logits(args, data, model):
    return model(data["g"], data["etypes"], presorted=args.grouped_gemm,
                 etype_counts=data["counts"],
                 rel_graphs=data["rel_graphs"])


def step_loss(args, data, model, batch=None):
    return masked_ce(logits(args, data, model), data["labels"],
                     data["train_mask"])


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    train_acc = test_acc = None
    for epoch in range(args.epochs):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 10 == 0 or epoch == 0:
            with torch.no_grad():
                pred = logits(args, data, model).argmax(dim=1)
            train_acc = accuracy(pred, data["labels"], data["train_mask"])
            test_acc = accuracy(pred, data["labels"], data["test_mask"])
            print(f"epoch {epoch + 1:3d} loss {loss:.4f} "
                  f"train {train_acc:.4f} test {test_acc:.4f}")
    print(f"done in {sum(st.step_ms) / 1e3:.1f}s")
    return st.metrics(train=train_acc, test=test_acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
