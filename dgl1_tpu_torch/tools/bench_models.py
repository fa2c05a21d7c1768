"""Model-level benchmark of the port: full-graph train-step time for GCN,
GAT and R-GCN (the port's ``tools/bench_models.py``).

    python -m dgl1_tpu_torch.tools.bench_models [--scale cora|pubmed|arxiv]
        [--model gcn|gat|rgcn|all] [--epochs 20] [--precision f32|bf16]
        [--fwd-only] [--huborder] [--union] [--device cuda|cpu]

The same flags, scales and models as the reference: cora is
``rand_graph(2708, 10832)``, pubmed ``powerlaw_graph(19717, 5)`` and arxiv
``powerlaw_graph(169343, 26)``, each with ``add_self_loop``; GCN hidden
256 at arxiv and 64 elsewhere, GAT ``hidden // 8`` x 8 heads at arxiv (8 x
8 elsewhere) with dropout 0, R-GCN 128 -> 64 -> 40 with 4 bases over 8
relations drawn by ``default_rng(0)`` on ``powerlaw_graph(169343, 26)``;
Adam 1e-2, softmax cross-entropy over every node. ``--precision bf16``
sets the kernels' matmul mode (``ops.set_matmul_precision``).
``--huborder`` relabels the GCN/GAT graph hub-first (``reorder_graph(g,
'hub')``); for R-GCN it takes the identity relation layouts
(``typed_subgraphs(identity=True)``) in place of the plain per-relation
subgraphs, and ``--union`` the relation-stacked union block
(``typed_union_graph``, ``RelGraphConv(union_graph=)``); both assert
that every layout claims ``identity_expand``, as the reference does.
Features and labels are random, so the relabels' ``perm`` is not
applied.

Timing: one warm-up step (it builds and loads the kernels; its seconds
are ``compile_s``), then ``epochs`` steps between two device syncs (a
host clock on the CPU). Prints one JSON line per model with the
reference's keys, ``backend`` the device type. Runs on ``cuda`` unless
given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

__all__ = ["make_graph", "bench", "main"]

def make_graph(scale: str, device=None):
    """(graph, nodes, input features, classes) of a scale, with
    self-loops added."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.data import powerlaw_graph

    if scale == "cora":
        n, deg, in_f, classes = 2708, 4, 1433, 7
        g = dgl.rand_graph(n, n * deg, seed=0, device=device)
    elif scale == "pubmed":
        n, deg, in_f, classes = 19717, 5, 500, 3
        g = powerlaw_graph(n, deg, seed=0, device=device)
    elif scale == "arxiv":
        n, deg, in_f, classes = 169343, 26, 128, 40
        g = powerlaw_graph(n, deg, seed=0, device=device)
    else:
        raise ValueError(f"unknown scale {scale!r}")
    return dgl.add_self_loop(g), n, in_f, classes


def rgcn_graphs(device=None, num_rels: int = 8, huborder: bool = False,
                union: bool = False, nodes: int = 169343):
    """The typed graph of ``--model rgcn`` (no self-loops) and what its
    path runs on: the per-relation subgraphs, the identity relation
    layouts (``huborder``) or the union block (``union``). ``nodes`` sizes
    the graph (the arxiv shape by default)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.data import typed_powerlaw_graph

    g, etypes = typed_powerlaw_graph(nodes, 26, num_rels, seed=0,
                                     device=device)
    if union:
        gu, _ = dgl.typed_union_graph(g, etypes, num_rels)
        assert gu.hub_dst_meta.identity_expand
        return g, gu
    if huborder:
        rel, _ = dgl.typed_subgraphs(g, etypes, num_rels, identity=True)
        assert all(gr.hub_dst_meta.identity_expand for gr in rel)
        return g, rel
    return g, dgl.typed_subgraphs(g, etypes, num_rels)


def bench(model_name: str, scale: str, epochs: int = 20,
          fwd_only: bool = False, huborder: bool = False,
          union: bool = False, device=None, graph=None):
    """Time ``epochs`` steps of one model after a warm-up step and print
    the reference's JSON line. ``graph``: a prebuilt graph of the scale
    (GCN, GAT) or ``(typed graph, relation graphs)`` (R-GCN), else built
    here; for R-GCN the second item is the union block under ``union``
    (:func:`rgcn_graphs`). Returns the printed record with ``losses`` (one
    per step, warm-up first), ``steps`` and ``peak_mem_gb`` (None on the
    CPU)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import GAT, GCN, RGCN

    dev = dgl.resolve_device(device)
    kw = {}
    if model_name == "rgcn":
        in_f, classes, num_rels = 128, 40, 8
        g, typed = graph if graph is not None else rgcn_graphs(
            dev, num_rels, huborder=huborder, union=union)
        n = g.num_nodes()
        kw = {"union_graph" if union else "rel_graphs": typed}
    elif model_name in ("gcn", "gat"):
        if graph is None:
            g, n, in_f, classes = make_graph(scale, dev)
        else:
            g = graph
            n, in_f, classes = {"cora": (2708, 1433, 7),
                                "pubmed": (19717, 500, 3),
                                "arxiv": (169343, 128, 40)}[scale]
            if g.num_nodes() != n:
                raise ValueError(f"the {scale} graph has {n} nodes, not "
                                 f"{g.num_nodes()}")
        if huborder and g.hub_dst is not None:
            g = dgl.reorder_graph(g, node_permute_algo="hub")
            assert g.hub_dst_meta.identity_expand
    else:
        raise ValueError(f"unknown model {model_name!r}")
    hidden = 256 if scale == "arxiv" else 64

    init = torch.Generator().manual_seed(2)
    if model_name == "gcn":
        model = GCN(in_f, hidden, classes, dropout=0.0, device=dev,
                    generator=init)
    elif model_name == "rgcn":
        model = RGCN(n, 64, classes, num_rels, num_bases=4, in_feats=in_f,
                     device=dev, generator=init)
    else:
        model = GAT(in_f, hidden // 8 if scale == "arxiv" else 8, classes,
                    heads=8, feat_drop=0.0, attn_drop=0.0, device=dev,
                    generator=init)
    feat = torch.randn(n, in_f, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    labels = torch.randint(0, classes, (n,), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []

    def step():
        if fwd_only:
            with torch.no_grad():
                loss = F.cross_entropy(model(g, feat=feat, **kw), labels)
        else:
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(g, feat=feat, **kw), labels)
            loss.backward()
            opt.step()
        losses.append(loss.detach())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model.train()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    step()
    sync()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(epochs):
        step()
    sync()
    dt = (time.perf_counter() - t0) / max(epochs, 1)

    rec = {
        "model": model_name + ("+union" if union and model_name == "rgcn"
                               else "")
        + ("+identity" if huborder and model_name == "rgcn" else ""),
        "scale": scale, "nodes": n,
        "edges": g.num_edges(), "hidden": hidden,
        "ms_per_epoch": dt * 1e3, "epochs_per_s": 1.0 / dt,
        "compile_s": compile_s, "backend": dev.type,
    }
    print(json.dumps(rec), flush=True)
    return dict(rec, losses=[float(x) for x in losses],
                steps=1 + epochs,
                peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else None))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="arxiv",
                   choices=["cora", "pubmed", "arxiv"])
    p.add_argument("--model", default="all",
                   choices=["gcn", "gat", "rgcn", "all"])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                   help="operand precision of the hand-written kernels "
                        "(ops/precision.py)")
    p.add_argument("--fwd-only", action="store_true",
                   help="time the forward pass only (no grad/adam)")
    p.add_argument("--huborder", action="store_true",
                   help="hub_order-relabel the GCN/GAT graph first; "
                        "rgcn: the identity relation layouts")
    p.add_argument("--union", action="store_true",
                   help="rgcn only: one g-SpMM over the relation-stacked "
                        "union block (typed_union_graph)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from dgl1_tpu_torch.ops import set_matmul_precision

    set_matmul_precision(args.precision)
    models = ["gcn", "gat"] if args.model == "all" else [args.model]
    for name in models:
        bench(name, args.scale, args.epochs, args.fwd_only,
              huborder=args.huborder, union=args.union, device=args.device)


if __name__ == "__main__":
    main()
