"""``attn_roofline`` (%, Kernels): the hub attention's least time over its
device time, a step. The hub attention is K6 (forward), K7 (backward to
the sources, or its g-major mode) and K8 (the fold of K7's partial
destination gradients); its kernels are named below.

Least time, each launch at its layer's shape, from what the function
needs over the graph's hub rows (the destinations the program's hub
layout routes to K6, read from ``hub_dst["hub_ids"]``), each input read
once and each output written once, at the card's peaks
(``peaks.least_seconds``):

* forward, H heads of width F (rows of H F), R hub rows, S distinct
  sources among their E in-edges: reads a source id per edge (4 E), el
  and the feature row of each source (4 S (H F + H)) and er of each row
  (4 R H); writes each row's numerator, denominator and max (4 R (H F +
  2 H)); 2 H F + 8 H FLOPs an edge (logit, leaky_relu, exp, the
  weighted sum over H F features).
* backward: reads the ids, the sources' el and feature rows, and per row
  er, the log-normaliser, the output gradient's dot term and the output
  gradient (4 R (3 H + H F)); writes the sources' feature and el
  gradients (4 S (H F + H)) and the rows' er gradients (4 R H); 4 H F +
  12 H FLOPs an edge. K8's fold is the program's way to the er gradient,
  so its time counts against the backward's least time.

Nothing to read (``None``) without a hub layout, or when the stretch
launched K6 other than once a layer a step."""

from __future__ import annotations

import numpy as np

from gnnbench.peaks import least_seconds
from gnnbench.trace import kernel_id

ATTN_KERNELS = frozenset((
    "attn_max_kernel", "attn_fwd_kernel", "attn_fold_kernel",
    "attn_run_kernel", "attn_seg_kernel", "attn_segscan_kernel",
    "attn_segapply_kernel", "attn_init_kernel", "attn_bcast_kernel",
    "attn_bwd_src_kernel", "attn_bwd_grp_kernel", "attn_grp_fold_kernel",
    "ger_part_kernel", "ger_fold_kernel"))


def layer_shapes(cfg):
    out = []
    for i in range(cfg["num_layers"]):
        last = i == cfg["num_layers"] - 1
        out.append((cfg["out_heads"] if last else cfg["heads"],
                    cfg["out_feats"] if last else cfg["hidden_feats"]))
    return out


def least_step_seconds(n_edges, n_src, n_rows, shapes) -> float:
    """The hub attention's least seconds a step (every layer forward and
    backward) at E hub edges, S distinct sources and R hub rows."""
    total = 0.0
    for h, f in shapes:
        row = h * f
        fwd_bytes = 4.0 * (n_edges + n_src * (row + h) + n_rows * h
                           + n_rows * (row + 2 * h))
        bwd_bytes = 4.0 * (n_edges + n_src * (row + h)
                           + n_rows * (3 * h + row) + n_src * (row + h)
                           + n_rows * h)
        total += least_seconds(fwd_bytes, n_edges * (2.0 * row + 8 * h))
        total += least_seconds(bwd_bytes, n_edges * (4.0 * row + 12 * h))
    return total


def hub_counts(coo, graph):
    """(E, S, R) of the graph's hub rows, from the program's hub layout
    and the edge lists (self-loops included when the traffic adds them)."""
    hub = getattr(graph, "hub_dst", None)
    if not hub:
        return None
    n = coo["num_nodes"]
    ids = hub["hub_ids"].cpu().numpy().astype(np.int64)
    rows = np.unique(ids[(ids >= 0) & (ids < n)])
    src, dst = coo["src"], coo["dst"]
    if coo.get("self_loops"):
        src = np.concatenate([src, np.arange(n)])
        dst = np.concatenate([dst, np.arange(n)])
    is_row = np.zeros(n, dtype=bool)
    is_row[rows] = True
    keep = is_row[dst]
    return int(keep.sum()), int(np.unique(src[keep]).size), int(rows.size)


def read(ctx):
    s = ctx.stretch
    shapes = layer_shapes(ctx.cfg)
    if s.launches.get("attn_fwd", 0) != len(shapes) * s.steps:
        return None
    counts = hub_counts(ctx.coo, ctx.graph)
    spent = s.seconds_where(lambda n: kernel_id(n) in ATTN_KERNELS)
    if counts is None or spent <= 0:
        return None
    return 100.0 * least_step_seconds(*counts, shapes) * s.steps / spent
