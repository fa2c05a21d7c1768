"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and imports ``dgl1_tpu_torch`` only (no JAX,
nothing of ``dgl1_tpu``). Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build the CUDA kernels from
   ``dgl1_tpu_torch/csrc`` (one nvcc per source, started together) and
   print the build time; the native host library must load (else the
   sampled phases would leave the fused sampler);
2. the R-GCN graphs of tools/bench_models.py --model rgcn
   (``powerlaw_graph(169343, 26)``, 8 relations per edge from
   ``default_rng(0)``, the relation-sorted copy and the 8 per-relation
   subgraphs); each hub kernel (K1 dense_fwd, K2 chunk_sum, K3 expand,
   K4a dense_bwd_fused, K4b dense_bwd) on the card at the arxiv
   trainer's shapes (K2 and K4b on a mixed-tier layout at 10^5 nodes
   whose four chunked groups hold about a third of the edges) against
   its float64 plain version, with every other width and layout the
   trainers give it as ``variants`` (GCN layer 2, the weighted GCN's
   in-degree sum, the per-relation R-GCN's relation-0 subgraph at F=64
   and 40, K3 after the grouped R-GCN's copy_e, and K3 at a row of 37
   floats; the arxiv shapes again with the diagonal epilogue their path
   gives K3, timed beside the unfused pair it replaces, and the R-GCN
   shapes with it checked only, as ``epilogue_checked``); then each attention
   kernel (K6 attn_fwd, K7 attn_bwd_src, K7 g-major attn_bwd_grp, K8
   ger_reduce) at arxiv layer 1's shapes (H=8, D=32, one group of 5,292
   chunks), with the same kernels at dropout 0.6, at layer 2 (H=1, D=40)
   and on the mixed graph (five groups) as each row's ``variants``; every
   kernel held against its plain torch version; one JSON line per kernel
   with its error, time (``ms``: launches back to back on a held stream,
   the device's time; ``host_paced_ms``: calls as the host issues them,
   which paces kernels shorter than their wrapper), bound (the bytes and
   operations this run's data needs), plain time and a library call's
   time (or why there is none).
   Every bf16 instantiation (the bf16 matmul mode, ``ops/precision.py``)
   is held against its float64 plain version in bf16 mode, the f32
   kernel's output must fail the same check, and the two must differ
   somewhere (see FLIP_SHARE): K1, K4a, K6 and K7, which the bf16
   trainers launch, as rows ``<name>.bf16`` at every shape those trainers
   give them; K2 (plain, mul, rhs), K4b, K5, K11 and K7 g-major (at
   dropout 0 and 0.6, and layer 2) as ``variants`` marked
   ``"bf16": true`` at their f32 row's main shape;
3. g-SpMM copy_u+sum forward and backward on bench.py's workload
   (``powerlaw_graph(2^19, 8)`` after the hub relabel, F=128) and on the
   mixed-tier graph, against the oracle engine; then ``gat_attention``
   forward and backward (H=8, D=32) on the arxiv and mixed graphs against
   the composed g-SDDMM -> edge_softmax -> u_mul_e path on the oracle
   engine; edges/s;
3b. the weighted hub ops (phases 2d and 3c): K2 mul (weighted-GCN layer
   1: arxiv ``full_fwd``, F=128, one weight per edge), K2 rhs (R-GCN layer
   1 on the sorted graph, he=64), K5 mul (F=128) and K5 rhs (he=64)
   against float64 plain versions, with the weighted GCN's layer 2 (F=40,
   ``full_fwd`` and ``full_bwd``) and in-degree sum (rhs he=1), R-GCN
   layer 2 (he=40), the GAT shape (he=8, rep=32) and the mixed graph as
   ``variants``; u_mul_e
   and copy_e through the hub engine against the oracle at arxiv
   (forward, grad_u, grad_e); the composed GAT chain on the hub engine
   against the fused attention;
4. the trainers at the arxiv configuration of tools/bench_models.py
   (169,343 nodes, ``add_self_loop(powerlaw_graph(., 26))``, Adam 1e-2):
   GCN 128 -> 256 -> 40 for 5 steps (K1, K3, K4a) and 3 on the mixed
   graph (K2, K4b); then the GAT trainer, 128 -> 8 x 32 -> 40 with
   dropout 0: logits against the composed path, 5 steps (K6, K7, K8), 3
   on the mixed graph, and 2 at the model's default dropout 0.6
   (in-kernel attention dropout); then the edge-weighted GCN
   (``EdgeWeightedGCN``: ``EdgeWeightNorm('both')`` of sigmoid(theta),
   theta a learnable parameter of the model: K2 mul
   3, K5 mul 2, K2 rhs 1, K5 rhs 1 per step, exactly). Losses finite (and
   falling without dropout), the launch counters of each path's kernels
   above zero; ms/step and peak memory. Then the g-major route: the arxiv
   GAT trainer on the layout with gperm/gout/gfirst removed from
   ``full_bwd`` (step-0 grads of every parameter against the normal
   route's within 1e-4 relative; 3 steps with exactly K7 g-major 2, K6 2,
   K7 2 and K8 0 per step). Then the port of tools/bench_models.py
   (``dgl1_tpu_torch.tools.bench_models.bench``) for GCN and GAT at arxiv
   on the arxiv graph above, 5 timed epochs after a warm-up step, in f32
   and in bf16: exact launches (the trainer runs' per step, bf16
   instantiations only in bf16), step-0 losses within 2e-2, ms per epoch
   and peak memory; then ``torch.profiler`` traces of 3 arxiv GAT steps
   and 3 arxiv GCN steps (device busy time, idle share, top kernels);
4g. link prediction (examples/train_link_pred.py) on a host copy of the
   arxiv graph: ``EdgeDataLoader`` over every edge (batch 512,
   ``negative_sampler.Uniform(1)``, ``exclude='self'``,
   ``NeighborSampler([10, 10], static_shapes=False)``: ELL-only blocks),
   GraphSAGE mean 128 -> 64 -> 64, ``u_dot_v`` scores, binary
   cross-entropy, Adam 1e-3, 5 steps (host sampling ms per batch, ms per
   step, launches recorded); then ``layerwise_inference`` over all nodes
   against the same model's full-graph forward on the oracle engine, each
   output within 1e-4 of its float64 abs sum (seconds, launches);
4c. R-GCN at configuration #4's shape (128 -> 64 ->
   40, 8 relations, 4 bases, Adam 1e-2): 5 steps on the per-relation path
   (K1, K3, K4a per relation, no weighted kernel) and 5 on the
   grouped-GEMM path (K2 rhs and K5 rhs 2 per step exactly; step-0 logits
   against the per-relation path and the oracle); bench_models' R-GCN in
   f32 and bf16 on the same graphs (as for GCN and GAT above); then a
   profile of 3 grouped steps;
4e. typed graphs and heterographs: the R-GCN typed graph's identity
   relation layouts (``typed_subgraphs(identity=True)``) and union block
   (``typed_union_graph``, 8 x 169,343 sources), each asserted to claim
   ``identity_expand`` (build seconds); K1 and K4a at relation 0's
   identity layout and at the union block's dense tier (F=64) against
   their float64 plain versions, as variants of the K1 and K4a rows;
   ``bench_models``' R-GCN with ``--huborder`` and with ``--union`` in
   f32 (5 epochs after the warm-up step; step-0 logits against the
   per-relation path through ``perm``, each within 1e-4 of its float64
   abs sum; no K3 and no weighted kernel,
   K1 and K4 launched; ms per epoch, launches per step); then
   configuration #4 at ogbn-mag's shape, ``synthetic_mag_heterograph
   (scale=1)`` (build seconds, edges and the auto engine of each of the
   7 relations), trained by ``HeteroEmbedding`` (128) and two
   ``HeteroGraphConv({etype: GraphConv(norm='right')})`` layers 128 -> 64
   -> 349 for 5 Adam steps (1e-2) on the train split's paper labels
   (step-0 paper logits against the oracle engine; ms per step, peak
   memory, launches per step, then a profile of 2 steps: device busy
   time, idle share, top device operations); then HAN at ACM's shape
   (3,025 papers, 5,835 authors, 56 subjects, 9,744 paper-author links,
   1,870 features; PAP and PSP metapath graphs; 1,870 -> 8 x 8 -> 3,
   dropout 0.6, Adam 5e-3, 5 steps): step-0 logits at dropout 0 against
   the composed path on the oracle engine in float64, the GATConv path
   of each metapath graph, launches (K6, K7 and K8 where a metapath
   graph takes the fused attention);
4f. the sampled R-GCN of examples/train_rgcn_sampled.py on the host copy
   of the mag graph (built once there, copied to the card for 4e):
   ``NeighborSampler([{e: 10}, {e: 10}])`` over all 7 relations (the
   numpy sampler), batch 512, 2 workers, paper features from a
   ``HostFeatureStore`` through ``pull_features``, ``HeteroRGCN`` 128 ->
   64 -> 349 over ``NodeEmbedding`` tables of 64 (sparse Adam 5e-2, Adam
   1e-2): step-0 paper logits against the oracle engine to 1e-4 of each
   logit's float64 abs sum, a warm-up step, 5 steps with K9 exactly once
   a relation whose backward runs (relations with no dst node counted
   apart: they launch nothing), ms per step, host sampling and pull ms
   per batch, then a profile of 3 steps;
5. sampled GraphSAGE at the Reddit
   configuration of tools/bench_minibatch.py (--scale reddit: 232,965
   nodes, 114,615,892 edges, F=602, 41 classes, fanouts [10, 25], batch
   1024, hidden 256, dropout 0.5, Adam 1e-3; parent graph on the host,
   features on the card): the graph's build seconds; K9 (tile_sum) at
   block 1's reverse tiles (F=256) and K10 (tile_minmax) at block 0's
   forward tiles (F=602) of a real sampled batch in gather mode (source
   rows read through the layout's index, as the copy ops run them),
   against their plain versions (K9 in float64 within the tolerance
   below, K10 exactly), with the pool step's other shapes, min, and
   message mode (a row per slot, as the binary ops run them) at each
   row's shape and block 1's forward tiles as ``variants``, each with
   its library call; the mean trainer for 5
   steps from the 2-worker loader (logits at step 0 against the oracle
   engine, launches K9 1 and every other kernel 0 per step, losses
   finite, then 5 steps on the first batch repeated whose losses fall;
   host sampling ms per batch, device step ms, peak memory); the pool
   trainer for 3 steps (K10 2 and K9 4 per step); the lstm trainer
   (``SAGEConv('lstm')``, an LSTM over each uniform ELL bucket) for 3
   steps, no kernel; ``torch.profiler``
   traces of 3 mean and 3 pool steps on batches sampled beforehand, the
   pool one with its peak memory;
4d. the block-dense slice on hub-free geometric graphs (bench.py's
   "geometric" family): ``geometric_graph(2^20, 8)`` and ``(2^17, 8)`` with
   ``formats=(..., "bdense")`` (build seconds, blocks, coverage, tail),
   and the RCM route (the 2^17 graph's ids shuffled by
   ``default_rng(1).permutation``, then ``reorder_graph(..., 'rcm')``,
   coverage at least 95%); K11 (block_fwd at GCN layer 1, 2^20 nodes,
   F=128; block_bwd at layer 2's backward, F=40) against its float64 plain
   version, with the other direction and width, bench.py's matrix (2^17
   nodes, F=32/128/512) and the RCM graph as ``variants``, the library
   call ``torch.sparse.mm`` on a CSR of the counts, and the MMA work the
   kernel does (occupied 16 x 16 sub-tiles x planes x 2 x 16 x 16 x F,
   F rounded up to 8) beside the dense work; copy_u sum and mean
   through "auto" (forward, grad_u) against the oracle, only K11
   launching; the RCM graph's aggregate against the oracle through
   ``ndata['_ID']``; the GCN trainer (128 -> 256 -> 40, 5 steps: K11
   forward 2 and transpose 1 per step exactly, nothing else), the GAT
   trainer (128 -> 8 x 32 -> 40, 3 steps at dropout 0 through
   ``bdense_gat_attention``, 2 calls per step and no kernel; 1 step at
   0.6 on the composed chain); ``torch.profiler`` traces of 3 GCN steps
   and 1 GAT step;
4h. the distributed layer (``dgl1_tpu_torch/parallel``): one card and one
   NCCL rank a device, so ``parallel.initialize`` at world size 1 over
   NCCL (backend and world size printed); the dry run's legs 1-7 and 11
   (``tools/dryrun_multichip.py``) at the reference's sizes, one JSON
   line each; the flagship combined + prefilled identity sharded GCN
   (BASELINE configuration #5's trainer at P = 1) on the arxiv graph,
   128 -> 256 -> 40, Adam 1e-2, 5 steps: step-0 logits within 1e-4 of
   each logit's float64 abs sum against the float64 oracle, exact hub
   launches a step, ms a step and a 2-step profile (device busy and idle
   share); the data-parallel sampled GraphSAGE at the Reddit
   configuration through ``DistGraph`` and ``DistNodeDataLoader`` (3
   steps, K9 once a step, host sampling ms a batch); then 4-part builds of
   leg 1's graph with tiles, leg 3's vertex cut, leg 5's hub layouts (with
   and without the identity relabel) and leg 7's block-dense one
   (partitioner and build seconds), each partition's local reduce (F =
   128) and, on leg 5's identity layouts, the fused attention (H = 8, D =
   32) run on the card in turn with the halo rows filled on the host,
   every partition's result held against the same call on the CPU (the
   kernels' plain versions) and the assembled rows and gradients against
   the float64 oracle; and each kernel at partition 0's shapes against
   its float64 plain version, timed, as variants of its row;
4i. the typed distributed layer (``parallel/hetero.py``), at world size 1
   over NCCL (initialized before it): phase 4c's typed graph made a
   one-ntype heterograph by ``to_heterogeneous`` and built at P = 1 with
   ``hub=True, hub_identity=True`` (every relation must claim
   ``identity_expand``; host seconds), dry run leg 9's model 128 -> 64 ->
   40 with per-relation and self weights, Adam 1e-2, 5 steps (step-0
   logits within 1e-4 of each logit's float64 abs sum against the float64
   oracle; exact hub launches a step and no K3; ms a step, a 2-step
   profile; K1, K4a and K2 both ways at relation 0's layout, F = 64 and
   40, as variants); then on the host mag graph (``scale=1``) built with
   ``tiles=True`` at P = 1 (partitioner and build seconds): leg 9's model
   at phase 4e's widths (paper features through ``w_in`` 128 -> 128,
   embeddings of 128 for the other types, 128 -> 64 -> 349, Adam 1e-2, 3
   steps; step-0 paper logits against the float64 oracle; K9 exactly:
   forward once a relation with a tile and layer, reverse once a relation
   whose output reaches the loss; a 2-step profile), the typed attention
   (H = 2, D = 8) forward and gradient on the same build, K9 at the cites
   relation's tiles as variants; then a 4-part greedy build of the
   scale-40 mag graph with tiles (partitioner and build seconds), each
   partition's local reduce of every relation (F = 64) forward and
   gradient on the card in turn with the halo rows filled on the host,
   each against the same call on the CPU and the assembled rows and
   gradients against the float64 oracle, K9 at partition 0's cites tiles
   as variants. Dry run legs 8-10 run with the others in 4h;
4j. the message-passing front end (``function/``, ``core.py``): after
   phase 4's GCN, the 2-layer GCN written through ``g.update_all(
   fn.copy_u('h', 'm'), fn.sum('m', 'h'))`` on the arxiv graph, 128 -> 256
   -> 40, sharing a ``models.GCN``'s weights (step-0 logits within 1e-4 of
   each logit's float64 abs sum of that model's; 5 steps with exactly
   phase 4's GCN launches a step); and one call of each builtin pair with
   its backward, each held against the same call on a CPU copy of the
   graph, launches counted: ``u_mul_e`` sum on the arxiv graph (K2 mul,
   K5 mul), a UDF reduce on its ELL plan and ``apply_edges(u_dot_v)`` (no
   kernel), ``copy_e`` sum on the R-GCN's sorted graph (K2 rhs, K5 rhs,
   in 4c), ``multi_update_all`` on the mag heterograph (ELL, no kernel,
   in 4e), ``copy_u`` max and sum on a sampled Reddit block (K10, K9, in
   5) and ``copy_u`` sum on the 2^17 geometric block-dense graph (K11
   both ways, in 4d);
4k. the graph-level layer and the convs, each model's weights
   a reference-layout parameter tree built in numpy from a seed and
   carried by ``params.from_jax_params``: after phase 4g, on the arxiv
   graph, examples/train_citation_zoo.py's APPNP (128 -> 64 -> 40,
   dropout 0.5, ``APPNPConv(k=10, alpha=0.1)``) and examples/train_gcn2.py's
   GCNII (16 ``GCN2Conv`` layers, hidden 64, alpha 0.1, lambda 0.5), 5
   Adam steps each at 1e-2: step-0 logits within 1e-4 of each logit's
   float64 abs sum against the float64 oracle engine, exactly 10 (16)
   hub propagations a step forward and backward (one ``copy_lhs`` sum
   g-SpMM's launches counted first), a 2-step APPNP profile; each conv
   with a graph forward and backward at in 128, out 64 (4 heads of 16)
   against its float64 oracle run (float32 for a conv with a kink before
   its first g-SpMM) within 1e-3 of each tensor's largest
   magnitude, launches and engine recorded (``ChebConv`` with
   ``laplacian_lambda_max`` of the arxiv graph, host seconds; GINConv also
   on the mixed graph: K2, K4b); the dense convs on a 4,096-node
   adjacency; DGI (hidden 128, 3 steps at 1e-3, step-0 embeddings against
   the float64 oracle); ``save_graphs``/``load_graphs`` of the arxiv graph
   with features (seconds, equal arrays); GIN graph classification (5
   layers, hidden 64, sum readout) over ``GraphDataLoader(batch_size=32,
   pad=True)`` on seeded power-law graphs of 200-800 nodes, 5 steps
   (step-0 logits against the float64 oracle, each batch's engine, host
   ms a batch against ms a step, a 2-step profile); DGCNN's EdgeConv at
   ModelNet40's shape (32 clouds of 1,024 points, ``KNNGraph(k=20)`` on
   the card, 3 -> 64, a 2-step profile); HGTConv on ``to_homogeneous``
   of the mag graph at scale 8; K1, K3, K4a at F = 64, K2 mul, K5 mul
   at 4 heads of 16, K2 rhs, K5 rhs at he = 4 and K10 at F = 4 on the
   arxiv forward tiles as variants of their rows. In phase 5, GATv2Conv
   (K9), EdgeConv and PNA max/min (K10) on a sampled Reddit block; in
   4d, GINConv sum on the 2^17 geometric graph (K11 both ways, and at F
   = 64 as variants);
4l. the rest of the single-device surface, after 4k: GNNExplainer on
   the arxiv GCN (``models.GCN(128, 256, 40)``, ``edge_weight`` to both
   layers; 100 mask epochs at lr 0.01): the masks after 3 epochs against
   the float64 oracle run, ``explain_graph`` launching exactly K2 mul 4,
   K5 mul 2 and K3 (with the diagonal) 2 a mask epoch plus one forward,
   ms a mask epoch, a 3-epoch profile, and ``explain_node`` (2 hops) at
   the highest and a median in-degree node (subgraph size, engine,
   launches); K2 mul's grad_u at F = 128 and K5 mul at F = 40 as
   variants; ``RedditDataset(full_scale=True)``'s synthetic fallback
   (232,965 nodes, F = 602, 41 classes; build and cache seconds), then
   GraphSAINT (walk mode, 2,000 roots of length 4, 8 batches) and
   Cluster-GCN (1,500 parts from a two-level greedy partition, 20 a
   batch, 10 steps) training ``models.GCN(602, 128, 41)``: pre-sampling
   and partition seconds, host ms a batch, ms a step, engines, launches,
   step-0 logits against the float64 oracle; then LGNN, the Tree-LSTM
   (both cells, eager and compiled), PinSAGE sampling and
   ``farthest_point_sampler`` (32 x 1,024 points to 512) at their
   examples' sizes against their CPU runs;
6. the ``{"kernels": [...]}`` line: ``launches_by_path`` holds each
   trainer run's count and ``launches`` their sum (every kernel above
   zero), then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present
or when the package is not beside this script.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# CUDA-core FLOP/s. Every kernel's function is float32 arithmetic (K11
# reaches it through exact bf16 tensor-core products, see below).
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
# Dense bf16 tensor-core FLOP/s (same data sheet): the rate of K11's MMAs.
BF16_TC_FLOPS = 989e12
# Elementwise tolerance of a kernel against its plain version: the sums
# run in another order (and K1/K2 add with atomics, in an order that
# changes between runs), so |kernel - plain| <= RTOL * (|A| |B|) + ATOL,
# with |A| |B| the same product over absolute values.
RTOL, ATOL = 1e-4, 1e-6
# The bf16 mode (ops/precision.py) rounds operands to bfloat16 in the
# kernel and in its float64 plain version alike, so a bf16 instantiation
# is held to RTOL like its float32 one. Where the rounded values include
# exp values (K6, K7), the kernel takes exp in float32 and the plain
# version in float64; where the two straddle a bfloat16 rounding boundary
# they round to neighbours one bf16 ulp apart (at most 2^-7 of the value),
# a product of it rounded again can take a second ulp and K6's rescale a
# third. Such a flip stays within RTOL of its row's sum over absolute
# values unless the row has few terms. Those checks therefore let at most
# FLIP_SHARE of an output's elements past RTOL, each within BF16_FLIPS of
# that sum. Every bf16 check has a negative control: the float32 kernel's
# output, held to the same check against the same bf16 plain version,
# must fail it wherever it differs from the bf16 output, so a kernel that
# rounds nothing, or not where the plain version does, fails. Both counts
# are in each bf16 row (``past_rtol``, ``past_rtol_f32``). A bf16
# instantiation must also differ from its float32 one by more than
# BF16_LIVE relative somewhere.
FLIP_SHARE = 1e-3
BF16_FLIPS = 3 * 2.0 ** -7
BF16_LIVE = 1e-4

_HUB_SRC, _HUB_REF = ("dgl1_tpu_torch/csrc/hub_kernels.cu",
                      "dgl1_tpu/ops/engine_hub.py")
_ATT_SRC, _ATT_REF = ("dgl1_tpu_torch/csrc/attn_kernels.cu",
                      "dgl1_tpu/ops/attention.py")
_TILE_SRC, _TILE_REF = ("dgl1_tpu_torch/csrc/tile_kernels.cu",
                        "dgl1_tpu/ops/engine_pallas.py")
_BD_SRC, _BD_REF = ("dgl1_tpu_torch/csrc/bdense_kernels.cu",
                    "dgl1_tpu/ops/engine_bdense.py")
# name -> (id, source in this repository, TPU kernel it replaces)
KERNEL_INFO = {
    "dense_fwd": ("K1", _HUB_SRC, f"{_HUB_REF}:170"),
    "chunk_sum": ("K2", _HUB_SRC, f"{_HUB_REF}:68"),
    "expand": ("K3", _HUB_SRC, f"{_HUB_REF}:303"),
    "dense_bwd_fused": ("K4a", _HUB_SRC, f"{_HUB_REF}:215"),
    "dense_bwd": ("K4b", _HUB_SRC, f"{_HUB_REF}:270"),
    "attn_fwd": ("K6", _ATT_SRC, f"{_ATT_REF}:152"),
    "attn_bwd_src": ("K7", _ATT_SRC, f"{_ATT_REF}:307"),
    "attn_bwd_grp": ("K7 g-major", _ATT_SRC, f"{_ATT_REF}:307"),
    "ger_reduce": ("K8", _ATT_SRC, f"{_ATT_REF}:612"),
    "tile_sum": ("K9", _TILE_SRC, f"{_TILE_REF}:54"),
    "tile_minmax": ("K10", _TILE_SRC, f"{_TILE_REF}:75"),
    "chunk_mul": ("K2 mul", _HUB_SRC, f"{_HUB_REF}:68"),
    "chunk_rhs": ("K2 rhs", _HUB_SRC, f"{_HUB_REF}:68"),
    "edge_grad_mul": ("K5 mul", _HUB_SRC, f"{_HUB_REF}:364"),
    "edge_grad_rhs": ("K5 rhs", _HUB_SRC, f"{_HUB_REF}:364"),
    "block_fwd": ("K11", _BD_SRC, f"{_BD_REF}:42"),
    "block_bwd": ("K11 transpose", _BD_SRC, f"{_BD_REF}:42"),
}
WEIGHTED = ("chunk_mul", "chunk_rhs", "edge_grad_mul", "edge_grad_rhs")


def log(*a):
    print(*a, flush=True)


# Cycles of the sleep kernel that holds the stream while the host enqueues
# a timed loop (about 20 ms at the H100's clock).
HOLD_CYCLES = 40_000_000


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    warm L2). A sleep kernel holds the stream while the host enqueues the
    loop, so the launches run back to back and the events time the device
    alone; without it a kernel shorter than its wrapper's host time (tens
    of microseconds) is timed at the host's pace (:func:`host_paced_ms`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_paced_ms(fn, iters=20, warmup=3):
    """``fn``'s time per call as the host issues it: CUDA events around
    ``iters`` calls on an idle stream, so a kernel that takes less device
    time than its wrapper's host work is timed at the host's pace (the
    ``host_paced_ms`` of each row)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, flops):
    t_b = bytes_moved / HBM_BPS * 1e3
    t_o = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _shape_finite(name, out, ref, scale):
    torch.cuda.synchronize()
    out, ref, scale = out.detach(), ref.detach(), scale.detach()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    return out, ref, scale


def check(name, out, ref, scale):
    out, ref, scale = _shape_finite(name, out, ref, scale)
    err = (out - ref).abs()
    tol = RTOL * scale + ATOL
    if not bool((err <= tol).all()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: err "
            f"{err.reshape(-1)[i].item()} > tol {tol.reshape(-1)[i].item()}")
    return float(err.max())


def check_bf16(name, out, ref, scale, f32_out, flips):
    """A bf16 output against its plain version in the bf16 mode: within
    RTOL, or with ``flips`` all but FLIP_SHARE of its elements within RTOL
    and those within BF16_FLIPS (see FLIP_SHARE); and, where the float32
    kernel's output differs from it, that output must fail the same check.
    Returns (max abs err, elements past RTOL, the float32 output's)."""
    out, ref, scale = _shape_finite(name, out, ref, scale)
    tol = RTOL * scale + ATOL
    allowed = int(FLIP_SHARE * out.numel()) if flips else 0
    cap = tol + (BF16_FLIPS * scale if flips else 0.0)
    err = (out - ref).abs()
    n_past = int((err > tol).sum())
    if n_past > allowed or not bool((err <= cap).all()):
        i = int((err / cap).argmax())
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: {n_past} "
            f"elements past RTOL (at most {allowed}); err "
            f"{err.reshape(-1)[i].item()} against tol "
            f"{tol.reshape(-1)[i].item()}")
    n_f32 = int(((f32_out.detach() - ref).abs() > tol).sum())
    if not torch.equal(f32_out, out) and n_f32 <= allowed:
        raise AssertionError(
            f"{name}: the float32 kernel's output passes the bf16 check "
            f"({n_f32} elements past RTOL, at most {allowed}): the check "
            f"does not see the mode's rounding")
    return float(err.max()), n_past, n_f32


def phase_build():
    from dgl1_tpu_torch import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    secs = time.perf_counter() - t0
    for name, (_, out) in cuda_build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or (
                    "spill" in line and "0 bytes spill stores" not in line):
                log(f"  ptxas {name}: {line.strip()}")
    log(json.dumps({"phase": "build", "seconds": round(secs, 3),
                    "sources": [str(p.relative_to(HERE)) for p in
                                cuda_build.SOURCES.values()]}))
    for name in cuda_build.SOURCES:
        cuda_build.load(name)


def arxiv_graph(dev):
    import dgl1_tpu_torch as dgl

    return dgl.add_self_loop(dgl.data.powerlaw_graph(169343, 26, seed=0,
                                                     device=dev))


def mixed_graph(dev):
    """Mixed-tier layout at 10^5 nodes, as tests/test_hub.py's "mixed"
    config at scale: ``powerlaw_graph(10^5, 26)``, 512 mid hubs with 4000
    uniform in-edges each, and 10^5 uniform edges. With a group floor of
    10^5 edges and a dense floor of 10^6, group 0 is dense and the next
    four groups are chunked (about a third of all edges). The tail's
    source side (64k rows) is too large for the fused backward's gate, so
    K2 and K4b run."""
    import dgl1_tpu_torch as dgl

    n, n_mid, mid_deg = 100_000, 4 * 128, 4000
    rng = np.random.default_rng(5)
    base = dgl.data.powerlaw_graph(n, 26, seed=1, hub=False, device="cpu")
    s0, d0 = (t.numpy() for t in base.edges())
    d1 = np.repeat(np.arange(1000, 1000 + n_mid), mid_deg)
    s1 = rng.integers(0, n, d1.size)
    s2, d2 = rng.integers(0, n, n), rng.integers(0, n, n)
    g = dgl.graph((np.concatenate([s0, s1, s2]),
                   np.concatenate([d0, d1, d2])), num_nodes=n,
                  hub=100_000, hub_dense_floor=1_000_000, device=dev)
    m = g.hub_dst_meta
    assert m.n_dense == 1 and m.n_groups - m.n_dense >= 3, m
    return g


def chunked_share(g):
    """Edges on the chunked tier (real forward slots) over all edges."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    _, _, valid = K._chunk_rows(g.hub_dst["part_fwd"])
    return int(valid.sum()) / g.num_edges()


def kernel_row(name, out, ref, scale, fn, plain, library, bytes_moved,
               flops, shapes, library_note=None, plain_iters=20,
               exact=False, f32_out=None, flips=False, more=None):
    """Check one kernel against its plain version and time both. ``out``,
    ``ref`` and ``scale`` may be tuples (one entry per output). ``exact``:
    the outputs must be equal element for element (infinities included)
    and ``scale`` is unused. ``f32_out``: the float32 instantiation's
    output when ``out`` is the bf16 one (the row is then ``name.bf16``,
    checked by :func:`check_bf16`); ``flips``: its outputs include rounded
    exp values (FLIP_SHARE). ``more``: further keys of the row."""
    bf16 = f32_out is not None
    if not isinstance(out, tuple):
        out, ref, scale = (out,), (ref,), (scale,)
        f32_out = (f32_out,) if bf16 else None
    extra = {}
    if bf16:
        torch.cuda.synchronize()
        if not any(bool(((o - f).abs() > BF16_LIVE * f.abs()).any())
                   for o, f in zip(out, f32_out)):
            raise AssertionError(f"{name}.bf16: no output differs from "
                                 f"the float32 kernel's")
        res = [check_bf16(f"{name}.bf16[{i}]", *a, flips)
               for i, a in enumerate(zip(out, ref, scale, f32_out))]
        err = max(r[0] for r in res)
        extra = {"past_rtol": [r[1] for r in res],
                 "past_rtol_f32": [r[2] for r in res]}
    elif exact:
        torch.cuda.synchronize()
        for i, (o, r) in enumerate(zip(out, ref)):
            if not torch.equal(o, r):
                raise AssertionError(f"{name}[{i}]: kernel differs from its "
                                     f"plain version")
        err = 0.0
    else:
        err = max(check(f"{name}[{i}]", o, r, s)
                  for i, (o, r, s) in enumerate(zip(out, ref, scale)))
    ms = cuda_ms(fn)
    paced_ms = host_paced_ms(fn)
    plain_ms = cuda_ms(plain, iters=plain_iters,
                       warmup=min(3, plain_iters))
    lib_ms = cuda_ms(library) if library is not None else None
    b_ms, b_by = bound(bytes_moved, flops)
    tag, src, replaces = KERNEL_INFO[name]
    row = {"name": f"{name}.bf16" if bf16 else name,
           "id": f"{tag} bf16" if bf16 else tag, "route": "cuda",
           "source": src, "replaces": replaces, "launches": 0,
           "max_abs_err": err, "ms": ms, "host_paced_ms": paced_ms,
           "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "bytes": int(bytes_moved), "flops": int(flops),
           "tolerance": ("max abs difference 0" if exact else
                         f"|err| <= {RTOL} * |A||B| + {ATOL}"
                         + (f" but for at most {FLIP_SHARE} of the elements"
                            f" (each <= {BF16_FLIPS} * |A||B| more); the "
                            f"float32 kernel must fail it" if flips and bf16
                            else "; the float32 kernel must fail it"
                            if bf16 else "")),
           "bf16": bf16, "shapes": shapes, "ok": True, **extra,
           **(more or {})}
    if library_note:
        row["library_note"] = library_note
    log(json.dumps(row))
    return row


VARIANT_KEYS = ("bf16", "max_abs_err", "ms", "host_paced_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "bytes", "flops",
                "shapes", "past_rtol", "past_rtol_f32", "epilogue",
                "unfused_ms", "slot_bound_ms")


def with_variants(row, variants):
    """``row`` with the other shapes its kernel runs at on the trainer
    paths, each checked and timed as the row (library calls on the row's
    case and the variants that ask for one, else null)."""
    row["variants"] = [{k: v[k] for k in VARIANT_KEYS if k in v}
                       for v in variants]
    return row


def dense_fwd_case(case, g, dev, f, seed=0, library=True, bf16=False):
    """K1 on ``g``'s count matrix at width f against its float64 plain
    version (with ``bf16``, both in the bf16 mode). Bytes: C, the rows of U
    that a nonzero of C needs, and the output, once."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    kern = functools.partial(K.dense_fwd, bf16=bf16)
    plain = functools.partial(K.dense_fwd_torch, bf16=bf16)

    gen = torch.Generator(device=dev).manual_seed(seed)
    c, n = g.hub_dst["dense_c"], g.num_src_nodes()
    kd = c.shape[1]
    # Rows of U the product needs: those whose row of C is not all zero.
    u_rows = int((c[:n] != 0).any(dim=1).sum())
    u = torch.randn(n, f, device=dev, generator=gen)
    lib = None
    if library:
        cf = c[:n].float().t()
        lib = lambda: torch.mm(cf, u)  # noqa: E731
    return kernel_row(
        "dense_fwd", kern(c, u), plain(c, u.double()),
        plain(c, u.abs().double()),
        lambda: kern(c, u), lambda: plain(c, u), lib,
        nbytes(c) + u_rows * f * 4 + kd * f * 4,
        2 * int((c != 0).sum()) * f,
        {"case": case, "c": list(c.shape), "c_dtype": str(c.dtype),
         "u": [n, f], "u_rows_needed": u_rows},
        f32_out=K.dense_fwd(c, u) if bf16 else None)


def expand_case(case, g, dev, f, seed=0, library=True, epilogue=None,
                timed=True):
    """K3 at width f on ``g``'s merged block ``[tail stack | hub block]``
    (the tail stack of a random U, a random hub block of the layout's
    groups) against its float64 plain version. ``epilogue``: the diagonal
    in K3's output pass, "u" as copy_lhs and u_mul_e give it (a weight a
    row, the graph's diagonal where it has one, times U's row) or "w" as
    copy_e gives it (f weights a row, alone); its bytes count U's rows and
    the weights, and ``unfused_ms`` times what it replaces: K3 without it,
    then the engine's torch passes. Without ``timed`` the kernel is only
    checked, and the case and its error are returned."""
    from dgl1_tpu_torch.ops import hub_kernels as K
    from dgl1_tpu_torch.ops.engine_ell import ell_stack

    gen = torch.Generator(device=dev).manual_seed(seed)
    hub, m, n = g.hub_dst, g.hub_dst_meta, g.num_nodes()
    u = torch.randn(n, f, device=dev, generator=gen)
    stacked = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid"],
                        "copy_lhs", "sum", u, None)
    hub_block = torch.randn(m.n_groups * 128, f, device=dev, generator=gen)
    merged = torch.cat([stacked, hub_block], dim=0).contiguous()
    del stacked, hub_block
    xs, xd = hub["x_starts"], hub["x_desc"]
    diag, diag_bytes, more = (), 0, {}
    if epilogue == "u":
        w = (hub["diag"][:, None] if m.has_diag else
             torch.randn(n, 1, device=dev, generator=gen))
        diag, diag_bytes = (w, u), nbytes(w, u)
        unfused = lambda: K.expand(merged, xs, xd, n) + w * u  # noqa: E731
    elif epilogue == "w":
        w = torch.randn(n, f, device=dev, generator=gen)
        diag, diag_bytes = (w,), nbytes(w)
        unfused = lambda: K.expand(merged, xs, xd, n) + w  # noqa: E731
    if epilogue and timed:
        more = {"epilogue": epilogue, "unfused_ms": cuda_ms(unfused)}
    del u
    d64 = tuple(x.double() for x in diag)
    ref = K.expand_torch(merged.double(), xs, xd, n, *d64)
    scale = K.expand_torch(merged.double().abs(), xs, xd, n,
                           *(x.abs() for x in d64))
    del d64
    if not timed:
        err = check(f"expand[{case}]", K.expand(merged, xs, xd, n, *diag),
                    ref, scale)
        return {"case": case, "epilogue": epilogue, "max_abs_err": err}
    lib = None
    if library:
        t_inv = hub["t_inv"].long()
        idx_z = torch.where(t_inv < merged.shape[0], t_inv,
                            torch.full_like(t_inv, merged.shape[0]))
        merged_z = torch.cat([merged, merged.new_zeros(1, f)])
        lib = lambda: torch.index_select(merged_z, 0, idx_z)  # noqa: E731
    n_desc = int(xs[-(-n // 512)])
    return kernel_row(
        "expand", K.expand(merged, xs, xd, n, *diag), ref, scale,
        lambda: K.expand(merged, xs, xd, n, *diag),
        lambda: K.expand_torch(merged, xs, xd, n, *diag), lib,
        nbytes(merged) + 4 * (n_desc + -(-n // 512) + 1) + n * f * 4
        + diag_bytes, 0,
        {"case": case, "merged": list(merged.shape), "num_dst": n},
        more=more)


def dense_bwd_fused_case(case, g, dev, f, seed=0, library=True,
                         bf16=False):
    """K4a at width f on ``g``'s count matrix and tail-src stack against
    its float64 plain version (with ``bf16``, both in the bf16 mode)."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    kern = functools.partial(K.dense_bwd_fused, bf16=bf16)
    plain = functools.partial(K.dense_bwd_fused_torch, bf16=bf16)
    from dgl1_tpu_torch.ops.engine_ell import ell_stack

    gen = torch.Generator(device=dev).manual_seed(seed)
    hub, m, n = g.hub_dst, g.hub_dst_meta, g.num_src_nodes()
    c = hub["dense_c"]
    kd = c.shape[1]
    if not hub["gb_desc"].shape[0]:
        raise AssertionError(f"dense_bwd_fused[{case}]: the layout has no "
                             f"fused-backward descriptors")
    ct = torch.randn(kd, f, device=dev, generator=gen)
    ct_full = torch.randn(g.num_dst_nodes(), f, device=dev, generator=gen)
    tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                     "copy_lhs", "sum", ct_full, None).contiguous()
    del ct_full
    gs, gd = hub["gb_starts"], hub["gb_desc"]
    lib = None
    if library:
        cf = c[:n].float()
        lib = lambda: torch.mm(cf, ct)  # noqa: E731
    n_gdesc = int(gs[c.shape[0] // 1024])
    return kernel_row(
        "dense_bwd_fused", kern(c, ct, tail, gs, gd, n),
        plain(c, ct.double(), tail.double(), gs, gd, n),
        plain(c, ct.abs().double(), tail.abs().double(), gs, gd, n),
        lambda: kern(c, ct, tail, gs, gd, n),
        lambda: plain(c, ct, tail, gs, gd, n), lib,
        c[:n].numel() * c.element_size() + nbytes(ct, tail)
        + 4 * (n_gdesc + c.shape[0] // 1024 + 1) + n * f * 4,
        2 * int((c[:n] != 0).sum()) * f + n_gdesc * f,
        {"case": case, "c": list(c.shape), "ct": [kd, f],
         "tail": list(tail.shape), "n_out": n},
        f32_out=K.dense_bwd_fused(c, ct, tail, gs, gd, n) if bf16 else None)


def phase_kernels(dev, g_arx, g_mix, g_rel0, g_sorted):
    """K1, K3 and K4a at the arxiv GCN's layer-1 (K1, K3) and layer-2 (K4a)
    widths, each against its float64 plain version, with the other shapes
    the trainers give them as ``variants``: GCN layer 2 (F=40) and the
    weighted GCN's in-degree sum (F=1) on arxiv; the per-relation R-GCN's
    relation-0 subgraph at F=64 and F=40 (layer 1 and 2 projected first);
    K3 after the grouped R-GCN's copy_e (he=64, 40) on the
    relation-sorted graph; K1 on the mixed-tier layout. Then K2 and K4b
    on the mixed-tier layout at F=128, with the mixed GCN's F=40 (K2
    forward and its window-major grad_u, K4b) as ``variants``. The bf16
    instantiations: K1 and K4a, which the bf16 trainers launch, as rows
    of their own at every shape those trainers give them (GCN layers 1
    and 2, the R-GCN relation subgraph at F=64 and F=40); K2 and K4b as
    variants at their row's main shape."""

    def variants(case_fn, cases, library=(), **kw):
        return [case_fn(c, g, dev, f, *more, seed=i + 1,
                        library=c in library, **kw)
                for i, (c, g, f, *more) in enumerate(cases)]

    bf = dict(seed=9, library=False, bf16=True)
    # K3's shapes: GCN layer 2, the weighted GCN's in-degree sum, the
    # per-relation R-GCN, the grouped R-GCN's copy_e, a row of 37 floats.
    k3 = [("arxiv_f40", g_arx, 40), ("arxiv_f1", g_arx, 1),
          ("rgcn_rel0_f64", g_rel0, 64), ("rgcn_rel0_f40", g_rel0, 40),
          ("rgcn_sorted_he64", g_sorted, 64),
          ("rgcn_sorted_he40", g_sorted, 40), ("arxiv_f37", g_arx, 37)]
    # The diagonal epilogue, timed where a path gives K3 one: the arxiv
    # GCN's copy_lhs at both layers, the weighted GCN's copy_e in-degree
    # sum, and the tail path. The R-GCN graphs have no extracted self-loop,
    # so their shapes are only checked with it.
    k3_diag = [("arxiv_f128", g_arx, 128, "u"), ("arxiv_f40", g_arx, 40, "u"),
               ("arxiv_f1", g_arx, 1, "w"), ("arxiv_f37", g_arx, 37, "u")]
    k3_checked = [("rgcn_rel0_f64", g_rel0, 64, "u"),
                  ("rgcn_rel0_f40", g_rel0, 40, "u"),
                  ("rgcn_sorted_he64", g_sorted, 64, "w"),
                  ("rgcn_sorted_he40", g_sorted, 40, "w")]
    rows = [
        with_variants(dense_fwd_case("arxiv_f128", g_arx, dev, 128),
                      variants(dense_fwd_case, [
                          ("arxiv_f40", g_arx, 40),
                          ("rgcn_rel0_f64", g_rel0, 64),
                          ("rgcn_rel0_f40", g_rel0, 40),
                          ("mixed_f128", g_mix, 128),
                          ("mixed_f40", g_mix, 40)],
                          library=("arxiv_f40",))),
        with_variants(dense_fwd_case("arxiv_f128", g_arx, dev, 128, **bf),
                      variants(dense_fwd_case, [
                          ("arxiv_f40", g_arx, 40),
                          ("rgcn_rel0_f64", g_rel0, 64),
                          ("rgcn_rel0_f40", g_rel0, 40)], bf16=True)),
        with_variants(dense_bwd_fused_case("arxiv_f40", g_arx, dev, 40, **bf),
                      variants(dense_bwd_fused_case, [
                          ("rgcn_rel0_f64", g_rel0, 64),
                          ("rgcn_rel0_f40", g_rel0, 40)], bf16=True)),
        with_variants(expand_case("arxiv_f128", g_arx, dev, 128),
                      variants(expand_case, k3)
                      + [expand_case(c + "_diag", g, dev, f, seed=20 + i,
                                     library=False, epilogue=e)
                         for i, (c, g, f, e) in enumerate(k3_diag)]),
        with_variants(dense_bwd_fused_case("arxiv_f40", g_arx, dev, 40),
                      variants(dense_bwd_fused_case, [
                          ("rgcn_rel0_f64", g_rel0, 64),
                          ("rgcn_rel0_f40", g_rel0, 40)])),
        with_variants(chunk_sum_case("mixed_f128", g_mix, dev, 128),
                      variants(chunk_sum_case, [
                          ("mixed_f40", g_mix, 40),
                          ("mixed_grad_u_f40", g_mix, 40, True)],
                          library=("mixed_f40",))
                      + [chunk_sum_case("mixed_f128", g_mix, dev, 128,
                                        **bf)]),
        with_variants(dense_bwd_case("mixed_f128", g_mix, dev, 128),
                      variants(dense_bwd_case, [("mixed_f40", g_mix, 40)])
                      + [dense_bwd_case("mixed_f128", g_mix, dev, 128,
                                        **bf)]),
    ]
    k3_row = next(r for r in rows if r["name"] == "expand")
    k3_row["epilogue_checked"] = [
        expand_case(c + "_diag", g, dev, f, seed=30 + i, epilogue=e,
                    timed=False)
        for i, (c, g, f, e) in enumerate(k3_checked)]
    return {r["name"]: r for r in rows}


def chunk_sum_case(case, g, dev, f, bwd=False, seed=0, library=True,
                   bf16=False):
    """K2 (plain mode) at width f over ``g``'s chunked tier: ``part_fwd``
    (the forward), or with ``bwd`` the window-major ``part_bwd`` (grad_u:
    the chunked groups' cotangent rows into source windows), against its
    float64 plain version (with ``bf16``, both in the bf16 mode)."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    kern = functools.partial(K.chunk_sum, bf16=bf16)
    plain = functools.partial(K.chunk_sum_torch, bf16=bf16)

    gen = torch.Generator(device=dev).manual_seed(seed)
    m = g.hub_dst_meta
    lay = g.hub_dst["part_bwd" if bwd else "part_fwd"]
    n_chunked = (m.n_groups - m.n_dense) * 128
    n_in = n_chunked if bwd else g.num_nodes()
    n_out_b = m.n_win if bwd else m.n_groups - m.n_dense
    u = torch.randn(n_in, f, device=dev, generator=gen)
    rows_in, rows_out, valid = K._chunk_rows(lay)
    valid = valid & (rows_in < n_in)
    n_real = int(valid.sum())
    # Input rows the real slots gather, each read once.
    n_in_rows = int(torch.unique(rows_in[valid]).numel())
    lib = None
    if library:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # sparse CSR is a beta feature
            s_mat = torch.sparse_coo_tensor(
                torch.stack([rows_out[valid], rows_in[valid]]),
                torch.ones(n_real, device=dev), (n_out_b * 128, n_in),
                check_invariants=False).coalesce().to_sparse_csr()
        lib = lambda: torch.sparse.mm(s_mat, u)  # noqa: E731
    return kernel_row(
        "chunk_sum", kern(lay, u, n_out_b),
        plain(lay, u.double(), n_out_b),
        plain(lay, u.abs().double(), n_out_b),
        lambda: kern(lay, u, n_out_b),
        lambda: plain(lay, u, n_out_b), lib,
        nbytes(lay["a"], lay["b"], lay["in_id"], lay["out_id"])
        + n_in_rows * f * 4 + n_out_b * 128 * f * 4, n_real * f,
        {"case": case, "layout": "part_bwd" if bwd else "part_fwd",
         "chunks": int(lay["in_id"].shape[0]),
         "slots": int(lay["a"].shape[0]), "real_slots": n_real,
         "input_rows_gathered": n_in_rows,
         "chunked_edge_share": chunked_share(g),
         "inp": [n_in, f], "out_blocks": n_out_b},
        f32_out=K.chunk_sum(lay, u, n_out_b) if bf16 else None)


def dense_bwd_case(case, g, dev, f, seed=0, library=True, bf16=False):
    """K4b at width f on ``g``'s count matrix against its float64 plain
    version (with ``bf16``, both in the bf16 mode)."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    kern = functools.partial(K.dense_bwd, bf16=bf16)
    plain = functools.partial(K.dense_bwd_torch, bf16=bf16)

    gen = torch.Generator(device=dev).manual_seed(seed)
    c, n = g.hub_dst["dense_c"], g.num_nodes()
    ct = torch.randn(c.shape[1], f, device=dev, generator=gen)
    lib = None
    if library:
        cf = c[:n].float()
        lib = lambda: torch.mm(cf, ct)  # noqa: E731
    return kernel_row(
        "dense_bwd", kern(c, ct, n), plain(c, ct.double(), n),
        plain(c, ct.abs().double(), n),
        lambda: kern(c, ct, n), lambda: plain(c, ct, n),
        lib, c[:n].numel() * c.element_size() + nbytes(ct) + n * f * 4,
        2 * int((c[:n] != 0).sum()) * f,
        {"case": case, "c": list(c.shape), "c_dtype": str(c.dtype),
         "ct": list(ct.shape), "n_out": n},
        f32_out=K.dense_bwd(c, ct, n) if bf16 else None)


SLOPE = 0.2
NO_LIBRARY = ("no single PyTorch call computes this function: the fused "
              "softmax-weighted aggregation over a hub chunk layout")


def f64(args):
    """The float tensors of ``args`` in float64 (layouts pass through)."""
    return tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def attn_case(case, g, dev, h, d, drop, plain_iters=3, library=True,
              bf16=False):
    """K6, K7 (both modes) and K8 on the card against their plain versions
    at one layer's shapes; one row per kernel. Inputs are random from a
    fixed seed; K7's lse is K6's own softmax log-normaliser of the hub
    rows, so its coefficients have the sizes training gives them. With
    ``bf16`` the kernels and their plain versions run in the bf16 mode
    (rows ``<name>.bf16``; K8 has none).

    The plain version that a kernel is held against runs in float64 on
    the same inputs: an arxiv hub row sums ~10^5 terms, and float32
    ``index_add_`` (one atomic after another into one address) drops every
    term below half an ulp of a sum of ~5*10^4 (0.4% of den); the kernels
    sum blocks of slots first. ``plain_ms`` times it in float32."""
    from dgl1_tpu_torch.ops import attn_kernels as AK
    from dgl1_tpu_torch.ops import hub_kernels as K
    from dgl1_tpu_torch.ops.engine_xla import take_fill

    gen = torch.Generator(device=dev).manual_seed(11)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, f, gr = g.num_nodes(), h * d, m.n_groups * 128
    lf, lb = hub["full_fwd"], hub["full_bwd"]
    el = torch.randn(n, h, device=dev, generator=gen)
    er = torch.randn(n, h, device=dev, generator=gen)
    ft = torch.randn(n, f, device=dev, generator=gen)
    er_g = take_fill(er, hub["hub_ids"]).contiguous()
    seed = torch.tensor([20260501], dtype=torch.int32, device=dev)
    drop_bytes = lambda lay: nbytes(lay["eid"]) if drop > 0 else 0
    shapes = {"case": case, "h": h, "d": d, "drop": drop,
              "chunks": int(lf["in_id"].shape[0]),
              "slots": int(lf["a"].shape[0]), "groups": m.n_groups,
              "windows": m.n_win}
    bf = {"bf16": True} if bf16 else {}
    sfx = ".bf16" if bf16 else ""
    rows = {}

    def row(name, fn, plain, args, abs_args, bytes_moved, flops, shp,
            scale_fix=None):
        out = fn(*args, **bf)
        ref = plain(*f64(args), **bf)
        sc = plain(*f64(abs_args), **bf)
        if scale_fix is not None:
            sc = scale_fix(sc, ref)
        rows[name + sfx] = kernel_row(
            name, out, ref, sc, lambda: fn(*args, **bf),
            lambda: plain(*args, **bf), None, bytes_moved + nbytes(*(
                out if isinstance(out, tuple) else (out,))), flops, shp,
            NO_LIBRARY, plain_iters, f32_out=fn(*args) if bf16 else None,
            flips=True)
        return out

    # K6.
    fa = (lf, el, er_g, ft, h, d, SLOPE, drop, seed, m.n_groups)
    rows_in, _, valid = K._chunk_rows(lf)
    n_real = int(valid.sum())
    src_rows = int(torch.unique(rows_in[valid]).numel())
    shapes.update(real_slots=n_real, source_rows=src_rows)
    num, den, mraw = row(
        "attn_fwd", AK.attn_fwd, AK.attn_fwd_torch, fa,
        (lf, el, er_g, ft.abs()) + fa[4:],
        nbytes(lf["a"], lf["b"], lf["in_id"], lf["out_id"]) + drop_bytes(lf)
        + src_rows * (h + f) * 4 + nbytes(er_g), n_real * (2 * f + 8 * h),
        dict(shapes),
        scale_fix=lambda sc, ref: (sc[0], ref[1], torch.zeros_like(ref[2])))

    # K7 (to_src=True). Sums over absolute values bound each output's
    # terms: |ft|, |ct| and -|rho| make every term of g, q and acoef * ct
    # non-negative.
    lse_g = (torch.nn.functional.leaky_relu(er_g + mraw, SLOPE)
             + torch.log(den.clamp_min(1e-30))).contiguous()
    rho_g = torch.randn(gr, h, device=dev, generator=gen)
    ct_g = torch.randn(gr, f, device=dev, generator=gen)
    group = (er_g, lse_g, rho_g)
    abs_group = (er_g, lse_g, -rho_g.abs())
    tail = (h, d, SLOPE, drop, seed)
    _, rows_w, valid_b = K._chunk_rows(lb)
    win_rows = int(torch.unique(rows_w[valid_b]).numel())
    out = row("attn_bwd_src", AK.attn_bwd_src, AK.attn_bwd_src_torch,
              (lb, el, *group, ft, ct_g, *tail, m.n_win),
              (lb, el, *abs_group, ft.abs(), ct_g.abs(), *tail, m.n_win),
              nbytes(lb["a"], lb["b"], lb["in_id"], lb["out_id"])
              + drop_bytes(lb) + win_rows * (h + f) * 4
              + nbytes(*group, ct_g), n_real * (4 * f + 12 * h),
              dict(shapes, source_rows=win_rows))
    gerp = out[2]

    # K7 g-major over the forward layout: grad_er per hub row.
    row("attn_bwd_grp", AK.attn_bwd_grp, AK.attn_bwd_grp_torch,
        (lf, el, *group, ft, ct_g, *tail, m.n_groups),
        (lf, el, *abs_group, ft.abs(), ct_g.abs(), *tail, m.n_groups),
        nbytes(lf["a"], lf["b"], lf["in_id"], lf["out_id"]) + drop_bytes(lf)
        + src_rows * (h + f) * 4 + nbytes(*group, ct_g),
        n_real * (2 * f + 12 * h), dict(shapes))
    if bf16:
        return rows

    # K8 on K7's partials.
    ger = AK.ger_reduce(lb, gerp, m.n_groups)
    perm = gerp.reshape(-1, 128, h).index_select(0, lb["gperm"].long())
    gout = lb["gout"].long()
    rows["ger_reduce"] = kernel_row(
        "ger_reduce", ger, AK.ger_reduce_torch(lb, gerp.double(),
                                               m.n_groups),
        AK.ger_reduce_torch(lb, gerp.abs().double(), m.n_groups),
        lambda: AK.ger_reduce(lb, gerp, m.n_groups),
        lambda: AK.ger_reduce_torch(lb, gerp, m.n_groups),
        (lambda: gerp.new_zeros((m.n_groups, 128, h)).index_add_(0, gout,
                                                                 perm))
        if library else None,
        nbytes(gerp, lb["gperm"], lb["gout"], ger), gerp.numel(),
        dict(shapes, partial_rows=int(gerp.shape[0])),
        None if library else "timed on the main case only", 20)
    return rows


def phase_attn_kernels(dev, g_arx, g_mix):
    """The attention rows at arxiv layer 1 (H=8, D=32, dropout 0); the
    same kernels at dropout 0.6, at layer 2 (H=1, D=40) and on the mixed
    graph (several groups, which K8 folds) ride in each row's
    ``variants``. The bf16 mode at arxiv layer 1 (dropout 0 and 0.6) and
    layer 2, the shapes the bf16 GAT trainer gives K6 and K7: K6 and K7
    rows of their own, K7 g-major as variants of its row."""
    rows = attn_case("arxiv_layer1", g_arx, dev, 8, 32, 0.0)
    variants = [attn_case("arxiv_layer1_drop0.6", g_arx, dev, 8, 32, 0.6,
                          plain_iters=1, library=False),
                attn_case("arxiv_layer2", g_arx, dev, 1, 40, 0.0,
                          plain_iters=1, library=False),
                attn_case("mixed_layer1", g_mix, dev, 8, 32, 0.0,
                          plain_iters=1, library=False),
                attn_case("mixed_layer1_drop0.6", g_mix, dev, 8, 32, 0.6,
                          plain_iters=1, library=False)]
    for name, row in rows.items():
        with_variants(row, [v[name] for v in variants])
    bf = [attn_case(c, g_arx, dev, h, d, p, plain_iters=1, library=False,
                    bf16=True)
          for c, h, d, p in (("arxiv_layer1", 8, 32, 0.0),
                             ("arxiv_layer1_drop0.6", 8, 32, 0.6),
                             ("arxiv_layer2", 1, 40, 0.0))]
    for name in ("attn_fwd.bf16", "attn_bwd_src.bf16"):
        rows[name] = with_variants(bf[0][name], [v[name] for v in bf[1:]])
    rows["attn_bwd_grp"]["variants"] += [
        {k: v["attn_bwd_grp.bf16"][k] for k in VARIANT_KEYS
         if k in v["attn_bwd_grp.bf16"]} for v in bf]
    return rows


def composed_view(g):
    """The same graph without its hub layout: GATConv then takes the
    composed g-SDDMM -> edge_softmax -> u_mul_e path."""
    gv = copy.copy(g)
    gv.hub_dst = gv.hub_dst_meta = None
    return gv


def gat_attention_path(name, g, dev, h=8, d=32):
    """gat_attention forward and backward with K6-K8 against the composed
    path on the oracle engine, run in float64 (see attn_case); counters
    zeroed before and read after. Values within 1e-4 of the same sums
    over |ft|; grads within 1e-4 of (|ref| + the largest |ref|), as hub
    rows sum millions of terms that cancel."""
    from dgl1_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(5)
    n, e = g.num_nodes(), g.num_edges()
    xs = [torch.randn(n, h, device=dev, generator=gen),
          torch.randn(n, h, device=dev, generator=gen),
          torch.randn(n, h, d, device=dev, generator=gen)]
    w = torch.randn(n, h, d, device=dev, generator=gen)
    gv = composed_view(g)

    def composed(el, er, ft):
        a = ops.edge_softmax(gv, torch.nn.functional.leaky_relu(
            ops.gsddmm(gv, "add", el[:, :, None], er[:, :, None]), SLOPE))
        return ops.gspmm(gv, "mul", "sum", ft, a)

    ops.set_engine("xla")
    try:
        rin = [x.double().requires_grad_(True) for x in xs]
        ref = composed(*rin)
        rgrads = torch.autograd.grad((ref * w.double()).sum(), rin)
        with torch.no_grad():
            scale = composed(*f64((xs[0], xs[1], xs[2].abs())))
        ref = ref.detach()
    finally:
        ops.set_engine("auto")
    reset_all_launches()
    fin = [x.clone().requires_grad_(True) for x in xs]
    out = ops.gat_attention(g, *fin, SLOPE)
    fgrads = torch.autograd.grad((out * w).sum(), fin)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_launches(name, counts, ("attn_fwd", "attn_bwd_src", "ger_reduce"))
    err_f = check(f"{name} fwd", out, ref, scale)
    err_b = {k: check(f"{name} grad_{k}", a, b, b.abs() + b.abs().max())
             for k, a, b in zip(("el", "er", "ft"), fgrads, rgrads)}
    del ref, rgrads, scale, rin
    fwd_ms = cuda_ms(lambda: ops.gat_attention(g, *xs, SLOPE))
    out2 = ops.gat_attention(g, *fin, SLOPE)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out2, fin, w,
                                                 retain_graph=True))
    log(json.dumps({
        "phase": "gat_attention", "path": name, "nodes": n, "edges": e,
        "h": h, "d": d, "launches": counts, "fwd_err": err_f,
        "bwd_err": err_b, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_edges_per_s": e / (fwd_ms * 1e-3),
        "bwd_edges_per_s": e / (bwd_ms * 1e-3)}))


def phase_gat(name, dev, g, steps, expect, drop=0.0, check_logits=True):
    """The GAT trainer (128 -> 8 x 32 -> 40, Adam 1e-2) for ``steps``
    steps on ``g`` with feature and attention dropout ``drop``; counters
    zeroed before and read after; every kernel in ``expect`` must have
    launched."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import GAT

    n, in_f, hidden, heads, classes = g.num_nodes(), 128, 32, 8, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = GAT(in_f, hidden, classes, heads=heads, out_heads=1,
                feat_drop=drop, attn_drop=drop, device=dev,
                generator=torch.Generator().manual_seed(2))
    lerr = lmax = None
    if check_logits:
        # Logits through K6 against the composed path on the oracle
        # engine in float64 (see attn_case), same weights, before any
        # step.
        model.eval()
        with torch.no_grad():
            ops.set_engine("xla")
            try:
                ref = copy.deepcopy(model).double()(composed_view(g),
                                                    feat.double())
            finally:
                ops.set_engine("auto")
            out = model(g, feat)
        if out.shape != (n, classes):
            raise AssertionError(f"logits shape {tuple(out.shape)}")
        lerr = float((out - ref).abs().max())
        lmax = float(ref.abs().max())
        if not lerr <= 1e-4 * lmax:
            raise AssertionError(f"{name} logits: fused vs composed err "
                                 f"{lerr} > 1e-4 * max|logit| ({lmax})")
        del ref, out

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=steps, lr=1e-2,
                    generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    counts = all_launches()
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if drop == 0.0 and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    expect_launches(name, counts, expect)
    log(json.dumps({
        "phase": "gat_train", "path": name, "nodes": n,
        "edges": g.num_edges(), "dims": [in_f, [heads, hidden], classes],
        "drop": drop, "steps": steps, "losses": losses,
        "ms_per_step": [s * 1e3 for s in res["step_s"]],
        "ms_per_step_after_first": float(np.mean(res["step_s"][1:]) * 1e3),
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "logits_err_vs_composed": lerr, "logits_max_abs": lmax,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    return counts


def profile_gat(dev, g, steps=3):
    """Where the arxiv GAT step's device time goes: ``torch.profiler``
    over ``steps`` Adam steps after two warm-up steps (dropout 0); host
    ms per step, device busy ms per step, the idle share and the top
    device kernels by self time."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import GAT
    from torch.profiler import ProfilerActivity, profile

    n, classes = g.num_nodes(), 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, 128, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = GAT(128, 32, classes, heads=8, feat_drop=0.0, attn_drop=0.0,
                device=dev, generator=torch.Generator().manual_seed(2))
    dgl.train(g, feat, labels, model, steps=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train(g, feat, labels, model, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summarize_profile("gat_profile", "gat_arxiv_train", prof, steps,
                      wall_ms)


def profile_gcn(dev, g, steps=3):
    """Where the arxiv GCN step's device time goes, as :func:`profile_gat`
    measures the GAT step: ``torch.profiler`` over ``steps`` Adam steps
    (128 -> 256 -> 40, lr 1e-2) after two warm-up steps."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import GCN
    from torch.profiler import ProfilerActivity, profile

    n, classes = g.num_nodes(), 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, 128, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = GCN(128, 256, classes, num_layers=2, dropout=0.0, device=dev,
                generator=torch.Generator().manual_seed(2))
    dgl.train(g, feat, labels, model, steps=2, lr=1e-2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train(g, feat, labels, model, steps=steps, lr=1e-2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summarize_profile("gcn_profile", "gcn_arxiv_train", prof, steps,
                      wall_ms)


# The R-GCN configuration of tools/bench_models.py --model rgcn (lines
# 49-60, 95-97; BASELINE.json configuration #4's shape).
RGCN = dict(nodes=169343, deg=26, rels=8, in_f=128, hidden=64, classes=40,
            bases=4, lr=1e-2)


def rgcn_setup(dev):
    """The typed graph (``powerlaw_graph(169343, 26)``, no self-loops, a
    relation per edge from ``default_rng(0)``), its relation-sorted copy
    for the grouped-GEMM path and the 8 per-relation subgraphs, built on
    the host and moved to the card; host seconds of each."""
    import dgl1_tpu_torch as dgl

    t0 = time.perf_counter()
    g, et = dgl.data.typed_powerlaw_graph(RGCN["nodes"], RGCN["deg"],
                                          RGCN["rels"], seed=0, device=dev)
    t1 = time.perf_counter()
    g_sorted, et_sorted, counts = dgl.data.sort_by_relation(g, et,
                                                            RGCN["rels"])
    t2 = time.perf_counter()
    rel = dgl.typed_subgraphs(g, et, RGCN["rels"])
    t3 = time.perf_counter()
    log(json.dumps({
        "phase": "rgcn_graphs", "build_s": t1 - t0, "sorted_copy_s": t2 - t1,
        "typed_subgraphs_s": t3 - t2, "nodes": g.num_nodes(),
        "edges": g.num_edges(), "relations": RGCN["rels"],
        "edges_per_relation": counts.tolist(),
        "sorted": repr(g_sorted.hub_dst_meta),
        "relation_0": repr(rel[0].hub_dst_meta),
        "relations_with_hub": sum(r.hub_dst_meta is not None for r in rel)}))
    return dict(g=g, g_sorted=g_sorted, rel=rel, counts=counts,
                et=torch.as_tensor(et[: g.num_edges()], device=dev),
                et_sorted=torch.as_tensor(et_sorted, device=dev))


def weighted_row(name, case, g, dev, he, rep, bwd=False, library=True,
                 seed=0, bf16=False):
    """One of K2 mul/rhs (``chunk_*``) or K5 mul/rhs (``edge_grad_*``) on
    ``g``'s full layout (the window-major ``full_bwd`` with ``bwd``: grad_u
    of u_mul_e) at he heads of rep features, against its float64 plain
    version on the same random inputs (plain_ms times the float32 plain
    version). Bytes: the layout, each input row the real slots need and
    the output, once. Library calls, timed only: ``torch.sparse.mm`` of a
    CSR holding the weights (K2 mul, one head), ``index_add_`` of the real
    slots' edge rows gathered beforehand (K2 rhs),
    ``torch.sparse.sampled_addmm`` over the slots' (hub row, source) pattern
    (K5 mul, one head; duplicate edges merge there), ``index_select`` of the
    cotangent rows (K5 rhs). With ``bf16`` the kernel and its plain
    version run in the bf16 mode."""
    from dgl1_tpu_torch.ops import hub_kernels as K

    bf = {"bf16": True} if bf16 else {}

    gen = torch.Generator(device=dev).manual_seed(seed)
    hub, m = g.hub_dst, g.hub_dst_meta
    n, gr, f = g.num_nodes(), m.n_groups * 128, he * rep
    mode = "mul" if name.endswith("mul") else "rhs"
    lay = hub["full_bwd" if bwd else "full_fwd"]
    rows_in, rows_out, valid = K._chunk_rows(lay)
    real = valid.nonzero().squeeze(1)
    n_real = int(real.numel())
    ri, ro = rows_in.index_select(0, real), rows_out.index_select(0, real)
    shapes = {"case": case, "he": he, "rep": rep,
              "layout": "full_bwd" if bwd else "full_fwd",
              "chunks": int(lay["in_id"].shape[0]),
              "slots": int(lay["a"].shape[0]), "real_slots": n_real,
              "groups": m.n_groups, "windows": m.n_win}
    lay_bytes = nbytes(lay["a"], lay["b"], lay["in_id"], lay["out_id"])
    in_rows = int(torch.unique(ri).numel())
    lib, note = None, None if library else "timed on the main case only"

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def d(x):
        return None if x is None else x.double()

    def a(x):
        return None if x is None else x.abs().double()

    if name.startswith("chunk"):
        e2 = rnd(g.num_edges(), he)
        inp = rnd(gr if bwd else n, f) if mode == "mul" else None
        n_out = m.n_win if bwd else m.n_groups
        args = (mode, lay, e2, inp, n_out, he, rep)
        out = K.chunk_weighted(*args, **bf)
        f32_out = K.chunk_weighted(*args) if bf16 else None
        ref = K.chunk_weighted_torch(mode, lay, d(e2), d(inp), n_out, he,
                                     rep, **bf)
        scale = K.chunk_weighted_torch(mode, lay, a(e2), a(inp), n_out, he,
                                       rep, **bf)
        fn = lambda: K.chunk_weighted(*args, **bf)  # noqa: E731
        plain = lambda: K.chunk_weighted_torch(*args, **bf)  # noqa: E731
        bytes_moved = (lay_bytes + nbytes(lay["eid"]) + n_real * he * 4
                       + (in_rows * f * 4 if mode == "mul" else 0)
                       + nbytes(out))
        flops = n_real * f * (2 if mode == "mul" else 1)
        eid_r = lay["eid"].long().index_select(0, real)
        if library and mode == "mul" and he == 1:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # sparse CSR is beta
                s_mat = torch.sparse_coo_tensor(
                    torch.stack([ro, ri]), e2[:, 0].index_select(0, eid_r),
                    (n_out * 128, inp.shape[0]),
                    check_invariants=False).coalesce().to_sparse_csr()
            lib = lambda: torch.sparse.mm(s_mat, inp)  # noqa: E731
        elif library and mode == "rhs":
            msg = e2.index_select(0, eid_r)
            lib_out = torch.zeros_like(out)
            lib = lambda: lib_out.index_add_(0, ro, msg)  # noqa: E731
        elif library:
            note = "no single PyTorch call for per-head weights"
    else:
        ct = rnd(gr, f if mode == "mul" else he)
        u = rnd(n, f) if mode == "mul" else None
        args = (mode, lay, u, ct, he, rep)
        out = K.edge_grad(*args, **bf)
        f32_out = K.edge_grad(*args) if bf16 else None
        ref = K.edge_grad_torch(mode, lay, d(u), d(ct), he, rep, **bf)
        scale = K.edge_grad_torch(mode, lay, a(u), a(ct), he, rep, **bf)
        fn = lambda: K.edge_grad(*args, **bf)  # noqa: E731
        plain = lambda: K.edge_grad_torch(*args, **bf)  # noqa: E731
        bytes_moved = (lay_bytes + (in_rows * f * 4 if mode == "mul" else 0)
                       + nbytes(ct, out))
        flops = 2 * n_real * f if mode == "mul" else 0
        if library and mode == "mul" and he == 1:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pattern = torch.sparse_coo_tensor(
                    torch.stack([ro, ri]), torch.ones(n_real, device=dev),
                    (gr, n), check_invariants=False).coalesce(
                ).to_sparse_csr()
            u_t = u.t().contiguous()
            lib = lambda: torch.sparse.sampled_addmm(  # noqa: E731
                pattern, ct, u_t)
        elif library and mode == "rhs":
            lib = lambda: ct.index_select(0, ro)  # noqa: E731
        elif library:
            note = "no single PyTorch call for per-head dots"
    shapes["input_rows"] = in_rows
    row = kernel_row(name, out, ref, scale, fn, plain, lib, bytes_moved,
                     flops, shapes, note, plain_iters=3, f32_out=f32_out)
    del out, ref, scale, f32_out
    return row


def phase_weighted_kernels(dev, g_arx, g_mix, g_rel):
    """K2 mul at weighted-GCN layer 1 (arxiv ``full_fwd``, F=128, one
    weight per edge), K2 rhs at R-GCN layer 1 (relation-sorted graph,
    he=64), K5 mul at F=128 and K5 rhs at he=64; as ``variants``: the
    weighted GCN's layer 2 (K2 mul at F=40 over ``full_fwd`` and, for
    grad_u, over ``full_bwd``; K5 mul at F=40) and its in-degree sum
    (K2/K5 rhs at he=1), R-GCN layer 2 (he=40), the GAT shape (he=8,
    rep=32; rhs he=8, the softmax denominator) and the mixed graph (five
    groups); last, each at its main case in the bf16 mode."""
    cases = {
        "chunk_mul": [("gcnw_layer1_f128", g_arx, 1, 128, False),
                      ("gcnw_layer2_f40", g_arx, 1, 40, False),
                      ("gcnw_layer2_grad_u_f40", g_arx, 1, 40, True),
                      ("gat_h8_d32", g_arx, 8, 32, False),
                      ("mixed_f128", g_mix, 1, 128, False)],
        "chunk_rhs": [("rgcn_layer1_he64", g_rel, 64, 1, False),
                      ("rgcn_layer2_he40", g_rel, 40, 1, False),
                      ("gcnw_in_w_he1", g_arx, 1, 1, False),
                      ("gat_den_he8", g_arx, 8, 1, False),
                      ("mixed_he8", g_mix, 8, 1, False)],
        "edge_grad_mul": [("gcnw_layer1_f128", g_arx, 1, 128, False),
                          ("gcnw_layer2_f40", g_arx, 1, 40, False),
                          ("gat_h8_d32", g_arx, 8, 32, False),
                          ("mixed_f128", g_mix, 1, 128, False)],
        "edge_grad_rhs": [("rgcn_layer1_he64", g_rel, 64, 1, False),
                          ("rgcn_layer2_he40", g_rel, 40, 1, False),
                          ("gcnw_in_w_he1", g_arx, 1, 1, False),
                          ("gat_den_he8", g_arx, 8, 1, False),
                          ("mixed_he8", g_mix, 8, 1, False)],
    }
    rows = {}
    for name, cs in cases.items():
        (case, g, he, rep, bwd), *rest = cs
        rows[name] = with_variants(
            weighted_row(name, case, g, dev, he, rep, bwd),
            [weighted_row(name, c, gg, dev, h, r, b, library=False,
                          seed=i + 1)
             for i, (c, gg, h, r, b) in enumerate(rest)]
            + [weighted_row(name, case, g, dev, he, rep, bwd, library=False,
                            seed=9, bf16=True)])
        torch.cuda.empty_cache()
    return rows


def weighted_gspmm_path(name, g, dev, op, width, expect):
    """u_mul_e (one weight per edge, F=width) or copy_e (he=width) + sum,
    forward, grad_u and grad_e, through the hub engine against the oracle
    engine in float64; counters zeroed before and read after. Each result
    within 1e-4 of the same computation over absolute values."""
    from dgl1_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(3)
    n, e = g.num_nodes(), g.num_edges()
    mul = op == "mul"
    u = torch.randn(n, width, device=dev, generator=gen) if mul else None
    ew = torch.randn(e, 1 if mul else width, device=dev, generator=gen)
    w = torch.randn(n, width, device=dev, generator=gen)

    def run(uu, ee, ww):
        ins = [x.clone().requires_grad_(True) for x in (uu, ee)
               if x is not None]
        out = ops.gspmm(g, op, "sum", *([None] if not mul else []), *ins)
        grads = torch.autograd.grad((out * ww).sum(), ins)
        return [out.detach()] + list(grads)

    ops.set_engine("xla")
    try:
        ref = run(*f64((u, ew, w)))
        scale = run(*f64(tuple(None if x is None else x.abs()
                               for x in (u, ew, w))))
    finally:
        ops.set_engine("auto")
    ops.set_engine("hub")
    try:
        reset_all_launches()
        got = run(u, ew, w)
        torch.cuda.synchronize()
        counts = all_launches()
        expect_launches(name, counts, expect)
        errs = {k: check(f"{name} {k}", a, b, c) for k, a, b, c in zip(
            ("fwd", "grad_u", "grad_e") if mul else ("fwd", "grad_e"),
            got, ref, scale)}
        del ref, scale
        ins = [x for x in (u, ew) if x is not None]
        fwd_ms = cuda_ms(lambda: ops.gspmm(g, op, "sum",
                                           *([None] if not mul else []),
                                           *ins))
        rin = [x.clone().requires_grad_(True) for x in ins]
        out2 = ops.gspmm(g, op, "sum", *([None] if not mul else []), *rin)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out2, rin, w,
                                                     retain_graph=True))
    finally:
        ops.set_engine("auto")
    log(json.dumps({
        "phase": "gspmm_weighted", "path": name, "op": op, "width": width,
        "nodes": n, "edges": e, "launches": counts, "errors": errs,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_edges_per_s": e / (fwd_ms * 1e-3),
        "bwd_edges_per_s": e / (bwd_ms * 1e-3)}))


def composed_gat_on_hub(name, g, dev, h=8, d=32):
    """The composed GAT chain on the hub engine (g-SDDMM, edge_softmax
    whose denominator is a hub copy_e, then u_mul_e per head) against the
    fused ``gat_attention`` on the same graph, both float32; counters
    zeroed before the composed run and read after (K2 mul/rhs, K5
    mul/rhs). Values within 1e-4 of the fused sums over |ft|, grads within
    1e-4 of (|ref| + the largest |ref|), as gat_attention_path."""
    from dgl1_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(9)
    n = g.num_nodes()
    xs = [torch.randn(n, h, device=dev, generator=gen),
          torch.randn(n, h, device=dev, generator=gen),
          torch.randn(n, h, d, device=dev, generator=gen)]
    w = torch.randn(n, h, d, device=dev, generator=gen)

    def composed(el, er, ft):
        a = ops.edge_softmax(g, torch.nn.functional.leaky_relu(
            ops.gsddmm(g, "add", el[:, :, None], er[:, :, None]), SLOPE))
        return ops.gspmm(g, "mul", "sum", ft, a)

    fin = [x.clone().requires_grad_(True) for x in xs]
    ref = ops.gat_attention(g, *fin, SLOPE)
    rgrads = torch.autograd.grad((ref * w).sum(), fin)
    with torch.no_grad():
        scale = ops.gat_attention(g, xs[0], xs[1], xs[2].abs(), SLOPE)
    reset_all_launches()
    cin = [x.clone().requires_grad_(True) for x in xs]
    out = composed(*cin)
    cgrads = torch.autograd.grad((out * w).sum(), cin)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_launches(name, counts, WEIGHTED)
    err_f = check(f"{name} fwd", out, ref, scale)
    err_b = {k: check(f"{name} grad_{k}", a, b, b.abs() + b.abs().max())
             for k, a, b in zip(("el", "er", "ft"), cgrads, rgrads)}
    log(json.dumps({"phase": "composed_gat_hub", "path": name, "h": h,
                    "d": d, "launches": counts, "fwd_err": err_f,
                    "bwd_err": err_b}))


def train_record(phase, name, g, res, counts, steps, **extra):
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    dev = g.device
    log(json.dumps(dict({
        "phase": phase, "path": name, "nodes": g.num_nodes(),
        "edges": g.num_edges(), "steps": steps, "losses": losses,
        "ms_per_step": [x * 1e3 for x in res["step_s"]],
        "ms_per_step_after_first": float(np.mean(res["step_s"][1:]) * 1e3),
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9},
        **extra)))


def logits_vs(name, what, out, ref, rel=1e-3):
    """|out - ref| <= rel * max|ref| (float32 sums of hub rows of up to
    ~10^6 terms in two orders, as phase_gcn)."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: logits shape {tuple(out.shape)}")
    err, mx = float((out - ref).abs().max()), float(ref.abs().max())
    if not err <= rel * mx:
        raise AssertionError(f"{name} logits vs {what}: err {err} > {rel} "
                             f"* max|logit| ({mx})")
    return err, mx


def logits_vs_abs(name, what, out, ref, bound, rel=1e-4):
    """|out - ref| <= rel * bound, element by element, ``bound`` the
    float64 sum over absolute values of each logit's terms: a wrong low-
    degree row fails however large the hub rows' logits are. Returns
    (max error, max error / bound)."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: logits shape {tuple(out.shape)}")
    err = (out.double() - ref.double()).abs()
    bad = err > rel * bound
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0]) // out.shape[1]
        raise AssertionError(
            f"{name} logits vs {what}: {int(bad.sum())} elements over "
            f"{rel} * abs sum; row {i}: err {float(err[i].max())}, abs sum "
            f"{float(bound[i].min())}")
    return float(err.max()), float((err / bound.clamp_min(1e-300)).max())


def rgcn_abs_bound(model, r, feat):
    """Row-wise bound for R-GCN logits: the model with every parameter
    and feature replaced by its absolute value, in float64 under the
    oracle engine on the per-relation subgraphs. With relu(|x|) = |x|
    each logit is then at least the sum of the absolute values of its
    terms, the bias and loop terms included."""
    from dgl1_tpu_torch import ops

    a = copy.deepcopy(model).double()
    with torch.no_grad():
        for p in a.parameters():
            p.abs_()
        ops.set_engine("xla")
        try:
            return a(r["g"], feat=feat.abs().double(), rel_graphs=r["rel"])
        finally:
            ops.set_engine("auto")


def phase_gcn_weighted(name, dev, g, steps):
    """The edge-weighted GCN (``EdgeWeightedGCN``: two
    ``GraphConv(norm='none')``, 128 -> 256 -> 40, dropout 0, Adam 1e-2)
    whose weights are ``EdgeWeightNorm('both')`` of sigmoid(theta), theta
    a learnable logit per edge (zero at the start: the symmetric GCN
    normalisation); step-0 logits against the oracle engine; per step K2
    mul 3, K5 mul 2, K2 rhs 1 and K5 rhs 1."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import EdgeWeightedGCN

    n, in_f, hidden, classes = g.num_nodes(), 128, 256, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = EdgeWeightedGCN(g.num_edges_padded(), in_f, hidden, classes,
                            dropout=0.0, device=dev,
                            generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ops.set_engine("xla")
        try:
            ref = model(g, feat)
        finally:
            ops.set_engine("auto")
        lerr, lmax = logits_vs(name, "oracle", model(g, feat), ref)
    del ref
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=steps, lr=1e-2)
    torch.cuda.synchronize()
    counts = all_launches()
    per_step = {"chunk_mul": 3, "edge_grad_mul": 2, "chunk_rhs": 1,
                "edge_grad_rhs": 1}
    expect_exact(name, {k: counts[k] for k in WEIGHTED},
                 {k: v * steps for k, v in per_step.items()})
    train_record("gcn_weighted_train", name, g, res, counts, steps,
                 dims=[in_f, hidden, classes],
                 logits_err_vs_oracle=lerr, logits_max_abs=lmax,
                 theta_abs_mean=float(model.theta.detach().abs().mean()))
    return counts


def rgcn_model(dev):
    from dgl1_tpu_torch.models import RGCN as RGCNModel

    return RGCNModel(RGCN["nodes"], RGCN["hidden"], RGCN["classes"],
                     RGCN["rels"], num_bases=RGCN["bases"],
                     in_feats=RGCN["in_f"], device=dev,
                     generator=torch.Generator().manual_seed(2))


def rgcn_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(RGCN["nodes"], RGCN["in_f"], device=dev, generator=gen)
    labels = torch.randint(0, RGCN["classes"], (RGCN["nodes"],), device=dev,
                           generator=gen)
    return feat, labels


def rgcn_args(r, grouped):
    """(graph, model keyword arguments) of the grouped-GEMM path (the
    relation-sorted graph, ``segment_mm``, hub copy_e) or the
    per-relation path (one projection and one hub copy_u per relation)."""
    if grouped:
        return r["g_sorted"], dict(etypes=r["et_sorted"], presorted=True,
                                   etype_counts=r["counts"])
    return r["g"], dict(rel_graphs=r["rel"])


def phase_rgcn(name, dev, r, steps, grouped):
    """The R-GCN trainer at the configuration-#4 shape (128 -> 64 -> 40, 8
    relations, 4 bases, self-loop weight, Adam 1e-2) for ``steps`` steps.
    Step-0 logits against the oracle engine and, on the grouped path,
    against the per-relation path with the same parameters. Launches: the
    grouped path K2 rhs and K5 rhs 2 per step and no K2 mul or K5 mul;
    the per-relation path K1 and K4 (and no weighted kernel)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops

    feat, labels = rgcn_inputs(dev)
    model = rgcn_model(dev)
    g, kw = rgcn_args(r, grouped)
    model.eval()
    with torch.no_grad():
        ops.set_engine("xla")
        try:
            ref = model(g, feat=feat, **kw)
        finally:
            ops.set_engine("auto")
        out = model(g, feat=feat, **kw)
        lerr, lmax = logits_vs(name, "oracle", out, ref)
        extra = {"logits_err_vs_oracle": lerr, "logits_max_abs": lmax}
        if grouped:
            g2, kw2 = rgcn_args(r, False)
            extra["logits_err_vs_per_relation"] = logits_vs(
                name, "per-relation path", out, model(g2, feat=feat,
                                                      **kw2))[0]
    del ref, out
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=steps, lr=RGCN["lr"], **kw)
    torch.cuda.synchronize()
    counts = all_launches()
    if grouped:
        expect_exact(name, {k: counts[k] for k in WEIGHTED},
                     {"chunk_rhs": 2 * steps, "edge_grad_rhs": 2 * steps})
    else:
        expect_exact(name, {k: counts[k] for k in WEIGHTED}, {})
        any_bwd = counts["dense_bwd"] + counts["dense_bwd_fused"]
        expect_launches(name, dict(counts, dense_bwd_any=any_bwd),
                        ("dense_fwd", "dense_bwd_any"))
    train_record("rgcn_train", name, g, res, counts, steps,
                 dims=[RGCN["in_f"], RGCN["hidden"], RGCN["classes"]],
                 relations=RGCN["rels"], bases=RGCN["bases"], **extra)
    return counts


def profile_rgcn(dev, r, steps=3):
    """Where the grouped R-GCN step's device time goes: ``torch.profiler``
    over ``steps`` steps after two warm-up steps; as profile_gat."""
    import dgl1_tpu_torch as dgl
    from torch.profiler import ProfilerActivity, profile

    feat, labels = rgcn_inputs(dev)
    model = rgcn_model(dev)
    g, kw = rgcn_args(r, True)
    dgl.train(g, feat, labels, model, steps=2, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train(g, feat, labels, model, steps=steps, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summarize_profile("rgcn_profile", "rgcn_grouped_train", prof, steps,
                      wall_ms)


# Phase 4e: typed graphs and heterographs. The identity relation layouts
# and the union block of tools/bench_models.py --model rgcn --huborder /
# --union (lines 55-75), configuration #4 at ogbn-mag's own shape (the
# rgcn-hetero pattern on data.synthetic_mag_heterograph), and HAN at the
# HAN paper's ACM shape (Wang et al., WWW 2019: 3,025 papers, 5,835
# authors, 56 subjects, 1,870 features, 3 classes; examples/train_han.py's
# class-biased links).
MAG = dict(scale=1, emb=128, hidden=64, classes=349, lr=1e-2, steps=5)
ACM = dict(papers=3025, authors=5835, subjects=56, pa_edges=9744,
           feat=1870, classes=3, hidden=8, heads=8, dropout=0.6, lr=5e-3,
           steps=5)


def typed_setup(dev, r):
    """The R-GCN typed graph's identity relation layouts
    (``typed_subgraphs(identity=True)``) and its relation-stacked union
    block (``typed_union_graph``), built on the host; each must claim
    ``identity_expand``, as the reference's script asserts."""
    import dgl1_tpu_torch as dgl

    t0 = time.perf_counter()
    rel_id, perm = dgl.typed_subgraphs(r["g"], r["et"], RGCN["rels"],
                                       identity=True)
    t1 = time.perf_counter()
    gu, perm_u = dgl.typed_union_graph(r["g"], r["et"], RGCN["rels"])
    t2 = time.perf_counter()
    if not all(gr.hub_dst_meta.identity_expand for gr in rel_id):
        raise AssertionError("an identity relation layout lost "
                             "identity_expand")
    if not gu.hub_dst_meta.identity_expand:
        raise AssertionError("the union block lost identity_expand")
    log(json.dumps({
        "phase": "typed_graphs", "typed_subgraphs_identity_s": t1 - t0,
        "typed_union_graph_s": t2 - t1,
        "relation_0": repr(rel_id[0].hub_dst_meta),
        "relation_edges": [gr.num_edges() for gr in rel_id],
        "union": repr(gu.hub_dst_meta),
        "union_num_src": gu.num_src_nodes(),
        "union_num_dst": gu.num_dst_nodes()}))
    return dict(rel_id=rel_id, gu=gu,
                perm=torch.as_tensor(perm, device=dev),
                perm_u=torch.as_tensor(perm_u, device=dev))


def typed_kernel_variants(dev, rows, tl):
    """K1 and K4a at relation 0's identity layout (phantom hub slots and
    tail rows) and at the union block's dense tier (8 x 169,343 source
    rows), F=64, against their float64 plain versions, as variants of
    the K1 and K4a rows."""
    for name, case in (("dense_fwd", dense_fwd_case),
                       ("dense_bwd_fused", dense_bwd_fused_case)):
        rows[name]["variants"] += [
            {k: v[k] for k in VARIANT_KEYS if k in v}
            for v in (case("rgcn_identity_rel0_f64", tl["rel_id"][0], dev,
                           64, seed=40, library=False),
                      case("rgcn_union_f64", tl["gu"], dev, 64, seed=41,
                           library=False))]


def phase_rgcn_typed(name, dev, r, tl, union, epochs=5):
    """``bench_models.bench('rgcn', 'arxiv')`` in f32 on the identity
    relation layouts (``--huborder``) or the union block (``--union``):
    step-0 logits against the per-relation path with the same parameters
    through ``perm``, each element within 1e-4 of its float64 abs sum
    (:func:`rgcn_abs_bound`, computed once into ``tl``), then ``epochs``
    timed epochs after the warm-up step, counters zeroed before and read
    after. No K3 (identity layouts take the pad-forward) and no weighted
    kernel; K1 and K4 must launch."""
    from dgl1_tpu_torch.tools.bench_models import bench

    feat, _ = rgcn_inputs(dev)
    model = rgcn_model(dev)
    perm = tl["perm_u" if union else "perm"]
    typed = tl["gu"] if union else tl["rel_id"]
    kw = {"union_graph" if union else "rel_graphs": typed}
    model.eval()
    if "abs_bound" not in tl:
        tl["abs_bound"] = rgcn_abs_bound(model, r, feat)
    with torch.no_grad():
        ref = model(r["g"], feat=feat, rel_graphs=r["rel"])[perm]
        out = model(r["g"], feat=feat[perm], **kw)
        lerr, lratio = logits_vs_abs(name, "per-relation path", out, ref,
                                     tl["abs_bound"][perm])
        lmax = float(ref.abs().max())
    del model, ref, out, feat
    torch.cuda.empty_cache()
    reset_all_launches()
    rec = bench("rgcn", "arxiv", epochs=epochs, device=dev,
                graph=(r["g"], typed), huborder=not union, union=union)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact(name, {k: counts[k] for k in WEIGHTED + ("expand",)}, {})
    expect_launches(name, dict(counts, dense_bwd_any=counts["dense_bwd"]
                               + counts["dense_bwd_fused"]),
                    ("dense_fwd", "dense_bwd_any"))
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"{name}: non-finite loss {rec['losses']}")
    log(json.dumps(dict(
        rec, phase="rgcn_typed_train", path=name,
        launches={k: v for k, v in counts.items() if v},
        launches_per_step=per_step(counts, rec["steps"]),
        logits_err_vs_per_relation=lerr,
        logits_err_over_abs_sum=lratio, logits_max_abs=lmax,
        identity_expand=True)))
    return counts


def forward_engine(g, f=1):
    """The engine the auto dispatch gives ``g``'s copy_u sum (the first
    of bdense, hub, ell, tile that takes it; "xla" when none does)."""
    from dgl1_tpu_torch.ops import dispatch

    u = torch.zeros(g.num_src_nodes(), f, device=g.device)
    for name in dispatch._candidates(True):
        if dispatch._ENGINES[name](g, "copy_lhs", "sum", u, None) is not None:
            return name
    return "xla"


def mag_setup(dev):
    """``synthetic_mag_heterograph(scale=1)`` (ogbn-mag's node counts,
    7 relations, 32,882,164 edges, every relation a block with every
    layout its in-degrees earn) built once on the host, where the sampled
    phase reads it, and copied to the card for the full-graph phase; the
    build and copy seconds, edges per relation and each relation's
    engine. Returns (host graph, card graph, split)."""
    import dgl1_tpu_torch as dgl

    t0 = time.perf_counter()
    hg_host, split = dgl.data.synthetic_mag_heterograph(scale=MAG["scale"],
                                                        device="cpu")
    t1 = time.perf_counter()
    hg = hg_host.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rels = {"/".join(c): {"edges": hg[c].num_edges(),
                          "engine": forward_engine(hg[c]),
                          "hub": repr(hg[c].hub_dst_meta)
                          if hg[c].hub_dst_meta is not None else None}
            for c in hg.canonical_etypes}
    log(json.dumps({
        "phase": "hetero_graphs", "build_s": t1 - t0, "to_card_s": t2 - t1,
        "nodes": {nt: hg.num_nodes(nt) for nt in hg.ntypes},
        "edges": hg.num_edges(), "relations": rels,
        "device_mem_gb": torch.cuda.memory_allocated(dev) / 1e9}))
    return hg_host, hg, split


class MagRGCN(torch.nn.Module):
    """The rgcn-hetero pattern at configuration #4's shape: learned
    embeddings (``HeteroEmbedding``, dim 128) for every type but paper,
    paper features of 128, then two ``HeteroGraphConv({etype:
    GraphConv(norm='right')})`` layers 128 -> 64 -> 349 with ReLU between;
    returns the paper logits."""

    def __init__(self, hg, dev, gen):
        super().__init__()
        from dgl1_tpu_torch.nn import (GraphConv, HeteroEmbedding,
                                       HeteroGraphConv)

        self.emb = HeteroEmbedding(
            {nt: hg.num_nodes(nt) for nt in hg.ntypes if nt != "paper"},
            MAG["emb"], device=dev, generator=gen)
        dims = (MAG["emb"], MAG["hidden"], MAG["classes"])
        self.layers = torch.nn.ModuleList(
            HeteroGraphConv({et: GraphConv(dims[i], dims[i + 1],
                                           norm="right", device=dev,
                                           generator=gen)
                             for et in hg.etypes})
            for i in range(2))

    def forward(self, hg, feat):
        h = dict(self.emb.weights(), paper=feat)
        h = {k: torch.relu(v) for k, v in self.layers[0](hg, h).items()}
        return self.layers[1](hg, h)["paper"]


def phase_mag_rgcn(name, dev, hg, train_ids):
    """:class:`MagRGCN` for 5 full-graph Adam steps (1e-2) on the paper
    labels of the train split: step-0 paper logits against the oracle
    engine, losses finite and falling; ms per step, peak memory,
    launches per step by kernel; then a profile of 2 steps (device busy
    time, idle share, top device operations)."""
    from dgl1_tpu_torch import ops
    from torch.profiler import ProfilerActivity, profile

    feat = hg.nodes["paper"].data["feat"]
    labels = hg.nodes["paper"].data["label"].long()[train_ids]
    model = MagRGCN(hg, dev, torch.Generator().manual_seed(2))
    with torch.no_grad():
        ops.set_engine("xla")
        try:
            ref = model(hg, feat)
        finally:
            ops.set_engine("auto")
        lerr, lmax = logits_vs(name, "oracle", model(hg, feat), ref)
    del ref
    opt = torch.optim.Adam(model.parameters(), lr=MAG["lr"])

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(
            model(hg, feat)[train_ids], labels)
        loss.backward()
        opt.step()
        return loss

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    losses, step_s = [], []
    for _ in range(MAG["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step().detach()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = all_launches()
    train_record("hetero_rgcn_mag_train", name, hg, {
        "losses": losses, "step_s": step_s}, counts, MAG["steps"],
        dims=[MAG["emb"], MAG["hidden"], MAG["classes"]],
        relations=len(hg.canonical_etypes),
        logits_err_vs_oracle=lerr, logits_max_abs=lmax)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    summarize_profile("hetero_rgcn_mag_profile", name, prof, 2, wall_ms,
                      peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return counts


# examples/train_rgcn_sampled.py at ogbn-mag's widths (its defaults with
# the real dataset's 349 classes): fanouts 10 and 10 over every relation,
# batch 512, hidden 64, embeddings 64, Adam 1e-2, sparse Adam 5e-2.
SAMPLED_MAG = dict(batch=512, fanout=10, emb=64, hidden=64, classes=349,
                   lr=1e-2, sparse_lr=5e-2, steps=5, workers=2)


def hetero_abs_bound(model, blocks, x):
    """Row-wise bound for the hetero R-GCN's logits: the model with every
    parameter and input by absolute value, in float64 under the oracle
    engine (relu(|x|) = |x|, and the degree norms are positive)."""
    from dgl1_tpu_torch import ops

    a = copy.deepcopy(model).double()
    with torch.no_grad():
        for p in a.parameters():
            p.abs_()
        ops.set_engine("xla")
        try:
            return a(blocks, {k: v.abs().double() for k, v in x.items()})
        finally:
            ops.set_engine("auto")


def k9_relations(blocks, out_ntype="paper"):
    """The relations whose backward runs K9 in a sampled hetero R-GCN
    step: each relation into ``out_ntype`` of the output block, and each
    relation of the input block into a source type of those, where it has
    dst nodes; and the count of empty relations (no dst node) of each
    block, which launch nothing."""
    r1 = [c for c, g in blocks[1].rel_graphs.items()
          if c[2] == out_ntype and g.num_dst_nodes()]
    need = {c[0] for c in r1}
    r0 = [c for c, g in blocks[0].rel_graphs.items()
          if c[2] in need and g.num_dst_nodes()]
    empty = [sum(g.num_dst_nodes() == 0 for g in b.rel_graphs.values())
             for b in blocks]
    return len(r0) + len(r1), empty


def phase_sampled_rgcn_mag(name, dev, hg, split):
    """The sampled R-GCN of examples/train_rgcn_sampled.py at full scale:
    ``NeighborSampler([{e: 10}, {e: 10}])`` over the 7 relations of the
    host mag graph (the numpy sampler), ``NodeDataLoader`` of the train
    papers (batch 512, 2 workers) with the paper features pulled from a
    ``HostFeatureStore`` through ``pull_features``, ``HeteroRGCN`` 128 ->
    64 -> 349 over ``NodeEmbedding`` tables of 64 for the other types,
    trained by ``train_sampled_rgcn`` (Adam 1e-2, sparse Adam 5e-2).
    Step-0 paper logits against the oracle engine to 1e-4 of each
    logit's float64 abs sum; a warm-up step, then 5 steps from the loader
    with K9 launched exactly once a relation whose backward runs (empty
    relations, none; counted apart); ms per step, host sampling and pull
    ms per batch; then a profile of 3 steps on batches sampled
    beforehand. K9 at two of the step's shapes is checked against its
    float64 plain version and timed; returns (launches, those rows as
    variants of the K9 row)."""
    from torch.profiler import ProfilerActivity, profile

    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.data import HostFeatureStore
    from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader
    from dgl1_tpu_torch.models import HeteroRGCN
    from dgl1_tpu_torch.optim import NodeEmbedding, take_rows
    from dgl1_tpu_torch.train import embed_ids, train_sampled_rgcn

    cfg = SAMPLED_MAG
    t_phase = time.perf_counter()
    store = HostFeatureStore(hg.nodes["paper"].data["feat"].numpy(),
                             device=dev)
    labels = hg.nodes["paper"].data["label"].to(dev)
    fan = {c[1]: cfg["fanout"] for c in hg.canonical_etypes}
    loader = NodeDataLoader(
        hg, {"paper": split["train"]}, NeighborSampler([fan, fan]),
        batch_size=cfg["batch"], shuffle=True, seed=0,
        num_workers=cfg["workers"], prefetch=2,
        pull_features=lambda inp: store.pull_to_device(inp["paper"]),
        device=dev)
    embed = [nt for nt in hg.ntypes if nt != "paper"]
    gen = torch.Generator().manual_seed(3)
    tables = {nt: NodeEmbedding.create(hg.num_nodes(nt), cfg["emb"],
                                       generator=gen, device=dev).table
              for nt in embed}
    dims = dict({nt: cfg["emb"] for nt in embed}, paper=store.shape[1])
    model = HeteroRGCN(hg.canonical_etypes, dims, cfg["hidden"],
                       cfg["classes"], device=dev,
                       generator=torch.Generator().manual_seed(2))

    it = iter(loader)
    b0 = next(it)
    it.close()
    inp, out, blocks, mask, x_paper = b0
    ids = embed_ids(inp, blocks, tables)
    x = dict({nt: take_rows(tables[nt], ids[nt]) for nt in embed},
             paper=x_paper)
    with torch.no_grad():
        got = model(blocks, x)
        ops.set_engine("xla")
        try:
            ref = model(blocks, x)
        finally:
            ops.set_engine("auto")
    if got.shape != (cfg["batch"], cfg["classes"]):
        raise AssertionError(f"{name}: logits shape {tuple(got.shape)}")
    lerr, lratio = logits_vs_abs(name, "oracle", got, ref,
                                 hetero_abs_bound(model, blocks, x))
    per_step, empty = k9_relations(blocks)
    del got, ref, x
    # K9 at the shapes this step gives it (every aggregation runs at the
    # hidden width, 64): the output block's cites and the input block's
    # writes, reverse tiles read through their gather, as variants of the
    # K9 row.
    k9_variants = []
    for name_v, b, c in (("mag_block1_cites_tsrc_f64", blocks[1], "cites"),
                         ("mag_block0_writes_tsrc_f64", blocks[0],
                          "writes")):
        rel = b[c]
        v = tile_case(name_v, rel.tsrc, rel.num_dst_nodes(), cfg["hidden"],
                      dev, seed=len(k9_variants) + 20)
        k9_variants.append({k: v[k] for k in VARIANT_KEYS if k in v})
    warm = train_sampled_rgcn([b0], None, labels, model, tables,
                              lr=cfg["lr"], sparse_lr=cfg["sparse_lr"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = train_sampled_rgcn(loader, None, labels, model, tables,
                             states=warm["states"], steps=cfg["steps"],
                             lr=cfg["lr"], sparse_lr=cfg["sparse_lr"])
    torch.cuda.synchronize()
    counts = all_launches()
    losses = res["losses"]
    if len(losses) != cfg["steps"] or not all(math.isfinite(v)
                                              for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    expect_exact(name, counts, {"tile_sum": per_step * cfg["steps"]})
    log(json.dumps({
        "phase": "sampled_rgcn_mag_train", "path": name,
        "dims": [store.shape[1], cfg["hidden"], cfg["classes"]],
        "emb": cfg["emb"], "fanouts": [cfg["fanout"]] * 2,
        "batch": cfg["batch"], "relations": len(hg.canonical_etypes),
        "steps": cfg["steps"], "warmup_loss": warm["losses"][0],
        "losses": losses,
        "ms_per_step": [v * 1e3 for v in res["step_s"]],
        "ms_per_step_after_first": float(np.mean(res["step_s"][1:]) * 1e3),
        "wait_ms_per_step": [v * 1e3 for v in res["wait_s"]],
        "host_sample_ms_per_batch": float(np.mean(res["sample_ms"])),
        "host_sample_ms": res["sample_ms"],
        "host_pull_ms_per_batch": float(np.mean(res["pull_ms"])),
        "launches": counts,
        "launches_per_step": {k: v / cfg["steps"] for k, v in counts.items()},
        "k9_relations_per_step": per_step,
        "empty_relations_per_block": empty,
        "logits_err_vs_oracle": lerr, "logits_err_over_abs_sum": lratio,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    it.close()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_sampled_rgcn(batches, None, labels, model, tables,
                           states=res["states"], lr=cfg["lr"],
                           sparse_lr=cfg["sparse_lr"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    summarize_profile("sampled_rgcn_mag_profile", name, prof, 3, wall_ms,
                      host_sample_ms_per_batch=float(
                          np.mean(loader.sample_s) * 1e3))
    log(json.dumps({"phase": "sampled_rgcn_mag_done",
                    "seconds": time.perf_counter() - t_phase}))
    return counts, k9_variants


# The link prediction of examples/train_link_pred.py at the arxiv graph of
# tools/bench_models.py: GraphSAGE mean 128 -> 64 -> 64, fanouts [10, 10]
# unpadded, batch 512 edges, one uniform negative each, the batch's own
# edges excluded from its blocks, a u_dot_v score, Adam 1e-3.
LINKPRED = dict(feat=128, hidden=64, fanouts=[10, 10], batch=512, lr=1e-3,
                steps=5, infer_batch=32768)


def phase_link_pred(name, dev, g):
    """Link prediction on the arxiv graph ``g`` (a host copy samples):
    ``EdgeDataLoader`` over every edge with ``exclude='self'`` and
    ``negative_sampler.Uniform(1)``, ``NeighborSampler([10, 10],
    static_shapes=False)`` (ELL-only blocks), GraphSAGE 128 -> 64 -> 64,
    ``u_dot_v`` scores, binary cross-entropy, Adam 1e-3 for 5 steps (host
    sampling ms per batch, ms per step, the launches, recorded); then one
    ``layerwise_inference`` over all nodes, held element by element
    against the same model's full-graph forward on the oracle engine to
    1e-4 of each output's float64 abs sum, with its seconds and
    launches."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.dataloading import (EdgeDataLoader, NeighborSampler,
                                            layerwise_inference,
                                            negative_sampler)
    from dgl1_tpu_torch.models import GraphSAGE

    cfg = LINKPRED
    t_phase = time.perf_counter()
    g_host = g.to("cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(g.num_nodes(), cfg["feat"], device=dev, generator=gen)
    model = GraphSAGE(cfg["feat"], cfg["hidden"], cfg["hidden"],
                      num_layers=2, dropout=0.0, device=dev,
                      generator=torch.Generator().manual_seed(2))
    loader = EdgeDataLoader(
        g_host, np.arange(g_host.num_edges()),
        NeighborSampler(cfg["fanouts"], static_shapes=False),
        batch_size=cfg["batch"], shuffle=True,
        negative_sampler=negative_sampler.Uniform(1), seed=0,
        exclude="self", device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    losses, step_s, sample_ms = [], [], []
    it = iter(loader)
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        inp, pos, neg, blocks = next(it)
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        h = model(blocks, feat.index_select(0, inp))
        ps = dgl.ops.u_dot_v(pos, h, h)[:, 0]
        ns = dgl.ops.u_dot_v(neg, h, h)[:, 0]
        scores = torch.cat([ps, ns])
        y = torch.cat([torch.ones_like(ps), torch.zeros_like(ns)])
        loss = torch.nn.functional.binary_cross_entropy_with_logits(scores,
                                                                    y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        sample_ms.append((t1 - t0) * 1e3)
    it.close()
    counts = all_launches()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    model.eval()
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = layerwise_inference(
            g_host, feat,
            [lambda b, x: torch.relu(model.layers[0](b, x)),
             lambda b, x: model.layers[1](b, x)],
            batch_size=cfg["infer_batch"])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        infer_counts = all_launches()
        ops.set_engine("xla")
        try:
            ref = model(g, feat)
        finally:
            ops.set_engine("auto")
        a = copy.deepcopy(model).double()
        for p in a.parameters():
            p.abs_()
        ops.set_engine("xla")
        try:
            bound = a(g, feat.abs().double())
        finally:
            ops.set_engine("auto")
    ierr, iratio = logits_vs_abs(name, "full-graph oracle", out, ref, bound)
    log(json.dumps({
        "phase": "link_pred_train", "path": name, "nodes": g.num_nodes(),
        "edges": g.num_edges(),
        "dims": [cfg["feat"], cfg["hidden"], cfg["hidden"]],
        "fanouts": cfg["fanouts"], "batch_edges": cfg["batch"],
        "steps": cfg["steps"], "losses": losses,
        "ms_per_step": [v * 1e3 for v in step_s],
        "host_sample_ms_per_batch": float(np.mean(sample_ms)),
        "host_sample_ms": sample_ms, "launches": counts,
        "layerwise_inference_s": infer_s,
        "layerwise_inference_batch": cfg["infer_batch"],
        "layerwise_launches": {k: v for k, v in infer_counts.items() if v},
        "inference_err_vs_full_graph": ierr,
        "inference_err_over_abs_sum": iratio,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "seconds": time.perf_counter() - t_phase}))
    return counts


def acm_graphs(dev, seed=0):
    """The ACM-shaped heterograph (paper-author and paper-subject, both
    directions; a paper's links go to its class's community with
    probability 0.85, else anywhere, as examples/train_han.py draws
    them), its PAP and PSP metapath graphs, random features and the
    labels, with a train mask over half the papers."""
    import dgl1_tpu_torch as dgl

    rng = np.random.default_rng(seed)
    n_p, c = ACM["papers"], ACM["classes"]
    label = rng.integers(0, c, n_p)

    def links(src, n_targets):
        comm = rng.integers(0, c, n_targets)
        pools = [np.flatnonzero(comm == k) for k in range(c)]
        own = rng.random(len(src)) < 0.85
        pick = np.array([pools[label[s]][rng.integers(len(pools[label[s]]))]
                         for s in src])
        return np.where(own, pick, rng.integers(0, n_targets, len(src)))

    pa_s = np.concatenate([np.arange(n_p), rng.integers(
        0, n_p, ACM["pa_edges"] - n_p)])
    pa_d = links(pa_s, ACM["authors"])
    ps_s = np.arange(n_p)
    ps_d = links(ps_s, ACM["subjects"])
    t0 = time.perf_counter()
    hg = dgl.heterograph({
        ("paper", "pa", "author"): (pa_s, pa_d),
        ("author", "ap", "paper"): (pa_d, pa_s),
        ("paper", "ps", "subject"): (ps_s, ps_d),
        ("subject", "sp", "paper"): (ps_d, ps_s),
    }, num_nodes_dict={"paper": n_p, "author": ACM["authors"],
                       "subject": ACM["subjects"]}, device=dev)
    graphs = [dgl.metapath_reachable_graph(hg, p)
              for p in (["pa", "ap"], ["ps", "sp"])]
    secs = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.randn(n_p, ACM["feat"], device=dev, generator=gen)
    train = torch.as_tensor(rng.permutation(n_p)[: n_p // 2], device=dev)
    return graphs, feat, torch.as_tensor(label, device=dev), train, secs


def gat_path(g, head_dim):
    """Which of GATConv's three paths ``g`` takes (see GATConv)."""
    from dgl1_tpu_torch.ops.attention import can_fuse_attention
    from dgl1_tpu_torch.ops.battention import can_fuse_battention

    if can_fuse_attention(g, head_dim):
        return "fused hub attention"
    return "block-dense" if can_fuse_battention(g) else "composed"


def phase_han(name, dev):
    """HAN (1,870 -> 8 heads x 8 -> 3, dropout 0.6, Adam 5e-3) on the PAP
    and PSP metapath graphs for 5 steps: step-0 logits at dropout 0
    against the composed path on the oracle engine in float64, the
    GATConv path of each metapath graph, launches; losses finite."""
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import HAN

    graphs, feat, label, train, secs = acm_graphs(dev)
    model = HAN(2, ACM["feat"], ACM["hidden"], ACM["classes"],
                num_heads=ACM["heads"], dropout=ACM["dropout"], device=dev,
                generator=torch.Generator().manual_seed(2))
    model.eval()
    with torch.no_grad():
        ops.set_engine("xla")
        try:
            ref = copy.deepcopy(model).double()(
                [composed_view(g) for g in graphs], feat.double())
        finally:
            ops.set_engine("auto")
        lerr, lmax = logits_vs(name, "composed path", model(graphs, feat),
                               ref.float(), rel=1e-4)
    del ref
    opt = torch.optim.Adam(model.parameters(), lr=ACM["lr"])
    gen = torch.Generator(device=dev).manual_seed(7)
    model.train()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    losses, step_s = [], []
    for _ in range(ACM["steps"]):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(
            model(graphs, feat, generator=gen)[train], label[train])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = all_launches()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    paths = {p: gat_path(g, ACM["hidden"]) for p, g in zip(("PAP", "PSP"),
                                                           graphs)}
    log(json.dumps({
        "phase": "han_train", "path": name, "papers": ACM["papers"],
        "metapath_edges": {p: g.num_edges() for p, g in zip(("PAP", "PSP"),
                                                           graphs)},
        "gatconv_path": paths, "build_s": secs,
        "dims": [ACM["feat"], [ACM["heads"], ACM["hidden"]],
                 ACM["classes"]], "dropout": ACM["dropout"],
        "steps": ACM["steps"], "losses": losses,
        "ms_per_step": [x * 1e3 for x in step_s],
        "ms_per_step_after_first": float(np.mean(step_s[1:]) * 1e3),
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_step": per_step(counts, ACM["steps"]),
        "logits_err_vs_composed": lerr, "logits_max_abs": lmax,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    if "fused hub attention" in paths.values():
        expect_launches(name, counts, ("attn_fwd", "attn_bwd_src",
                                       "ger_reduce"))
    return counts


REDDIT = dict(batch=1024, fanouts=[10, 25], hidden=256, lr=1e-3)


def reddit_setup(dev):
    """The Reddit configuration of tools/bench_minibatch.py (--scale
    reddit): 232,965 nodes, 114,615,892 edges, F=602, 41 classes, 153,431
    training seeds; the parent stays on the host. Features and labels are
    random from a seed, resident on the card."""
    import dgl1_tpu_torch as dgl

    t0 = time.perf_counter()
    g, in_f, classes, train_ids = dgl.data.minibatch_graph("reddit", seed=0)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(g.num_nodes(), in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (g.num_nodes(),), device=dev,
                           generator=gen)
    log(json.dumps({"phase": "reddit_graph", "build_s": build_s,
                    "nodes": g.num_nodes(), "edges": g.num_edges(),
                    "feat": in_f, "classes": classes,
                    "train_seeds": len(train_ids)}))
    return dict(g=g, in_f=in_f, classes=classes, train_ids=train_ids,
                feat=feat, labels=labels)


def reddit_loader(r, dev, seed=0):
    from dgl1_tpu_torch.dataloading import NeighborSampler, NodeDataLoader

    return NodeDataLoader(r["g"], r["train_ids"],
                          NeighborSampler(REDDIT["fanouts"]),
                          batch_size=REDDIT["batch"], shuffle=True,
                          seed=seed, num_workers=2, prefetch=2, device=dev)


def tile_case(name, tiles, n_src, f, dev, is_max=None, mode="gather",
              seed=0):
    """K9 (``is_max`` None) or K10 on one tile layout of a sampled Reddit
    block at width ``f``. ``mode`` "gather": the engine's copy ops, source
    rows (n_src, f) read through the layout's ``gather``, whose padding
    slots point at an extra row of NaN; "msg": the binary ops, a message
    row per slot, padding rows NaN. A kernel that read a padding slot would
    put NaN in its output. K9 is held against its float64 plain version
    with the script's tolerance, K10 against its float32 plain version
    exactly; plain_ms times the float32 plain version. The library call
    (timed only) gets the real slots' rows gathered beforehand:
    ``index_add_`` for K9, ``scatter_reduce_`` amax or amin
    (include_self=False) for K10. Bytes: each distinct source row the real
    slots read (message mode: each real slot's row) and, in gather mode,
    the real slots' indices; the layout; the output. ``slot_bound_ms``
    counts a row for every real slot instead, as the message mode must
    read them: rows that many slots share come from L2 only if it holds
    them."""
    from dgl1_tpu_torch.ops import tile_kernels as TK

    gen = torch.Generator(device=dev).manual_seed(seed)
    lid = tiles["lid"]
    args = (tiles["rows"], tiles["first"], lid)
    n_tiles, n_rb = lid.shape[0], tiles["block_mask"].shape[0]
    pad = lid.reshape(-1) < 0
    real = (~pad).nonzero().squeeze(1)
    n_real = int(real.numel())
    if mode == "gather":
        src = torch.randn(n_src + 1, f, device=dev, generator=gen)
        src[n_src] = float("nan")
        idx = tiles["gather"].clone()
        idx[pad] = n_src
        src_rows = idx.index_select(0, real)
        read = int(torch.unique(src_rows).numel()) * f * 4 + n_real * 4
    else:
        src = torch.randn(lid.numel(), f, device=dev, generator=gen)
        src[pad] = float("nan")
        idx, src_rows = None, real
        read = n_real * f * 4
    if is_max is not None:
        src.clamp_(min=0.0)  # relu'd pool features: ties at zero
    target = (tiles["rows"].long()[:, None] * 128 + lid.long()).reshape(
        -1).index_select(0, real)
    rest = nbytes(lid, tiles["rows"], tiles["first"]) + n_rb * 128 * f * 4
    bytes_moved = read + rest
    more = {"slot_bound_ms": bound(n_real * f * 4 + rest
                                   + (n_real * 4 if idx is not None else 0),
                                   n_real * f)[0]}
    plan = TK.tile_plan_for(src, n_rb)
    shapes = {"case": name, "mode": mode, "f": f, "tiles": n_tiles,
              "row_blocks": n_rb, "slots": int(lid.numel()),
              "real_slots": n_real, "src_rows": int(src.shape[0]),
              "row_blocks_with_edges": int(tiles["block_mask"].sum()),
              "plan": plan._asdict()}
    msg_real = src.index_select(0, src_rows)
    lib_out = torch.zeros(n_rb * 128, f, device=dev)
    if is_max is None:
        lib = lambda: lib_out.index_add_(0, target, msg_real)  # noqa: E731
        out = TK.tile_sum(*args, src, n_rb, idx)
        ref = TK.tile_sum_torch(*args, src.double(), n_rb, idx)
        scale = TK.tile_sum_torch(*args, src.abs().double(), n_rb, idx)
        return kernel_row(
            "tile_sum", out, ref, scale,
            lambda: TK.tile_sum(*args, src, n_rb, idx),
            lambda: TK.tile_sum_torch(*args, src, n_rb, idx), lib,
            bytes_moved, n_real * f, shapes, plain_iters=3, more=more)
    tidx = target[:, None].expand(-1, f)
    red = "amax" if is_max else "amin"
    lib = lambda: lib_out.scatter_reduce_(  # noqa: E731
        0, tidx, msg_real, red, include_self=False)
    out = TK.tile_minmax(is_max, *args, src, n_rb, idx)
    ref = TK.tile_minmax_torch(is_max, *args, src, n_rb, idx)
    shapes["reduce"] = "max" if is_max else "min"
    return kernel_row(
        "tile_minmax", out, ref, None,
        lambda: TK.tile_minmax(is_max, *args, src, n_rb, idx),
        lambda: TK.tile_minmax_torch(is_max, *args, src, n_rb, idx), lib,
        bytes_moved, n_real * f, shapes, plain_iters=3, exact=True,
        more=more)


def phase_tile_kernels(dev, blocks):
    """K9 and K10 on a real sampled Reddit batch at the pool step's six
    shapes, in gather mode (the copy ops the trainers run): K9 at block 1
    ``tsrc`` (F=256: the mean step's only launch) with block 0 ``tsrc``
    and ``tdst`` (F=602) and block 1 ``tdst`` as ``variants``; K10 max at
    block 0 ``tdst`` (F=602: the pool step's first layer) with block 1
    ``tdst`` and min at both as ``variants``. Message mode (the binary
    ops) rides as variants at each kernel's row shape and at block 1
    ``tdst``. A ``tdst`` layout reads the block's source rows, a ``tsrc``
    one its destination rows."""
    b0, b1 = blocks

    def case(name, b, direction, f, seed, **kw):
        n_src = (b.num_src_nodes() if direction == "tdst"
                 else b.num_dst_nodes())
        return tile_case(name, getattr(b, direction), n_src, f, dev,
                         seed=seed, **kw)

    k9 = with_variants(case("block1_tsrc_f256", b1, "tsrc", 256, 0), [
        case("block0_tsrc_f602", b0, "tsrc", 602, 1),
        case("block0_tdst_f602", b0, "tdst", 602, 2),
        case("block1_tdst_f256", b1, "tdst", 256, 5),
        case("block1_tsrc_f256_msg", b1, "tsrc", 256, 0, mode="msg"),
        case("block1_tdst_f256_msg", b1, "tdst", 256, 5, mode="msg")])
    k10 = with_variants(
        case("block0_tdst_f602_max", b0, "tdst", 602, 6, is_max=True), [
            case("block0_tdst_f602_min", b0, "tdst", 602, 3, is_max=False),
            case("block1_tdst_f256_max", b1, "tdst", 256, 4, is_max=True),
            case("block1_tdst_f256_min", b1, "tdst", 256, 7, is_max=False),
            case("block0_tdst_f602_max_msg", b0, "tdst", 602, 6,
                 is_max=True, mode="msg"),
            case("block1_tdst_f256_max_msg", b1, "tdst", 256, 4,
                 is_max=True, mode="msg")])
    return {"tile_sum": k9, "tile_minmax": k10}


def sage_model(r, dev, aggregator, dropout=0.5):
    from dgl1_tpu_torch.models import GraphSAGE

    return GraphSAGE(r["in_f"], REDDIT["hidden"], r["classes"],
                     num_layers=len(REDDIT["fanouts"]),
                     aggregator=aggregator, dropout=dropout, device=dev,
                     generator=torch.Generator().manual_seed(2))


def expect_exact(name, counts, want):
    """Every kernel's launch count equals ``want`` (0 where absent)."""
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{name}: launches {bad}, expected {want}")


def phase_sage(name, dev, r, loader, aggregator, steps, per_step,
               first_batch=None):
    """The sampled GraphSAGE trainer at the Reddit configuration (602 ->
    256 -> 41, fanouts [10, 25], batch 1024, dropout 0.5, Adam 1e-3) for
    ``steps`` steps from ``loader``; counters zeroed before and read
    after, each kernel's count equal to ``per_step`` times the steps. With
    ``first_batch``, first the step-0 logits against the oracle engine on
    the card, and after the run 5 steps of a fresh model on that batch
    repeated, whose losses must fall (dropout 0 there: at 0.5 its noise
    can hide five steps of progress)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops

    model = sage_model(r, dev, aggregator)
    lerr = lmax = None
    if first_batch is not None:
        inp, out, blocks, _ = first_batch
        x = r["feat"].index_select(0, inp)
        model.eval()
        with torch.no_grad():
            ops.set_engine("xla")
            try:
                ref = model(blocks, x)
            finally:
                ops.set_engine("auto")
            got = model(blocks, x)
        if got.shape != (REDDIT["batch"], r["classes"]):
            raise AssertionError(f"logits shape {tuple(got.shape)}")
        # The ELL mean adds at most 25 rows in another order than the
        # oracle's index_add; everything else is the same float32 math.
        lerr = float((got - ref).abs().max())
        lmax = float(ref.abs().max())
        if not lerr <= 1e-4 * lmax:
            raise AssertionError(f"{name} logits: engines vs oracle err "
                                 f"{lerr} > 1e-4 * max|logit| ({lmax})")
        del ref, got, x
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    gen = torch.Generator(device=dev).manual_seed(7)
    res = dgl.train_sampled(loader, r["feat"], r["labels"], model,
                            steps=steps, lr=REDDIT["lr"], generator=gen)
    torch.cuda.synchronize()
    counts = all_launches()
    losses = res["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses}")
    expect_exact(name, counts, {k: v * steps for k, v in per_step.items()})
    rec = {
        "phase": "sage_train", "path": name, "aggregator": aggregator,
        "dims": [r["in_f"], REDDIT["hidden"], r["classes"]],
        "fanouts": REDDIT["fanouts"], "batch": REDDIT["batch"],
        "steps": steps, "losses": losses,
        "ms_per_step": [x * 1e3 for x in res["step_s"]],
        "device_step_ms_after_first": float(np.mean(res["step_s"][1:]) * 1e3),
        "wait_ms_per_step": [x * 1e3 for x in res["wait_s"]],
        "host_sample_ms_per_batch": float(np.mean(res["sample_ms"])),
        "host_sample_ms": res["sample_ms"],
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "logits_err_vs_oracle": lerr, "logits_max_abs": lmax,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if first_batch is not None:
        rep = dgl.train_sampled([first_batch] * 5, r["feat"], r["labels"],
                                sage_model(r, dev, aggregator, dropout=0.0),
                                lr=REDDIT["lr"])
        if not rep["losses"][-1] < rep["losses"][0]:
            raise AssertionError(f"{name}: loss on a repeated batch did not "
                                 f"fall: {rep['losses']}")
        rec["repeated_batch_losses"] = rep["losses"]
    log(json.dumps(rec))
    return counts


def profile_sage(dev, r, batches, aggregator="mean", steps=3):
    """Where a Reddit step's device time goes (mean: ``sage_profile``,
    pool: ``sage_pool_profile``): ``torch.profiler`` over ``steps`` steps
    on batches sampled beforehand (so the loader is out of the window),
    after two warm-up steps, as profile_gat; with the window's peak device
    memory."""
    import dgl1_tpu_torch as dgl
    from torch.profiler import ProfilerActivity, profile

    model = sage_model(r, dev, aggregator)
    dgl.train_sampled(batches[:2], r["feat"], r["labels"], model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train_sampled(batches[2:2 + steps], r["feat"], r["labels"],
                          model)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    mean = aggregator == "mean"
    summarize_profile(
        "sage_profile" if mean else "sage_pool_profile",
        "sage_reddit_train" if mean else "sage_reddit_pool_train", prof,
        steps, wall_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def summarize_profile(phase, path, prof, steps, wall_ms, **extra):
    """Device busy time, idle share and the top device kernels of a
    ``torch.profiler`` window of ``steps`` steps; ``extra`` keys join the
    line."""
    events = prof.key_averages()
    # Device spans of host annotations share their name with a host event
    # and would count the same device time twice.
    host_keys = {e.key for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host_keys]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    if not busy_ms > 0:
        raise AssertionError(f"{phase}: the trace holds no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    log(json.dumps({
        "phase": phase, "path": path, "steps": steps,
        "host_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": dev_us(e) / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top],
        **extra}))


# The block-dense workloads: bench.py --matrix's "geometric" family
# (bench.py:57-76: geometric_graph(2^17, 8), F in {32, 128, 512}),
# tools/bench_bdense.py:15 (2^17, degree 8, F=128) and the trainers'
# geometric graph of 2^20 nodes; the RCM route recovers a shuffled copy.
BDENSE_FORMATS = ("coo", "csr", "csc", "ell", "bdense")


def bdense_layout_record(g, seconds):
    m, e = g.bdense_meta, g.num_edges()
    return {"nodes": g.num_nodes(), "edges": e, "build_s": seconds,
            "blocks": m.n_blocks, "covered_share": m.covered / e,
            "tail_edges": e - m.covered,
            "max_row_blocks": m.max_row_blocks,
            "max_col_blocks": m.max_col_blocks,
            "a_dtype": str(g.bdense["a"].dtype),
            "a_mb": nbytes(g.bdense["a"]) / 1e6,
            "hub": g.hub_dst_meta is not None}


def bdense_setup(dev):
    """The geometric graphs of 2^20 and 2^17 nodes (degree 8, seed 0) with
    the block-dense layout, then the RCM route: the 2^17 graph's ids
    shuffled by ``default_rng(1).permutation`` and recovered by
    ``reorder_graph(..., 'rcm', formats=...)`` (coverage at least 95%)."""
    import dgl1_tpu_torch as dgl

    out, rec = {}, {"phase": "bdense_graphs"}
    for name, n in (("g20", 1 << 20), ("g17", 1 << 17)):
        t0 = time.perf_counter()
        out[name] = dgl.data.geometric_graph(n, 8, seed=0,
                                             formats=BDENSE_FORMATS,
                                             device=dev)
        rec[name] = bdense_layout_record(out[name],
                                         time.perf_counter() - t0)
    n = 1 << 17
    src, dst = (x.cpu().numpy() for x in out["g17"].edges())
    shuf = np.random.default_rng(1).permutation(n)
    t0 = time.perf_counter()
    out["shuf"] = dgl.graph((shuf[src], shuf[dst]), num_nodes=n,
                            formats=BDENSE_FORMATS, device=dev)
    rec["shuffled"] = bdense_layout_record(out["shuf"],
                                           time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["rcm"] = dgl.reorder_graph(out["shuf"], "rcm",
                                   formats=BDENSE_FORMATS)
    rec["rcm"] = bdense_layout_record(out["rcm"], time.perf_counter() - t0)
    log(json.dumps(rec))
    for name in ("g20", "g17", "rcm"):
        if out[name].hub_dst is not None or rec[name]["blocks"] == 0:
            raise AssertionError(f"{name}: expected a block-dense layout and "
                                 f"no hub layout: {rec[name]}")
    if not rec["rcm"]["covered_share"] >= 0.95:
        raise AssertionError(f"RCM coverage {rec['rcm']['covered_share']}")
    return out


def _block_args(g, transpose):
    bd = g.bdense
    if transpose:
        return (True, bd["ab"], bd["col_ptr"], bd["rbb"])
    return (False, bd["a"], bd["row_ptr"], bd["cb"])


def _block_sparse(g, transpose):
    """The dense tier as one (n, n) float32 CSR of counts, in the
    direction K11 multiplies (its transpose for ``transpose``): the
    library call's operand."""
    tr, a, ptr, in_blk = _block_args(g, transpose)
    k = g.bdense_meta.n_blocks
    n = g.num_nodes()
    a3 = a[: k * 128].view(k, 128, 128)
    kk, i, j = (a3 != 0).nonzero(as_tuple=True)
    ob = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1,
                                              device=a.device),
                                 torch.diff(ptr.long()))
    out_local, in_local = (j, i) if tr else (i, j)
    rows = ob[kk] * 128 + out_local
    cols = in_blk.long()[kk] * 128 + in_local
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "beta"
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), a3[kk, i, j].float(),
            (n, n)).coalesce().to_sparse_csr()


def block_case(case, g, dev, f, transpose=False, seed=0, library=True,
               bf16=False):
    """K11 at width f on ``g``'s layout, forward or transpose, against its
    float64 plain version (with ``bf16``, both in the bf16 mode). Bytes:
    the count blocks, the run pointers and
    input block ids, the rows of x that a nonzero count needs, and the
    whole output, once each. Operations: 2 per nonzero count and column
    (the sparse product's need); ``dense_flops`` is the dense work over
    the kept blocks that the kernel does."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK

    gen = torch.Generator(device=dev).manual_seed(seed)
    args = _block_args(g, transpose)
    _, a, ptr, in_blk = args
    n, k = g.num_nodes(), g.bdense_meta.n_blocks
    x = torch.randn(n, f, device=dev, generator=gen)
    nz = a[: k * 128].view(k, 128, 128) != 0
    need = nz.any(dim=2) if transpose else nz.any(dim=1)
    x_rows = int(torch.unique((in_blk.long()[:k, None] * 128 + torch.arange(
        128, device=dev))[need]).numel())
    nnz = int(nz.sum())
    lib = None
    if library:
        csr = _block_sparse(g, transpose)
        lib = lambda: torch.sparse.mm(csr, x)  # noqa: E731
    kern = functools.partial(BK.block_mm, bf16=bf16)
    plain = functools.partial(BK.block_mm_torch, bf16=bf16)
    row = kernel_row(
        "block_bwd" if transpose else "block_fwd", kern(*args, x, n),
        plain(*args, x.double(), n), plain(*args, x.abs().double(), n),
        lambda: kern(*args, x, n), lambda: plain(*args, x, n), lib,
        nbytes(a, ptr, in_blk) + x_rows * f * 4 + n * f * 4, 2 * nnz * f,
        {"case": case, "transpose": transpose, "n": n, "f": f, "blocks": k,
         "nnz": nnz, "x_rows_needed": x_rows, "a_dtype": str(a.dtype)},
        library_note=("torch.sparse.mm with the dense tier as a CSR of "
                      "counts" if library else None),
        f32_out=BK.block_mm(*args, x, n) if bf16 else None)
    row["shapes"]["dense_flops"] = 2 * k * 128 * 128 * f
    row["shapes"]["dense_flops_bound_ms"] = (2 * k * 128 * 128 * f
                                             / FP32_FLOPS * 1e3)
    tiles = occupied_sub_tiles(a[: k * 128].view(k, 128, 128), bf16)
    mma = tiles * (1 if bf16 else 3) * 2 * 16 * 16 * (-(-f // 8) * 8)
    row["shapes"].update(occupied_sub_tiles=tiles, sub_tiles=k * 64,
                         mma_flops=mma,
                         mma_flops_bound_ms=mma / BF16_TC_FLOPS * 1e3)
    return row


def occupied_sub_tiles(a3, bf16):
    """The 16 x 16 sub-tiles with a nonzero count that K11 multiplies,
    summed over the bf16 planes it stages (one for bf16 counts or the bf16
    mode; hi, mid and lo of float32 counts otherwise)."""
    planes = [a3.to(torch.bfloat16)]
    if a3.dtype == torch.float32 and not bf16:
        rest = a3 - planes[0].float()
        planes.append(rest.to(torch.bfloat16))
        planes.append((rest - planes[1].float()).to(torch.bfloat16))
    k = a3.shape[0]
    return sum(int((p.view(k, 8, 16, 8, 16) != 0).any(dim=4).any(dim=2)
                   .sum()) for p in planes)


def phase_block_kernels(dev, bg):
    """K11 forward at GCN layer 1 (2^20 nodes, F=128) and transpose at
    layer 2's backward (F=40), each against its float64 plain version,
    with the other shapes as ``variants``: the other direction at the
    other width on 2^20 nodes, bench.py's matrix (2^17 nodes, F=32, 128,
    512), the RCM graph at F=128 and the main shape in the bf16 mode."""

    def variants(transpose, cases):
        return [block_case(c, g, dev, f, transpose, seed=i + 1,
                           library=False)
                for i, (c, g, f) in enumerate(cases)]

    g20, g17, rcm = bg["g20"], bg["g17"], bg["rcm"]
    rows = {}
    for tr, (main_f, other_f) in ((False, (128, 40)), (True, (40, 128))):
        main = block_case(f"geo2e20_f{main_f}", g20, dev, main_f, tr)
        rows[main["name"]] = with_variants(main, variants(tr, [
            (f"geo2e20_f{other_f}", g20, other_f),
            ("geo2e17_f32", g17, 32), ("geo2e17_f128", g17, 128),
            ("geo2e17_f512", g17, 512), ("rcm2e17_f128", rcm, 128)])
            + [block_case(f"geo2e20_f{main_f}", g20, dev, main_f, tr,
                          seed=9, library=False, bf16=True)])
    return rows


def bdense_gspmm_path(name, g, dev, f):
    """copy_u with sum and mean, forward and grad_u, through dispatch
    "auto" against the oracle engine; K11 forward and transpose must
    launch and every other kernel stay at 0; edges/s of the sum."""
    from dgl1_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(3)
    n, e = g.num_nodes(), g.num_edges()
    u = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(n, f, device=dev, generator=gen)

    def run(engine, uu, ww, red):
        ops.set_engine(engine)
        try:
            x = uu.clone().requires_grad_(True)
            out = ops.gspmm(g, "copy_lhs", red, x, None)
            (gx,) = torch.autograd.grad((out * ww).sum(), x)
        finally:
            ops.set_engine("auto")
        return out.detach(), gx

    rec = {"phase": "bdense_gspmm", "path": name, "nodes": n, "edges": e,
           "f": f}
    for red in ("sum", "mean"):
        ref = run("xla", u, w, red)
        scale = run("xla", u.abs(), w.abs(), red)
        reset_all_launches()
        got = run("auto", u, w, red)
        torch.cuda.synchronize()
        counts = all_launches()
        expect_exact(name, counts, {"block_fwd": 1, "block_bwd": 1})
        rec[red] = {"fwd_err": check(f"{name} {red} fwd", got[0], ref[0],
                                     scale[0]),
                    "bwd_err": check(f"{name} {red} bwd", got[1], ref[1],
                                     scale[1])}
        del ref, scale, got
    fwd_ms = cuda_ms(lambda: ops.gspmm(g, "copy_lhs", "sum", u, None))
    ur = u.clone().requires_grad_(True)
    out = ops.gspmm(g, "copy_lhs", "sum", ur, None)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, ur, w,
                                                 retain_graph=True))
    rec.update({"launches": counts, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                "fwd_edges_per_s": e / (fwd_ms * 1e-3),
                "bwd_edges_per_s": e / (bwd_ms * 1e-3)})
    log(json.dumps(rec))


def rcm_route(dev, bg, f=128):
    """The aggregate on the RCM-reordered graph (through "auto": K11 and
    the tail) against the oracle on the shuffled graph, mapped through
    ``ndata['_ID']``."""
    from dgl1_tpu_torch import ops

    g_shuf, g_rcm = bg["shuf"], bg["rcm"]
    perm = g_rcm.ndata["_ID"].long()
    u = torch.randn(g_shuf.num_nodes(), f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    reset_all_launches()
    got = ops.gspmm(g_rcm, "copy_lhs", "sum", u[perm], None)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact("rcm_route", counts, {"block_fwd": 1})
    ops.set_engine("xla")
    try:
        ref = ops.gspmm(g_shuf, "copy_lhs", "sum", u, None)[perm]
        scale = ops.gspmm(g_shuf, "copy_lhs", "sum", u.abs(), None)[perm]
    finally:
        ops.set_engine("auto")
    log(json.dumps({"phase": "bdense_rcm_route", "f": f,
                    "err": check("rcm_route", got, ref, scale),
                    "covered_share": g_rcm.bdense_meta.covered
                    / g_rcm.num_edges(), "launches": counts}))


def bdense_inputs(g, dev, classes=40, in_f=128):
    gen = torch.Generator(device=dev).manual_seed(0)
    n = g.num_nodes()
    return (torch.randn(n, in_f, device=dev, generator=gen),
            torch.randint(0, classes, (n,), device=dev, generator=gen))


def phase_bdense_gcn(name, dev, g, steps):
    """The GCN trainer (the arxiv GCN's widths 128 -> 256 -> 40, dropout
    0, Adam 1e-2) on the geometric graph: step-0 logits against the oracle
    engine, losses finite and falling, exactly K11 forward 2 and transpose
    1 per step and every other kernel 0."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import GCN

    feat, labels = bdense_inputs(g, dev)
    model = GCN(128, 256, 40, num_layers=2, dropout=0.0, device=dev,
                generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ops.set_engine("xla")
        try:
            ref = model(g, feat)
        finally:
            ops.set_engine("auto")
        lerr, lmax = logits_vs(name, "oracle", model(g, feat), ref, 1e-4)
    del ref
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=steps, lr=1e-2)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact(name, counts, {"block_fwd": 2 * steps,
                                "block_bwd": steps})
    train_record("bdense_gcn_train", name, g, res, counts, steps,
                 dims=[128, 256, 40], logits_err_vs_oracle=lerr,
                 logits_max_abs=lmax)
    return counts


def phase_bdense_gat(name, dev, g, steps, drop=0.0):
    """The GAT trainer (the arxiv GAT's widths 128 -> 8 x 32 -> 40, Adam
    1e-2) on the geometric graph. At dropout 0: step-0 logits against the
    composed chain on the oracle engine (the same model on the graph
    without its layout), ``bdense_gat_attention`` called twice per step
    (``battention.CALLS``), losses falling. At ``drop`` > 0 (features and
    attention) the composed chain runs and the counter stays. No kernel
    launches either way."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import GAT
    from dgl1_tpu_torch.ops import battention

    feat, labels = bdense_inputs(g, dev)
    model = GAT(128, 32, 40, heads=8, out_heads=1, feat_drop=drop,
                attn_drop=drop, device=dev,
                generator=torch.Generator().manual_seed(2))
    extra = {}
    if drop == 0.0:
        gv = copy.copy(g)
        gv.bdense = gv.bdense_meta = None
        model.eval()
        with torch.no_grad():
            ops.set_engine("xla")
            try:
                ref = model(gv, feat)
            finally:
                ops.set_engine("auto")
            lerr, lmax = logits_vs(name, "composed", model(g, feat), ref,
                                   1e-4)
        extra = {"logits_err_vs_composed": lerr, "logits_max_abs": lmax}
        del ref, gv
        model.train()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    calls0 = battention.CALLS["bdense_gat_attention"]
    res = dgl.train(g, feat, labels, model, steps=steps, lr=1e-2,
                    generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    counts = all_launches()
    calls = battention.CALLS["bdense_gat_attention"] - calls0
    expect_exact(name, counts, {})
    want_calls = 2 * steps if drop == 0.0 else 0
    if calls != want_calls:
        raise AssertionError(f"{name}: bdense_gat_attention ran {calls} "
                             f"times, expected {want_calls}")
    losses = res["losses"]
    if drop == 0.0:
        train_record("bdense_gat_train", name, g, res, counts, steps,
                     dims=[128, [8, 32], 40], drop=drop,
                     battention_calls=calls, **extra)
    else:
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss: {losses}")
        log(json.dumps({
            "phase": "bdense_gat_train", "path": name, "drop": drop,
            "steps": steps, "losses": losses,
            "ms_per_step": [x * 1e3 for x in res["step_s"]],
            "battention_calls": calls, "launches": counts,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    return counts


def profile_bdense(dev, g, model_name, steps, warmup):
    """Where a block-dense trainer step's device time goes:
    ``torch.profiler`` over ``steps`` steps after ``warmup`` steps of the
    GCN or the GAT (dropout 0); as profile_gat."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import GAT, GCN
    from torch.profiler import ProfilerActivity, profile

    feat, labels = bdense_inputs(g, dev)
    gen = torch.Generator().manual_seed(2)
    if model_name == "gcn":
        model = GCN(128, 256, 40, num_layers=2, dropout=0.0, device=dev,
                    generator=gen)
    else:
        model = GAT(128, 32, 40, heads=8, feat_drop=0.0, attn_drop=0.0,
                    device=dev, generator=gen)
    dgl.train(g, feat, labels, model, steps=warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train(g, feat, labels, model, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summarize_profile(f"bdense_{model_name}_profile",
                      f"bdense_{model_name}_geo2e20_train", prof, steps,
                      wall_ms)


def strip_gperm(g):
    """A view of ``g`` whose backward layout has no gperm descriptors, as
    a layout built before them would: the attention then takes grad_er
    from K7 g-major over the forward layout, as the reference does."""
    gs = copy.copy(g)
    gs.hub_dst = dict(g.hub_dst)
    gs.hub_dst["full_bwd"] = {k: v for k, v in g.hub_dst["full_bwd"].items()
                              if k not in ("gperm", "gout", "gfirst")}
    return gs


def phase_gat_gmajor(name, dev, g, steps):
    """The GAT trainer (128 -> 8 x 32 -> 40, dropout 0, Adam 1e-2) on
    ``g`` with gperm/gout/gfirst removed from ``full_bwd``. Step-0 grads of
    every parameter against the normal route's (K7 + K8): max |diff| <=
    1e-4 * max |grad| per parameter (the same terms summed in another
    order). Then ``steps`` steps with exact launches per step: K7 g-major
    2, K6 2, K7 2, K8 0 and every other kernel 0."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import GAT

    n, in_f, classes = g.num_nodes(), 128, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = GAT(in_f, 32, classes, heads=8, out_heads=1, feat_drop=0.0,
                attn_drop=0.0, device=dev,
                generator=torch.Generator().manual_seed(2))
    gs = strip_gperm(g)
    grads = []
    for graph in (g, gs):
        model.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(model(graph, feat),
                                          labels.long()).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    rel = {k: float((a - grads[1][k]).abs().max()
                    / a.abs().max().clamp_min(1e-30))
           for k, a in grads[0].items()}
    bad = {k: v for k, v in rel.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"{name}: step-0 grads differ from the gperm "
                             f"route's: {bad}")
    del grads
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(gs, feat, labels, model, steps=steps, lr=1e-2)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact(name, counts, {"attn_fwd": 2 * steps,
                                "attn_bwd_src": 2 * steps,
                                "attn_bwd_grp": 2 * steps})
    train_record("gat_train", name, gs, res, counts, steps,
                 dims=[in_f, [8, 32], classes],
                 step0_grad_rel_err_vs_gperm_route=rel)
    return counts


def per_step(counts, steps):
    """A trainer run's launches per step (each a whole multiple)."""
    out = {}
    for k, v in counts.items():
        if v % steps:
            raise AssertionError(f"{k}: {v} launches in {steps} steps")
        if v:
            out[k] = v // steps
    return out


def phase_bench_models(dev, model, graph, step_counts, epochs=5):
    """``dgl1_tpu_torch.tools.bench_models.bench(model, 'arxiv')`` on the
    prebuilt ``graph`` for ``epochs`` timed steps after its warm-up step,
    in f32 and then in bf16 (its ``--precision bf16`` mode), counters
    zeroed before each run and read after. Launches exact: the same
    model's trainer run above per step (``step_counts``) times the steps
    bench takes; in bf16 every kernel with a bf16 instantiation (K1, K4a,
    K6, K7 here) launches only that one. Step-0 losses of the two
    precisions within 2e-2. Returns the two runs' (path, counts)."""
    from dgl1_tpu_torch.ops import matmul_precision
    from dgl1_tpu_torch.tools.bench_models import bench

    runs, losses = [], {}
    for prec in ("f32", "bf16"):
        torch.cuda.empty_cache()
        reset_all_launches()
        with matmul_precision(prec):
            rec = bench(model, "arxiv", epochs=epochs, device=dev,
                        graph=graph)
        torch.cuda.synchronize()
        counts = all_launches()
        path = f"bench_{model}_arxiv_{prec}"
        want = {}
        for k, v in step_counts.items():
            if prec == "bf16" and f"{k}.bf16" in counts:
                k = f"{k}.bf16"
            want[k] = v * rec["steps"]
        expect_exact(path, counts, want)
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise AssertionError(f"{path}: non-finite loss {rec['losses']}")
        losses[prec] = rec["losses"]
        log(json.dumps(dict(rec, phase="bench_models", path=path,
                            precision=prec,
                            launches={k: v for k, v in counts.items() if v},
                            launches_per_step=per_step(counts,
                                                       rec["steps"]))))
        runs.append((path, counts))
    d0 = abs(losses["bf16"][0] - losses["f32"][0])
    if not d0 <= 2e-2:
        raise AssertionError(f"bench {model}: step-0 loss bf16 "
                             f"{losses['bf16'][0]} vs f32 {losses['f32'][0]}")
    log(json.dumps({"phase": "bench_models_bf16_vs_f32", "model": model,
                    "step0_loss_diff": d0}))
    return runs


def _kernel_modules():
    from dgl1_tpu_torch.ops import attn_kernels as AK
    from dgl1_tpu_torch.ops import bdense_kernels as BK
    from dgl1_tpu_torch.ops import hub_kernels as K
    from dgl1_tpu_torch.ops import tile_kernels as TK

    return K, AK, TK, BK


def reset_all_launches():
    for m in _kernel_modules():
        m.reset_launches()


def all_launches():
    out = {}
    for m in _kernel_modules():
        out.update(m.LAUNCHES)
    return out


def expect_launches(name, counts, expect):
    missing = [k for k in expect if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}: {counts}")


def gspmm_path(name, g, dev, f, expect):
    """copy_u+sum forward and backward through the hub engine against
    the oracle engine; counters zeroed before and read after; every
    kernel in ``expect`` must have launched."""
    from dgl1_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(1)
    n, e = g.num_nodes(), g.num_edges()
    u = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(n, f, device=dev, generator=gen)
    ops.set_engine("xla")
    ur = u.clone().requires_grad_(True)
    ref = ops.gspmm(g, "copy_lhs", "sum", ur, None)
    (gref,) = torch.autograd.grad((ref * w).sum(), ur)
    # Tolerance scales: A|u| for the forward, A^T|w| for grad_u.
    scale = ops.gspmm(g, "copy_lhs", "sum", u.abs(), None)
    us = u.clone().requires_grad_(True)
    (gscale,) = torch.autograd.grad(
        (ops.gspmm(g, "copy_lhs", "sum", us, None) * w.abs()).sum(), us)
    ops.set_engine("hub")
    try:
        uh = u.clone().requires_grad_(True)
        reset_all_launches()
        out = ops.gspmm(g, "copy_lhs", "sum", uh, None)
        (gh,) = torch.autograd.grad((out * w).sum(), uh)
        torch.cuda.synchronize()
        counts = all_launches()
        expect_launches(name, counts, expect)
        err_f = check(f"{name} fwd", out, ref, scale)
        err_b = check(f"{name} bwd", gh, gref, gscale)
        fwd_ms = cuda_ms(lambda: ops.gspmm(g, "copy_lhs", "sum", u, None))
        uh2 = u.clone().requires_grad_(True)
        out2 = ops.gspmm(g, "copy_lhs", "sum", uh2, None)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out2, uh2, w,
                                                     retain_graph=True))
    finally:
        ops.set_engine("auto")
    log(json.dumps({
        "phase": "gspmm", "path": name, "nodes": n, "edges": e, "f": f,
        "meta": {"n_groups": g.hub_dst_meta.n_groups,
                 "n_dense": g.hub_dst_meta.n_dense,
                 "identity_expand": g.hub_dst_meta.identity_expand},
        "chunked_edge_share": chunked_share(g),
        "launches": counts, "fwd_err": err_f, "bwd_err": err_b,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_edges_per_s": e / (fwd_ms * 1e-3),
        "bwd_edges_per_s": e / (bwd_ms * 1e-3)}))


def phase_gcn(name, dev, g, steps, expect):
    """The GCN trainer (128 -> 256 -> 40, Adam 1e-2) for ``steps`` steps on
    ``g``; counters zeroed before and read after; every kernel in
    ``expect`` must have launched."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import GCN

    n, in_f, hidden, classes = g.num_nodes(), 128, 256, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    model = GCN(in_f, hidden, classes, num_layers=2, dropout=0.0,
                device=dev, generator=torch.Generator().manual_seed(2))
    # Logits through the hub engine against the oracle engine, same
    # weights, before any step.
    with torch.no_grad():
        ops.set_engine("xla")
        ref = model(g, feat)
        ops.set_engine("auto")
        out = model(g, feat)
    if out.shape != (n, classes):
        raise AssertionError(f"logits shape {tuple(out.shape)}")
    # The top hub row sums 2.8M non-negative layer-2 terms in float32;
    # two summation orders differ there by ~1e-4 of the largest logit.
    lerr = float((out - ref).abs().max())
    lmax = float(ref.abs().max())
    if not lerr <= 1e-3 * lmax:
        raise AssertionError(f"{name} logits: hub vs oracle err {lerr} > "
                             f"1e-3 * max|logit| ({lmax})")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=steps, lr=1e-2)
    torch.cuda.synchronize()
    counts = all_launches()
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    expect_launches(name, counts, expect)
    log(json.dumps({
        "phase": "gcn_train", "path": name, "nodes": n,
        "edges": g.num_edges(),
        "dims": [in_f, hidden, classes], "steps": steps, "losses": losses,
        "ms_per_step": [s * 1e3 for s in res["step_s"]],
        "ms_per_step_after_first": float(np.mean(res["step_s"][1:]) * 1e3),
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "logits_err_vs_oracle": lerr, "logits_max_abs": lmax,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    return counts


# ----------------------------------------------------------------------
# Phase 4h: the distributed layer (dgl1_tpu_torch/parallel). The machine
# has one card and NCCL takes one rank a device, so the distributed path
# runs at world size 1 over NCCL; the 4-part builds run each partition's
# local operation in turn in this one process, the halo rows filled on the
# host from the global features (PartitionedGraph.combined_from_global).
# ----------------------------------------------------------------------

DIST = dict(parts=4, f=128, h=8, d=32, flagship_steps=5, sage_steps=3,
            flagship_dims=(128, 256, 40), lr=1e-2)


def phase_dist_init():
    """``parallel.initialize`` at world size 1 on NCCL (a TCP store on
    localhost)."""
    import socket

    import torch.distributed as dist
    from dgl1_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    backend = parallel.initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=120,
                                  device="cuda")
    if backend != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"initialize gave {backend}, world "
                             f"{dist.get_world_size()}")
    log(json.dumps({"phase": "dist_init", "backend": backend,
                    "world_size": dist.get_world_size(),
                    "seconds": time.perf_counter() - t0}))


def phase_dryrun_legs(dev):
    """The dry run's legs 1-7 and 11 (tools/dryrun_multichip.py) at world
    size 1 over NCCL, at the reference's sizes; one JSON line a leg (its
    seconds include the host builds)."""
    from dgl1_tpu_torch.tools.dryrun_multichip import run_legs

    reset_all_launches()
    t0 = time.perf_counter()
    run_legs(0, 1, dev, log=lambda r: log(json.dumps(
        dict(r, phase="dryrun_leg"))))
    torch.cuda.synchronize()
    counts = all_launches()
    log(json.dumps({"phase": "dryrun_done", "seconds":
                    time.perf_counter() - t0,
                    "launches": {k: v for k, v in counts.items() if v}}))
    return counts


def _gcn_oracle64(g, feat, params, absolute=False):
    """The 2-layer GCN logits ``A relu(A X W1 + b1) W2 + b2`` (A = D^-1/2
    A D^-1/2 with global degrees) in float64 on the oracle engine; with
    ``absolute`` every value and weight by its absolute value and relu by
    abs, each logit's sum over absolute values."""
    from dgl1_tpu_torch import ops

    no = g.out_degrees().double().clamp(min=1.0) ** -0.5
    ni = g.in_degrees().double().clamp(min=1.0) ** -0.5
    w1, b1, w2, b2 = (params[k].detach().double()
                      for k in ("w1", "b1", "w2", "b2"))
    x = feat.double()
    if absolute:
        w1, b1, w2, b2, x = (t.abs() for t in (w1, b1, w2, b2, x))

    def a(h):
        return ops.gspmm(g, "copy_lhs", "sum", h * no[:, None],
                         None) * ni[:, None]

    ops.set_engine("xla")
    try:
        h = a(x) @ w1 + b1
        h = h.abs() if absolute else torch.relu(h)
        return a(h) @ w2 + b2
    finally:
        ops.set_engine("auto")


def phase_dist_flagship(name, dev, g):
    """BASELINE configuration #5's trainer, the flagship combined +
    prefilled identity sharded GCN (``build_partitioned_graph(hub=True,
    hub_identity=True)`` at P = 1) on the arxiv trainer's graph, 128 -> 256
    -> 40, Adam 1e-2, 5 steps: step-0 logits within 1e-4 of each logit's
    float64 abs sum against the float64 oracle, exact hub launches a step
    (layer 1's input needs no gradient: K1 twice, K4a or K4b once, K2
    three times where a chunked group exists, no K3 on the identity
    layout), ms a step, then a profile of 2 steps."""
    from dgl1_tpu_torch.ops.engine_hub import _use_fused_bwd
    from dgl1_tpu_torch.parallel import build_partitioned_graph
    from dgl1_tpu_torch.parallel.sharded_ops import (
        fill_halo_combined, make_sharded_gcn_matvec_combined)
    from dgl1_tpu_torch.parallel.train import (init_gcn_params,
                                               make_gcn_train_step)
    from torch.profiler import ProfilerActivity, profile

    in_f, hidden, classes = DIST["flagship_dims"]
    steps = DIST["flagship_steps"]
    t0 = time.perf_counter()
    pg = build_partitioned_graph(g, np.zeros(g.num_nodes(), np.int32), 1,
                                 tiles=False, hub=True, hub_identity=True)
    build_s = time.perf_counter() - t0
    m = pg.hub_meta
    if m is None or not m.identity_expand:
        raise AssertionError(f"{name}: no identity hub layout: {m}")
    pl = pg.local(0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(g.num_nodes(), in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (g.num_nodes(),), device=dev,
                           generator=gen)
    x = fill_halo_combined(pl)(pg.shard_node_data_combined(feat, 0))
    y = pg.shard_node_data(labels, 0)
    mask = torch.as_tensor(pg.node_mask[0], device=dev)
    params = init_gcn_params(in_f, hidden, classes, device=dev,
                             generator=torch.Generator().manual_seed(2))
    # Step-0 logits against the float64 oracle.
    mv1 = make_sharded_gcn_matvec_combined(pl, halo_filled=True)
    mv = make_sharded_gcn_matvec_combined(pl)
    with torch.no_grad():
        h = torch.relu(mv1(x) @ params["w1"] + params["b1"])
        logits = (mv(h) @ params["w2"] + params["b2"])[: pl.n_loc]
        got = pg.unshard_node_data(logits[None])
    ref = _gcn_oracle64(g, feat, params)
    bound_ = _gcn_oracle64(g, feat, params, absolute=True)
    lerr, lrel = logits_vs_abs(name, "float64 oracle", got, ref, bound_)
    del ref, bound_, got, h, logits
    opt = torch.optim.Adam(params.values(), lr=DIST["lr"])
    step, _ = make_gcn_train_step(pl, opt, classes, combined=True,
                                  prefilled=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(step(params, x, y, mask))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    counts = all_launches()
    fused = _use_fused_bwd(m, pl.hub)
    chunked = m.n_groups > m.n_dense
    want = {"dense_fwd": 2 if m.n_dense else 0,
            "dense_bwd_fused": 1 if fused else 0,
            "dense_bwd": 1 if (m.n_dense and not fused) else 0,
            "chunk_sum": 3 if chunked else 0}
    expect_exact(name, counts, {k: v * steps for k, v in want.items()})
    rec = {"phase": "dist_gcn_train", "path": name,
           "nodes": g.num_nodes(), "edges": g.num_edges(),
           "dims": [in_f, hidden, classes], "steps": steps,
           "build_s": build_s, "hub_rows": pg.hub_rows, "n_loc": pg.n_loc,
           "meta": {"n_groups": m.n_groups, "n_dense": m.n_dense,
                    "n_tail_rows": m.n_tail_rows,
                    "identity_expand": m.identity_expand,
                    "covered": m.covered, "has_diag": m.has_diag},
           "losses": losses, "ms_per_step": [s * 1e3 for s in step_s],
           "ms_per_step_after_first": float(np.mean(step_s[1:]) * 1e3),
           "launches": {k: v for k, v in counts.items() if v},
           "launches_per_step": want,
           "logits_err_vs_oracle64": lerr,
           "logits_err_over_abs_sum": lrel,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    log(json.dumps(rec))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(2):
            step(params, x, y, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / 2
    summarize_profile("dist_gcn_profile", name, prof, 2, wall_ms)
    return counts


def phase_dist_sage(name, dev, r):
    """The data-parallel sampled GraphSAGE at the Reddit configuration
    (602 -> 256 -> 41, fanouts [10, 25], batch 1024, Adam 1e-3, dropout 0)
    through ``DistGraph`` (one part) and ``DistNodeDataLoader`` at world
    size 1: the features a host ``DistTensor``, gathered per batch in the
    loader's 2 workers and copied to the card, gradients averaged over
    the world; 3 steps, K9 once a step exactly, host sampling and pull ms
    a batch."""
    from dgl1_tpu_torch.dataloading import NeighborSampler
    from dgl1_tpu_torch.parallel import (DistGraph, DistNodeDataLoader,
                                         DistTensor, node_split)
    from dgl1_tpu_torch.parallel.train import make_dp_sampled_step

    steps = DIST["sage_steps"]
    g = r["g"]
    dg = DistGraph(g, 1, part=np.zeros(g.num_nodes(), np.int32))
    dg.ndata["feat"] = DistTensor(dg.book, {0: r["feat"].cpu().numpy()},
                                  name="feat")
    seeds = node_split(np.asarray(r["train_ids"]), dg.book, 0)
    loader = DistNodeDataLoader(
        dg, seeds, NeighborSampler(REDDIT["fanouts"]),
        batch_size=REDDIT["batch"], shuffle=True, seed=0, device=dev,
        num_workers=2, prefetch=2)
    model = sage_model(r, dev, "mean", dropout=0.0)
    step = make_dp_sampled_step(model, torch.optim.Adam(
        model.parameters(), lr=REDDIT["lr"]))
    reset_all_launches()
    losses, step_s, wait_s = [], [], []
    it = iter(loader)
    for _ in range(steps):
        t0 = time.perf_counter()
        inp, out, blocks, mask, x = next(it)
        t1 = time.perf_counter()
        y = r["labels"].index_select(0, out)
        losses.append(step(blocks, x, y, mask))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        wait_s.append(t1 - t0)
    it.close()
    counts = all_launches()
    expect_exact(name, counts, {"tile_sum": steps})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    sample_ms = [s * 1e3 for s in loader.loader.sample_s[:steps]]
    pull_ms = [s * 1e3 for s in loader.loader.pull_s[:steps]]
    log(json.dumps({
        "phase": "dist_sage_train", "path": name, "world_size": 1,
        "dims": [r["in_f"], REDDIT["hidden"], r["classes"]],
        "fanouts": REDDIT["fanouts"], "batch": REDDIT["batch"],
        "steps": steps, "losses": losses,
        "ms_per_step": [s * 1e3 for s in step_s],
        "wait_ms_per_step": [s * 1e3 for s in wait_s],
        "host_sample_ms_per_batch": float(np.mean(sample_ms)),
        "host_sample_ms": sample_ms,
        "host_pull_ms_per_batch": float(np.mean(pull_ms)),
        "host_pull_ms": pull_ms, "launches": {
            k: v for k, v in counts.items() if v}}))
    return counts


def dist_part_builds():
    """The 4-part host builds of the dry run's graphs: leg 1's with tiles
    (K9; the leg itself takes the segment path), leg 3's vertex cut, leg
    5's hub layouts with and without the identity relabel and those of its
    symmetric copy (dense and chunked groups and a tail), leg 7's
    block-dense; partitioner and build seconds."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel import (build_partitioned_graph,
                                         vertex_cut_edge_owner)
    from dgl1_tpu_torch.parallel.partition import greedy_partition_assignment

    p_ = DIST["parts"]
    secs, builds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[key] = time.perf_counter() - t0
        return out

    g1 = dgl.to_bidirected(dgl.data.powerlaw_graph(100_000, 12, seed=0,
                                                   device="cpu"))
    part1 = timed("greedy_leg1", lambda: greedy_partition_assignment(
        g1, p_, balance_edges=True))
    builds["leg1_tiles"] = (g1, timed("build_leg1_tiles", lambda:
                                      build_partitioned_graph(g1, part1,
                                                              p_)))
    g3 = dgl.data.powerlaw_graph(20_000, 5, seed=1, device="cpu")
    part3 = timed("greedy_leg3", lambda: greedy_partition_assignment(
        g3, p_, balance_edges=True))
    eo = vertex_cut_edge_owner(g3, part3, p_)
    builds["leg3_vertex_cut"] = (g3, timed(
        "build_leg3_vertex_cut", lambda: build_partitioned_graph(
            g3, part3, p_, edge_owner=eo)))
    g5 = dgl.data.powerlaw_graph(12_000, 6, seed=4, device="cpu")
    part5 = timed("greedy_leg5", lambda: greedy_partition_assignment(
        g5, p_, balance_edges=True))
    for key, ident in (("leg5_hub", False), ("leg5_hub_identity", True)):
        builds[key] = (g5, timed(f"build_{key}", lambda: (
            build_partitioned_graph(g5, part5, p_, tiles=False, hub=256,
                                    hub_dense_floor=512,
                                    hub_identity=ident))))
    # Leg 5's graph made symmetric: its parts keep a tail (K4a's fused
    # tail; leg 5's own hub groups cover every edge, so it takes K4b) and
    # chunked groups (K2).
    g5b = dgl.to_bidirected(g5)
    part5b = timed("greedy_leg5_bidir", lambda: greedy_partition_assignment(
        g5b, p_, balance_edges=True))
    builds["leg5_bidir_hub"] = (g5b, timed(
        "build_leg5_bidir_hub", lambda: build_partitioned_graph(
            g5b, part5b, p_, tiles=False, hub=256, hub_dense_floor=512)))
    n7 = 50_000
    rng7 = np.random.default_rng(3)
    s7 = rng7.integers(0, n7, n7 * 8)
    d7 = np.clip(s7 + rng7.integers(-150, 150, n7 * 8), 0, n7 - 1)
    g7 = dgl.graph((s7, d7), num_nodes=n7, device="cpu")
    part7 = (np.arange(n7) * p_ // n7).astype(np.int32)
    builds["leg7_bdense"] = (g7, timed("build_leg7_bdense", lambda: (
        build_partitioned_graph(g7, part7, p_, bdense=True))))
    t0 = time.perf_counter()
    from dgl1_tpu_torch.parallel.partition import metis_partition_assignment

    metis_partition_assignment(g5, p_)
    secs["metis_leg5"] = time.perf_counter() - t0
    log(json.dumps({"phase": "dist_part_builds", "parts": p_,
                    "seconds": secs,
                    "builds": {k: {"n_loc": pg.n_loc, "e_loc": pg.e_loc,
                                   "m_halo": pg.m_halo, "m_part": pg.m_part,
                                   "hub_rows": pg.hub_rows,
                                   "hub_meta": repr(pg.hub_meta)}
                               for k, (_, pg) in builds.items()}}))
    return builds


def _scatter_rows(total, ids, rows):
    """``total[ids] += rows`` over the rows whose id is not -1."""
    ok = ids >= 0
    total.index_add_(0, ids[ok], rows[ok])


def part_spmm_check(name, g, pg, dev):
    """Each partition's local copy_u sum (``local_spmm_sum``: tiles, hub or
    block-dense, vertex-cut partial slots) forward and backward on the
    card in turn, every partition's result against the same call on the
    CPU (the kernels' plain versions), then the assembled owned rows and
    the gradient against the float64 single-device oracle. Counters count
    the card's calls only."""
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.parallel.sharded_ops import local_spmm_sum

    f, n = DIST["f"], g.num_nodes()
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(n, f, generator=gen)
    w = torch.randn(n, f, generator=gen)
    gd = g.to(dev)
    ops.set_engine("xla")
    try:
        xr = x.to(dev).double().requires_grad_(True)
        ref = ops.gspmm(gd, "copy_lhs", "sum", xr, None)
        (gref,) = torch.autograd.grad((ref * w.to(dev).double()).sum(), xr)
        scale = ops.gspmm(gd, "copy_lhs", "sum", x.abs().to(dev).double(),
                          None)
        us = x.abs().to(dev).double().requires_grad_(True)
        (gscale,) = torch.autograd.grad(
            (ops.gspmm(gd, "copy_lhs", "sum", us, None)
             * w.abs().to(dev).double()).sum(), us)
    finally:
        ops.set_engine("auto")
    y_all = torch.zeros(n, f, device=dev)
    g_all = torch.zeros(n, f, device=dev)
    per_part = []
    reset_all_launches()
    for p in range(pg.num_parts):
        pl = pg.local(p, dev)
        comb = pg.combined_from_global(x, p).to(dev).requires_grad_(True)
        oid = torch.as_tensor(pg.output_ids(p), device=dev)
        cid = torch.as_tensor(pg.combined_ids(p), device=dev)
        y = local_spmm_sum(pl, comb)
        ct = torch.where((oid >= 0)[:, None],
                         w.to(dev).index_select(0, oid.clamp(min=0)),
                         torch.zeros((), device=dev))
        (gc,) = torch.autograd.grad((y * ct).sum(), comb)
        _scatter_rows(y_all, oid, y.detach())
        _scatter_rows(g_all, cid, gc)
        per_part.append((p, comb.detach(), ct, y.detach(), gc))
    torch.cuda.synchronize()
    counts = all_launches()
    # Each partition's card result against its plain versions (the same
    # call on CPU tensors), outside the counted window.
    errs = []
    for p, comb, ct, y, gc in per_part:
        pc = pg.local(p, "cpu")
        cc = comb.cpu().requires_grad_(True)
        yc = local_spmm_sum(pc, cc)
        (gcc,) = torch.autograd.grad((yc * ct.cpu()).sum(), cc)
        pl_abs = pg.local(p, dev)
        with torch.no_grad():
            ys = local_spmm_sum(pl_abs, comb.abs())
        ca = comb.abs().requires_grad_(True)
        (gs,) = torch.autograd.grad((local_spmm_sum(pl_abs, ca)
                                     * ct.abs()).sum(), ca)
        errs.append({"part": p,
                     "fwd": check(f"{name} part {p} fwd vs plain", y,
                                  yc.to(dev), ys),
                     "bwd": check(f"{name} part {p} bwd vs plain", gc,
                                  gcc.to(dev), gs)})
    err_f = check(f"{name} fwd vs oracle", y_all, ref.float(), scale)
    err_b = check(f"{name} bwd vs oracle", g_all, gref.float(), gscale)
    log(json.dumps({"phase": "dist_part_spmm", "path": name,
                    "parts": pg.num_parts, "nodes": n,
                    "edges": g.num_edges(), "f": f,
                    "launches": {k: v for k, v in counts.items() if v},
                    "fwd_err_vs_oracle": err_f, "bwd_err_vs_oracle": err_b,
                    "parts_vs_plain": errs}))
    return counts


def part_gat_check(name, g, pg, dev):
    """The fused attention (K6, K7, K8) on each partition's hub layout in
    turn (``fused_attention_local``, H = 8, D = 32), each partition's result
    and gradients against the same call on the CPU (the plain versions),
    then the assembled owned rows and gradients against the composed
    path on the float64 oracle (as gat_attention_path)."""
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.parallel.sharded_ops import fused_attention_local

    h, d, n = DIST["h"], DIST["d"], g.num_nodes()
    gen = torch.Generator().manual_seed(22)
    el, er = (torch.randn(n, h, generator=gen) for _ in range(2))
    ft = torch.randn(n, h, d, generator=gen)
    w = torch.randn(n, h, d, generator=gen)
    gv = composed_view(g.to(dev))

    def composed(a, b, c):
        att = ops.edge_softmax(gv, torch.nn.functional.leaky_relu(
            ops.gsddmm(gv, "add", a[:, :, None], b[:, :, None]), SLOPE))
        return ops.gspmm(gv, "mul", "sum", c, att)

    ops.set_engine("xla")
    try:
        rin = [t.to(dev).double().requires_grad_(True) for t in (el, er, ft)]
        ref = composed(*rin)
        rgrads = torch.autograd.grad((ref * w.to(dev).double()).sum(), rin)
        with torch.no_grad():
            scale = composed(*(t.to(dev).double() for t in
                               (el, er, ft.abs())))
        ref = ref.detach()
    finally:
        ops.set_engine("auto")
    outs = [torch.zeros(n, h, d, device=dev), torch.zeros(n, h, device=dev),
            torch.zeros(n, h, device=dev), torch.zeros(n, h * d, device=dev)]

    def run(pl, p, device):
        ins = [pg.combined_from_global(el, p),
               pg.shard_node_data(er, p),
               pg.combined_from_global(ft.reshape(n, h * d), p)]
        ins = [t.to(device).requires_grad_(True) for t in ins]
        out = fused_attention_local(pl, *ins, SLOPE)
        own = torch.as_tensor(np.where(pg.node_mask[p], pg.orig_ids[p], -1),
                              device=device)
        ct = torch.where((own >= 0)[:, None, None],
                         w.to(device).index_select(0, own.clamp(min=0)),
                         torch.zeros((), device=device))
        grads = torch.autograd.grad((out * ct).sum(), ins)
        return out.detach(), grads, own

    reset_all_launches()
    per_part = []
    for p in range(pg.num_parts):
        out, (gel, ger, gft), own = run(pg.local(p, dev), p, dev)
        cid = torch.as_tensor(pg.combined_ids(p), device=dev)
        _scatter_rows(outs[0], own, out)
        _scatter_rows(outs[1], cid, gel)
        _scatter_rows(outs[2], own, ger)
        _scatter_rows(outs[3], cid, gft)
        per_part.append((p, out, gel, ger, gft))
    torch.cuda.synchronize()
    counts = all_launches()
    expect_launches(name, counts, ("attn_fwd", "attn_bwd_src",
                                   "ger_reduce"))
    errs = []
    for p, out, gel, ger, gft in per_part:
        oc, gc, _ = run(pg.local(p, "cpu"), p, "cpu")
        errs.append({"part": p, **{
            k: check(f"{name} part {p} {k} vs plain", a, b.to(dev),
                     b.to(dev).abs() + b.abs().max().to(dev))
            for k, a, b in zip(("out", "gel", "ger", "gft"),
                               (out, gel, ger, gft), (oc,) + gc)}})
    err_f = check(f"{name} fwd vs oracle", outs[0], ref.float(), scale)
    err_b = {k: check(f"{name} grad_{k} vs oracle", a, b.reshape(a.shape),
                      b.abs().reshape(a.shape) + b.abs().max())
             for k, a, b in zip(("el", "er", "ft"), outs[1:], rgrads)}
    log(json.dumps({"phase": "dist_part_gat", "path": name,
                    "parts": pg.num_parts, "nodes": n, "h": h, "d": d,
                    "launches": {k: v for k, v in counts.items() if v},
                    "fwd_err_vs_oracle": err_f, "bwd_err_vs_oracle": err_b,
                    "parts_vs_plain": errs}))
    return counts


def _part_tiles(pl, key):
    """A partition's tile layout for tile_case: its row blocks and the
    scratch block the cross-part padding tiles aim at."""
    t = dict(getattr(pl, key))
    t["block_mask"] = torch.cat([t["block_mask"],
                                 t["block_mask"].new_zeros(1)])
    return t


def part_block_case(case, pl, dev, f, transpose):
    """K11 at width f on one partition's block descriptors (n_out output
    rows from n_comb combined rows, or the transpose) against its float64
    plain version."""
    from dgl1_tpu_torch.ops import bdense_kernels as BK

    bd = pl.bdense
    gen = torch.Generator(device=dev).manual_seed(23)
    if transpose:
        args = (True, bd["ab"], bd["col_ptr"], bd["rbb"])
        n_in, n_out = pl.n_out, pl.n_comb
    else:
        args = (False, bd["a"], bd["row_ptr"], bd["cb"])
        n_in, n_out = pl.n_comb, pl.n_out
    k = int(args[2][-1])
    x = torch.randn(n_in, f, device=dev, generator=gen)
    nnz = int((args[1][: k * 128] != 0).sum())
    return kernel_row(
        "block_bwd" if transpose else "block_fwd",
        BK.block_mm(*args, x, n_out), BK.block_mm_torch(*args, x.double(),
                                                        n_out),
        BK.block_mm_torch(*args, x.abs().double(), n_out),
        lambda: BK.block_mm(*args, x, n_out),
        lambda: BK.block_mm_torch(*args, x, n_out), None,
        nbytes(args[1][: k * 128], args[2], args[3]) + n_in * f * 4
        + n_out * f * 4, 2 * nnz * f,
        {"case": case, "transpose": transpose, "n_in": n_in,
         "n_out": n_out, "f": f, "blocks": k, "nnz": nnz},
        library_note="timed on the main case only")


def part_kernel_variants(dev, rows, builds):
    """Each kernel of the partitioned paths at partition 0's shapes (F =
    128; H = 8, D = 32) against its float64 plain version, timed, as
    variants of the kernel rows: K9 over leg 1's and leg 3's halo tiles
    (both directions), K1, K3 and K4a on leg 5's hub layout, K1 and K4a on
    its identity layout, K6-K8 there, K1, K2 (both directions), K3 and
    K4a on the symmetric copy's, K11 both ways on leg 7's blocks."""
    f = DIST["f"]

    def add(name, row):
        rows[name]["variants"].append(
            {k: row[k] for k in VARIANT_KEYS if k in row})

    for key in ("leg1_tiles", "leg3_vertex_cut"):
        pl = builds[key][1].local(0, dev)
        add("tile_sum", tile_case(f"part4_{key}_fwd_p0", _part_tiles(
            pl, "tiles_fwd"), pl.n_comb, f, dev))
        add("tile_sum", tile_case(f"part4_{key}_rev_p0", _part_tiles(
            pl, "tiles_rev"), pl.n_out, f, dev))
    hg = builds["leg5_hub"][1].local(0, dev).hub_graph()
    add("dense_fwd", dense_fwd_case("part4_leg5_hub_p0", hg, dev, f))
    add("dense_bwd_fused", dense_bwd_fused_case("part4_leg5_hub_p0", hg,
                                                dev, f))
    add("expand", expand_case("part4_leg5_hub_p0", hg, dev, f))
    hi = builds["leg5_hub_identity"][1].local(0, dev).hub_graph()
    add("dense_fwd", dense_fwd_case("part4_leg5_identity_p0", hi, dev, f))
    add("dense_bwd_fused", dense_bwd_fused_case("part4_leg5_identity_p0",
                                                hi, dev, f))
    hb = builds["leg5_bidir_hub"][1].local(0, dev).hub_graph()
    add("dense_fwd", dense_fwd_case("part4_leg5_bidir_p0", hb, dev, f))
    add("chunk_sum", chunk_sum_case("part4_leg5_bidir_p0", hb, dev, f))
    add("chunk_sum", chunk_sum_case("part4_leg5_bidir_bwd_p0", hb, dev, f,
                                    bwd=True))
    add("expand", expand_case("part4_leg5_bidir_p0", hb, dev, f))
    add("dense_bwd_fused", dense_bwd_fused_case("part4_leg5_bidir_p0", hb,
                                                dev, f))
    for k, row in attn_case("part4_leg5_identity_p0", hi, dev, DIST["h"],
                            DIST["d"], 0.0, library=False).items():
        add(k, row)
    pl7 = builds["leg7_bdense"][1].local(0, dev)
    for tr in (False, True):
        add("block_bwd" if tr else "block_fwd",
            part_block_case("part4_leg7_p0", pl7, dev, f, tr))


def phase_dist(dev, g_arx_host, r):
    """Phase 4h: NCCL at world size 1, the dry run's legs, the flagship
    sharded GCN at the arxiv widths, the data-parallel sampled GraphSAGE
    at the Reddit configuration, the 4-part per-partition checks. Returns
    each path's (name, counts)."""
    from dgl1_tpu_torch import parallel

    t0 = time.perf_counter()
    phase_dist_init()
    out = [("dryrun_legs_world1", phase_dryrun_legs(dev))]
    out.append(("dist_gcn_arxiv_flagship_train", phase_dist_flagship(
        "dist_gcn_arxiv_flagship_train", dev, g_arx_host)))
    out.append(("dist_sage_reddit_dp_train", phase_dist_sage(
        "dist_sage_reddit_dp_train", dev, r)))
    builds = dist_part_builds()
    for key in ("leg1_tiles", "leg3_vertex_cut", "leg5_hub",
                "leg5_hub_identity", "leg5_bidir_hub", "leg7_bdense"):
        g, pg = builds[key]
        out.append((f"part4_{key}", part_spmm_check(f"part4_{key}", g, pg,
                                                    dev)))
    g5, pg5 = builds["leg5_hub_identity"]
    out.append(("part4_leg5_identity_gat", part_gat_check(
        "part4_leg5_identity_gat", g5, pg5, dev)))
    parallel.exit_client()
    log(json.dumps({"phase": "dist_done",
                    "seconds": time.perf_counter() - t0}))
    return out, builds


# ----------------------------------------------------------------------
# Phase 4i: the typed distributed layer (dgl1_tpu_torch/parallel/hetero.py)
# at world size 1 over NCCL, and the 4-part typed build run partition by
# partition with the halo rows filled on the host.
# ----------------------------------------------------------------------

TYPED = dict(dims=(128, 64, 40), steps=5, lr=1e-2, mag_scale=1,
             mag_steps=3, mag_dims=(128, 64, 349), attn_h=2, attn_d=8,
             parts=4, part_scale=40, part_f=64)
_EDGE_CHUNK = 1 << 21


def _rel_edges(hg, dev):
    """Each relation's real (src, dst) as long tensors on ``dev``."""
    out = {}
    for c in hg.canonical_etypes:
        rel = hg[c]
        e = rel.num_edges()
        out[c] = (rel.src[:e].to(dev).long(), rel.dst[:e].to(dev).long())
    return out


def _typed_layer64(hg, edges, x, w, s, norm, absolute=False):
    """One typed layer in float64 over the global graph: sum_r A_r (x[src]
    W_r), 'right' normalized, + x W_self; with ``absolute`` every value by
    its absolute value (each output then bounds the sum of the absolute
    values of its terms). Edges in chunks to bound the gathered rows."""
    ab = (lambda t: t.abs()) if absolute else (lambda t: t)
    out, deg = {}, {}
    for c, (src, dst) in edges.items():
        st, _, dt = c
        if st not in x:
            continue
        h = ab(x[st].double()) @ ab(w[c].detach().double())
        y = h.new_zeros((hg.num_nodes(dt), h.shape[1]))
        for i in range(0, src.shape[0], _EDGE_CHUNK):
            y.index_add_(0, dst[i: i + _EDGE_CHUNK],
                         h.index_select(0, src[i: i + _EDGE_CHUNK]))
        out[dt] = out[dt] + y if dt in out else y
        deg[dt] = deg.get(dt, 0) + torch.bincount(
            dst, minlength=hg.num_nodes(dt)).double()
    for nt in out:
        if norm == "right":
            out[nt] = out[nt] / deg[nt].clamp_min(1.0)[:, None]
        if s is not None and nt in s:
            out[nt] = out[nt] + ab(x[nt].double()) @ ab(
                s[nt].detach().double())
    return out


def _typed_logits64(hg, edges, x, params, out_type, absolute=False):
    """Two typed layers with relu between (abs with ``absolute``): leg 9's
    logits in float64 from global inputs ``x`` {nt: (N_nt, F)}."""
    h1 = _typed_layer64(hg, edges, x, params["w1"], params["s1"], "right",
                        absolute)
    h1 = {k: (v.abs() if absolute else torch.relu(v))
          for k, v in h1.items()}
    return _typed_layer64(hg, edges, h1, params["w2"], params["s2"],
                          "right", absolute)[out_type]


def _typed_step0(name, phg, pl, hg, dev, params, feats_global, out_type):
    """Step-0 logits of leg 9's model on this one part against the
    float64 oracle on the global graph, within 1e-4 of each logit's
    float64 abs sum. ``feats_global`` {nt: (N_nt, F)} are the model's
    inputs before ``w_in``; the part's embeddings stand for the rest."""
    from dgl1_tpu_torch.parallel.hetero import make_sharded_rgcn_layer

    layer = make_sharded_rgcn_layer(pl)
    w_in = params.get("w_in")
    x_loc = {nt: phg.shard_node_data(nt, v, 0).to(dev)
             for nt, v in feats_global.items()}
    with torch.no_grad():
        h0 = {nt: v if w_in is None else v @ w_in for nt, v in x_loc.items()}
        h0.update(params.get("emb", {}))
        h1 = {nt: torch.relu(v) for nt, v in
              layer(h0, params["w1"], params["s1"]).items()}
        logits = layer(h1, params["w2"], params["s2"])[out_type]
        got = phg.unshard_node_data(out_type, logits[None])
        x = {nt: v.to(dev).double() for nt, v in feats_global.items()}
        if w_in is not None:
            x = {nt: v @ w_in.detach().double() for nt, v in x.items()}
        for nt, v in params.get("emb", {}).items():
            x[nt] = phg.unshard_node_data(nt, v.detach()[None]).double()
        edges = _rel_edges(hg, dev)
        ref = _typed_logits64(hg, edges, x, params, out_type)
        xa = {nt: v.abs() for nt, v in x.items()}
        bound_ = _typed_logits64(hg, edges, xa, params, out_type, True)
    return logits_vs_abs(name, "float64 oracle", got, ref, bound_)


def _typed_want(pl, layers_bwd):
    """Exact hub launches a step of two typed layers whose relations all
    carry a hub layout: per relation and layer K1 where a dense group
    exists and K2 where a chunked one does, forward; backward for the
    relations in ``layers_bwd`` (each layer's set): K4a (fused) or K4b,
    and K2 again; no K3 on identity layouts."""
    from dgl1_tpu_torch.ops.engine_hub import _use_fused_bwd

    want = {"dense_fwd": 0, "chunk_sum": 0, "dense_bwd_fused": 0,
            "dense_bwd": 0, "expand": 0}
    for bwd in layers_bwd:
        for c in pl.etypes:
            m = pl.hub_meta[c]
            chunked = m.n_groups > m.n_dense
            want["dense_fwd"] += 1 if m.n_dense else 0
            want["chunk_sum"] += 1 if chunked else 0
            want["expand"] += 0 if m.identity_expand else 1
            if c in bwd:
                fused = _use_fused_bwd(m, pl.hub[c])
                want["dense_bwd_fused"] += 1 if fused else 0
                want["dense_bwd"] += 1 if (m.n_dense and not fused) else 0
                want["chunk_sum"] += 1 if chunked else 0
    return want


def _run_typed_steps(name, dev, step, params, feats, labels, mask, steps):
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(step(params, feats, labels, mask))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    counts = all_launches()
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    return losses, step_s, counts


def _typed_profile(phase, name, dev, step, params, feats, labels, mask):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(2):
            step(params, feats, labels, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / 2
    summarize_profile(phase, name, prof, 2, wall_ms,
                      peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def typed_identity_setup(r):
    """Phase 4c's typed graph as a one-ntype heterograph through
    ``to_heterogeneous`` (relations '0'..'7'), on the host, and its
    identity build at P = 1 (``hub=True, hub_identity=True``); host
    seconds of each."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel.hetero import (build_partitioned_hetero,
                                                hetero_partition_assignment)

    t0 = time.perf_counter()
    g = r["g"].to("cpu")
    n = g.num_nodes()
    g.ndata["_TYPE"] = torch.zeros(n, dtype=torch.int64)
    g.ndata["_ID"] = torch.arange(n)
    g.edata["_TYPE"] = r["et"].cpu()
    hg = dgl.to_heterogeneous(g, ["_N"],
                              [str(i) for i in range(RGCN["rels"])])
    t1 = time.perf_counter()
    part = hetero_partition_assignment(hg, 1, part_method="random")
    t2 = time.perf_counter()
    phg = build_partitioned_hetero(hg, part, 1, hub=True, hub_identity=True)
    t3 = time.perf_counter()
    bad = [c for c in phg.etypes if phg.hub.get(c) is None
           or not phg.hub_meta[c].identity_expand]
    if bad:
        raise AssertionError(f"typed identity: no identity layout on {bad}")
    log(json.dumps({"phase": "typed_identity_build", "to_heterogeneous_s":
                    t1 - t0, "partition_s": t2 - t1, "build_s": t3 - t2,
                    "relations": len(phg.etypes), "hub_rows": phg.hub_rows[
                        phg.etypes[0]], "meta": repr(phg.hub_meta[
                            phg.etypes[0]])}))
    return hg, phg


def phase_typed_identity(name, dev, hg, phg, rows):
    """The typed identity sharded R-GCN at configuration #4's shape at
    P = 1: 128 -> 64 -> 40 with per-relation and self weights, Adam 1e-2,
    5 steps; step-0 logits against the float64 oracle; exact hub launches
    a step and no K3; ms a step and a 2-step profile. K1, K4a and K2
    (forward and backward, over the pinned chunks) at relation 0's layout
    (F = 64 and 40) join their rows as variants."""
    from dgl1_tpu_torch.parallel.hetero import (init_typed_rgcn_params,
                                                make_typed_rgcn_train_step)

    in_f, hidden, classes = TYPED["dims"]
    pl = phg.local(0, dev)
    gen = torch.Generator().manual_seed(0)
    n = hg.num_nodes("_N")
    feat = torch.randn(n, in_f, generator=gen)
    labels = torch.randint(0, classes, (n,), generator=gen)
    params = init_typed_rgcn_params(pl, in_f, hidden, classes, "_N",
                                    device=dev, generator=gen)
    lerr, lrel = _typed_step0(name, phg, pl, hg, dev, params, {"_N": feat},
                              "_N")
    leaves = [x for v in params.values() for x in v.values()]
    step = make_typed_rgcn_train_step(
        pl, torch.optim.Adam(leaves, lr=TYPED["lr"]), classes, "_N")
    feats = {"_N": phg.shard_node_data("_N", feat, 0).to(dev)}
    y = phg.shard_node_data("_N", labels, 0).to(dev)
    mask = torch.as_tensor(phg.node_mask["_N"][0], device=dev)
    steps = TYPED["steps"]
    losses, step_s, counts = _run_typed_steps(name, dev, step, params, feats,
                                              y, mask, steps)
    want = _typed_want(pl, [set(pl.etypes), set(pl.etypes)])
    if want["expand"]:
        raise AssertionError(f"{name}: a relation without identity expand")
    expect_exact(name, counts, {k: v * steps for k, v in want.items()})
    log(json.dumps({
        "phase": "typed_identity_train", "path": name, "nodes": n,
        "edges": hg.num_edges(), "relations": len(pl.etypes),
        "dims": [in_f, hidden, classes], "steps": steps, "losses": losses,
        "ms_per_step": [s * 1e3 for s in step_s],
        "ms_per_step_after_first": float(np.mean(step_s[1:]) * 1e3),
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_step": want, "logits_err_vs_oracle64": lerr,
        "logits_err_over_abs_sum": lrel,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    _typed_profile("typed_identity_profile", name, dev, step, params, feats,
                   y, mask)
    c0 = pl.etypes[0]
    hg0 = pl.hub_graph(c0)
    for f in (hidden, classes):
        for kname, case in (("dense_fwd", dense_fwd_case),
                            ("dense_bwd_fused", dense_bwd_fused_case)):
            row = case(f"typed_identity_rel0_f{f}", hg0, dev, f, seed=50,
                       library=False)
            rows[kname]["variants"].append(
                {k: row[k] for k in VARIANT_KEYS if k in row})
        # K2 over the pinned (forced) chunks, both directions: the step's
        # 16 forward and 16 backward launches.
        for bwd in (False, True):
            tag = "_bwd" if bwd else ""
            row = chunk_sum_case(f"typed_identity_rel0{tag}_f{f}", hg0, dev,
                                 f, bwd=bwd, seed=51)
            rows["chunk_sum"]["variants"].append(
                {k: row[k] for k in VARIANT_KEYS if k in row})
    return counts


def phase_typed_mag(name, dev, hg_host):
    """Leg 9's model at ogbn-mag's shape (phase 4e's widths: embeddings
    128, 128 -> 64 -> 349 through a replicated ``w_in`` 128 -> 128, Adam
    1e-2) on ``build_partitioned_hetero(tiles=True)`` at P = 1: partition
    and build seconds, step-0 paper logits against the float64 oracle, 3
    steps with K9 exactly: forward once a relation with edges and layer,
    backward once for each relation whose output reaches the loss; then
    the typed attention (H = 2, D = 8) forward and gradient on the same
    build, and K9 at the cites relation's tiles as variants."""
    from dgl1_tpu_torch.parallel.hetero import (
        build_partitioned_hetero, hetero_partition_assignment,
        init_typed_rgcn_params, make_sharded_hetero_attention,
        make_typed_rgcn_train_step)

    in_f, hidden, classes = TYPED["mag_dims"]
    t0 = time.perf_counter()
    # At P = 1 every partitioner gives the one part; "random" skips the
    # greedy stream over 33M edges.
    part = hetero_partition_assignment(hg_host, 1, part_method="random")
    t1 = time.perf_counter()
    phg = build_partitioned_hetero(hg_host, part, 1, tiles=True)
    t2 = time.perf_counter()
    pl = phg.local(0, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(json.dumps({"phase": "typed_mag_build", "partition_s": t1 - t0,
                    "build_s": t2 - t1, "to_card_s": t3 - t2,
                    "scale": TYPED["mag_scale"],
                    "edges": hg_host.num_edges(),
                    "e_loc": {"/".join(c): v for c, v in
                              phg.e_loc.items()}}))
    gen = torch.Generator().manual_seed(3)
    featureless = [nt for nt in pl.ntypes if nt != "paper"]
    params = init_typed_rgcn_params(pl, in_f, hidden, classes, "paper",
                                    proj_from=in_f, featureless=featureless,
                                    device=dev, generator=gen)
    feat = hg_host.nodes["paper"].data["feat"]
    lerr, lrel = _typed_step0(name, phg, pl, hg_host, dev, params,
                              {"paper": feat}, "paper")
    leaves = [x for v in params.values() for x in (
        v.values() if isinstance(v, dict) else [v])]
    step = make_typed_rgcn_train_step(
        pl, torch.optim.Adam(leaves, lr=TYPED["lr"]), classes)
    feats = {"paper": phg.shard_node_data("paper", feat, 0).to(dev)}
    y = phg.shard_node_data("paper", hg_host.nodes["paper"].data["label"],
                            0).to(dev)
    mask = torch.as_tensor(phg.node_mask["paper"][0], device=dev)
    steps = TYPED["mag_steps"]
    losses, step_s, counts = _run_typed_steps(name, dev, step, params, feats,
                                              y, mask, steps)
    # K9 launches where a layout has a tile (a relation with edges).
    live = [c for c in pl.etypes if pl.tiles_fwd[c]["lid"].shape[0]]
    l2_bwd = [c for c in pl.etypes if c[2] == "paper"
              and pl.tiles_rev[c]["lid"].shape[0]]
    l1_bwd = [c for c in pl.etypes if c[2] in {x[0] for x in l2_bwd}
              and pl.tiles_rev[c]["lid"].shape[0]]
    want = {"tile_sum": 2 * len(live) + len(l2_bwd) + len(l1_bwd)}
    expect_exact(name, counts, {k: v * steps for k, v in want.items()})
    log(json.dumps({
        "phase": "typed_mag_train", "path": name,
        "nodes": {nt: hg_host.num_nodes(nt) for nt in hg_host.ntypes},
        "edges": hg_host.num_edges(), "dims": [in_f, hidden, classes],
        "steps": steps, "losses": losses,
        "ms_per_step": [s * 1e3 for s in step_s],
        "ms_per_step_after_first": float(np.mean(step_s[1:]) * 1e3),
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_step": want, "relations_with_edges": len(live),
        "backward_relations": [len(l2_bwd), len(l1_bwd)],
        "logits_err_vs_oracle64": lerr, "logits_err_over_abs_sum": lrel,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    _typed_profile("typed_mag_profile", name, dev, step, params, feats, y,
                   mask)
    # The typed attention on the same build, forward and gradient.
    ah, ad = TYPED["attn_h"], TYPED["attn_d"]
    agen = torch.Generator(device=dev).manual_seed(4)

    def leaf(*shape):
        return (torch.randn(*shape, device=dev, generator=agen)
                * 0.1).requires_grad_(True)

    el = {c: leaf(pl.n_loc[c[0]], ah) for c in pl.etypes}
    er = {nt: leaf(pl.n_loc[nt], ah) for nt in pl.ntypes}
    ft = {c: leaf(pl.n_loc[c[0]], ah, ad) for c in pl.etypes}
    attn = make_sharded_hetero_attention(pl)
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = attn(el, er, ft)
    val = sum((v ** 2).sum() for v in out.values())
    val.backward()
    torch.cuda.synchronize()
    a_ms = (time.perf_counter() - t0) * 1e3
    vals = [float(val.detach())] + [float(t.grad.abs().sum()) for t in (
        *el.values(), *er.values(), *ft.values())]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{name} attention: non-finite {vals[:4]}")
    log(json.dumps({"phase": "typed_mag_attention", "path": name,
                    "heads": ah, "head_dim": ad, "fwd_bwd_ms": a_ms,
                    "value": vals[0], "launches": {
                        k: v for k, v in all_launches().items() if v}}))
    c = ("paper", "cites", "paper")
    k9 = [typed_k9_variant(f"typed_mag_cites_{key}_f{f}", pl, key, c, n_src,
                           f, dev)
          for key, n_src, f in (("tiles_fwd", pl.n_comb("paper"), hidden),
                                ("tiles_rev", pl.n_loc["paper"], classes))]
    return counts, k9


def typed_k9_variant(case, pl, key, c, n_src, f, dev):
    """K9 at one relation's tile layout of a typed partition (``key``
    'tiles_fwd' or 'tiles_rev') as a variant of its row: the layout with
    the scratch row block its padding tiles aim at."""
    t = dict(getattr(pl, key)[c])
    t["block_mask"] = torch.cat([t["block_mask"],
                                 t["block_mask"].new_zeros(1)])
    row = tile_case(case, t, n_src, f, dev)
    return {k: row[k] for k in VARIANT_KEYS if k in row}


def _combined_ids(phg, nt, rank):
    """Global id of each row of part ``rank``'s combined ``nt`` table; -1
    on phantom rows and halo slots no relation reads."""
    own = np.where(phg.node_mask[nt][rank], phg.orig_ids[nt][rank], -1)
    m = phg.m_halo[nt]
    if m == 0:
        return own.astype(np.int64)
    halo = np.full((phg.num_parts, m), -1, np.int64)
    for q in range(phg.num_parts):
        sid = phg.send_idx[nt][q, rank]
        halo[q] = np.where(phg.node_mask[nt][q][sid],
                           phg.orig_ids[nt][q][sid], -1)
    live = np.zeros(phg.num_parts * m, bool)
    n_loc = phg.n_loc[nt]
    for c in phg.etypes:
        if c[0] != nt:
            continue
        es, ed = phg.esrc[c][rank], phg.edst[c][rank]
        used = (es >= n_loc) & (ed < phg.n_loc[c[2]])
        live[es[used] - n_loc] = True
    return np.concatenate([own.astype(np.int64),
                           np.where(live, halo.reshape(-1), -1)])


def phase_typed_parts(name, dev):
    """A 4-part greedy build of ``synthetic_mag_heterograph(scale=40)``
    with tiles (partitioner and build seconds), each partition's local
    reduce of every relation (K9 forward and, for the gradient, reverse;
    F = 64) on the card in turn with the halo rows filled on the host,
    each against the same call on the CPU (the kernel's plain version),
    then the assembled rows and gradients of each relation against the
    float64 oracle; returns the counts and K9 at partition 0's cites tiles
    (the variants of its row)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel.hetero import (_local_rel_reduce,
                                                build_partitioned_hetero,
                                                hetero_partition_assignment)

    p_, f = TYPED["parts"], TYPED["part_f"]
    hg, _ = dgl.data.synthetic_mag_heterograph(scale=TYPED["part_scale"],
                                               device="cpu")
    t0 = time.perf_counter()
    part = hetero_partition_assignment(hg, p_, part_method="greedy")
    t1 = time.perf_counter()
    phg = build_partitioned_hetero(hg, part, p_, tiles=True)
    t2 = time.perf_counter()
    gen = torch.Generator().manual_seed(31)
    x = {nt: torch.randn(hg.num_nodes(nt), f, generator=gen)
         for nt in hg.ntypes}
    w = {nt: torch.randn(hg.num_nodes(nt), f, generator=gen)
         for nt in hg.ntypes}
    edges = _rel_edges(hg, dev)
    reset_all_launches()
    y_all = {c: torch.zeros(hg.num_nodes(c[2]), f, device=dev)
             for c in hg.canonical_etypes}
    g_all = {c: torch.zeros(hg.num_nodes(c[0]), f, device=dev)
             for c in hg.canonical_etypes}
    per_part = []
    n_k9 = 0
    for p in range(p_):
        pl = phg.local(p, dev)
        # K9 launches where a layout has a tile: forward, then reverse.
        n_k9 += sum(int(t[c]["lid"].shape[0] > 0) for c in pl.etypes
                    for t in (pl.tiles_fwd, pl.tiles_rev))
        for c in hg.canonical_etypes:
            st, _, dt = c
            comb = phg.combined_from_global(st, x[st], p).to(
                dev).requires_grad_(True)
            oid = torch.as_tensor(np.where(phg.node_mask[dt][p],
                                           phg.orig_ids[dt][p], -1),
                                  device=dev)
            cid = torch.as_tensor(_combined_ids(phg, st, p), device=dev)
            y = _local_rel_reduce(pl, c, comb)
            ct = torch.where((oid >= 0)[:, None],
                             w[dt].to(dev).index_select(0, oid.clamp(min=0)),
                             torch.zeros((), device=dev))
            (gc,) = torch.autograd.grad((y * ct).sum(), comb)
            _scatter_rows(y_all[c], oid, y.detach())
            _scatter_rows(g_all[c], cid, gc)
            per_part.append((p, c, comb.detach(), ct, y.detach(), gc))
    torch.cuda.synchronize()
    counts = all_launches()
    errs = []
    for p, c, comb, ct, y, gc in per_part:
        pc, pd = phg.local(p, "cpu"), phg.local(p, dev)
        cc = comb.cpu().requires_grad_(True)
        yc = _local_rel_reduce(pc, c, cc)
        (gcc,) = torch.autograd.grad((yc * ct.cpu()).sum(), cc)
        with torch.no_grad():
            ys = _local_rel_reduce(pd, c, comb.abs())
        ca = comb.abs().requires_grad_(True)
        (gs,) = torch.autograd.grad((_local_rel_reduce(pd, c, ca)
                                     * ct.abs()).sum(), ca)
        errs.append({"part": p, "rel": "/".join(c),
                     "fwd": check(f"{name} {c} part {p} fwd vs plain", y,
                                  yc.to(dev), ys),
                     "bwd": check(f"{name} {c} part {p} bwd vs plain", gc,
                                  gcc.to(dev), gs)})
    oracle = []
    for c, (src, dst) in edges.items():
        st, _, dt = c
        xs, ws = x[st].to(dev).double(), w[dt].to(dev).double()
        ref = xs.new_zeros((hg.num_nodes(dt), f)).index_add_(
            0, dst, xs.index_select(0, src))
        scale = xs.new_zeros((hg.num_nodes(dt), f)).index_add_(
            0, dst, xs.abs().index_select(0, src))
        gref = xs.new_zeros(xs.shape).index_add_(0, src,
                                                 ws.index_select(0, dst))
        gscale = xs.new_zeros(xs.shape).index_add_(
            0, src, ws.abs().index_select(0, dst))
        oracle.append({"rel": "/".join(c), "edges": int(src.shape[0]),
                       "fwd": check(f"{name} {c} fwd vs oracle", y_all[c],
                                    ref.float(), scale),
                       "bwd": check(f"{name} {c} bwd vs oracle", g_all[c],
                                    gref.float(), gscale)})
    expect_exact(name, counts, {"tile_sum": n_k9})
    log(json.dumps({"phase": "typed_part_spmm", "path": name, "parts": p_,
                    "scale": TYPED["part_scale"], "f": f,
                    "edges": hg.num_edges(), "partition_s": t1 - t0,
                    "build_s": t2 - t1,
                    "m_halo": phg.m_halo, "launches": {
                        k: v for k, v in counts.items() if v},
                    "vs_oracle": oracle, "parts_vs_plain": errs}))
    pl0 = phg.local(0, dev)
    c = ("paper", "cites", "paper")
    return counts, [typed_k9_variant(f"typed_part4_cites_{key}_p0", pl0,
                                     key, c, n_src, f, dev)
                    for key, n_src in (("tiles_fwd", pl0.n_comb("paper")),
                                       ("tiles_rev", pl0.n_loc["paper"]))]


# ----------------------------------------------------------------------
# Phase 4j: the message-passing front end (function/, core.py): the GCN
# written through update_all, and one call of each builtin pair, with its
# backward, on the graph whose layout takes it.
# ----------------------------------------------------------------------

FRONT = dict(f=64, steps=5)


class UpdateAllGCN(torch.nn.Module):
    """``models.GCN``'s layers (their parameters), each aggregation
    written as ``g.update_all(fn.copy_u('h', 'm'), fn.sum('m', 'h'))``
    inside ``g.local_scope()``: the symmetric norms, the projection before
    the aggregation where the layer narrows (GraphConv's order), the bias
    after."""

    def __init__(self, gcn):
        super().__init__()
        self.convs = gcn.layers

    def forward(self, g, feat, generator=None):
        from dgl1_tpu_torch import function as fn

        n_out = g.out_degrees().float().clamp(min=1.0) ** -0.5
        n_in = g.in_degrees().float().clamp(min=1.0) ** -0.5
        h = feat
        for i, conv in enumerate(self.convs):
            h = h * n_out[:, None]
            if conv.in_feats > conv.out_feats:
                h = conv.weight(h)
            with g.local_scope():
                g.ndata["h"] = h
                g.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
                h = g.ndata["h"]
            if conv.in_feats <= conv.out_feats:
                h = conv.weight(h)
            h = h * n_in[:, None] + conv.bias
            if i < len(self.convs) - 1:
                h = torch.relu(h)
        return h


def phase_update_all_gcn(name, dev, g, gcn_counts):
    """The 2-layer GCN through ``update_all`` on the arxiv graph, 128 ->
    256 -> 40, sharing a ``models.GCN``'s weights: step-0 logits against
    that model's within 1e-4 of each logit's float64 abs sum (the float64
    oracle engine with every weight and feature by its absolute value), 5
    Adam steps with exactly phase 4's GCN launches a step."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import ops
    from dgl1_tpu_torch.models import GCN

    n, in_f, hidden, classes = g.num_nodes(), 128, 256, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, in_f, device=dev, generator=gen)
    labels = torch.randint(0, classes, (n,), device=dev, generator=gen)
    gcn = GCN(in_f, hidden, classes, num_layers=2, dropout=0.0, device=dev,
              generator=torch.Generator().manual_seed(2))
    model = UpdateAllGCN(copy.deepcopy(gcn))
    with torch.no_grad():
        got = model(g, feat)
        ref = gcn(g, feat)
        a = copy.deepcopy(gcn).double()
        for p in a.parameters():
            p.abs_()
        ops.set_engine("xla")
        try:
            bound_ = a(g, feat.abs().double())
        finally:
            ops.set_engine("auto")
    lerr, lrel = logits_vs_abs(name, "models.GCN", got, ref, bound_)
    del a, bound_, ref
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=FRONT["steps"], lr=1e-2)
    torch.cuda.synchronize()
    counts = all_launches()
    want = per_step(gcn_counts, 5)
    expect_exact(name, counts, {k: v * FRONT["steps"]
                                for k, v in want.items()})
    train_record("update_all_gcn_train", name, g, res, counts,
                 FRONT["steps"], dims=[in_f, hidden, classes],
                 launches_per_step_phase4=want,
                 logits_err_vs_gcn=lerr, logits_err_over_abs_sum=lrel)
    return counts


def _frame(g, where):
    """The frame dict ``where`` names: 'ndata', 'edata', 'srcdata' or
    'nframes:<ntype>' (a heterograph's)."""
    if where.startswith("nframes:"):
        return g.nframes[where.split(":", 1)[1]]
    return getattr(g, where)


def _pair_call(g, inputs, call, absolute=False):
    """``call(g)`` with ``inputs`` [(key, frame, cpu tensor, grad?)] put
    into the frames on g's device (by absolute value with ``absolute``),
    and the gradient of sum(out * ct) into each input that wants one;
    ``ct`` a fixed draw of out's shape (by absolute value likewise)."""
    dev = g.device
    leaves = []
    for key, where, base, rg in inputs:
        t = (base.abs() if absolute else base).to(dev).requires_grad_(rg)
        _frame(g, where)[key] = t
        if rg:
            leaves.append(t)
    out = call(g)
    ct = torch.randn(tuple(out.shape),
                     generator=torch.Generator().manual_seed(9)).to(dev)
    if absolute:
        ct = ct.abs()
    grads = torch.autograd.grad((out * ct).sum(), leaves) if leaves else []
    return out.detach(), [gr.detach() for gr in grads]


def frontend_pair(name, g_dev, g_cpu, inputs, call, expect=()):
    """One front-end call with its backward on the card (counters zeroed
    before and read after; each kernel in ``expect`` launched, and none
    where ``expect`` is empty), held against the same call on the CPU copy
    of the graph within the script's tolerance, its scale the same call
    over absolute values."""
    reset_all_launches()
    t0 = time.perf_counter()
    out, grads = _pair_call(g_dev, inputs, call)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_launches()
    launched = {k: v for k, v in counts.items() if v}
    if expect:
        expect_launches(name, counts, expect)
    elif launched:
        raise AssertionError(f"{name}: launched {launched}")
    ref, rgrads = _pair_call(g_cpu, inputs, call)
    sc, sgrads = _pair_call(g_cpu, inputs, call, absolute=True)
    dev = out.device
    errs = [check(f"{name} out", out, ref.to(dev), sc.abs().to(dev))]
    for i, (a, b, s_) in enumerate(zip(grads, rgrads, sgrads)):
        errs.append(check(f"{name} grad {i}", a, b.to(dev),
                          s_.abs().to(dev)))
    log(json.dumps({"phase": "frontend_pair", "path": name,
                    "edges": g_dev.num_edges(), "out": list(out.shape),
                    "ms_with_backward": ms, "launches": launched,
                    "errs": errs}))
    return counts


def frontend_arxiv_pairs(dev, g):
    """u_mul_e sum on the arxiv graph with a weight an edge (K2 mul, K5
    mul), a UDF reduce on its ELL plan and apply_edges(u_dot_v) (no
    kernel); returns each path's counts."""
    from dgl1_tpu_torch import function as fn

    f, n, e = FRONT["f"], g.num_nodes(), g.num_edges()
    gc = g.to("cpu")
    gen = torch.Generator().manual_seed(41)
    h = torch.randn(n, f, generator=gen)
    w = torch.rand(e, 1, generator=gen)
    out = [("frontend_u_mul_e_sum_arxiv", frontend_pair(
        "frontend_u_mul_e_sum_arxiv", g, gc,
        [("h", "ndata", h, True), ("w", "edata", w, True)],
        lambda x: x.update_all(fn.u_mul_e("h", "w", "m"),
                               fn.sum("m", "o")),
        ("chunk_mul", "edge_grad_mul")))]
    if g.ell_dst is None:
        raise AssertionError("the arxiv graph has no ELL layout")
    h16 = h[:, :16].contiguous()
    out.append(("frontend_udf_reduce_arxiv_ell", frontend_pair(
        "frontend_udf_reduce_arxiv_ell", g, gc, [("h", "ndata", h16, True)],
        lambda x: x.update_all(
            fn.copy_u("h", "m"),
            lambda nb: {"o": (nb.mailbox["m"] ** 2).sum(dim=1)}))))
    out.append(("frontend_apply_edges_u_dot_v_arxiv", frontend_pair(
        "frontend_apply_edges_u_dot_v_arxiv", g, gc,
        [("h", "ndata", h16, True)],
        lambda x: x.apply_edges(fn.u_dot_v("h", "h", "s")))))
    for x in (g, gc):
        for k in ("h", "o"):
            x.ndata.pop(k, None)
        for k in ("w", "s"):
            x.edata.pop(k, None)
    return out


def frontend_copy_e(dev, g_sorted):
    """copy_e sum on the R-GCN's relation-sorted graph at he = 64 (K2 rhs,
    K5 rhs)."""
    from dgl1_tpu_torch import function as fn

    e = g_sorted.num_edges()
    w = torch.randn(e, FRONT["f"], generator=torch.Generator().manual_seed(42))
    name = "frontend_copy_e_sum_rgcn"
    counts = frontend_pair(
        name, g_sorted, g_sorted.to("cpu"), [("w", "edata", w, True)],
        lambda x: x.update_all(fn.copy_e("w", "m"), fn.sum("m", "o")),
        ("chunk_rhs", "edge_grad_rhs"))
    g_sorted.edata.pop("w", None)
    g_sorted.ndata.pop("o", None)
    return [(name, counts)]


def frontend_block(dev, block):
    """copy_u max (K10) and sum (K9 in the backward) on one sampled Reddit
    block."""
    from dgl1_tpu_torch import function as fn

    bc = block.to("cpu")
    x = torch.randn(block.num_src_nodes(), FRONT["f"],
                    generator=torch.Generator().manual_seed(43))
    out = []
    for red, kern in (("max", "tile_minmax"), ("sum", "tile_sum")):
        name = f"frontend_copy_u_{red}_reddit_block"
        out.append((name, frontend_pair(
            name, block, bc, [("h", "srcdata", x, True)],
            lambda g, red=red: g.update_all(fn.copy_u("h", "m"),
                                            getattr(fn, red)("m", "o")),
            (kern,))))
    return out


def frontend_bdense(dev, g17):
    """copy_u sum on the 2^17 geometric block-dense graph (K11 both
    ways)."""
    from dgl1_tpu_torch import function as fn

    x = torch.randn(g17.num_nodes(), FRONT["f"],
                    generator=torch.Generator().manual_seed(44))
    name = "frontend_copy_u_sum_geo2e17"
    counts = frontend_pair(
        name, g17, g17.to("cpu"), [("h", "ndata", x, True)],
        lambda g: g.update_all(fn.copy_u("h", "m"), fn.sum("m", "o")),
        ("block_fwd", "block_bwd"))
    for k in ("h", "o"):
        g17.ndata.pop(k, None)
    return [(name, counts)]


def frontend_mag(dev, hg, hg_host):
    """multi_update_all on the mag heterograph: copy_u sum on every
    relation (no relation clears the hub bar: the ELL engine, no kernel),
    summed across relations."""
    from dgl1_tpu_torch import function as fn

    gen = torch.Generator().manual_seed(45)
    inputs = [("hx", f"nframes:{nt}", torch.randn(hg.num_nodes(nt), 8,
                                                  generator=gen), True)
              for nt in hg.ntypes]
    spec = {c: (fn.copy_u("hx", "m"), fn.sum("m", "ox"))
            for c in hg.canonical_etypes}
    name = "frontend_multi_update_all_mag"

    def call(g):
        return torch.cat([v.reshape(-1) for _, v in sorted(
            g.multi_update_all(spec, "sum").items())])

    counts = frontend_pair(name, hg, hg_host, inputs, call)
    for x in (hg, hg_host):
        for fr in x.nframes.values():
            for k in ("hx", "ox"):
                fr.pop(k, None)
    return [(name, counts)]


# ----------------------------------------------------------------------
# Phase 4k: the graph-level layer, the convs and the graph files. Model
# legs carry their weights from a reference-layout parameter tree built in
# numpy from a seed, through params.from_jax_params.
# ----------------------------------------------------------------------

# The kernels the convs of phase 4k must launch between them: K1-K5,
# K9, K10, K11.
CONV_KERNELS = ("dense_fwd", "chunk_sum", "expand", "dense_bwd_fused",
                "dense_bwd", "chunk_mul", "chunk_rhs", "edge_grad_mul",
                "edge_grad_rhs", "tile_sum", "tile_minmax", "block_fwd",
                "block_bwd")
ZOO = dict(in_f=128, out_f=64, heads=4, head_f=16, appnp_hidden=64,
           classes=40, steps=5, gcnii_layers=16, dense_nodes=4096,
           hgt_mag_scale=8, gin_graphs=1024, gin_feat=64, gin_hidden=64,
           gin_batch=32, gin_nodes=(200, 800), gin_degree=2, gin_steps=5,
           clouds=32, points=1024, knn_k=20, dgi_hidden=128, dgi_steps=3)


def _np_dense(rng, n_in, n_out, bias=True):
    """A flax ``Dense`` leaf: kernel (in, out) of std 1/sqrt(in), bias of
    std 0.1."""
    leaf = {"kernel": (rng.normal(size=(n_in, n_out)) / math.sqrt(n_in))
            .astype(np.float32)}
    if bias:
        leaf["bias"] = (0.1 * rng.normal(size=(n_out,))).astype(np.float32)
    return leaf


def _load_tree(model, tree):
    """``model`` with the reference-layout ``tree`` loaded through
    ``from_jax_params`` (every parameter named by the tree)."""
    from dgl1_tpu_torch.params import from_jax_params

    model.load_state_dict(from_jax_params({"params": tree}), strict=True)
    return model


def _drop(x, p, training, generator):
    from dgl1_tpu_torch.nn.conv import _dropout

    return _dropout(x, p, generator) if training and p > 0 else x


class AppnpNet(torch.nn.Module):
    """examples/train_citation_zoo.py's ``appnp`` model: dropout, Dense ->
    relu, dropout, Dense, then ``APPNPConv(k=10, alpha=0.1)``; flax's
    auto names ``Dense_0``/``Dense_1``."""

    def __init__(self, in_f, hidden, classes, dropout, dev):
        super().__init__()
        from dgl1_tpu_torch.nn import APPNPConv

        self.Dense_0 = torch.nn.Linear(in_f, hidden, device=dev)
        self.Dense_1 = torch.nn.Linear(hidden, classes, device=dev)
        self.prop = APPNPConv(k=10, alpha=0.1, device=dev)
        self.dropout = dropout

    def forward(self, g, feat, generator=None):
        x = _drop(feat, self.dropout, self.training, generator)
        x = torch.relu(self.Dense_0(x))
        x = _drop(x, self.dropout, self.training, generator)
        return self.prop(g, self.Dense_1(x))

    @staticmethod
    def tree(rng, in_f, hidden, classes):
        return {"Dense_0": _np_dense(rng, in_f, hidden),
                "Dense_1": _np_dense(rng, hidden, classes)}


class Gcn2Net(torch.nn.Module):
    """examples/train_gcn2.py's GCNII: ``fc_in`` -> relu, ``layers``
    ``GCN2Conv(project_initial_features=True)`` + relu (``conv_{l}``, layer
    l + 1), ``fc_out``, dropout before each."""

    def __init__(self, in_f, hidden, classes, layers, alpha, lambda_,
                 dropout, dev):
        super().__init__()
        from dgl1_tpu_torch.nn import GCN2Conv

        self.fc_in = torch.nn.Linear(in_f, hidden, device=dev)
        self.layers = layers
        for l in range(layers):
            setattr(self, f"conv_{l}", GCN2Conv(
                hidden, layer=l + 1, alpha=alpha, lambda_=lambda_,
                project_initial_features=True, device=dev))
        self.fc_out = torch.nn.Linear(hidden, classes, device=dev)
        self.dropout = dropout

    def forward(self, g, feat, generator=None):
        def drop(x):
            return _drop(x, self.dropout, self.training, generator)

        h0 = torch.relu(self.fc_in(drop(feat)))
        h = h0
        for l in range(self.layers):
            h = torch.relu(getattr(self, f"conv_{l}")(g, drop(h), h0))
        return self.fc_out(drop(h))

    @staticmethod
    def tree(rng, in_f, hidden, classes, layers):
        t = {"fc_in": _np_dense(rng, in_f, hidden),
             "fc_out": _np_dense(rng, hidden, classes)}
        for l in range(layers):
            t[f"conv_{l}"] = {"fc": _np_dense(rng, hidden, hidden)}
        return t


def _abs_oracle(model, g, feat, call):
    """``call(model, g, feat)`` in float64 on the oracle engine, and the
    same with every parameter and input by its absolute value (each
    output's float64 abs sum), model in eval mode."""
    from dgl1_tpu_torch import ops

    m64 = copy.deepcopy(model).double().eval()
    ops.set_engine("xla")
    try:
        with torch.no_grad():
            ref = call(m64, g, feat.double())
            for p in m64.parameters():
                p.abs_()
            bound_ = call(m64, g, feat.abs().double())
    finally:
        ops.set_engine("auto")
    return ref, bound_


def model_step0(name, model, g, feat, call=None):
    """The model's step-0 output on the card (eval mode) against its
    float64 oracle run, within 1e-4 of each output's float64 abs sum."""
    call = call or (lambda m, gg, x: m(gg, x))
    model.eval()
    with torch.no_grad():
        got = call(model, g, feat)
    ref, bound_ = _abs_oracle(model, g, feat, call)
    return logits_vs_abs(name, "float64 oracle", got, ref, bound_)


def gspmm_unit(g, f):
    """Launches of one ``copy_lhs`` sum g-SpMM on ``g`` at width f (the
    convs' propagation): (forward, backward) count dicts."""
    from dgl1_tpu_torch.ops import gspmm

    x = torch.randn(g.num_src_nodes(), f, device=g.device,
                    requires_grad=True)
    reset_all_launches()
    y = gspmm(g, "copy_lhs", "sum", x, None)
    torch.cuda.synchronize()
    fwd = {k: v for k, v in all_launches().items() if v}
    reset_all_launches()
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    bwd = {k: v for k, v in all_launches().items() if v}
    return fwd, bwd


def _scaled(counts, k):
    return {n: v * k for n, v in counts.items()}


def _plus(*ds):
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def learnable_labels(feat, classes, seed):
    """Labels a linear map of the features can fit (argmax of a fixed
    random projection), so five steps lower the loss even with dropout."""
    gen = torch.Generator(device=feat.device).manual_seed(seed)
    w = torch.randn(feat.shape[1], classes, device=feat.device,
                    generator=gen)
    return (feat @ w).argmax(dim=1)


def phase_appnp(name, dev, g, profile_steps=2):
    """examples/train_citation_zoo.py --model appnp at arxiv scale: 128 ->
    64 -> 40, dropout 0.5, ``APPNPConv(k=10, alpha=0.1)``, 5 Adam steps at
    1e-2 (dropout masks from a seeded generator); step-0 logits against the
    float64 oracle; exactly 10 propagations a step forward and backward
    (``gspmm_unit`` at F = 40); a profile of ``profile_steps`` steps."""
    import dgl1_tpu_torch as dgl
    from torch.profiler import ProfilerActivity, profile

    z = ZOO
    n = g.num_nodes()
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, z["in_f"], device=dev, generator=gen)
    labels = learnable_labels(feat, z["classes"], 1)
    model = _load_tree(
        AppnpNet(z["in_f"], z["appnp_hidden"], z["classes"], 0.5, dev),
        AppnpNet.tree(np.random.default_rng(18), z["in_f"],
                      z["appnp_hidden"], z["classes"]))
    lerr, lrel = model_step0(name, model, g, feat)
    fwd, bwd = gspmm_unit(g, z["classes"])
    want = _plus(_scaled(fwd, 10), _scaled(bwd, 10))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    drop_gen = torch.Generator(device=dev).manual_seed(3)
    res = dgl.train(g, feat, labels, model, steps=z["steps"], lr=1e-2,
                    generator=drop_gen)
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact(name, counts, _scaled(want, z["steps"]))
    train_record("appnp_train", name, g, res, counts, z["steps"],
                 dims=[z["in_f"], z["appnp_hidden"], z["classes"]],
                 k=10, launches_per_step_expected=want,
                 logits_err_vs_oracle64=lerr, logits_err_over_abs_sum=lrel)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train(g, feat, labels, model, steps=profile_steps, lr=1e-2,
                  generator=drop_gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / profile_steps
    summarize_profile("appnp_profile", name, prof, profile_steps, wall_ms)
    return counts


def phase_gcnii(name, dev, g):
    """examples/train_gcn2.py's defaults at arxiv scale: 16 GCN2Conv
    layers, hidden 64, alpha 0.1, lambda 0.5, dropout 0.5, 5 Adam steps at
    1e-2; step-0 logits against the float64 oracle; exactly 16
    propagations a step forward and backward (``gspmm_unit`` at F =
    64)."""
    import dgl1_tpu_torch as dgl

    z = ZOO
    n, hid, layers = g.num_nodes(), z["out_f"], z["gcnii_layers"]
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(n, z["in_f"], device=dev, generator=gen)
    labels = learnable_labels(feat, z["classes"], 2)
    model = _load_tree(
        Gcn2Net(z["in_f"], hid, z["classes"], layers, 0.1, 0.5, 0.5, dev),
        Gcn2Net.tree(np.random.default_rng(19), z["in_f"], hid,
                     z["classes"], layers))
    lerr, lrel = model_step0(name, model, g, feat)
    fwd, bwd = gspmm_unit(g, hid)
    want = _plus(_scaled(fwd, layers), _scaled(bwd, layers))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    res = dgl.train(g, feat, labels, model, steps=z["steps"], lr=1e-2,
                    generator=torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    counts = all_launches()
    expect_exact(name, counts, _scaled(want, z["steps"]))
    train_record("gcnii_train", name, g, res, counts, z["steps"],
                 layers=layers, hidden=hid, launches_per_step_expected=want,
                 logits_err_vs_oracle64=lerr, logits_err_over_abs_sum=lrel)
    return counts


def conv_case(name, make, g, inputs, grad_of=(0,), expect=(), f64=True):
    """One conv's forward and backward on the card (the auto engine,
    counters zeroed before and read after; each kernel in ``expect``
    launched) against the same module and inputs on the oracle engine in
    float64: each output and each input's gradient of ``sum(out * ct)``
    (``ct`` a fixed draw) within 1e-3 of that tensor's largest magnitude,
    as phase 4's GCN logits check. Without ``f64`` the oracle runs in
    float32: for a conv with a kink before its first g-SpMM (a
    leaky_relu, a max over per-edge values), where a float32 value within
    rounding of the kink takes the other branch in float64 (EGAT's edge
    output did on the arxiv graph); in float32 both sides do the same
    arithmetic up to the first g-SpMM. ``inputs``: card tensors (float
    ones in ``grad_of`` get gradients). ``make()`` builds the module on
    the card."""
    from dgl1_tpu_torch import ops

    mod = make()
    mod.eval()
    xs = [x.detach().clone().requires_grad_(i in grad_of)
          for i, x in enumerate(inputs)]

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    reset_all_launches()
    t0 = time.perf_counter()
    got = outs(mod(g, *xs))
    cts = [torch.randn(o.shape, device=o.device,
                       generator=torch.Generator(device=o.device)
                       .manual_seed(50 + i)) for i, o in enumerate(got)]
    sum((o * c).sum() for o, c in zip(got, cts)).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_launches()
    expect_launches(name, counts, expect)
    engine = (forward_engine(g) if hasattr(g, "hub_dst") else "dense")
    grads = [xs[i].grad for i in grad_of]
    got = [o.detach() for o in got]
    del xs
    dt = torch.float64 if f64 else torch.float32
    m_ref = copy.deepcopy(mod).to(dt) if f64 else mod
    xr = [(x.to(dt) if x.is_floating_point() else x).detach().clone()
          .requires_grad_(i in grad_of) for i, x in enumerate(inputs)]
    ops.set_engine("xla")
    try:
        ref = outs(m_ref(g, *xr))
        sum((o * c.to(dt)).sum() for o, c in zip(ref, cts)).backward()
    finally:
        ops.set_engine("auto")
    del m_ref
    errs = []
    pairs = list(zip(got, (r.detach() for r in ref)))
    pairs += [(a, xr[i].grad) for a, i in zip(grads, grad_of)]
    for k, (a, b) in enumerate(pairs):
        scale = float(b.abs().max())
        err = float((a.to(dt) - b).abs().max())
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{name}[{k}]: err {err} > 1e-3 * "
                                 f"max|ref| ({scale})")
        errs.append(err / max(scale, 1e-300))
    launched = {k: v for k, v in counts.items() if v}
    log(json.dumps({"phase": "conv_leg", "path": name,
                    "nodes": g.num_src_nodes() if hasattr(g, "hub_dst")
                    else g.shape[0],
                    "edges": g.num_edges() if hasattr(g, "hub_dst")
                    else int((g != 0).sum()),
                    "engine": engine, "out": [list(o.shape) for o in got],
                    "ms_with_backward": ms, "launches": launched,
                    "rel_errs": errs}))
    return counts


def conv_legs_arxiv(dev, g, g_mix):
    """The hub-graph convs on the arxiv graph at in 128, out 64 (4 heads
    of 16 where the conv has heads), each against its oracle run
    with its launches counted (``conv_case``); GINConv also on the mixed
    graph (K2, K4b). ChebConv takes ``laplacian_lambda_max`` of the arxiv
    graph (host seconds reported). Returns [(path, counts)]."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import nn as tnn

    z = ZOO
    fi, fo, h, hf = z["in_f"], z["out_f"], z["heads"], z["head_f"]
    n, e = g.num_nodes(), g.num_edges_padded()
    gen = torch.Generator(device=dev).manual_seed(60)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    x, x64w = rnd(n, fi), rnd(n, 64)
    wg = torch.Generator().manual_seed(61)
    kw = dict(device=dev, generator=wg)
    t0 = time.perf_counter()
    lam = float(dgl.laplacian_lambda_max(g)[0])
    lam_s = time.perf_counter() - t0
    log(json.dumps({"phase": "laplacian_lambda_max", "graph": "arxiv",
                    "lambda_max": lam, "host_s": lam_s}))
    z_types = torch.tensor([1.0, 6.0, 8.0], device=dev)[
        torch.randint(0, 3, (n,), device=dev, generator=gen)][:, None]
    dist = torch.rand(e, 1, device=dev, generator=gen) * 4.0
    hub = ("dense_fwd", "expand", "dense_bwd_fused")
    mul = ("chunk_mul", "edge_grad_mul")
    rhs = ("chunk_rhs", "edge_grad_rhs")
    cases = [
        ("dotgat", lambda: tnn.DotGatConv(fi, hf, h, **kw), [x], (0,), mul),
        ("gin_sum", lambda: tnn.GINConv(
            apply_func=tnn.conv.dense(fi, fo, **kw), device=dev), [x], (0,),
         hub),
        ("sgconv", lambda: tnn.SGConv(fi, fo, k=2, **kw), [x], (0,), hub),
        ("appnp", lambda: tnn.APPNPConv(k=3, device=dev), [x], (0,), hub),
        ("tagconv", lambda: tnn.TAGConv(fi, fo, k=2, **kw), [x], (0,), hub),
        ("chebconv", lambda: tnn.ChebConv(fi, fo, k=2, **kw),
         [x, torch.tensor(lam, device=dev)], (0,), hub),
        ("edgeconv", lambda: tnn.EdgeConv(fi, fo, **kw), [x], (0,), ()),
        ("gated", lambda: tnn.GatedGraphConv(64, 64, n_steps=2, **kw),
         [x64w], (0,), rhs),
        ("agnn", lambda: tnn.AGNNConv(device=dev), [x], (0,), mul),
        ("nnconv_sum", lambda: tnn.NNConv(
            8, 8, tnn.conv.dense(4, 64, **kw), "sum", **kw),
         [rnd(n, 8), rnd(e, 4)], (0, 1), rhs),
        ("gmmconv_sum", lambda: tnn.GMMConv(fi, fo, 2, 3, "sum", **kw),
         [x, rnd(e, 2)], (0, 1), rhs),
        ("cfconv", lambda: tnn.CFConv(fi, 16, fo, fo, **kw),
         [x, rnd(e, 16)], (0, 1), mul),
        ("atomic", lambda: tnn.AtomicConv((3.0,) * 4, (0.5, 1.0, 2.0, 3.0),
                                          (1.0,) * 4, (1.0, 6.0, 8.0),
                                          device=dev),
         [z_types, dist], (1,), ()),
        ("gatv2", lambda: tnn.GATv2Conv(fi, hf, h, **kw), [x], (0,), mul),
        ("egat", lambda: tnn.EGATConv(fi, 16, hf, hf, h, **kw),
         [x, rnd(e, 16)], (0, 1), mul),
        ("edgegat", lambda: tnn.EdgeGATConv(fi, 16, hf, h, **kw),
         [x, rnd(e, 16)], (0, 1), ()),
        ("gcn2", lambda: tnn.GCN2Conv(fi, layer=1, **kw), [x, rnd(n, fi)],
         (0, 1), hub),
        # sum, mean (the hub engine) and max, min; std's square root
        # amplifies float32 rounding (tested on the CPU).
        ("pna", lambda: tnn.PNAConv(fi, fo, aggregators=(
            "mean", "max", "min", "sum"), **kw), [x], (0,), hub),
    ]
    # Kinks before the first g-SpMM: the float32 oracle (conv_case).
    kinked = ("edgeconv", "gatv2", "egat", "edgegat")
    out = []
    for cname, make, inputs, grad_of, expect in cases:
        path = f"conv_{cname}_arxiv"
        out.append((path, conv_case(path, make, g, inputs, grad_of, expect,
                                    f64=cname not in kinked)))
        torch.cuda.empty_cache()
    xm = torch.randn(g_mix.num_nodes(), fi, device=dev, generator=gen)
    out.append(("conv_gin_sum_mixed", conv_case(
        "conv_gin_sum_mixed", lambda: tnn.GINConv(
            apply_func=tnn.conv.dense(fi, fo, **kw), device=dev),
        g_mix, [xm], (0,), ("dense_fwd", "chunk_sum", "dense_bwd"))))
    return out


def conv_legs_dense(dev):
    """The dense convs on a 4,096-node random adjacency (density 1%, a
    plain matmul a propagation, no kernel) against their oracle
    runs."""
    from dgl1_tpu_torch import nn as tnn

    z = ZOO
    nd, fi, fo = z["dense_nodes"], z["in_f"], z["out_f"]
    gen = torch.Generator(device=dev).manual_seed(62)
    adj = (torch.rand(nd, nd, device=dev, generator=gen) < 0.01).float()
    x = torch.randn(nd, fi, device=dev, generator=gen)
    kw = dict(device=dev, generator=torch.Generator().manual_seed(63))
    out = []
    for cname, make, extra in (
            ("dense_graph", lambda: tnn.DenseGraphConv(fi, fo, **kw), []),
            ("dense_sage", lambda: tnn.DenseSAGEConv(fi, fo, **kw), []),
            ("dense_cheb", lambda: tnn.DenseChebConv(fi, fo, 3, **kw),
             [torch.tensor(1.8, device=dev)])):
        path = f"conv_{cname}_4096"
        out.append((path, conv_case(path, make, adj, [x] + extra)))
    return out


def conv_leg_hgt(dev):
    """HGTConv on ``to_homogeneous`` of the mag heterograph at
    ``hgt_mag_scale`` (128 -> 4 x 16, 4 node types, 7 edge types),
    against its oracle run."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch import nn as tnn

    z = ZOO
    t0 = time.perf_counter()
    hg, _ = dgl.data.synthetic_mag_heterograph(scale=z["hgt_mag_scale"],
                                               device="cpu")
    g = dgl.to_homogeneous(hg).to(dev)
    log(json.dumps({"phase": "hgt_graph", "scale": z["hgt_mag_scale"],
                    "nodes": g.num_nodes(), "edges": g.num_edges(),
                    "build_s": time.perf_counter() - t0}))
    nt, et = g.ndata["_TYPE"].long(), g.edata["_TYPE"].long()
    x = torch.randn(g.num_nodes(), z["in_f"], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(64))
    path = "conv_hgt_mag"
    counts = conv_case(path, lambda: tnn.HGTConv(
        z["in_f"], z["head_f"], z["heads"], len(hg.ntypes),
        len(hg.canonical_etypes), device=dev,
        generator=torch.Generator().manual_seed(65)), g, [x, nt, et])
    return [(path, counts)]


def conv_legs_block(dev, block, f):
    """On one sampled Reddit block (F = 602): GATv2Conv, as the
    reference's ``test_new_convs_on_blocks`` runs it, EdgeConv and PNA's
    max and min (K10 forward, K9 in its backward)."""
    from dgl1_tpu_torch import nn as tnn

    x = torch.randn(block.num_src_nodes(), f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(66))
    kw = dict(device=dev, generator=torch.Generator().manual_seed(67))
    z = ZOO
    out = []
    for cname, make, expect in (
            ("gatv2", lambda: tnn.GATv2Conv(f, z["head_f"], z["heads"],
                                            **kw), ()),
            ("edgeconv", lambda: tnn.EdgeConv(f, z["out_f"], **kw), ()),
            ("pna_max_min", lambda: tnn.PNAConv(
                f, z["out_f"], aggregators=("max", "min"),
                scalers=("identity",), **kw),
             ("tile_minmax", "tile_sum"))):
        path = f"conv_{cname}_reddit_block"
        out.append((path, conv_case(path, make, block, [x], (0,), expect,
                                    f64=cname == "pna_max_min")))
    return out


def conv_leg_bdense(dev, g17):
    """GINConv sum on the 2^17 geometric block-dense graph (F = 64): K11
    both ways."""
    from dgl1_tpu_torch import nn as tnn

    x = torch.randn(g17.num_nodes(), 64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(68))
    path = "conv_gin_sum_geo2e17"
    return [(path, conv_case(path, lambda: tnn.GINConv(
        apply_func=tnn.conv.dense(
            64, 64, device=dev, generator=torch.Generator().manual_seed(69)),
        device=dev), g17, [x], (0,), ("block_fwd", "block_bwd")))]


class _GinData:
    """``count`` seeded power-law graphs of ``gin_nodes`` nodes (REDDIT-
    BINARY's range) with ``gin_feat``-wide features and a label each,
    built on the host when indexed."""

    def __init__(self, count):
        self.count = count

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        import dgl1_tpu_torch as dgl

        z = ZOO
        rng = np.random.default_rng(1000 + i)
        n = int(rng.integers(z["gin_nodes"][0], z["gin_nodes"][1] + 1))
        g = dgl.data.powerlaw_graph(n, z["gin_degree"], seed=i,
                                    formats=("csc",), device="cpu")
        g.ndata["x"] = torch.from_numpy(
            rng.normal(size=(n, z["gin_feat"])).astype(np.float32))
        return g, i % 2


def _gin_tree(rng, in_f, hidden, classes, layers):
    t = {}
    for i in range(layers - 1):
        t[f"mlp{i}"] = {"fc0": _np_dense(rng, in_f if i == 0 else hidden,
                                         hidden),
                        "ln0": {"scale": np.ones(hidden, np.float32),
                                "bias": np.zeros(hidden, np.float32)},
                        "fc_out": _np_dense(rng, hidden, hidden)}
        t[f"bn{i}"] = {"scale": np.ones(hidden, np.float32),
                       "bias": np.zeros(hidden, np.float32)}
    for i in range(layers):
        # Small prediction weights: the sum readout adds hundreds of rows.
        t[f"pred{i}"] = _np_dense(rng, in_f if i == 0 else hidden, classes)
        t[f"pred{i}"]["kernel"] *= 0.02
    return t


def phase_gin(name, dev, profile_steps=2):
    """GIN graph classification (the GIN paper's and DGL's
    examples/pytorch/gin defaults: 5 layers, hidden 64, sum readout, 2
    classes) over ``GraphDataLoader(batch_size=32, pad=True)`` on 1,024
    seeded power-law graphs of 200-800 nodes, 5 Adam steps at 1e-2 of the
    masked cross entropy: step-0 logits against the float64 oracle, the
    engine of each batch's propagation (the padding graph's self-loops may
    earn a hub layout), host ms a batch of the loader against device ms a
    step, launches, and a profile of ``profile_steps`` steps."""
    from dgl1_tpu_torch.dataloading import GraphDataLoader
    from dgl1_tpu_torch.models import GIN
    from torch.profiler import ProfilerActivity, profile

    z = ZOO
    # prefetch 0: each batch is built when asked for, so its host time is
    # the loader's cost a batch.
    loader = GraphDataLoader(_GinData(z["gin_graphs"]),
                             batch_size=z["gin_batch"], shuffle=True,
                             pad=True, prefetch=0, seed=0, device=dev)
    t0 = time.perf_counter()
    it = iter(loader)
    batches, load_ms = [], []
    for _ in range(z["gin_steps"] + profile_steps):
        t1 = time.perf_counter()
        batches.append(next(it))
        load_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_load_s = time.perf_counter() - t0
    model = _load_tree(
        GIN(z["gin_feat"], z["gin_hidden"], 2, num_layers=5, device=dev),
        _gin_tree(np.random.default_rng(20), z["gin_feat"], z["gin_hidden"],
                  2, 5))
    bg0 = batches[0][0]
    lerr, lrel = model_step0(name, model, bg0, bg0.ndata["x"])
    engines_ = [forward_engine(b[0], z["gin_hidden"]) for b in batches]
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model.train()

    def step(b):
        bg, y, mask = b
        opt.zero_grad(set_to_none=True)
        logits = model(bg, bg.ndata["x"])[: z["gin_batch"]]
        nll = torch.nn.functional.cross_entropy(logits, y.long(),
                                                reduction="none")
        loss = (nll * mask).sum() / mask.sum()
        loss.backward()
        opt.step()
        return loss

    reset_all_launches()
    losses, step_ms = [], []
    for b in batches[: z["gin_steps"]]:
        t1 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss.detach()))
    counts = all_launches()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[z["gin_steps"]:]:
            step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / profile_steps
    summarize_profile("gin_profile", name, prof, profile_steps, wall_ms)
    log(json.dumps({
        "phase": "gin_train", "path": name, "graphs": z["gin_graphs"],
        "batch": z["gin_batch"], "steps": z["gin_steps"], "losses": losses,
        "batch_nodes": [b[0].num_nodes() for b in batches],
        "batch_edges": [b[0].num_edges() for b in batches],
        "engine_per_batch": engines_,
        "loader_host_ms_per_batch": load_ms, "loader_wall_s": wall_load_s,
        "ms_per_step": step_ms,
        "launches": {k: v for k, v in counts.items() if v},
        "logits_err_vs_oracle64": lerr, "logits_err_over_abs_sum": lrel}))
    return counts


def phase_dgcnn(name, dev, profile_steps=2):
    """DGCNN's first EdgeConv at ModelNet40's published shape: 32 clouds
    of 1,024 points, ``KNNGraph(k=20)`` built on the card (ms), EdgeConv
    3 -> 64 forward and backward against its oracle run, the
    engine taken, and a profile of ``profile_steps`` steps of kNN build +
    EdgeConv forward and backward."""
    from dgl1_tpu_torch import nn as tnn
    from torch.profiler import ProfilerActivity, profile

    z = ZOO
    gen = torch.Generator(device=dev).manual_seed(70)
    pts = torch.randn(z["clouds"], z["points"], 3, device=dev, generator=gen)
    knn = tnn.KNNGraph(z["knn_k"], device=dev)
    knn(pts[:1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = knn(pts)
    torch.cuda.synchronize()
    knn_ms = (time.perf_counter() - t0) * 1e3
    if g.num_edges() != z["clouds"] * z["points"] * z["knn_k"]:
        raise AssertionError(f"{name}: {g.num_edges()} kNN edges")
    x = pts.reshape(-1, 3)
    make = lambda: tnn.EdgeConv(  # noqa: E731
        3, 64, device=dev, generator=torch.Generator().manual_seed(71))
    counts = conv_case(name, make, g, [x], f64=False)
    conv = make()

    def step():
        gg = knn(pts)
        xx = pts.reshape(-1, 3).requires_grad_(True)
        conv(gg, xx).sum().backward()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profile_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / profile_steps
    summarize_profile("dgcnn_profile", name, prof, profile_steps, wall_ms,
                      knn_build_ms=knn_ms, engine=forward_engine(g, 64))
    return counts


def phase_dgi(name, dev, g):
    """examples/train_dgi.py's ``DGI(hidden=128)`` at arxiv scale, 3 Adam
    steps at 1e-3, corruption permutations from a seeded generator on the
    card: step-0 embeddings against the float64 oracle, losses finite,
    launches."""
    from dgl1_tpu_torch.models import DGI

    z = ZOO
    n = g.num_nodes()
    feat = torch.randn(n, z["in_f"], device=dev,
                       generator=torch.Generator(device=dev).manual_seed(72))
    tree = {"encoder": {"conv0": {
        "weight": {"kernel": _np_dense(np.random.default_rng(21), z["in_f"],
                                       z["dgi_hidden"])["kernel"]},
        "bias": np.zeros(z["dgi_hidden"], np.float32)},
        "prelu0": {"negative_slope": np.asarray(0.25, np.float32)}},
        "discriminator": _np_dense(np.random.default_rng(22),
                                   z["dgi_hidden"], z["dgi_hidden"])["kernel"]}
    model = _load_tree(DGI(z["in_f"], z["dgi_hidden"], device=dev), tree)
    lerr, lrel = model_step0(name, model, g, feat,
                             call=lambda m, gg, x: m.embed(gg, x))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    perm_gen = torch.Generator(device=dev).manual_seed(5)
    model.train()
    reset_all_launches()
    losses, step_ms = [], []
    for _ in range(z["dgi_steps"]):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model(g, feat, generator=perm_gen)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
    counts = all_launches()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    log(json.dumps({"phase": "dgi_train", "path": name, "nodes": n,
                    "hidden": z["dgi_hidden"], "losses": losses,
                    "ms_per_step": step_ms,
                    "launches": {k: v for k, v in counts.items() if v},
                    "embed_err_vs_oracle64": lerr,
                    "embed_err_over_abs_sum": lrel}))
    return counts


def phase_graph_files(dev, g):
    """``save_graphs``/``load_graphs`` round trip of the arxiv graph with
    128-wide features and a label dict in a temporary directory: seconds
    each way, the file's size, every array equal after the load."""
    import tempfile

    import dgl1_tpu_torch as dgl

    gen = torch.Generator(device=dev).manual_seed(73)
    g.ndata["feat"] = torch.randn(g.num_nodes(), 128, device=dev,
                                  generator=gen)
    y = torch.randint(0, 40, (g.num_nodes(),), device=dev, generator=gen)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "arxiv.npz")
            t0 = time.perf_counter()
            dgl.save_graphs(path, g, labels={"y": y})
            save_s = time.perf_counter() - t0
            size = Path(path).stat().st_size
            t0 = time.perf_counter()
            (back,), labels = dgl.load_graphs(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
    finally:
        feat = g.ndata.pop("feat")
    e = g.num_edges()
    if (back.num_nodes() != g.num_nodes() or back.num_edges() != e
            or not torch.equal(back.src[:e], g.src[:e])
            or not torch.equal(back.dst[:e], g.dst[:e])
            or not torch.equal(back.ndata["feat"], feat)
            or not torch.equal(labels["y"], y)):
        raise AssertionError("graph files: the arxiv graph did not come "
                             "back as saved")
    log(json.dumps({"phase": "graph_files", "nodes": g.num_nodes(),
                    "edges": e, "file_mb": size / 1e6, "save_s": save_s,
                    "load_s": load_s, "hub": back.hub_dst is not None}))


def zoo_kernel_variants(dev, rows, g_arx):
    """The kernels at phase 4k's new shapes, each against its plain
    version as a variant of its row: K1, K3 (with the diagonal epilogue)
    and K4a at GCNII's F = 64 on the arxiv graph, K2 mul and K5 mul at the
    attention convs' 4 heads of 16 there, K2 rhs and K5 rhs at their
    ``edge_softmax`` sums (he = 4); returns K10 at that softmax's max (F =
    4) on the arxiv graph's forward tiles, whose hub row of 2.8M edges is
    one row block, as a variant for K10's row (made in phase 5)."""
    new = {
        "dense_fwd": dense_fwd_case("gcnii_arxiv_f64", g_arx, dev, 64,
                                    seed=80, library=False),
        "expand": expand_case("gcnii_arxiv_f64_diag", g_arx, dev, 64,
                              seed=81, library=False, epilogue="u"),
        "dense_bwd_fused": dense_bwd_fused_case("gcnii_arxiv_f64", g_arx,
                                                dev, 64, seed=82,
                                                library=False),
        "chunk_mul": weighted_row("chunk_mul", "attn_convs_arxiv_h4x16",
                                  g_arx, dev, 4, 16, library=False,
                                  seed=83),
        "edge_grad_mul": weighted_row("edge_grad_mul",
                                      "attn_convs_arxiv_h4x16", g_arx, dev,
                                      4, 16, library=False, seed=84),
        "chunk_rhs": weighted_row("chunk_rhs", "softmax_sum_arxiv_he4",
                                  g_arx, dev, 4, 1, library=False, seed=86),
        "edge_grad_rhs": weighted_row("edge_grad_rhs",
                                      "softmax_sum_arxiv_he4", g_arx, dev, 4,
                                      1, library=False, seed=87),
    }
    for name, v in new.items():
        rows[name]["variants"].append({k: v[k] for k in VARIANT_KEYS
                                       if k in v})
    # K10's row is made in phase 5: its variant joins it there.
    v = tile_case("softmax_max_arxiv_tdst_f4", g_arx.tdst, g_arx.num_nodes(),
                  4, dev, is_max=True, seed=88)
    return [{k: v[k] for k in VARIANT_KEYS if k in v}]


def bdense_gin_variants(dev, rows, g17):
    """K11 forward and transpose at the GINConv leg's F = 64 on the 2^17
    geometric graph, as variants of their rows."""
    for name, tr in (("block_fwd", False), ("block_bwd", True)):
        v = block_case("gin_geo2e17_f64", g17, dev, 64, tr, seed=85,
                       library=False)
        rows[name]["variants"].append({k: v[k] for k in VARIANT_KEYS
                                       if k in v})


# Phase 4l: the rest of the single-device surface. GNNExplainer on the
# arxiv GCN (examples of DGL's explain module: num_epochs 100, lr 0.01),
# GraphSAINT's random-walk sampler and Cluster-GCN at Reddit's shape (the
# GraphSAINT authors' Reddit walk setting: 2,000 roots of length 4; the
# Cluster-GCN paper's: 1,500 parts, 20 a batch), and the small models at
# their examples' widths.
EXPLAIN = dict(in_f=128, hidden=256, classes=40, epochs=100, lr=0.01,
               hops=2, oracle_epochs=3, profile_epochs=3)
# Launches per mask epoch of the arxiv GCN with a weighted aggregation
# (hub engine, one dense group, the self-loop diagonal extracted): each
# layer's forward is K2 mul with K3's diagonal epilogue, its backward K2
# mul on the full backward layout (grad_u: the feature mask reaches layer
# 1's input) and K5 mul (grad_e, the edge mask). The base prediction
# before the epochs is one forward.
EXPLAIN_PER_EPOCH = {"chunk_mul": 4, "edge_grad_mul": 2, "expand": 2}
EXPLAIN_BASE = {"chunk_mul": 2, "expand": 2}
SAINT = dict(roots=2000, length=4, batches=8, num_pre=20, hidden=128,
             lr=1e-2)
CLUSTER = dict(parts=1500, per_batch=20, top_parts=30, steps=10,
               hidden=128, lr=1e-2)
SMALL = dict(lgnn_graphs=2, lgnn_nodes=60, lgnn_hidden=32, tree_batch=32,
             tree_x=64, tree_h=64, pinsage_items=500, pinsage_users=300,
             pinsage_categories=5, pinsage_batch=64, fps_clouds=32,
             fps_points=1024, fps_samples=512)


def masks_vs(name, got, ref, per_element):
    """A mask (sigmoid values) against its float64 oracle: every element
    within 1e-4 of the mask's abs sum, and with ``per_element`` within
    1e-4 itself. The feature mask's gradient sums over every node and can
    cancel, which Adam's normalised step turns into a relative error of
    the step; an edge's is a few products, its error stays near float32
    rounding. Returns (max error, max error over the abs sum)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: mask shape {tuple(got.shape)}")
    err = float((got.detach().double().cpu() - ref.detach().cpu())
                .abs().max())
    abs_sum = float(ref.abs().sum())
    tol = 1e-4 if per_element else 1e-4 * abs_sum
    if not bool(torch.isfinite(got).all()) or not err <= tol:
        raise AssertionError(f"{name}: mask err {err} > {tol}")
    return err, err / abs_sum


def phase_explainer(dev, g):
    """GNNExplainer on the arxiv GCN (``models.GCN(128, 256, 40)``, norm
    'both', eval mode, weights from a seed; ``model_fn`` gives the edge
    weight to both layers), reference defaults (100 epochs, lr 0.01):
    the masks after 3 epochs against the same loop in float64 on the
    oracle engine (``masks_vs``: each element within 1e-4 of the mask's
    abs sum, an edge mask's within 1e-4); ``explain_graph`` with
    exactly EXPLAIN_BASE plus EXPLAIN_PER_EPOCH a mask epoch launched and
    nothing else, ms a mask epoch (100 epochs less 0), a profile of 3
    epochs of the mask loop; ``explain_node`` (2 hops) at the node of
    highest in-degree and a node of median in-degree: the subgraph's size,
    its engine, launches and seconds. Returns [(path, counts)]."""
    from dgl1_tpu_torch import khop_in_subgraph, ops
    from dgl1_tpu_torch.models import GCN
    from dgl1_tpu_torch.nn import GNNExplainer
    from torch.profiler import ProfilerActivity, profile

    e = EXPLAIN
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(g.num_nodes(), e["in_f"], device=dev, generator=gen)
    model = GCN(e["in_f"], e["hidden"], e["classes"], norm="both",
                device=dev, generator=torch.Generator().manual_seed(21))
    model.eval()

    def mask_gen():
        return torch.Generator().manual_seed(0)

    def explainer(m, epochs):
        return GNNExplainer(lambda gg, x, ew: m(gg, x, edge_weight=ew),
                            e["hops"], lr=e["lr"], num_epochs=epochs)

    def run(epochs, call):
        ex = explainer(model, epochs)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        out = call(ex)
        torch.cuda.synchronize()
        return out, all_launches(), time.perf_counter() - t0

    def graph_call(ex):
        return ex.explain_graph(g, feat, generator=mask_gen())

    # The masks after 3 epochs against the float64 oracle run.
    (fm3, em3), _, _ = run(e["oracle_epochs"], graph_call)
    m64 = copy.deepcopy(model).double()
    ops.set_engine("xla")
    try:
        fm64, em64 = explainer(m64, e["oracle_epochs"]).explain_graph(
            g, feat.double(), generator=mask_gen())
    finally:
        ops.set_engine("auto")
    del m64
    errs = {"edge": masks_vs("explain_graph edge mask", em3, em64, True),
            "feat": masks_vs("explain_graph feat mask", fm3, fm64, False)}
    del fm64, em64
    torch.cuda.empty_cache()
    # Launches and ms a mask epoch: 100 epochs against none.
    _, base, t0_s = run(0, graph_call)
    expect_exact("explain_graph_base", base, EXPLAIN_BASE)
    torch.cuda.reset_peak_memory_stats(dev)
    (fm, em), counts, t_s = run(e["epochs"], graph_call)
    expect_exact("explain_graph_arxiv",
                 counts, _plus(EXPLAIN_BASE,
                               _scaled(EXPLAIN_PER_EPOCH, e["epochs"])))
    if not (em.shape == (g.num_edges(),) and fm.shape == (e["in_f"],)):
        raise AssertionError(f"explain_graph: masks {tuple(em.shape)}, "
                             f"{tuple(fm.shape)}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # A profile of the mask loop alone.
    ex = explainer(model, e["profile_epochs"])
    with torch.no_grad():
        target = int(model(g, feat, edge_weight=torch.ones(
            g.num_edges_padded(), device=dev)).reshape(-1).argmax())

    def target_fn(logits):
        return -torch.log_softmax(logits.reshape(-1), dim=0)[target]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ex._optimize(g, feat, target_fn, mask_gen())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / e["profile_epochs"]
    summarize_profile("explainer_profile", "explain_graph_arxiv", prof,
                      e["profile_epochs"], wall_ms)
    log(json.dumps({
        "phase": "explain_graph", "path": "explain_graph_arxiv",
        "nodes": g.num_nodes(), "edges": g.num_edges(),
        "dims": [e["in_f"], e["hidden"], e["classes"]],
        "epochs": e["epochs"], "seconds": t_s, "seconds_0_epochs": t0_s,
        "ms_per_mask_epoch": (t_s - t0_s) * 1e3 / e["epochs"],
        "launches": {k: v for k, v in counts.items() if v},
        "launches_per_mask_epoch": EXPLAIN_PER_EPOCH,
        "launches_base": {k: v for k, v in base.items() if v},
        "peak_mem_gb": peak,
        "oracle_epochs": e["oracle_epochs"],
        "edge_mask_err_vs_oracle64": errs["edge"][0],
        "edge_mask_err_over_abs_sum": errs["edge"][1],
        "feat_mask_err_vs_oracle64": errs["feat"][0],
        "feat_mask_err_over_abs_sum": errs["feat"][1],
        "edge_mask_mean": float(em.mean()),
        "edge_mask_range": [float(em.min()), float(em.max())]}))
    out = [("explain_graph_arxiv", counts)]
    deg = g.in_degrees().cpu().numpy()
    picks = (("hub", int(deg.argmax())),
             ("median", int(np.argsort(deg, kind="stable")[len(deg) // 2])))
    for tag, node in picks:
        t1 = time.perf_counter()
        sg, _ = khop_in_subgraph(g, node, e["hops"])
        khop_s = time.perf_counter() - t1
        engine = forward_engine(sg, e["classes"])
        del sg
        (center, sg, fm, em), counts, secs = run(
            e["epochs"],
            lambda ex: ex.explain_node(node, g, feat, generator=mask_gen()))
        if not (em.shape == (sg.num_edges(),) and bool(
                torch.isfinite(em).all()) and bool(torch.isfinite(fm).all())):
            raise AssertionError(f"explain_node {tag}: masks")
        log(json.dumps({
            "phase": "explain_node", "path": f"explain_node_arxiv_{tag}",
            "node": node, "in_degree": int(deg[node]), "hops": e["hops"],
            "subgraph_nodes": sg.num_nodes(),
            "subgraph_edges": sg.num_edges(), "engine": engine,
            "hub_meta": repr(sg.hub_dst_meta), "khop_seconds": khop_s,
            "seconds": secs, "epochs": e["epochs"],
            "launches": {k: v for k, v in counts.items() if v}}))
        out.append((f"explain_node_arxiv_{tag}", counts))
        del sg
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "explainer_done",
                    "seconds": time.perf_counter() - t_phase}))
    return out


def explainer_kernel_variants(dev, rows, g_arx):
    """The explainer's shapes not timed elsewhere, each against its
    float64 plain version with its library call, as variants of their
    rows: K2 mul's grad_u at layer 1 (``full_bwd``, F = 128) and K5 mul at
    layer 2 (F = 40) with ``sampled_addmm``."""
    for name, case, rep, bwd in (
            ("chunk_mul", "explainer_grad_u_f128", 128, True),
            ("edge_grad_mul", "explainer_layer2_f40", 40, False)):
        v = weighted_row(name, case, g_arx, dev, 1, rep, bwd, seed=90)
        rows[name]["variants"].append({k: v[k] for k in VARIANT_KEYS
                                       if k in v})
    torch.cuda.empty_cache()


def reddit_dataset(dev, tmp):
    """``data.RedditDataset(full_scale=True)``'s synthetic fallback on the
    card (232,965 nodes, average degree 50 made bidirected, 602 features,
    41 classes), its cache written under ``tmp``: build and cache
    seconds."""
    import dgl1_tpu_torch as dgl

    t0 = time.perf_counter()
    ds = dgl.data.RedditDataset(full_scale=True, raw_dir=tmp, device=dev)
    secs = time.perf_counter() - t0
    g = ds[0]
    if not (ds.is_synthetic and g.num_nodes() == 232965
            and tuple(g.ndata["feat"].shape) == (232965, 602)):
        raise AssertionError("RedditDataset(full_scale=True): unexpected "
                             "graph")
    cache = Path(tmp) / f"{ds.name}_processed.npz"
    log(json.dumps({"phase": "reddit_dataset", "nodes": g.num_nodes(),
                    "edges": g.num_edges(), "seconds": secs,
                    "cache_mb": cache.stat().st_size / 2 ** 20,
                    "train_nodes": int(g.ndata["train_mask"].sum())}))
    return g


def _sampled_loss(model, sg, mask, train_mask):
    """``examples/train_saint.py``'s loss: cross entropy over the real
    training nodes, weighted by ``loss_norm`` where the batch has it."""
    logp = torch.log_softmax(model(sg, sg.ndata["feat"]), dim=1)
    ce = -logp.gather(1, sg.ndata["label"].long()[:, None])[:, 0]
    w = mask * train_mask[sg.ndata["_ID"].long()]
    if "loss_norm" in sg.ndata:
        w = w * sg.ndata["loss_norm"]
    return (ce * w).sum() / w.sum().clamp_min(1e-6)


def train_subgraphs(name, dev, g, batches, steps, hidden, lr):
    """``models.GCN(602, hidden, 41)`` (dropout 0, weights from a seed)
    for ``steps`` Adam steps, one a subgraph drawn from ``batches``: the
    step-0 logits against the float64 oracle (1e-4 of each logit's abs
    sum), host ms to draw each batch, ms a step, each batch's engine,
    size and launches. Returns the launches of all steps."""
    from dgl1_tpu_torch.models import GCN

    model = GCN(g.ndata["feat"].shape[1], hidden, 41, dropout=0.0,
                device=dev, generator=torch.Generator().manual_seed(22))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    it = iter(batches)
    host_ms, step_ms, losses, per_step = [], [], [], []
    engines_, sizes = [], []
    lerr = None
    total = {}
    for i in range(steps):
        t0 = time.perf_counter()
        sg, mask = next(it)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            lerr = model_step0(name, model, sg, sg.ndata["feat"])
        model.train()
        engines_.append(forward_engine(sg, hidden))
        sizes.append([int(mask.sum()), sg.num_nodes(), sg.num_edges()])
        reset_all_launches()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = _sampled_loss(model, sg, mask, g.ndata["train_mask"])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = all_launches()
        per_step.append({k: v for k, v in counts.items() if v})
        total = _plus(total, counts)
        losses.append(float(loss.detach()))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    log(json.dumps({
        "phase": "subgraph_train", "path": name, "steps": steps,
        "dims": [g.ndata["feat"].shape[1], hidden, 41], "losses": losses,
        "host_ms_per_batch": host_ms, "ms_per_step": step_ms,
        "ms_per_step_after_first": float(np.mean(step_ms[1:])),
        "engine_per_batch": engines_,
        "real_nodes_padded_nodes_edges": sizes,
        "launches_per_step": per_step,
        "logits_err_vs_oracle64": lerr[0],
        "logits_err_over_abs_sum": lerr[1]}))
    return total


def two_level_partition(g, k1, k2):
    """``k1 * k2`` parts: the port's greedy partitioner into ``k1`` parts
    of ``g``, then each part's induced subgraph into ``k2`` by the same
    partitioner (its cost grows with the parts times the nodes, so one
    level of 1,500 parts over 232,965 nodes takes many minutes on the
    host)."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.parallel.partition import (
        edge_cut_fraction, greedy_partition_assignment)

    e = g.num_edges()
    src = g.src[:e].cpu().numpy().astype(np.int64)
    dst = g.dst[:e].cpu().numpy().astype(np.int64)
    n = g.num_nodes()
    host = dgl.graph((src, dst), num_nodes=n, formats=("csc",),
                     device="cpu")
    top = greedy_partition_assignment(host, k1)
    inner = np.where(top[src] == top[dst], top[src], -1)
    order = np.argsort(inner, kind="stable")
    bounds = np.searchsorted(inner[order], np.arange(-1, k1 + 1))
    out = np.empty(n, np.int64)
    relabel = np.empty(n, np.int64)
    for p in range(k1):
        ids = np.nonzero(top == p)[0]
        relabel[ids] = np.arange(len(ids))
        eids = order[bounds[p + 1]:bounds[p + 2]]
        sub = dgl.graph((relabel[src[eids]], relabel[dst[eids]]),
                        num_nodes=len(ids), formats=("csc",), device="cpu")
        out[ids] = p * k2 + greedy_partition_assignment(sub, k2)
    return out, 1.0 - edge_cut_fraction(host, out)


def phase_saint_cluster(dev):
    """GraphSAINT (walk mode: 2,000 roots of length 4, 20 pre-sampling
    batches) and Cluster-GCN (1,500 parts, 20 a batch) on
    ``RedditDataset(full_scale=True)``'s synthetic fallback, each training
    ``models.GCN(602, 128, 41)`` with Adam 1e-2 (SAINT 8 batches with
    ``loss_norm`` weighting the loss, Cluster-GCN 10): pre-sampling and
    partitioner seconds, host ms a batch, ms a step, engines and
    launches (``train_subgraphs``). Returns [(path, counts)]."""
    import tempfile

    from dgl1_tpu_torch.dataloading import ClusterGCNDataLoader, SAINTSampler

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        g = reddit_dataset(dev, tmp)
    s = SAINT
    t0 = time.perf_counter()
    sampler = SAINTSampler(g, "walk", (s["roots"], s["length"]),
                           num_batches=s["batches"], num_pre=s["num_pre"],
                           seed=0, device=dev)
    pre_s = time.perf_counter() - t0
    log(json.dumps({"phase": "saint_presample", "mode": "walk",
                    "roots": s["roots"], "length": s["length"],
                    "num_pre": s["num_pre"], "seconds": pre_s}))
    out.append(("saint_reddit_train", train_subgraphs(
        "saint_reddit_train", dev, g, sampler, s["batches"], s["hidden"],
        s["lr"])))
    del sampler
    c = CLUSTER
    t0 = time.perf_counter()
    assign, inner = two_level_partition(g, c["top_parts"],
                                        c["parts"] // c["top_parts"])
    part_s = time.perf_counter() - t0
    sizes = np.bincount(assign, minlength=c["parts"])
    log(json.dumps({"phase": "cluster_partition", "parts": c["parts"],
                    "levels": [c["top_parts"], c["parts"] // c["top_parts"]],
                    "seconds": part_s, "edges_within_parts": inner,
                    "part_nodes_min_max": [int(sizes.min()),
                                           int(sizes.max())]}))
    # prefetch 0: each batch is built when asked for, so its host time is
    # the loader's cost a batch.
    loader = ClusterGCNDataLoader(g, c["parts"], c["per_batch"], seed=0,
                                  prefetch=0, partition_assignment=assign,
                                  device=dev)
    out.append(("cluster_gcn_reddit_train", train_subgraphs(
        "cluster_gcn_reddit_train", dev, g, loader, c["steps"], c["hidden"],
        c["lr"])))
    del loader, g
    torch.cuda.empty_cache()
    return out


def _vs_cpu64(name, got, ref, rel=1e-4):
    """Card output against a float64 CPU run: max error within ``rel`` of
    the largest magnitude."""
    got = got.detach().double().cpu()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: output {tuple(got.shape)}")
    err, mx = float((got - ref).abs().max()), float(ref.abs().max())
    if not err <= rel * mx:
        raise AssertionError(f"{name}: err {err} > {rel} * {mx}")
    return err / mx


def timed_fwd_bwd(model, call):
    """(output, host ms of forward and backward, launches)."""
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call(model)
    out.sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, all_launches()


def cpu64_run(model, call):
    from dgl1_tpu_torch import ops

    m = copy.deepcopy(model).double().cpu().eval()
    ops.set_engine("xla")
    try:
        with torch.no_grad():
            return call(m)
    finally:
        ops.set_engine("auto")


def pinsage_item_graph(device):
    """examples/train_pinsage.py's item graph (500 items, 300 users, 5
    categories, 12 interactions a user; the example's draws)."""
    import dgl1_tpu_torch as dgl

    s = SMALL
    items, users, cats = (s["pinsage_items"], s["pinsage_users"],
                          s["pinsage_categories"])
    rng = np.random.default_rng(0)
    cat = rng.integers(0, cats, items)
    u_cat = rng.integers(0, cats, users)
    iu = rng.integers(0, users, users * 12)
    in_cat = rng.random(len(iu)) < 0.85
    it = np.where(in_cat, rng.permutation(items)[np.searchsorted(
        np.sort(cat), u_cat[iu], side="left").clip(0, items - 1)],
        rng.integers(0, items, len(iu)))
    by_cat = [np.flatnonzero(cat == c) for c in range(cats)]
    it = np.where(in_cat, np.asarray(
        [by_cat[c][rng.integers(0, len(by_cat[c]))] for c in u_cat[iu]]), it)
    order = np.argsort(iu, kind="stable")
    iu_s, it_s = iu[order], it[order]
    ss, dd = [], []
    for a, b in zip(np.searchsorted(iu_s, np.arange(users), side="left"),
                    np.searchsorted(iu_s, np.arange(users), side="right")):
        its = np.unique(it_s[a:b])
        if len(its) > 1:
            pairs = np.array(np.meshgrid(its, its)).reshape(2, -1)
            keep = pairs[0] != pairs[1]
            ss.append(pairs[0][keep])
            dd.append(pairs[1][keep])
    return dgl.to_simple(dgl.graph((np.concatenate(ss), np.concatenate(dd)),
                                   num_nodes=items, device=device))


def phase_small_models(dev):
    """The small models once each at their examples' widths, each on the
    card against a float64 CPU run of the same parameters (max error
    within 1e-4 of the largest magnitude): LGNN (examples/train_lgnn.py:
    SBM mixtures of 60 nodes, 2 communities, average degree 8, hidden 32,
    3 layers), the Tree-LSTM (examples/train_treelstm.py: x and h 64, a
    batch of 32 synthetic SST trees) with both cells, eager and compiled;
    then PinSAGE sampling at examples/train_pinsage.py's graph (its
    sampler settings, 64 seeds) against the same on a CPU copy, and
    ``farthest_point_sampler`` on 32 x 1,024 points down to 512 against
    the CPU's indices. Returns [(path, counts)]."""
    import dgl1_tpu_torch as dgl
    from dgl1_tpu_torch.models import LGNN, TreeLSTM
    from dgl1_tpu_torch.sampling import PinSAGESampler

    s = SMALL
    out = []
    t_phase = time.perf_counter()
    kw = dict(avg_deg=8.0, pq=2.0, seed=0)
    g, lg, pm = dgl.data.SBMMixtureDataset(s["lgnn_graphs"], s["lgnn_nodes"],
                                           2, device=dev, **kw)[0]
    gc, lgc, pmc = dgl.data.SBMMixtureDataset(
        s["lgnn_graphs"], s["lgnn_nodes"], 2, device="cpu", **kw)[0]
    model = LGNN(hidden=s["lgnn_hidden"], communities=2, device=dev,
                 generator=torch.Generator().manual_seed(23)).eval()
    o, ms, counts = timed_fwd_bwd(model, lambda m: m(g, lg, pm))
    rel = _vs_cpu64("lgnn", o, cpu64_run(model, lambda m: m(gc, lgc,
                                                            pmc.double())))
    log(json.dumps({"phase": "small_model", "path": "lgnn_sbm",
                    "nodes": g.num_nodes(), "edges": g.num_edges(),
                    "line_graph_edges": lg.num_edges(),
                    "hidden": s["lgnn_hidden"], "ms_fwd_bwd": ms,
                    "launches": {k: v for k, v in counts.items() if v},
                    "err_over_max": rel}))
    out.append(("lgnn_sbm", counts))
    trees = dgl.data.SSTDataset("train", num_trees=s["tree_batch"], seed=0,
                                device="cpu")
    bgc = dgl.batch([trees[i] for i in range(s["tree_batch"])],
                    device="cpu")
    bg = bgc.to(dev)
    sched = dgl.topo_schedule(bgc)
    for cell in ("childsum", "nary"):
        model = TreeLSTM(trees.vocab_size, s["tree_x"], s["tree_h"], 5,
                         cell_type=cell, device=dev,
                         generator=torch.Generator().manual_seed(24)).eval()
        for mode, sc in (("eager", None), ("compiled", sched)):
            o, ms, counts = timed_fwd_bwd(model, lambda m: m(
                bg, bg.ndata["x"], bg.ndata["mask"], schedule=sc))
            rel = _vs_cpu64(f"treelstm {cell} {mode}", o, cpu64_run(
                model, lambda m: m(bgc, bgc.ndata["x"],
                                   bgc.ndata["mask"].double(), schedule=sc)))
            path = f"treelstm_{cell}_{mode}"
            log(json.dumps({"phase": "small_model", "path": path,
                            "trees": s["tree_batch"],
                            "nodes": bg.num_nodes(), "levels": int(
                                sched["ids"].shape[0]),
                            "x_h": [s["tree_x"], s["tree_h"]],
                            "ms_fwd_bwd": ms,
                            "launches": {k: v for k, v in
                                         counts.items() if v},
                            "err_over_max": rel}))
            out.append((path, counts))
    # PinSAGE sampling: the card's graph against a CPU copy, one seed.
    gi, gic = pinsage_item_graph(dev), pinsage_item_graph("cpu")
    kw = dict(num_traversals=2, termination_prob=0.5, num_random_walks=16,
              num_neighbors=5, seed=1)
    seeds = torch.arange(s["pinsage_batch"], device=dev)
    reset_all_launches()
    t0 = time.perf_counter()
    fr = PinSAGESampler(gi, **kw)(seeds)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_launches()
    frc = PinSAGESampler(gic, **kw)(seeds.cpu())
    e = fr.num_edges()
    if not (e == frc.num_edges() and torch.equal(fr.src[:e].cpu(),
                                                  frc.src[:e])
            and torch.equal(fr.dst[:e].cpu(), frc.dst[:e])
            and torch.equal(fr.edata["weights"].cpu(), frc.edata["weights"])):
        raise AssertionError("PinSAGESampler: the card's frontier differs "
                             "from the CPU's")
    log(json.dumps({"phase": "small_model", "path": "pinsage_sampler",
                    "items": gi.num_nodes(), "item_edges": gi.num_edges(),
                    "seeds": s["pinsage_batch"], "frontier_edges": e,
                    "ms": ms}))
    out.append(("pinsage_sampler", counts))
    # Farthest-point sampling at ModelNet40's shape.
    pos = torch.randn(s["fps_clouds"], s["fps_points"], 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(25))
    reset_all_launches()
    idx = dgl.geometry.farthest_point_sampler(pos, s["fps_samples"],
                                              device=dev)
    counts = all_launches()
    want = dgl.geometry.farthest_point_sampler(pos.cpu(), s["fps_samples"],
                                               device="cpu")
    if not torch.equal(idx.cpu(), want):
        raise AssertionError("farthest_point_sampler: the card's indices "
                             "differ from the CPU's")
    ms = cuda_ms(lambda: dgl.geometry.farthest_point_sampler(
        pos, s["fps_samples"], device=dev), iters=3, warmup=1)
    log(json.dumps({"phase": "small_model", "path": "farthest_point_sampler",
                    "shape": [s["fps_clouds"], s["fps_points"], 3],
                    "samples": s["fps_samples"], "ms": ms}))
    out.append(("farthest_point_sampler", counts))
    log(json.dumps({"phase": "small_models_done",
                    "seconds": time.perf_counter() - t_phase}))
    return out


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (HERE / "dgl1_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: dgl1_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import dgl1_tpu_torch as dgl

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # Phase 1: card and build.
    log(card_line())
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "python": sys.version.split()[0]}))
    phase_build()
    from dgl1_tpu_torch import _native

    # The fused sampler needs the host library: without it the sampled
    # phases would take the numpy sampler and measure another path.
    if _native.lib() is None:
        raise AssertionError("the native host library did not build")

    # Graphs (host build, then device).
    t0 = time.perf_counter()
    g_arx = arxiv_graph(dev)
    g_mix = mixed_graph(dev)
    g_bench = dgl.reorder_graph(
        dgl.data.powerlaw_graph(1 << 19, 8, seed=0, device=dev), "hub")
    assert g_bench.hub_dst_meta.identity_expand
    log(json.dumps({"phase": "graphs", "seconds":
                    time.perf_counter() - t0,
                    "arxiv": repr(g_arx.hub_dst_meta),
                    "mixed": repr(g_mix.hub_dst_meta),
                    "mixed_edges": g_mix.num_edges(),
                    "mixed_chunked_edge_share": chunked_share(g_mix)}))

    # The R-GCN graphs: the typed graph, its relation-sorted copy and the
    # 8 relation subgraphs, whose shapes phase 2 checks too.
    r = rgcn_setup(dev)

    # Phase 2: each kernel against its plain version, at the shapes the
    # trainers give it.
    rows = phase_kernels(dev, g_arx, g_mix, r["rel"][0], r["g_sorted"])

    # Phase 3: g-SpMM through the engine.
    gspmm_path("bench_2e19_relabeled", g_bench, dev, 128,
               ("dense_fwd", "dense_bwd_fused"))
    gspmm_path("mixed_1e5", g_mix, dev, 128,
               ("dense_fwd", "chunk_sum", "dense_bwd"))
    del g_bench

    # Phase 2b/3b: the attention kernels against their plain versions,
    # then the fused op against the composed path.
    rows.update(phase_attn_kernels(dev, g_arx, g_mix))
    gat_attention_path("gat_attention_arxiv", g_arx, dev)
    gat_attention_path("gat_attention_mixed", g_mix, dev)

    # Phase 2d/3c: the weighted hub kernels (K2 mul/rhs, K5) against their
    # float64 plain versions, then u_mul_e and copy_e through the hub
    # engine against the oracle, and the composed GAT chain on the hub
    # engine against the fused attention.
    rows.update(phase_weighted_kernels(dev, g_arx, g_mix, r["g_sorted"]))
    weighted_gspmm_path("gspmm_mul_arxiv_f128", g_arx, dev, "mul", 128,
                        ("chunk_mul", "edge_grad_mul"))
    weighted_gspmm_path("gspmm_copy_rhs_arxiv_he64", g_arx, dev,
                        "copy_rhs", 64, ("chunk_rhs", "edge_grad_rhs"))
    composed_gat_on_hub("composed_gat_arxiv", g_arx, dev)

    # Phase 4: the trainers, each path's counters zeroed before it and
    # read after. GCN: the arxiv graph (K1, K3, K4a), then the mixed-tier
    # graph, whose chunked tier and closed fused-backward gate take K2 and
    # K4b. GAT, the slice's main path: the arxiv graph (K6, K7, K8), the
    # mixed graph (several groups), and the arxiv graph at the model's
    # default dropout 0.6, so in-kernel attention dropout runs end to end.
    attn = ("attn_fwd", "attn_bwd_src", "ger_reduce")
    main_counts = [
        ("gcn_arxiv_train", phase_gcn(
            "gcn_arxiv_train", dev, g_arx, 5,
            ("dense_fwd", "expand", "dense_bwd_fused"))),
        ("gcn_mixed_train", phase_gcn(
            "gcn_mixed_train", dev, g_mix, 3,
            ("dense_fwd", "chunk_sum", "dense_bwd"))),
        ("gat_arxiv_train", phase_gat("gat_arxiv_train", dev, g_arx, 5,
                                      attn)),
        ("gat_mixed_train", phase_gat("gat_mixed_train", dev, g_mix, 3,
                                      attn)),
        ("gat_arxiv_train_drop0.6", phase_gat(
            "gat_arxiv_train_drop0.6", dev, g_arx, 2, attn, drop=0.6,
            check_logits=False)),
        ("gcn_weighted_train", phase_gcn_weighted(
            "gcn_weighted_train", dev, g_arx, 5)),
    ]
    # The g-major route: the arxiv GAT trainer on a layout without the
    # gperm descriptors (K7 g-major instead of K8).
    main_counts.append(("gat_arxiv_train_gmajor", phase_gat_gmajor(
        "gat_arxiv_train_gmajor", dev, g_arx, 3)))
    # The bench_models counterpart, the slice's main path: GCN and GAT at
    # arxiv in f32 and bf16 on the arxiv graph above.
    steps = dict(main_counts)
    for model, path in (("gcn", "gcn_arxiv_train"),
                        ("gat", "gat_arxiv_train")):
        main_counts += phase_bench_models(dev, model, g_arx,
                                          per_step(steps[path], 5))
    profile_gat(dev, g_arx)
    profile_gcn(dev, g_arx)
    # Phase 4j: the message-passing front end on the arxiv graph: the GCN
    # through update_all (phase 4's launches a step), u_mul_e sum (K2 mul,
    # K5 mul), a UDF reduce on the ELL plan and apply_edges(u_dot_v).
    main_counts.append(("update_all_gcn_arxiv_train", phase_update_all_gcn(
        "update_all_gcn_arxiv_train", dev, g_arx,
        steps["gcn_arxiv_train"])))
    main_counts += frontend_arxiv_pairs(dev, g_arx)
    # Phase 4g: link prediction on the arxiv graph (a host copy samples),
    # then layer-wise inference against the full-graph forward.
    main_counts.append(("link_pred_arxiv_train", phase_link_pred(
        "link_pred_arxiv_train", dev, g_arx)))
    # Phase 4k: APPNP and GCNII at arxiv scale (exact hub launches a
    # step), each hub conv on the arxiv graph against its oracle run
    # (GINConv also on the mixed graph), the dense convs, DGI, the graph
    # files, GIN graph classification, DGCNN's EdgeConv and HGTConv; the
    # kernels at the new shapes as variants of their rows.
    t4k = time.perf_counter()
    main_counts += [
        ("appnp_arxiv_train", phase_appnp("appnp_arxiv_train", dev, g_arx)),
        ("gcnii_arxiv_train", phase_gcnii("gcnii_arxiv_train", dev, g_arx)),
    ]
    main_counts += conv_legs_arxiv(dev, g_arx, g_mix)
    main_counts += conv_legs_dense(dev)
    main_counts.append(("dgi_arxiv_train", phase_dgi("dgi_arxiv_train", dev,
                                                     g_arx)))
    phase_graph_files(dev, g_arx)
    main_counts.append(("gin_graph_classification", phase_gin(
        "gin_graph_classification", dev)))
    main_counts.append(("dgcnn_edgeconv_modelnet40", phase_dgcnn(
        "dgcnn_edgeconv_modelnet40", dev)))
    main_counts += conv_leg_hgt(dev)
    zoo_k10 = zoo_kernel_variants(dev, rows, g_arx)
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "phase4k_done",
                    "seconds": time.perf_counter() - t4k}))
    # Phase 4l: GNNExplainer on the arxiv GCN (K2 mul, K5 mul and K3 with
    # its diagonal a mask epoch, exactly), GraphSAINT and Cluster-GCN at
    # Reddit's shape, then LGNN, the Tree-LSTM, PinSAGE sampling and
    # farthest-point sampling against their CPU runs.
    t4l = time.perf_counter()
    main_counts += phase_explainer(dev, g_arx)
    explainer_kernel_variants(dev, rows, g_arx)
    main_counts += phase_saint_cluster(dev)
    main_counts += phase_small_models(dev)
    log(json.dumps({"phase": "phase4l_done",
                    "seconds": time.perf_counter() - t4l}))
    del g_mix  # g_arx stays for phase 4h's flagship trainer

    # Phase 4c: R-GCN at the configuration-#4 shape, the slice's main
    # path: the per-relation path (K1, K3, K4 per relation) and the
    # grouped-GEMM path (K2 rhs, K5 rhs), then a profile of the grouped
    # step.
    main_counts += [
        ("rgcn_perrel_train", phase_rgcn("rgcn_perrel_train", dev, r, 5,
                                         grouped=False)),
        ("rgcn_grouped_train", phase_rgcn("rgcn_grouped_train", dev, r, 5,
                                          grouped=True)),
    ]
    main_counts += phase_bench_models(
        dev, "rgcn", (r["g"], r["rel"]),
        per_step(dict(main_counts)["rgcn_perrel_train"], 5))
    profile_rgcn(dev, r)
    main_counts += frontend_copy_e(dev, r["g_sorted"])

    # Phase 4e: typed graphs and heterographs. The identity relation
    # layouts and the union block (K1 and K4a on them as variants, then
    # bench_models' --huborder and --union R-GCN), then configuration #4
    # at ogbn-mag's shape on the heterograph layer, then HAN at ACM's.
    t4e = time.perf_counter()
    tl = typed_setup(dev, r)
    typed_kernel_variants(dev, rows, tl)
    main_counts += [
        ("rgcn_huborder_train", phase_rgcn_typed(
            "rgcn_huborder_train", dev, r, tl, union=False)),
        ("rgcn_union_train", phase_rgcn_typed(
            "rgcn_union_train", dev, r, tl, union=True)),
    ]
    del tl
    # Phase 4i: the typed distributed layer at world size 1 over NCCL: the
    # typed identity R-GCN on phase 4c's graph (K1, K2, K4a, no K3).
    t4i = time.perf_counter()
    phase_dist_init()
    hg_id, phg_id = typed_identity_setup(r)
    main_counts.append(("typed_identity_rgcn_train", phase_typed_identity(
        "typed_identity_rgcn_train", dev, hg_id, phg_id, rows)))
    del r, hg_id, phg_id
    t4i = time.perf_counter() - t4i
    torch.cuda.empty_cache()
    hg_host, hg, split = mag_setup(dev)
    main_counts.append(("hetero_rgcn_mag_train", phase_mag_rgcn(
        "hetero_rgcn_mag_train", dev, hg,
        torch.as_tensor(split["train"], device=dev))))
    main_counts += frontend_mag(dev, hg, hg_host)
    del hg
    torch.cuda.empty_cache()
    # Phase 4f: the sampled R-GCN of examples/train_rgcn_sampled.py on the
    # host copy (the numpy sampler over every relation, K9 in each
    # relation's backward).
    counts, mag_k9 = phase_sampled_rgcn_mag("sampled_rgcn_mag_train", dev,
                                            hg_host, split)
    main_counts.append(("sampled_rgcn_mag_train", counts))
    # Phase 4i on the mag graph: leg 9's model at P = 1 on the tile
    # layouts (K9 a relation), the typed attention, then the 4-part build
    # of the scale-40 graph partition by partition.
    t0 = time.perf_counter()
    counts, typed_k9 = phase_typed_mag("typed_mag_rgcn_train", dev, hg_host)
    main_counts.append(("typed_mag_rgcn_train", counts))
    del hg_host, split
    torch.cuda.empty_cache()
    counts, k9 = phase_typed_parts("typed_part4_mag_scale40", dev)
    main_counts.append(("typed_part4_mag_scale40", counts))
    typed_k9 += k9
    log(json.dumps({"phase": "typed_dist_done", "seconds":
                    t4i + time.perf_counter() - t0}))
    torch.cuda.empty_cache()
    main_counts.append(("han_train", phase_han("han_train", dev)))
    log(json.dumps({"phase": "hetero_done",
                    "seconds": time.perf_counter() - t4e}))

    # Phase 2c and 4b: the sampled GraphSAGE slice at the Reddit
    # configuration. K9/K10 against their plain versions on a real
    # sampled batch, then the trainers: mean (K9 once per step) and pool
    # (K10 twice, K9 four times per step), then profiles of a mean and a
    # pool step.
    from dgl1_tpu_torch.dataloading import NeighborSampler

    r = reddit_setup(dev)
    _, _, blocks = NeighborSampler(REDDIT["fanouts"]).sample_blocks(
        r["g"], r["train_ids"][:REDDIT["batch"]],
        rng=np.random.default_rng(0))
    blocks = [b.to(dev) for b in blocks]
    rows.update(phase_tile_kernels(dev, blocks))
    rows["tile_sum"]["variants"] += mag_k9 + typed_k9
    rows["tile_minmax"]["variants"] += zoo_k10
    main_counts += frontend_block(dev, blocks[0])
    main_counts += conv_legs_block(dev, blocks[0], r["in_f"])
    del blocks
    loader = reddit_loader(r, dev)
    it = iter(loader)
    batches = [next(it) for _ in range(5)]
    it.close()
    main_counts += [
        ("sage_reddit_train", phase_sage(
            "sage_reddit_train", dev, r, loader, "mean", 5,
            {"tile_sum": 1}, first_batch=batches[0])),
        ("sage_reddit_pool_train", phase_sage(
            "sage_reddit_pool_train", dev, r, loader, "pool", 3,
            {"tile_sum": 4, "tile_minmax": 2})),
    ]
    t_lstm = time.perf_counter()
    main_counts.append(("sage_reddit_lstm_train", phase_sage(
        "sage_reddit_lstm_train", dev, r, loader, "lstm", 3, {})))
    log(json.dumps({"phase": "sage_reddit_lstm_done",
                    "seconds": time.perf_counter() - t_lstm}))
    profile_sage(dev, r, batches)
    profile_sage(dev, r, batches, "pool")
    del loader, batches  # r stays for phase 4h's data-parallel trainer
    torch.cuda.empty_cache()

    # Phase 4d: the block-dense slice on the geometric graphs. K11 against
    # its float64 plain version, g-SpMM through "auto", the RCM route, the
    # GCN trainer (K11 forward 2, transpose 1 per step, nothing else), the
    # GAT trainer (bdense_gat_attention, no kernel; the composed chain at
    # dropout 0.6), then profiles of the GCN and GAT steps.
    t4d = time.perf_counter()
    bg = bdense_setup(dev)
    rows.update(phase_block_kernels(dev, bg))
    main_counts += frontend_bdense(dev, bg["g17"])
    main_counts += conv_leg_bdense(dev, bg["g17"])
    bdense_gin_variants(dev, rows, bg["g17"])
    bdense_gspmm_path("bdense_geo2e20_f128", bg["g20"], dev, 128)
    rcm_route(dev, bg)
    g20 = bg["g20"]
    del bg
    main_counts += [
        ("bdense_gcn_train", phase_bdense_gcn("bdense_gcn_train", dev, g20,
                                              5)),
        ("bdense_gat_train", phase_bdense_gat("bdense_gat_train", dev, g20,
                                              3)),
        ("bdense_gat_train_drop0.6", phase_bdense_gat(
            "bdense_gat_train_drop0.6", dev, g20, 1, drop=0.6)),
    ]
    profile_bdense(dev, g20, "gcn", steps=3, warmup=2)
    profile_bdense(dev, g20, "gat", steps=1, warmup=1)
    log(json.dumps({"phase": "bdense_done",
                    "seconds": time.perf_counter() - t4d}))
    del g20
    torch.cuda.empty_cache()

    # Phase 4h: the distributed layer at world size 1 over NCCL (the dry
    # run's legs, the flagship sharded GCN, the data-parallel sampled
    # GraphSAGE), then the 4-part builds run partition by partition, and
    # each kernel at partition 0's shapes as variants of its row.
    counts_4h, builds = phase_dist(dev, g_arx, r)
    main_counts += counts_4h
    part_kernel_variants(dev, rows, builds)
    del r, g_arx, builds

    # Every hub, tile and block-dense kernel ran under some conv of 4k.
    expect_launches("convs", _plus(*(c for p, c in main_counts
                                     if p.startswith("conv_"))),
                    CONV_KERNELS)
    # ``launches`` is one number per kernel: the sum of the trainer runs,
    # each zeroed and read on its own; ``launches_by_path`` keeps them
    # apart. The g-SpMM and gat_attention counts stay in their lines.
    for name, row in rows.items():
        row["launches_by_path"] = {p: c[name] for p, c in main_counts}
        row["launches"] = sum(row["launches_by_path"].values())
    expect_launches("trainers", {n: r["launches"] for n, r in
                                 rows.items()}, list(rows))
    log(json.dumps({"phase": "done",
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
