"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and imports ``dgl1_tpu_torch`` only (no JAX,
nothing of ``dgl1_tpu``). Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build the CUDA kernels from
   ``dgl1_tpu_torch/csrc`` (one nvcc per source, started together) and
   print the build time;
2. each hub kernel (K1 dense_fwd, K2 chunk_sum, K3 expand, K4a
   dense_bwd_fused, K4b dense_bwd) on the card at the arxiv trainer's
   shapes (K2 and K4b on a mixed-tier layout at 10^5 nodes whose four
   chunked groups hold about a third of the edges), then each attention
   kernel (K6 attn_fwd, K7 attn_bwd_src, K8 ger_reduce) at arxiv layer
   1's shapes (H=8, D=32, one group of 5,292 chunks), with the same
   kernels at dropout 0.6, at layer 2 (H=1, D=40) and on the mixed graph
   (five groups) as each row's ``variants``; every kernel held against its
   plain torch version; one JSON line per kernel with its error, time,
   bound (the bytes and operations this run's data needs), plain time and
   a library call's time (or why there is none);
3. g-SpMM copy_u+sum forward and backward on bench.py's workload
   (``powerlaw_graph(2^19, 8)`` after the hub relabel, F=128) and on the
   mixed-tier graph, against the oracle engine; then ``gat_attention``
   forward and backward (H=8, D=32) on the arxiv and mixed graphs against
   the composed g-SDDMM -> edge_softmax -> u_mul_e path on the oracle
   engine; edges/s;
4. the trainers at the arxiv configuration of tools/bench_models.py
   (169,343 nodes, ``add_self_loop(powerlaw_graph(., 26))``, Adam 1e-2):
   GCN 128 -> 256 -> 40 for 5 steps (K1, K3, K4a) and 3 on the mixed
   graph (K2, K4b); then the GAT trainer, 128 -> 8 x 32 -> 40 with
   dropout 0: logits against the composed path, 5 steps (K6, K7, K8), 3
   on the mixed graph, and 2 at the model's default dropout 0.6
   (in-kernel attention dropout). Losses finite (and falling without
   dropout), the launch counters of each path's kernels above zero;
   ms/step and peak memory; then a ``torch.profiler`` trace of 3 arxiv
   GAT steps (device busy time, idle share, top kernels);
5. the sampled GraphSAGE slice, this slice's main path, at the Reddit
   configuration of tools/bench_minibatch.py (--scale reddit: 232,965
   nodes, 114,615,892 edges, F=602, 41 classes, fanouts [10, 25], batch
   1024, hidden 256, dropout 0.5, Adam 1e-3; parent graph on the host,
   features on the card): the graph's build seconds; K9 (tile_sum) at
   block 1's reverse tiles (F=256) and K10 (tile_minmax) at block 0's
   forward tiles (F=602) of a real sampled batch, against their plain
   versions (K9 in float64 within the tolerance below, K10 exactly), with
   other blocks, widths and min as ``variants``; the mean trainer for 5
   steps from the 2-worker loader (logits at step 0 against the oracle
   engine, launches K9 1 and every other kernel 0 per step, losses
   finite, then 5 steps on the first batch repeated whose losses fall;
   host sampling ms per batch, device step ms, peak memory); the pool
   trainer for 3 steps (K10 2 and K9 4 per step); a ``torch.profiler``
   trace of 3 mean steps on batches sampled beforehand;
6. the ``{"kernels": [...]}`` line: ``launches_by_path`` holds each
   trainer run's count and ``launches`` their sum (every kernel above
   zero), then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present
or when the package is not beside this script.
"""

from __future__ import annotations

import copy
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
# CUDA-core FLOP/s. Every kernel here computes in float32.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
# Elementwise tolerance of a kernel against its plain version: the sums
# run in another order (and K1/K2 add with atomics, in an order that
# changes between runs), so |kernel - plain| <= RTOL * (|A| |B|) + ATOL,
# with |A| |B| the same product over absolute values.
RTOL, ATOL = 1e-4, 1e-6

_HUB_SRC, _HUB_REF = ("dgl1_tpu_torch/csrc/hub_kernels.cu",
                      "dgl1_tpu/ops/engine_hub.py")
_ATT_SRC, _ATT_REF = ("dgl1_tpu_torch/csrc/attn_kernels.cu",
                      "dgl1_tpu/ops/attention.py")
_TILE_SRC, _TILE_REF = ("dgl1_tpu_torch/csrc/tile_kernels.cu",
                        "dgl1_tpu/ops/engine_pallas.py")
# name -> (id, source in this repository, TPU kernel it replaces)
KERNEL_INFO = {
    "dense_fwd": ("K1", _HUB_SRC, f"{_HUB_REF}:170"),
    "chunk_sum": ("K2", _HUB_SRC, f"{_HUB_REF}:68"),
    "expand": ("K3", _HUB_SRC, f"{_HUB_REF}:303"),
    "dense_bwd_fused": ("K4a", _HUB_SRC, f"{_HUB_REF}:215"),
    "dense_bwd": ("K4b", _HUB_SRC, f"{_HUB_REF}:270"),
    "attn_fwd": ("K6", _ATT_SRC, f"{_ATT_REF}:152"),
    "attn_bwd_src": ("K7", _ATT_SRC, f"{_ATT_REF}:307"),
    "ger_reduce": ("K8", _ATT_SRC, f"{_ATT_REF}:612"),
    "tile_sum": ("K9", _TILE_SRC, f"{_TILE_REF}:54"),
    "tile_minmax": ("K10", _TILE_SRC, f"{_TILE_REF}:75"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    warm L2)."""
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


def check(name, out, ref, scale):
    torch.cuda.synchronize()
    out, ref, scale = out.detach(), ref.detach(), scale.detach()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out - ref).abs()
    tol = RTOL * scale + ATOL
    if not bool((err <= tol).all()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: err "
            f"{err.reshape(-1)[i].item()} > tol {tol.reshape(-1)[i].item()}")
    return float(err.max())


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
               exact=False):
    """Check one kernel against its plain version and time both. ``out``,
    ``ref`` and ``scale`` may be tuples (one entry per output). ``exact``:
    the outputs must be equal element for element (infinities included)
    and ``scale`` is unused."""
    if not isinstance(out, tuple):
        out, ref, scale = (out,), (ref,), (scale,)
    if exact:
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
    plain_ms = cuda_ms(plain, iters=plain_iters,
                       warmup=min(3, plain_iters))
    lib_ms = cuda_ms(library) if library is not None else None
    b_ms, b_by = bound(bytes_moved, flops)
    tag, src, replaces = KERNEL_INFO[name]
    row = {"name": name, "id": tag, "route": "cuda", "source": src,
           "replaces": replaces, "launches": 0,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "bytes": int(bytes_moved), "flops": int(flops),
           "tolerance": ("max abs difference 0" if exact else
                         f"|err| <= {RTOL} * |A||B| + {ATOL}"),
           "shapes": shapes, "ok": True}
    if library_note:
        row["library_note"] = library_note
    log(json.dumps(row))
    return row


def phase_kernels(dev, g_arx, g_mix):
    from dgl1_tpu_torch.ops import hub_kernels as K
    from dgl1_tpu_torch.ops.engine_ell import ell_stack

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    hub, m = g_arx.hub_dst, g_arx.hub_dst_meta
    n = g_arx.num_nodes()
    c = hub["dense_c"]
    cf = c.float()
    kd = c.shape[1]
    nnz_all = int((c != 0).sum())
    # Rows of U the product needs: those whose row of C is not all zero.
    u_rows = int((c[:n] != 0).any(dim=1).sum())

    # K1 at layer 1's width (F = 128, the raw features).
    f1 = 128
    u = torch.randn(n, f1, device=dev, generator=gen)
    out = K.dense_fwd(c, u)
    rows.append(kernel_row(
        "dense_fwd", out, K.dense_fwd_torch(c, u),
        K.dense_fwd_torch(c, u.abs()),
        lambda: K.dense_fwd(c, u), lambda: K.dense_fwd_torch(c, u),
        lambda: torch.mm(cf[:n].t(), u),
        nbytes(c) + u_rows * f1 * 4 + kd * f1 * 4, 2 * nnz_all * f1,
        {"c": list(c.shape), "c_dtype": str(c.dtype), "u": [n, f1],
         "u_rows_needed": u_rows}))

    # K3 at layer 1's width: merged = [tail stack | hub block].
    stacked = ell_stack(m.tail_meta_dst, hub["t_idx"], hub["t_eid"],
                        "copy_lhs", "sum", u, None)
    merged = torch.cat([stacked, out], dim=0).contiguous()
    xs, xd = hub["x_starts"], hub["x_desc"]
    e3 = K.expand(merged, xs, xd, n)
    ref3 = K.expand_torch(merged, xs, xd, n)
    t_inv = hub["t_inv"].long()
    idx_z = torch.where(t_inv < merged.shape[0], t_inv,
                        torch.full_like(t_inv, merged.shape[0]))
    merged_z = torch.cat([merged, merged.new_zeros(1, f1)])
    n_desc = int(xs[-(-n // 512)])
    rows.append(kernel_row(
        "expand", e3, ref3, ref3.abs(),
        lambda: K.expand(merged, xs, xd, n),
        lambda: K.expand_torch(merged, xs, xd, n),
        lambda: torch.index_select(merged_z, 0, idx_z),
        nbytes(merged) + 4 * (n_desc + -(-n // 512) + 1) + n * f1 * 4, 0,
        {"merged": list(merged.shape), "num_dst": n}))

    # K4a at layer 2's width (F = 40: only layer 2 runs a backward).
    f2 = 40
    ct = torch.randn(kd, f2, device=dev, generator=gen)
    ct_full = torch.randn(n, f2, device=dev, generator=gen)
    tail = ell_stack(m.tail_meta_src, hub["r_idx"], hub["r_eid"],
                     "copy_lhs", "sum", ct_full, None).contiguous()
    gs, gd = hub["gb_starts"], hub["gb_desc"]
    o4 = K.dense_bwd_fused(c, ct, tail, gs, gd, n)
    ref4 = K.dense_bwd_fused_torch(c, ct, tail, gs, gd, n)
    scale4 = K.dense_bwd_fused_torch(c, ct.abs(), tail.abs(), gs, gd, n)
    nnz_n = int((c[:n] != 0).sum())
    n_gdesc = int(gs[c.shape[0] // 1024])
    rows.append(kernel_row(
        "dense_bwd_fused", o4, ref4, scale4,
        lambda: K.dense_bwd_fused(c, ct, tail, gs, gd, n),
        lambda: K.dense_bwd_fused_torch(c, ct, tail, gs, gd, n),
        lambda: torch.mm(cf[:n], ct),
        c[:n].numel() * c.element_size() + nbytes(ct, tail)
        + 4 * (n_gdesc + c.shape[0] // 1024 + 1) + n * f2 * 4,
        2 * nnz_n * f2 + n_gdesc * f2,
        {"c": list(c.shape), "ct": [kd, f2], "tail": list(tail.shape),
         "n_out": n}))

    # K2 and K4b on the mixed-tier layout (10^5 nodes, F = 128).
    hm, mm = g_mix.hub_dst, g_mix.hub_dst_meta
    nm = g_mix.num_nodes()
    um = torch.randn(nm, f1, device=dev, generator=gen)
    lay = hm["part_fwd"]
    n_out_b = mm.n_groups - mm.n_dense
    o2 = K.chunk_sum(lay, um, n_out_b)
    ref2 = K.chunk_sum_torch(lay, um, n_out_b)
    scale2 = K.chunk_sum_torch(lay, um.abs(), n_out_b)
    rows_in, rows_out, valid = K._chunk_rows(lay)
    valid = valid & (rows_in < nm)
    n_real = int(valid.sum())
    # Input rows the real slots gather, each read once.
    n_in_rows = int(torch.unique(rows_in[valid]).numel())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sparse CSR is a beta feature
        s_mat = torch.sparse_coo_tensor(
            torch.stack([rows_out[valid], rows_in[valid]]),
            torch.ones(n_real, device=dev), (n_out_b * 128, nm),
            check_invariants=False).coalesce().to_sparse_csr()
    rows.append(kernel_row(
        "chunk_sum", o2, ref2, scale2,
        lambda: K.chunk_sum(lay, um, n_out_b),
        lambda: K.chunk_sum_torch(lay, um, n_out_b),
        lambda: torch.sparse.mm(s_mat, um),
        nbytes(lay["a"], lay["b"], lay["in_id"], lay["out_id"])
        + n_in_rows * f1 * 4 + n_out_b * 128 * f1 * 4, n_real * f1,
        {"chunks": int(lay["in_id"].shape[0]),
         "slots": int(lay["a"].shape[0]), "real_slots": n_real,
         "input_rows_gathered": n_in_rows,
         "chunked_edge_share": chunked_share(g_mix),
         "inp": [nm, f1], "out_blocks": n_out_b}))

    cm = hm["dense_c"]
    cmf = cm.float()
    ctm = torch.randn(cm.shape[1], f1, device=dev, generator=gen)
    o5 = K.dense_bwd(cm, ctm, nm)
    rows.append(kernel_row(
        "dense_bwd", o5, K.dense_bwd_torch(cm, ctm, nm),
        K.dense_bwd_torch(cm, ctm.abs(), nm),
        lambda: K.dense_bwd(cm, ctm, nm),
        lambda: K.dense_bwd_torch(cm, ctm, nm),
        lambda: torch.mm(cmf[:nm], ctm),
        cm[:nm].numel() * cm.element_size() + nbytes(ctm) + nm * f1 * 4,
        2 * int((cm[:nm] != 0).sum()) * f1,
        {"c": list(cm.shape), "c_dtype": str(cm.dtype),
         "ct": list(ctm.shape), "n_out": nm}))
    return {r["name"]: r for r in rows}


SLOPE = 0.2
NO_LIBRARY = ("no single PyTorch call computes this function: the fused "
              "softmax-weighted aggregation over a hub chunk layout")


def f64(args):
    """The float tensors of ``args`` in float64 (layouts pass through)."""
    return tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def attn_case(case, g, dev, h, d, drop, plain_iters=3, library=True):
    """K6, K7 and K8 on the card against their plain versions at one
    layer's shapes; one row per kernel. Inputs are random from a fixed
    seed; K7's lse is K6's own softmax log-normaliser of the hub rows, so
    its coefficients have the sizes training gives them.

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
    rows = {}

    # K6.
    fa = (lf, el, er_g, ft, h, d, SLOPE, drop, seed, m.n_groups)
    out = AK.attn_fwd(*fa)
    ref = AK.attn_fwd_torch(*f64(fa))
    sc = AK.attn_fwd_torch(*f64((lf, el, er_g, ft.abs(), h, d, SLOPE, drop,
                                 seed, m.n_groups)))
    rows_in, _, valid = K._chunk_rows(lf)
    n_real = int(valid.sum())
    src_rows = int(torch.unique(rows_in[valid]).numel())
    shapes.update(real_slots=n_real, source_rows=src_rows)
    rows["attn_fwd"] = kernel_row(
        "attn_fwd", out, ref, (sc[0], ref[1], torch.zeros_like(ref[2])),
        lambda: AK.attn_fwd(*fa), lambda: AK.attn_fwd_torch(*fa), None,
        nbytes(lf["a"], lf["b"], lf["in_id"], lf["out_id"]) + drop_bytes(lf)
        + src_rows * (h + f) * 4 + nbytes(er_g) + nbytes(*out),
        n_real * (2 * f + 8 * h), dict(shapes), NO_LIBRARY, plain_iters)
    num, den, mraw = out
    del ref, sc

    # K7 (to_src=True).
    lse_g = (torch.nn.functional.leaky_relu(er_g + mraw, SLOPE)
             + torch.log(den.clamp_min(1e-30))).contiguous()
    rho_g = torch.randn(gr, h, device=dev, generator=gen)
    ct_g = torch.randn(gr, f, device=dev, generator=gen)
    ba = (lb, el, er_g, lse_g, rho_g, ft, ct_g, h, d, SLOPE, drop, seed,
          m.n_win)
    out = AK.attn_bwd_src(*ba)
    ref = AK.attn_bwd_src_torch(*f64(ba))
    # Sums over absolute values bound each output's terms: |ft|, |ct| and
    # -|rho| make every term of g, q and acoef * ct non-negative.
    sc = AK.attn_bwd_src_torch(*f64((lb, el, er_g, lse_g, -rho_g.abs(),
                                     ft.abs(), ct_g.abs(), h, d, SLOPE, drop,
                                     seed, m.n_win)))
    _, rows_w, valid_b = K._chunk_rows(lb)
    win_rows = int(torch.unique(rows_w[valid_b]).numel())
    rows["attn_bwd_src"] = kernel_row(
        "attn_bwd_src", out, ref, sc,
        lambda: AK.attn_bwd_src(*ba), lambda: AK.attn_bwd_src_torch(*ba),
        None,
        nbytes(lb["a"], lb["b"], lb["in_id"], lb["out_id"]) + drop_bytes(lb)
        + win_rows * (h + f) * 4 + nbytes(er_g, lse_g, rho_g, ct_g)
        + nbytes(*out),
        n_real * (4 * f + 12 * h), dict(shapes, source_rows=win_rows),
        NO_LIBRARY, plain_iters)
    gerp = out[2]
    del ref, sc

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
    ``variants``."""
    rows = attn_case("arxiv_layer1", g_arx, dev, 8, 32, 0.0)
    variants = [attn_case("arxiv_layer1_drop0.6", g_arx, dev, 8, 32, 0.6,
                          plain_iters=1, library=False),
                attn_case("arxiv_layer2", g_arx, dev, 1, 40, 0.0,
                          plain_iters=1, library=False),
                attn_case("mixed_layer1", g_mix, dev, 8, 32, 0.0,
                          plain_iters=1, library=False),
                attn_case("mixed_layer1_drop0.6", g_mix, dev, 8, 32, 0.6,
                          plain_iters=1, library=False)]
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bytes", "flops", "shapes")
    for name, row in rows.items():
        row["variants"] = [{k: v[name][k] for k in keep} for v in variants]
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


def tile_case(name, tiles, f, dev, is_max=None, library=True, seed=0):
    """K9 (``is_max`` None) or K10 on one tile layout of a sampled Reddit
    block at width ``f``. Message rows of padding slots hold NaN: a kernel
    that read one would put NaN in its output. K9 is held against its
    float64 plain version with the script's tolerance, K10 against its
    float32 plain version exactly; plain_ms times the float32 plain
    version. The library call (timed only) gets the real slots' rows
    gathered beforehand: ``index_add_`` for K9, ``scatter_reduce_`` amax
    or amin (include_self=False) for K10."""
    from dgl1_tpu_torch.ops import tile_kernels as TK

    gen = torch.Generator(device=dev).manual_seed(seed)
    lid = tiles["lid"]
    args = (tiles["rows"], tiles["first"], lid)
    n_tiles, n_rb = lid.shape[0], tiles["block_mask"].shape[0]
    msg = torch.randn(lid.numel(), f, device=dev, generator=gen)
    if is_max is not None:
        msg.clamp_(min=0.0)  # relu'd pool features: ties at zero
    real = (lid.reshape(-1) >= 0).nonzero().squeeze(1)
    msg[lid.reshape(-1) < 0] = float("nan")
    target = (tiles["rows"].long()[:, None] * 128 + lid.long()).reshape(
        -1).index_select(0, real)
    n_real = int(real.numel())
    bytes_moved = (n_real * f * 4 + nbytes(lid, tiles["rows"],
                                           tiles["first"])
                   + n_rb * 128 * f * 4)
    shapes = {"case": name, "f": f, "tiles": n_tiles, "row_blocks": n_rb,
              "slots": int(lid.numel()), "real_slots": n_real,
              "row_blocks_with_edges": int(tiles["block_mask"].sum())}
    lib = None
    if library:
        msg_real = msg.index_select(0, real)
        lib_out = torch.zeros(n_rb * 128, f, device=dev)
        if is_max is None:
            lib = lambda: lib_out.index_add_(0, target, msg_real)
        else:
            idx = target[:, None].expand(-1, f)
            red = "amax" if is_max else "amin"
            lib = lambda: lib_out.scatter_reduce_(0, idx, msg_real, red,
                                                  include_self=False)
    if is_max is None:
        out = TK.tile_sum(*args, msg, n_rb)
        ref = TK.tile_sum_torch(*args, msg.double(), n_rb)
        scale = TK.tile_sum_torch(*args, msg.abs().double(), n_rb)
        row = kernel_row(
            "tile_sum", out, ref, scale,
            lambda: TK.tile_sum(*args, msg, n_rb),
            lambda: TK.tile_sum_torch(*args, msg, n_rb), lib,
            bytes_moved, n_real * f, shapes, plain_iters=3)
    else:
        out = TK.tile_minmax(is_max, *args, msg, n_rb)
        ref = TK.tile_minmax_torch(is_max, *args, msg, n_rb)
        shapes["reduce"] = "max" if is_max else "min"
        row = kernel_row(
            "tile_minmax", out, ref, None,
            lambda: TK.tile_minmax(is_max, *args, msg, n_rb),
            lambda: TK.tile_minmax_torch(is_max, *args, msg, n_rb), lib,
            bytes_moved, n_real * f, shapes, plain_iters=3, exact=True)
    if lib is None:
        row["library_note"] = "timed on the main case only"
    return row


def phase_tile_kernels(dev, blocks):
    """K9 at block 1 ``tsrc`` (F=256: the mean step's only launch) and K10
    max at block 0 ``tdst`` (F=602: the pool step's first layer), on a
    real sampled Reddit batch; K9 at block 0 ``tsrc`` and ``tdst`` and
    K10 min and block 1 ride in ``variants``."""
    b0, b1 = blocks
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bytes", "flops", "shapes")
    k9 = tile_case("block1_tsrc_f256", b1.tsrc, 256, dev)
    k9["variants"] = [{k: v[k] for k in keep} for v in (
        tile_case("block0_tsrc_f602", b0.tsrc, 602, dev, library=False,
                  seed=1),
        tile_case("block0_tdst_f602", b0.tdst, 602, dev, library=False,
                  seed=2))]
    k10 = tile_case("block0_tdst_f602_max", b0.tdst, 602, dev, is_max=True)
    k10["variants"] = [{k: v[k] for k in keep} for v in (
        tile_case("block0_tdst_f602_min", b0.tdst, 602, dev, is_max=False,
                  library=False, seed=3),
        tile_case("block1_tdst_f256_max", b1.tdst, 256, dev, is_max=True,
                  library=False, seed=4))]
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


def profile_sage(dev, r, batches, steps=3):
    """Where the Reddit mean step's device time goes: ``torch.profiler``
    over ``steps`` steps on batches sampled beforehand (so the loader is
    out of the window), after two warm-up steps; as profile_gat."""
    import dgl1_tpu_torch as dgl
    from torch.profiler import ProfilerActivity, profile

    model = sage_model(r, dev, "mean")
    dgl.train_sampled(batches[:2], r["feat"], r["labels"], model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dgl.train_sampled(batches[2:2 + steps], r["feat"], r["labels"],
                          model)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    summarize_profile("sage_profile", "sage_reddit_train", prof, steps,
                      wall_ms)


def summarize_profile(phase, path, prof, steps, wall_ms):
    """Device busy time, idle share and the top device kernels of a
    ``torch.profiler`` window of ``steps`` steps."""
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
                         "calls_per_step": e.count / steps} for e in top]}))


def _kernel_modules():
    from dgl1_tpu_torch.ops import attn_kernels as AK
    from dgl1_tpu_torch.ops import hub_kernels as K
    from dgl1_tpu_torch.ops import tile_kernels as TK

    return K, AK, TK


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "python": sys.version.split()[0]}))
    phase_build()

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

    # Phase 2: each kernel against its plain version.
    rows = phase_kernels(dev, g_arx, g_mix)

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
    ]
    profile_gat(dev, g_arx)
    del g_arx, g_mix

    # Phase 2c and 4b: the sampled GraphSAGE slice at the Reddit
    # configuration. K9/K10 against their plain versions on a real
    # sampled batch, then the trainers: mean (K9 once per step) and pool
    # (K10 twice, K9 four times per step), then a profile of the mean step.
    from dgl1_tpu_torch.dataloading import NeighborSampler

    r = reddit_setup(dev)
    _, _, blocks = NeighborSampler(REDDIT["fanouts"]).sample_blocks(
        r["g"], r["train_ids"][:REDDIT["batch"]],
        rng=np.random.default_rng(0))
    rows.update(phase_tile_kernels(dev, [b.to(dev) for b in blocks]))
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
    profile_sage(dev, r, batches)

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
