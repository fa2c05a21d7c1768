"""Time the two design choices of K2's chunk walk against each other on
one card, each checked against its float64 plain version.

``chunk_walk_kernel`` (``csrc/hub_kernels.cu``) serves K2's plain and mul
modes, and makes two choices by mode:

- the counting sort's histogram: one shared atomic a slot (plain mode) or
  one a run of equal ``b`` in a warp, found with ``__match_any_sync``
  (mul mode);
- the consumer: output rows owned by a warp in registers over the block's
  run of chunks (plain mode) or equal shares of the sorted slots summed
  into a shared 128-row partial (mul mode).

This script builds a variant of the source in which both choices are
template flags, set at run time through ``hub_chunk_walk_variant``, into
``dgl1_tpu_torch/_build/``; routes the wrappers of ``ops/hub_kernels.py``
to it; and times each case's choices in the order A B (C) (C) B A, each a
mean of 20 launches after 3 warm-up (CUDA events, warm L2): K2 plain
against the other histogram on the mixed-tier layout (``part_fwd`` F=128
and F=40, ``part_bwd`` F=40); K2 mul against the other consumer and the
other histogram on the arxiv graph (``full_fwd`` F=128 and F=40,
``full_bwd`` F=40, the GAT shape he=8, rep=32) and on the mixed graph
(F=128): the shapes ``chip_smoke.py`` gives them. The variant is made by
replacing fixed snippets of the source; it raises if one is missing.

Run on a card: ``python -m dgl1_tpu_torch.tools.chunk_walk_variants
[--out FILE]``. It prints the card's name and power limit, then one JSON
line a case.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

__all__ = ["variant_source", "main"]

RTOL, ATOL = 1e-4, 1e-6

# (old, new) replacements that make the variant: the kernel takes
# HIST_WARP (the warp-aggregated histogram) and ROWS_OWNED (the consumer
# with register-owned rows, given the weighted modes' messages).
_PATCH = [
    ("""template <int VEC, int MODE, bool BF16>
__global__ void __launch_bounds__(CM_THREADS, 1)
    chunk_walk_kernel(""",
     """__device__ __forceinline__ int slot_w(int) { return 0; }
__device__ __forceinline__ int slot_w(int2 q) { return q.y; }

template <int VEC, int MODE, bool BF16, bool HIST_WARP, bool ROWS_OWNED>
__global__ void __launch_bounds__(CM_THREADS, 1)
    chunk_walk_kernel("""),
    ("""  float* bnd = acc + (PLAIN ? 0 : BLK * SW);  // [NW][SW] crossing runs
  Slot* sp = reinterpret_cast<Slot*>(bnd + (PLAIN ? 0 : NW * SW));""",
     """  float* bnd = acc + (ROWS_OWNED ? 0 : BLK * SW);
  Slot* sp = reinterpret_cast<Slot*>(bnd + (ROWS_OWNED ? 0 : NW * SW));"""),
    ("""  if (!PLAIN)
    for (int i = tid; i < BLK * SW; i += CM_THREADS) acc[i] = 0.f;""",
     """  if (!ROWS_OWNED)
    for (int i = tid; i < BLK * SW; i += CM_THREADS) acc[i] = 0.f;"""),
    ("""          if constexpr (PLAIN) {
            pos[k] = cb[k] >= 0 ? atomicAdd(cnt + cb[k], 1) : 0;""",
     """          if constexpr (!HIST_WARP) {
            pos[k] = cb[k] >= 0 ? atomicAdd(cnt + cb[k], 1) : 0;"""),
    ("""  if constexpr (PLAIN) {
    // ---- consumers, plain mode""",
     """  if constexpr (ROWS_OWNED) {
    int head[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      head[v] = MODE == kHeads && col0 + v < width ? (f0 + col0 + v) / rep : 0;
    // ---- consumers, plain mode"""),
    ("""            const int key = k + lane < n_b ? slot_key(sq[s0 + k + lane]) : 0;
            const int m = min(32, n_b - k);
            for (int t = 0; t < m; t += CW_UNROLL) {
              float x[CW_UNROLL][VEC];
#pragma unroll
              for (int u = 0; u < CW_UNROLL; ++u)
                ld_vec<VEC>(wn + (__shfl_sync(FULL, key, t + u) & 0xffff),
                            x[u]);
#pragma unroll
              for (int u = 0; u < CW_UNROLL; ++u) {
                if (t + u >= m) break;  // the same in every lane
#pragma unroll
                for (int v = 0; v < VEC; ++v) part[o][v] += x[u][v];
              }""",
     """            const Slot q = k + lane < n_b ? sq[s0 + k + lane] : Slot{};
            const int key = slot_key(q), wq = slot_w(q);
            const int m = min(32, n_b - k);
            for (int t = 0; t < m; t += CW_UNROLL) {
              float x[CW_UNROLL][VEC];
              int w[CW_UNROLL];
#pragma unroll
              for (int u = 0; u < CW_UNROLL; ++u) {
                ld_vec<VEC>(wn + (__shfl_sync(FULL, key, t + u) & 0xffff),
                            x[u]);
                w[u] = PLAIN ? 0 : __shfl_sync(FULL, wq, t + u);
              }
#pragma unroll
              for (int u = 0; u < CW_UNROLL; ++u) {
                if (t + u >= m) break;  // the same in every lane
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                  if constexpr (PLAIN) {
                    part[o][v] += x[u][v];
                  } else {
                    const float wt =
                        MODE == kOneHead
                            ? __int_as_float(w[u])
                            : (col0 + v < width
                                   ? __ldg(e2 + static_cast<int64_t>(w[u]) *
                                                    he + head[v])
                                   : 0.f);
                    part[o][v] = BF16 ? part[o][v] + rnd<true>(
                                                         rnd<true>(x[u][v]) * wt)
                                      : fmaf(x[u][v], wt, part[o][v]);
                  }
                }
              }"""),
    ("""template <int VEC, int MODE, bool BF16>
int launch_chunk_walk(""",
     """template <int VEC, int MODE, bool BF16, bool HIST_WARP, bool ROWS_OWNED>
int launch_chunk_walk("""),
    ("""  auto kern = chunk_walk_kernel<VEC, MODE, BF16>;""",
     """  auto kern = chunk_walk_kernel<VEC, MODE, BF16, HIST_WARP, ROWS_OWNED>;"""),
    ("""      (MODE == kPlain ? 2 * BLK : 3 * BLK + CM_CONSUMERS) * SW *""",
     """      (ROWS_OWNED ? 2 * BLK : 3 * BLK + CM_CONSUMERS) * SW *"""),
    # The run-time choice (-1: the mode's own); float32 launches only.
    ("""// plain: K2 plain (eid and e2 null); else mul, one weight per edge
// (he == 1) or several heads.""",
     """int g_hist_warp = -1, g_rows_owned = -1;

template <int VEC, int MODE, bool BF16>
int launch_chunk_walk(const int* a, const int* b, const int* eid,
                      const int* in_id, const int* out_id, int n_chunks,
                      int chunk, const float* e2, int n_e, int he, int rep,
                      const float* in, int n_in_rows, int ld, float* out,
                      int n_out_rows, int f, cudaStream_t stream) {
  constexpr bool P = MODE == kPlain;
#define VARIANT(H, R)                                                      \\
  return launch_chunk_walk<VEC, MODE, BF16, H, R>(                         \\
      a, b, eid, in_id, out_id, n_chunks, chunk, e2, n_e, he, rep, in,      \\
      n_in_rows, ld, out, n_out_rows, f, stream)
  if constexpr (BF16) {
    VARIANT(!P, P);
  } else if constexpr (P) {  // the shared partial needs weights
    if (g_hist_warp == 1) VARIANT(true, true);
    VARIANT(false, true);
  } else {
    if (g_rows_owned == 1) VARIANT(true, true);
    if (g_hist_warp == 0) VARIANT(false, false);
    VARIANT(true, false);
  }
#undef VARIANT
}

// plain: K2 plain (eid and e2 null); else mul, one weight per edge
// (he == 1) or several heads."""),
    ("""extern "C" {
""",
     """extern "C" {

int hub_chunk_walk_variant(int hist_warp, int rows_owned) {
  g_hist_warp = hist_warp;
  g_rows_owned = rows_owned;
  return 0;
}
"""),
]


def variant_source(src: str) -> str:
    """``hub_kernels.cu``'s text made into the variant (see the module
    docstring); raises ``ValueError`` if a snippet it replaces is not
    found exactly once."""
    for old, new in _PATCH:
        if src.count(old) != 1:
            raise ValueError("hub_kernels.cu no longer holds the snippet:\n"
                             + old)
        src = src.replace(old, new)
    return src


def _build():
    from dgl1_tpu_torch import cuda_build

    src = variant_source(cuda_build.SOURCES["hub_kernels"].read_text())
    key = hashlib.sha256((src + " ".join(cuda_build.FLAGS)).encode())
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = cuda_build.BUILD_DIR / f"hub_variants_{key.hexdigest()[:16]}.so"
    if not so.exists():
        cu = so.with_suffix(".cu")
        cu.write_text(src)
        p = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o",
                            str(so), str(cu)], capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in cuda_build._SIGNATURES["hub_kernels"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hub_chunk_walk_variant.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _graphs(dev):
    """The arxiv graph and the mixed-tier graph, as ``chip_smoke.py``
    builds them."""
    import dgl1_tpu_torch as dgl

    arxiv = dgl.add_self_loop(dgl.data.powerlaw_graph(169343, 26, seed=0,
                                                      device=dev))
    n, n_mid, mid_deg = 100_000, 4 * 128, 4000
    rng = np.random.default_rng(5)
    base = dgl.data.powerlaw_graph(n, 26, seed=1, hub=False, device="cpu")
    s0, d0 = (t.numpy() for t in base.edges())
    d1 = np.repeat(np.arange(1000, 1000 + n_mid), mid_deg)
    s1 = rng.integers(0, n, d1.size)
    s2, d2 = rng.integers(0, n, n), rng.integers(0, n, n)
    mixed = dgl.graph((np.concatenate([s0, s1, s2]),
                       np.concatenate([d0, d1, d2])), num_nodes=n,
                      hub=100_000, hub_dense_floor=1_000_000, device=dev)
    return arxiv, mixed


def _ms(fn, iters=20, warmup=3):
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


def _check(name, out, ref, scale):
    err = (out.double() - ref).abs()
    if not bool((err <= RTOL * scale + ATOL).all()):
        raise AssertionError(f"{name}: disagrees with its plain version "
                             f"(max abs err {float(err.max())})")
    return float(err.max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chunk_walk_variants needs an NVIDIA GPU")
    from dgl1_tpu_torch.ops import hub_kernels as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = _build()
    K._lib = lambda: lib  # the wrappers launch the variant library
    dev = torch.device("cuda")
    g_arx, g_mix = _graphs(dev)
    rows = []

    def paired(case, fn, ref, scale, choices):
        """choices: (hist_warp, rows_owned) pairs, the mode's own first."""
        err = {}
        for c in choices:
            lib.hub_chunk_walk_variant(*c)
            err[c] = _check(f"{case} {c}", fn(), ref, scale)
        ms = {c: [] for c in choices}
        for c in list(choices) + list(reversed(choices)):
            lib.hub_chunk_walk_variant(*c)
            ms[c].append(_ms(fn))
        lib.hub_chunk_walk_variant(-1, -1)
        row = {"case": case, "card": card,
               "choices": [{"hist_warp": c[0], "rows_owned": c[1],
                            "ms": ms[c], "mean_ms": sum(ms[c]) / len(ms[c]),
                            "max_abs_err": err[c]} for c in choices]}
        print(json.dumps(row), flush=True)
        rows.append(row)

    m = g_mix.hub_dst_meta
    for case, f, bwd in [("plain part_fwd F=128", 128, False),
                         ("plain part_fwd F=40", 40, False),
                         ("plain part_bwd F=40", 40, True)]:
        lay = g_mix.hub_dst["part_bwd" if bwd else "part_fwd"]
        n_in = (m.n_groups - m.n_dense) * 128 if bwd else g_mix.num_nodes()
        n_out = m.n_win if bwd else m.n_groups - m.n_dense
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.randn(n_in, f, device=dev, generator=gen)
        paired(case, lambda: K.chunk_sum(lay, u, n_out),
               K.chunk_sum_torch(lay, u.double(), n_out),
               K.chunk_sum_torch(lay, u.abs().double(), n_out),
               [(0, 1), (1, 1)])
    for case, g, he, rep, bwd in [
            ("mul full_fwd F=128", g_arx, 1, 128, False),
            ("mul full_fwd F=40", g_arx, 1, 40, False),
            ("mul full_bwd F=40", g_arx, 1, 40, True),
            ("mul GAT he=8 rep=32", g_arx, 8, 32, False),
            ("mul mixed F=128", g_mix, 1, 128, False)]:
        gm = g.hub_dst_meta
        lay = g.hub_dst["full_bwd" if bwd else "full_fwd"]
        gen = torch.Generator(device=dev).manual_seed(1)
        e2 = torch.randn(g.num_edges(), he, device=dev, generator=gen)
        inp = torch.randn(gm.n_groups * 128 if bwd else g.num_nodes(),
                          he * rep, device=dev, generator=gen)
        n_out = gm.n_win if bwd else gm.n_groups
        paired(case,
               lambda: K.chunk_weighted("mul", lay, e2, inp, n_out, he, rep),
               K.chunk_weighted_torch("mul", lay, e2.double(), inp.double(),
                                      n_out, he, rep),
               K.chunk_weighted_torch("mul", lay, e2.abs().double(),
                                      inp.abs().double(), n_out, he, rep),
               [(1, 0), (1, 1), (0, 0)])
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
