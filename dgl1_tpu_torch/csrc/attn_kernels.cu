// Fused GAT attention kernels for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (no --use_fast_math: expf and the subnormal floor behave as on the CPU)
// and bound with ctypes by dgl1_tpu_torch/ops/attn_kernels.py, whose
// wrappers check devices, types and shapes, allocate every output and
// count launches. Each entry point launches on the given stream and
// returns cudaGetLastError(); the wrapper raises when it is not 0.
//
// The kernels replace the Pallas kernels of dgl1_tpu/ops/attention.py:
//
//   K6 attn_fwd        <- _attn_fwd_kernel                (attention.py:152)
//   K7 attn_bwd_src    <- _attn_bwd_kernel, to_src=True   (attention.py:307)
//   K7 attn_bwd_grp    <- _attn_bwd_kernel, to_src=False  (attention.py:307)
//   K8 attn_ger_reduce <- _ger_reduce_kernel              (attention.py:612)
//
// The TPU kernels gather and scatter through one-hot matmuls and carry
// sums across an in-order grid in VMEM. Here gathers are row loads, sums
// live in shared memory, and blocks that share an output combine with one
// float atomic add per element at the end. Outputs are narrow: H columns
// for den/mraw/gel/partials and H*D for num/gft (the reference pads both
// to 128-lane multiples and its callers read these columns only).
//
// Layout (hub_format.py): chunks of CHUNK slots. In the forward layout a
// slot's a is the source row within window in_id[t] and b the hub row
// within group out_id[t]; chunks are sorted by (group, window) and the
// slots of a chunk by b. In the backward layout a is the hub row within
// group in_id[t], b the source row within window out_id[t]; chunks are
// sorted by (window, group). Padding slots have a = b = -1.
//
// Heads are processed in stripes of hs = max(1, 128 / D) heads (at most
// 128 feature columns; one head of up to 384 columns when D > 128): a
// block owns one stripe, so every per-head quantity it needs stays inside.
//
// K6 and both K7 modes have a BF16 instantiation, the reference's bf16
// matmul mode (dgl1_tpu/ops/precision.py): it rounds to bfloat16 (nearest
// even, in registers, rnd() below) exactly the values the reference casts
// to its compute dtype before a one-hot matmul, and nothing else (el and
// er stay float32: they pick the leaky_relu branch); inputs, outputs and
// sums stay float32. Each kernel's note lists its rounding points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;         // hub group rows / window rows
constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_COLS = 384;    // widest stripe (one head)
constexpr int MAX_Q = MAX_COLS / 32;
constexpr float NEG = -1e30f;    // the reference's -inf stand-in

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// bf16 mode: round to bfloat16, nearest even, and back.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Order-preserving int image of a float (for atomicMax) and its inverse.
__device__ __forceinline__ int f2key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// The reference's _mix32/_drop_mask: int32 arithmetic with wraparound and
// logical shifts, i.e. uint32. key = eid * 131 + head (wrapping).
__device__ __forceinline__ float drop_scale(int eid, int head, int seed,
                                            int thresh, float inv_keep) {
  uint32_t x = static_cast<uint32_t>(eid) * 131u + static_cast<uint32_t>(head);
  x = x * 0x9E3779B9u + static_cast<uint32_t>(seed);
  x ^= x >> 15;
  x *= 0xC2B2AE35u;
  x ^= x >> 13;
  const int bits = static_cast<int>(x & 0x7FFFFFFFu);
  return bits < thresh ? inv_keep : 0.f;
}

struct Stripe {
  int h0, nh, c0, nf;  // first head, heads, first column, columns
};

__device__ __forceinline__ Stripe stripe_of(int y, int hs, int h, int d) {
  Stripe s;
  s.h0 = y * hs;
  s.nh = min(hs, h - s.h0);
  s.c0 = s.h0 * d;
  s.nf = s.nh * d;
  return s;
}

// ---------------------------------------------------------------------
// K6: fused GAT forward over the forward layout.
//
// Replaces _attn_fwd_kernel, whose in-order grid carries each group's
// running max (mraw) and its num/den in VMEM from chunk to chunk with an
// online rescale. At arxiv scale every chunk (5,292) belongs to one
// group, so a block per group would run the whole forward on one SM.
// Two passes instead:
//   1. attn_max_kernel, one block per chunk: the chunk's max of el over
//      its real slots per head, then atomicMax of the float's ordered int
//      image into mkey[group, head]: the group's exact max, the value the
//      reference's running max ends at.
//   2. attn_fwd_kernel, a block per (run of consecutive chunks, head
//      stripe): p = exp(leaky(el_s + er_b) - leaky(er_b + mraw)) per slot
//      and head into shared memory, den += p and num += p * mask * ft_s
//      accumulated in a (128 x stripe) shared block. Slots of a chunk are
//      sorted by b, so a warp sums a run of equal-b slots in registers and
//      adds it to shared memory once. When the run of chunks moves to
//      another group, and at its end, the block adds its nonzero block
//      entries to num/den in device memory with one atomic each.
// No (E, H) or (E, H*D) array exists; p lives in shared memory per slot
// sub-block.
//
// BF16. The reference's online softmax rounds each chunk's p against the
// running max of the group's chunks so far, and rescales what came
// before by a scale that it rounds for num (not for den). Both sums
// depend on that order, so this mode reproduces it: attn_max_kernel also
// writes each chunk's max (cmax), attn_run_kernel takes the running max
// of each group's chunks in layout order (run), and attn_scale_kernel
// walks each group's chunks backwards and gives every (chunk, hub row,
// head) the product of the later chunks' scales exp(leaky(er + run_prev)
// - leaky(er + run)): fden in float32, fnum rounded per factor. Then
// p = exp(leaky(el + er) - leaky(er + run_t)); den takes rnd(p) * fden,
// num rnd(rnd(p * mask) * rnd(ft)) * fnum, the terms the reference's
// chunk-by-chunk rescale leaves in its sums. The scratch (run, fden,
// fnum; 2 * n_chunks * 128 * H floats) exists only in this mode.
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32, no dropout) the
// data are a and b (43.4 MB), ft (173.4 MB), el (5.4 MB): ~66 us at
// 3.35 TB/s; the exps and FMAs are a few GFLOP. This design reads each
// slot's ft row from L1/L2 (the slots of a window are consecutive, so a
// row is reused while cached) and pays one shared-memory add per run of
// equal-b slots; its time is held by those gathers, not by HBM.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
    attn_init_kernel(int* __restrict__ mkey, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < n) mkey[i] = f2key(NEG);
}

__global__ void __launch_bounds__(NT)
    attn_max_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    const int* __restrict__ in_id,
                    const int* __restrict__ out_id, int chunk,
                    const float* __restrict__ el, int h,
                    int* __restrict__ mkey, float* __restrict__ cmax) {
  __shared__ int smax[BLK];
  const int t = blockIdx.x;
  for (int k = threadIdx.x; k < h; k += NT) smax[k] = f2key(NEG);
  __syncthreads();
  const int64_t win0 = static_cast<int64_t>(in_id[t]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(t) * chunk;
  for (int idx = threadIdx.x; idx < chunk * h; idx += NT) {
    const int j = idx / h, k = idx - j * h;
    const int aa = a[slot0 + j], bb = b[slot0 + j];
    if (aa < 0 || bb < 0) continue;
    atomicMax(&smax[k], f2key(el[(win0 + aa) * h + k]));
  }
  __syncthreads();
  const int g = out_id[t];
  for (int k = threadIdx.x; k < h; k += NT) {
    atomicMax(&mkey[static_cast<int64_t>(g) * h + k], smax[k]);
    if (cmax != nullptr)
      cmax[static_cast<int64_t>(t) * h + k] = key2f(smax[k]);
  }
}

// First chunk of group g in the group-sorted out_id: lower_bound(g).
__device__ __forceinline__ int first_chunk(const int* __restrict__ out_id,
                                           int n_chunks, int g) {
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (out_id[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// bf16 mode: run[t, k], the running max of cmax over group out_id[t]'s
// chunks up to and including t. A thread per (group, head).
__global__ void __launch_bounds__(NT)
    attn_run_kernel(const int* __restrict__ out_id, int n_chunks,
                    const float* __restrict__ cmax, int n_groups, int h,
                    float* __restrict__ run) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * h) return;
  const int g = static_cast<int>(i / h), k = static_cast<int>(i % h);
  const int t0 = first_chunk(out_id, n_chunks, g);
  const int t1 = first_chunk(out_id, n_chunks, g + 1);
  float r = NEG;
  for (int t = t0; t < t1; ++t) {
    const float c = cmax[static_cast<int64_t>(t) * h + k];
    r = t == t0 ? c : fmaxf(r, c);
    run[static_cast<int64_t>(t) * h + k] = r;
  }
}

// bf16 mode: per (chunk t, hub row r of its group, head k), the product of
// the scales the reference's later chunks u of the group apply, scale_u =
// exp(leaky(er + run_{u-1}) - leaky(er + run_u)): fden in float32, fnum of
// the scales rounded to bf16. A thread per (group, row, head) walks the
// group's chunks backwards.
__global__ void __launch_bounds__(NT)
    attn_scale_kernel(const int* __restrict__ out_id, int n_chunks,
                      const float* __restrict__ run,
                      const float* __restrict__ er_g, int n_groups, int h,
                      float slope, float* __restrict__ fden,
                      float* __restrict__ fnum) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * BLK * h) return;
  const int64_t row = i / h;  // group * BLK + r
  const int k = static_cast<int>(i % h);
  const int g = static_cast<int>(row / BLK), r = static_cast<int>(row % BLK);
  const int t0 = first_chunk(out_id, n_chunks, g);
  const int t1 = first_chunk(out_id, n_chunks, g + 1);
  const float erv = er_g[row * h + k];
  float ad = 1.f, an = 1.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const int64_t o = (static_cast<int64_t>(t) * BLK + r) * h + k;
    fden[o] = ad;
    fnum[o] = an;
    if (t > t0) {
      const float r0 = run[static_cast<int64_t>(t - 1) * h + k];
      const float r1 = run[static_cast<int64_t>(t) * h + k];
      const float s = expf(leaky(erv + r0, slope) - leaky(erv + r1, slope));
      ad *= s;
      an *= rnd<true>(s);
    }
  }
}

__global__ void __launch_bounds__(NT)
    attn_bcast_kernel(const int* __restrict__ mkey, float* __restrict__ mraw,
                      int n_groups, int h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * BLK * h) return;
  const int64_t row = i / h, k = i - row * h;
  mraw[i] = key2f(mkey[(row / BLK) * h + k]);
}

// Adds the shared (128 x stripe) num block and (128 x nh) den block of
// group g to device memory, skipping zeros, and clears them.
__device__ void fwd_flush(float* num_sh, float* den_sh, int fs, int hs,
                          const Stripe& st, int g, int h, int F,
                          float* __restrict__ num, float* __restrict__ den) {
  __syncthreads();
  const int64_t row0 = static_cast<int64_t>(g) * BLK;
  for (int idx = threadIdx.x; idx < BLK * st.nf; idx += NT) {
    const int r = idx / st.nf, c = idx - r * st.nf;
    const float v = num_sh[r * fs + c];
    if (v != 0.f) atomicAdd(&num[(row0 + r) * F + st.c0 + c], v);
    num_sh[r * fs + c] = 0.f;
  }
  for (int idx = threadIdx.x; idx < BLK * st.nh; idx += NT) {
    const int r = idx / st.nh, k = idx - r * st.nh;
    const float v = den_sh[r * hs + k];
    if (v != 0.f) atomicAdd(&den[(row0 + r) * h + st.h0 + k], v);
    den_sh[r * hs + k] = 0.f;
  }
  __syncthreads();
}

template <bool DROP, bool BF16>
__global__ void __launch_bounds__(NT)
    attn_fwd_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    const int* __restrict__ eid,
                    const int* __restrict__ in_id,
                    const int* __restrict__ out_id, int n_chunks, int chunk,
                    int cpc, const float* __restrict__ el,
                    const float* __restrict__ er_g,
                    const float* __restrict__ ft,
                    const int* __restrict__ mkey,
                    const float* __restrict__ run,
                    const float* __restrict__ fden,
                    const float* __restrict__ fnum, int h, int d, int hs,
                    int sub, float slope, const int* __restrict__ seed,
                    int thresh, float inv_keep, float* __restrict__ num,
                    float* __restrict__ den) {
  extern __shared__ float smem[];
  const int fs = hs * d, F = h * d;
  float* num_sh = smem;                 // BLK * fs
  float* den_sh = num_sh + BLK * fs;    // BLK * hs
  float* pm_sh = den_sh + BLK * hs;     // sub * hs
  float* fn_sh = pm_sh + sub * hs;      // sub * hs (BF16: fnum per slot)
  int* src_sh = reinterpret_cast<int*>(fn_sh + (BF16 ? sub * hs : 0));  // sub
  int* b_sh = src_sh + sub;                                // sub
  const Stripe st = stripe_of(blockIdx.y, hs, h, d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sd = DROP ? seed[0] : 0;
  for (int i = tid; i < BLK * fs; i += NT) num_sh[i] = 0.f;
  for (int i = tid; i < BLK * hs; i += NT) den_sh[i] = 0.f;
  // Head of each column this lane owns (column lane + 32 q).
  int hq[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) hq[q] = (lane + 32 * q) / d;
  __syncthreads();

  const int t0 = blockIdx.x * cpc, t1 = min(n_chunks, t0 + cpc);
  int cur = -1;
  for (int t = t0; t < t1; ++t) {
    const int g = out_id[t];
    if (g != cur) {
      if (cur >= 0) fwd_flush(num_sh, den_sh, fs, hs, st, cur, h, F, num, den);
      cur = g;
    }
    const int64_t win0 = static_cast<int64_t>(in_id[t]) * BLK;
    const int64_t grp0 = static_cast<int64_t>(g) * BLK;
    for (int s0 = 0; s0 < chunk; s0 += sub) {
      const int ns = min(sub, chunk - s0);
      const int64_t slot0 = static_cast<int64_t>(t) * chunk + s0;
      for (int j = tid; j < ns; j += NT) {
        const int aa = a[slot0 + j], bb = b[slot0 + j];
        src_sh[j] = (aa >= 0 && bb >= 0) ? static_cast<int>(win0 + aa) : -1;
        b_sh[j] = bb;
      }
      __syncthreads();
      // p per (slot, head of the stripe); den takes p, num p * mask.
      for (int idx = tid; idx < ns * st.nh; idx += NT) {
        const int j = idx / st.nh, k = idx - j * st.nh;
        const int src = src_sh[j];
        float pm = 0.f;
        float fn = 1.f;
        if (src >= 0) {
          const int hd = st.h0 + k, bb = b_sh[j];
          const float erv = er_g[(grp0 + bb) * h + hd];
          const float elv = el[static_cast<int64_t>(src) * h + hd];
          const float mx =
              BF16 ? run[static_cast<int64_t>(t) * h + hd]
                   : key2f(mkey[static_cast<int64_t>(g) * h + hd]);
          const float p = expf(leaky(elv + erv, slope) - leaky(erv + mx, slope));
          if (BF16) {
            const int64_t o = (static_cast<int64_t>(t) * BLK + bb) * h + hd;
            atomicAdd(&den_sh[bb * hs + k], rnd<true>(p) * fden[o]);
            fn = fnum[o];
          } else {
            atomicAdd(&den_sh[bb * hs + k], p);
          }
          pm = rnd<BF16>(
              DROP ? p * drop_scale(eid[slot0 + j], hd, sd, thresh, inv_keep)
                   : p);
        }
        pm_sh[j * hs + k] = pm;
        if (BF16) fn_sh[j * hs + k] = fn;
      }
      __syncthreads();
      // num: each warp walks a contiguous run of slots; runs of equal b
      // sum in registers and go to shared memory once.
      const int per = (ns + NWARPS - 1) / NWARPS;
      const int j0 = warp * per, j1 = min(ns, j0 + per);
      float acc[MAX_Q];
#pragma unroll
      for (int q = 0; q < MAX_Q; ++q) acc[q] = 0.f;
      int prev = -1;
      for (int j = j0; j < j1; ++j) {
        const int src = src_sh[j];
        if (src < 0) continue;
        const int bb = b_sh[j];
        if (bb != prev) {
          if (prev >= 0) {
#pragma unroll
            for (int q = 0; q < MAX_Q; ++q) {
              const int c = lane + 32 * q;
              if (c < st.nf) atomicAdd(&num_sh[prev * fs + c], acc[q]);
              acc[q] = 0.f;
            }
          }
          prev = bb;
        }
        const float* frow = ft + static_cast<int64_t>(src) * F + st.c0;
        const float* prow = pm_sh + j * hs;
        const float* fnrow = fn_sh + j * hs;
#pragma unroll
        for (int q = 0; q < MAX_Q; ++q) {
          const int c = lane + 32 * q;
          if (c < st.nf) {
            if (BF16) {
              acc[q] += rnd<true>(prow[hq[q]] * rnd<true>(frow[c])) *
                        fnrow[hq[q]];
            } else {
              acc[q] = fmaf(prow[hq[q]], frow[c], acc[q]);
            }
          }
        }
      }
      if (prev >= 0) {
#pragma unroll
        for (int q = 0; q < MAX_Q; ++q) {
          const int c = lane + 32 * q;
          if (c < st.nf) atomicAdd(&num_sh[prev * fs + c], acc[q]);
        }
      }
      __syncthreads();
    }
  }
  if (cur >= 0) fwd_flush(num_sh, den_sh, fs, hs, st, cur, h, F, num, den);
}

// ---------------------------------------------------------------------
// K7: GAT backward, to_src=True, over the window-major layout.
//
// Replaces _attn_bwd_kernel(to_src=True), which recomputes p per chunk,
// accumulates gft/gel per window over consecutive chunks in VMEM and
// writes one per-chunk (128, 128) block of group-side q partials. Here a
// block owns one (window, head stripe): it finds its window's chunks by
// binary search of the sorted out_id and accumulates gft (128 x stripe)
// and gel (128 x nh) in shared memory with no device-memory atomics, and
// each chunk's partial (128 x nh) in shared memory, stored once per chunk.
// Per real slot and head it recomputes
//   acoef = exp(leaky(el_s + er_b) - lse_b)      (lse = mz + log den)
//   g     = <ft_s, ct_b> over the head's D features
//   q     = acoef * (g * mask - rho_b) * leaky'(el_s + er_b)
// then gel_s += q, partial_b += q, and gft_s += acoef * mask * ct_b. The
// slots of a window are not sorted by source, so gft takes one shared
// atomic add per slot and column.
//
// Bound on the H100: bytes. At arxiv layer 1 the data are a and b
// (43.4 MB), ft (173.4 MB) and el read once, the group rows (small), gft
// (173.4 MB) and gel written once, and the narrow partials (21.7 MB):
// ~126 us at 3.35 TB/s. This design gathers each slot's ft and ct rows
// (twice for ct) from L1/L2 and pays D shared atomics per slot and head;
// those, not HBM, hold it.
//
// BF16 rounds ft and ct, each product ft * ct before the head sum, acoef *
// mask, its product with ct and q (before every sum it enters), and lse
// and rho only when 3H > 128 (below that the reference packs [er | lse |
// rho] into one float32 block it does not round).
// ---------------------------------------------------------------------

// One term of the per-head dot <ft_s, ct_b>.
template <bool BF16>
__device__ __forceinline__ float dot_term(float x, float y, float acc) {
  return BF16 ? acc + rnd<true>(rnd<true>(x) * rnd<true>(y))
              : fmaf(x, y, acc);
}

// <fr, cr> over one head's d features; 16-byte loads when vec4.
template <bool BF16>
__device__ __forceinline__ float head_dot(const float* fr, const float* cr,
                                          int d, bool vec4) {
  float gv = 0.f;
  if (vec4) {
    for (int c = 0; c < d; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(fr + c);
      const float4 y = *reinterpret_cast<const float4*>(cr + c);
      gv = dot_term<BF16>(x.x, y.x, gv);
      gv = dot_term<BF16>(x.y, y.y, gv);
      gv = dot_term<BF16>(x.z, y.z, gv);
      gv = dot_term<BF16>(x.w, y.w, gv);
    }
  } else {
    for (int c = 0; c < d; ++c) gv = dot_term<BF16>(fr[c], cr[c], gv);
  }
  return gv;
}

template <bool DROP, bool BF16>
__global__ void __launch_bounds__(NT)
    attn_bwd_src_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        const int* __restrict__ eid,
                        const int* __restrict__ in_id,
                        const int* __restrict__ out_id, int n_chunks,
                        int chunk, const float* __restrict__ el,
                        const float* __restrict__ er_g,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ rho_g,
                        const float* __restrict__ ft,
                        const float* __restrict__ ct_g, int h, int d, int hs,
                        int sub, float slope, const int* __restrict__ seed,
                        int thresh, float inv_keep, float* __restrict__ gft,
                        float* __restrict__ gel, float* __restrict__ gerp) {
  extern __shared__ float smem[];
  const int fs = hs * d, F = h * d;
  float* gft_sh = smem;                  // BLK * fs
  float* gel_sh = gft_sh + BLK * fs;     // BLK * hs
  float* gp_sh = gel_sh + BLK * hs;      // BLK * hs (this chunk's partial)
  float* am_sh = gp_sh + BLK * hs;       // sub * hs  (acoef * mask)
  int* grow_sh = reinterpret_cast<int*>(am_sh + sub * hs);  // sub
  int* wl_sh = grow_sh + sub;                               // sub
  int* al_sh = wl_sh + sub;                                 // sub
  const Stripe st = stripe_of(blockIdx.y, hs, h, d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w = blockIdx.x;
  const int sd = DROP ? seed[0] : 0;
  const bool rstats = BF16 && 3 * h > BLK;
  for (int i = tid; i < BLK * fs; i += NT) gft_sh[i] = 0.f;
  for (int i = tid; i < 2 * BLK * hs; i += NT) gel_sh[i] = 0.f;

  // This window's chunks: [lower_bound(w), lower_bound(w + 1)).
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (out_id[mid] < w) lo = mid + 1; else hi = mid;
  }
  const int t0 = lo;
  hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (out_id[mid] <= w) lo = mid + 1; else hi = mid;
  }
  const int t1 = lo;
  const int64_t win0 = static_cast<int64_t>(w) * BLK;
  // 16-byte loads for the per-head dot when every row start is aligned.
  const bool vec4 = ((d | F) & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(ft) |
                      reinterpret_cast<uintptr_t>(ct_g)) & 15) == 0;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int64_t grp0 = static_cast<int64_t>(in_id[t]) * BLK;
    for (int s0 = 0; s0 < chunk; s0 += sub) {
      const int ns = min(sub, chunk - s0);
      const int64_t slot0 = static_cast<int64_t>(t) * chunk + s0;
      for (int j = tid; j < ns; j += NT) {
        const int aa = a[slot0 + j], bb = b[slot0 + j];
        grow_sh[j] = (aa >= 0 && bb >= 0) ? static_cast<int>(grp0 + aa) : -1;
        wl_sh[j] = bb;
        al_sh[j] = aa;
      }
      __syncthreads();
      for (int idx = tid; idx < ns * st.nh; idx += NT) {
        const int j = idx / st.nh, k = idx - j * st.nh;
        const int grow = grow_sh[j];
        float am = 0.f;
        if (grow >= 0) {
          const int hd = st.h0 + k, wl = wl_sh[j];
          const int64_t src = win0 + wl;
          const float elv = el[src * h + hd];
          const float erv = er_g[static_cast<int64_t>(grow) * h + hd];
          const float sv = elv + erv;
          float lse = lse_g[static_cast<int64_t>(grow) * h + hd];
          float rho = rho_g[static_cast<int64_t>(grow) * h + hd];
          if (rstats) {
            lse = rnd<true>(lse);
            rho = rnd<true>(rho);
          }
          const float acoef = expf(leaky(sv, slope) - lse);
          const float dl = sv >= 0.f ? 1.f : slope;
          const float gv = head_dot<BF16>(
              ft + src * F + hd * d,
              ct_g + static_cast<int64_t>(grow) * F + hd * d, d, vec4);
          const float m =
              DROP ? drop_scale(eid[slot0 + j], hd, sd, thresh, inv_keep)
                   : 1.f;
          const float q = rnd<BF16>(acoef * (gv * m - rho) * dl);
          am = rnd<BF16>(acoef * m);
          atomicAdd(&gel_sh[wl * hs + k], q);
          atomicAdd(&gp_sh[al_sh[j] * hs + k], q);
        }
        am_sh[j * hs + k] = am;
      }
      __syncthreads();
      for (int j = warp; j < ns; j += NWARPS) {
        const int grow = grow_sh[j];
        if (grow < 0) continue;
        const float* cr = ct_g + static_cast<int64_t>(grow) * F + st.c0;
        float* dst = gft_sh + wl_sh[j] * fs;
        const float* am = am_sh + j * hs;
        for (int c = lane; c < st.nf; c += 32)
          atomicAdd(&dst[c], rnd<BF16>(am[c / d] * rnd<BF16>(cr[c])));
      }
      __syncthreads();
    }
    // This chunk's partial: stored once, then cleared.
    for (int idx = tid; idx < BLK * st.nh; idx += NT) {
      const int r = idx / st.nh, k = idx - r * st.nh;
      gerp[(static_cast<int64_t>(t) * BLK + r) * h + st.h0 + k] =
          gp_sh[r * hs + k];
      gp_sh[r * hs + k] = 0.f;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < BLK * st.nf; idx += NT) {
    const int r = idx / st.nf, c = idx - r * st.nf;
    gft[(win0 + r) * F + st.c0 + c] = gft_sh[r * fs + c];
  }
  for (int idx = tid; idx < BLK * st.nh; idx += NT) {
    const int r = idx / st.nh, k = idx - r * st.nh;
    gel[(win0 + r) * h + st.h0 + k] = gel_sh[r * hs + k];
  }
}

// ---------------------------------------------------------------------
// K7 g-major: GAT backward, to_src=False, over the forward layout.
//
// Replaces _attn_bwd_kernel(to_src=False), which the reference runs when
// the backward layout has no gperm descriptors: it computes grad_er
// straight from the group-major forward layout, carrying each group's
// (128, 128) output block across its consecutive chunks in VMEM. In this
// layout a slot's a is the source row within window in_id[t] and b the
// hub row within group out_id[t]. Per real slot and head it recomputes
// K7's q (acoef, the full-width per-head dot <ft_s, ct_b> and the
// jacobian row term rho_b; see attn_bwd_src_kernel) and adds it to
// grad_er[b]. A group's chunks are consecutive, as in K6, but at arxiv
// scale one group holds all 5,292 chunks, so a block per group would run
// on one SM. A block owns a run of consecutive chunks instead (about four
// blocks per SM) and all heads: a thread per (slot, head) computes q from
// the ft and ct rows (16-byte loads) and adds it to the group's (128 x H)
// block in shared memory; when the run moves to another group, and at its
// end, the block adds the block's nonzero entries to grad_er with one
// atomic each.
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32) the data are a
// and b (43.4 MB), ft (173.4 MB) and el read once, the group rows (er,
// lse, rho, ct: small) and grad_er (n_groups * 128 * H) written once:
// ~67 us at 3.35 TB/s. Like K7 src this design waits on the row gathers
// (ft and ct rows from L1/L2), not on HBM.
//
// BF16: as attn_bwd_src_kernel (ft, ct, their products, q; lse and rho
// when 3H > 128).
// ---------------------------------------------------------------------
__device__ void grp_flush(float* gq_sh, int g, int h,
                          float* __restrict__ ger) {
  __syncthreads();
  float* dst = ger + static_cast<int64_t>(g) * BLK * h;
  for (int i = threadIdx.x; i < BLK * h; i += NT) {
    const float v = gq_sh[i];
    if (v != 0.f) atomicAdd(&dst[i], v);
    gq_sh[i] = 0.f;
  }
  __syncthreads();
}

template <bool DROP, bool BF16>
__global__ void __launch_bounds__(NT)
    attn_bwd_grp_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        const int* __restrict__ eid,
                        const int* __restrict__ in_id,
                        const int* __restrict__ out_id, int n_chunks,
                        int chunk, int cpc, const float* __restrict__ el,
                        const float* __restrict__ er_g,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ rho_g,
                        const float* __restrict__ ft,
                        const float* __restrict__ ct_g, int h, int d,
                        int sub, float slope, const int* __restrict__ seed,
                        int thresh, float inv_keep, float* __restrict__ ger) {
  extern __shared__ float smem[];
  float* gq_sh = smem;                                      // BLK * h
  int* src_sh = reinterpret_cast<int*>(gq_sh + BLK * h);   // sub
  int* b_sh = src_sh + sub;                                 // sub
  const int tid = threadIdx.x, F = h * d;
  const int sd = DROP ? seed[0] : 0;
  const bool rstats = BF16 && 3 * h > BLK;
  const bool vec4 = ((d | F) & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(ft) |
                      reinterpret_cast<uintptr_t>(ct_g)) & 15) == 0;
  for (int i = tid; i < BLK * h; i += NT) gq_sh[i] = 0.f;
  __syncthreads();

  const int t0 = blockIdx.x * cpc, t1 = min(n_chunks, t0 + cpc);
  int cur = -1;
  for (int t = t0; t < t1; ++t) {
    const int g = out_id[t];
    if (g != cur) {
      if (cur >= 0) grp_flush(gq_sh, cur, h, ger);
      cur = g;
    }
    const int64_t win0 = static_cast<int64_t>(in_id[t]) * BLK;
    const int64_t grp0 = static_cast<int64_t>(g) * BLK;
    for (int s0 = 0; s0 < chunk; s0 += sub) {
      const int ns = min(sub, chunk - s0);
      const int64_t slot0 = static_cast<int64_t>(t) * chunk + s0;
      for (int j = tid; j < ns; j += NT) {
        const int aa = a[slot0 + j], bb = b[slot0 + j];
        src_sh[j] = (aa >= 0 && bb >= 0) ? static_cast<int>(win0 + aa) : -1;
        b_sh[j] = bb;
      }
      __syncthreads();
      for (int idx = tid; idx < ns * h; idx += NT) {
        const int j = idx / h, k = idx - j * h;
        const int src = src_sh[j];
        if (src < 0) continue;
        const int bb = b_sh[j];
        const int64_t grow = grp0 + bb;
        const float sv = el[static_cast<int64_t>(src) * h + k] +
                         er_g[grow * h + k];
        float lse = lse_g[grow * h + k], rho = rho_g[grow * h + k];
        if (rstats) {
          lse = rnd<true>(lse);
          rho = rnd<true>(rho);
        }
        const float acoef = expf(leaky(sv, slope) - lse);
        const float dl = sv >= 0.f ? 1.f : slope;
        const float gv = head_dot<BF16>(ft + static_cast<int64_t>(src) * F +
                                            k * d,
                                        ct_g + grow * F + k * d, d, vec4);
        const float m =
            DROP ? drop_scale(eid[slot0 + j], k, sd, thresh, inv_keep) : 1.f;
        atomicAdd(&gq_sh[bb * h + k],
                  rnd<BF16>(acoef * (gv * m - rho) * dl));
      }
      __syncthreads();
    }
  }
  if (cur >= 0) grp_flush(gq_sh, cur, h, ger);
}

// ---------------------------------------------------------------------
// K8: out[gout[k]] += gerp[gperm[k]] over (128 x H) blocks.
//
// Replaces _ger_reduce_kernel, an in-order sweep over the chunks in
// gperm order with gfirst init flags. Here the output is zeroed by the
// wrapper; a thread owns one element of the (128 x H) block and a slice
// of cps consecutive chunks in gperm order, sums its slice in a register
// (gout is sorted, so a slice spans few groups) and adds each group's sum
// with one atomic. Reads are coalesced (consecutive threads, consecutive
// elements of one partial block).
//
// Bound on the H100: bytes, one read of the partials (21.7 MB at arxiv
// layer 1: 6.5 us) and one write of the output.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
    ger_reduce_kernel(const int* __restrict__ gperm,
                      const int* __restrict__ gout, int n_chunks, int cps,
                      const float* __restrict__ gerp, int h,
                      float* __restrict__ out) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int blk = BLK * h;
  if (e >= blk) return;
  const int k0 = blockIdx.y * cps, k1 = min(n_chunks, k0 + cps);
  float acc = 0.f;
  int cur = -1;
  for (int k = k0; k < k1; ++k) {
    const int g = gout[k];
    if (g != cur) {
      if (cur >= 0 && acc != 0.f)
        atomicAdd(&out[static_cast<int64_t>(cur) * blk + e], acc);
      acc = 0.f;
      cur = g;
    }
    acc += gerp[static_cast<int64_t>(gperm[k]) * blk + e];
  }
  if (cur >= 0 && acc != 0.f)
    atomicAdd(&out[static_cast<int64_t>(cur) * blk + e], acc);
}

int g_num_sms = 0;

int num_sms() {
  if (g_num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_num_sms <= 0) g_num_sms = 132;
  }
  return g_num_sms;
}

// Heads per stripe and slots per shared sub-block.
void stripe_plan(int h, int d, int* hs, int* sub) {
  *hs = d >= BLK ? 1 : BLK / d;
  if (*hs > h) *hs = h;
  int s = 1024;
  while (s > 32 && s * *hs > 4096) s /= 2;
  *sub = s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instantiation of a kernel template <bool DROP, bool BF16> that the
// run asks for.
#define PICK(kernel, drop, bf16)                                  \
  ((drop) ? ((bf16) ? kernel<true, true> : kernel<true, false>)   \
          : ((bf16) ? kernel<false, true> : kernel<false, false>))

// Chunks per block: about four blocks per SM over all stripes.
int chunks_per_block(int n_chunks, int n_stripes) {
  const int target = 4 * num_sms();
  const int cpc = static_cast<int>(
      (static_cast<int64_t>(n_chunks) * n_stripes + target - 1) / target);
  return cpc < 1 ? 1 : cpc;
}

}  // namespace

extern "C" {

// `num` and `den` must be zeroed; mkey is (n_groups, h) int32 scratch.
// seed null: no dropout. bf16: 1 for the bf16 mode, which needs the
// float32 scratch cmax and run (n_chunks, h) and fden and fnum
// (n_chunks * 128, h); null otherwise.
int attn_fwd(const int* a, const int* b, const int* eid, const int* in_id,
             const int* out_id, int n_chunks, int chunk, const float* el,
             const float* er_g, const float* ft, int h, int d, float slope,
             const int* seed, int thresh, float inv_keep, int n_groups,
             int* mkey, int bf16, float* cmax, float* run, float* fden,
             float* fnum, float* num, float* den, float* mraw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 && (cmax == nullptr || run == nullptr || fden == nullptr ||
               fnum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_keys = n_groups * h;
  if (n_keys > 0)
    attn_init_kernel<<<(n_keys + NT - 1) / NT, NT, 0, s>>>(mkey, n_keys);
  if (n_chunks > 0) {
    attn_max_kernel<<<n_chunks, NT, 0, s>>>(a, b, in_id, out_id, chunk, el,
                                            h, mkey, bf16 ? cmax : nullptr);
    if (bf16) {
      attn_run_kernel<<<(n_keys + NT - 1) / NT, NT, 0, s>>>(
          out_id, n_chunks, cmax, n_groups, h, run);
      const int64_t n_rows = static_cast<int64_t>(n_keys) * BLK;
      attn_scale_kernel<<<static_cast<int>((n_rows + NT - 1) / NT), NT, 0,
                          s>>>(out_id, n_chunks, run, er_g, n_groups, h,
                               slope, fden, fnum);
    }
    int hs, sub;
    stripe_plan(h, d, &hs, &sub);
    const int n_stripes = (h + hs - 1) / hs;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(BLK) * hs * d + BLK * hs +
                         static_cast<size_t>(bf16 ? 2 : 1) * sub * hs) +
        sizeof(int) * 2 * sub;
    const int cpc = chunks_per_block(n_chunks, n_stripes);
    dim3 grid((n_chunks + cpc - 1) / cpc, n_stripes);
    auto kern = PICK(attn_fwd_kernel, seed != nullptr, bf16);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, NT, smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, cpc, el, er_g, ft, mkey,
        run, fden, fnum, h, d, hs, sub, slope, seed,
        seed != nullptr ? thresh : 0, seed != nullptr ? inv_keep : 1.f, num,
        den);
  }
  const int64_t n_out = static_cast<int64_t>(n_groups) * BLK * h;
  if (n_out > 0)
    attn_bcast_kernel<<<static_cast<int>((n_out + NT - 1) / NT), NT, 0, s>>>(
        mkey, mraw, n_groups, h);
  return static_cast<int>(cudaGetLastError());
}

// Writes every element of gft (n_win*128, h*d), gel (n_win*128, h) and
// gerp (n_chunks*128, h). seed null: no dropout. bf16: 1 for the bf16
// mode.
int attn_bwd_src(const int* a, const int* b, const int* eid, const int* in_id,
                 const int* out_id, int n_chunks, int chunk, const float* el,
                 const float* er_g, const float* lse_g, const float* rho_g,
                 const float* ft, const float* ct_g, int h, int d,
                 float slope, const int* seed, int thresh, float inv_keep,
                 int n_win, int bf16, float* gft, float* gel, float* gerp,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_win > 0) {
    int hs, sub;
    stripe_plan(h, d, &hs, &sub);
    const int n_stripes = (h + hs - 1) / hs;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(BLK) * hs * d + 2 * BLK * hs +
                         static_cast<size_t>(sub) * hs) +
        sizeof(int) * 3 * sub;
    dim3 grid(n_win, n_stripes);
    auto kern = PICK(attn_bwd_src_kernel, seed != nullptr, bf16);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, NT, smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, el, er_g, lse_g, rho_g, ft,
        ct_g, h, d, hs, sub, slope, seed, seed != nullptr ? thresh : 0,
        seed != nullptr ? inv_keep : 1.f, gft, gel, gerp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7 g-major over the forward layout. `ger` (n_groups*128, h) must be
// zeroed. seed null: no dropout. bf16: 1 for the bf16 mode.
int attn_bwd_grp(const int* a, const int* b, const int* eid, const int* in_id,
                 const int* out_id, int n_chunks, int chunk, const float* el,
                 const float* er_g, const float* lse_g, const float* rho_g,
                 const float* ft, const float* ct_g, int h, int d,
                 float slope, const int* seed, int thresh, float inv_keep,
                 int bf16, float* ger, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || h > BLK || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks > 0) {
    int sub = 1024;
    while (sub > 32 && sub * h > 4096) sub /= 2;
    const size_t smem =
        sizeof(float) * static_cast<size_t>(BLK) * h + sizeof(int) * 2 * sub;
    const int cpc = chunks_per_block(n_chunks, 1);
    auto kern = PICK(attn_bwd_grp_kernel, seed != nullptr, bf16);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<(n_chunks + cpc - 1) / cpc, NT, smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, cpc, el, er_g, lse_g,
        rho_g, ft, ct_g, h, d, sub, slope, seed,
        seed != nullptr ? thresh : 0, seed != nullptr ? inv_keep : 1.f, ger);
  }
  return static_cast<int>(cudaGetLastError());
}

// `out` (n_groups*128, h) must be zeroed.
int attn_ger_reduce(const int* gperm, const int* gout, int n_chunks,
                    const float* gerp, int h, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blk = BLK * h;
  if (n_chunks > 0 && blk > 0) {
    const int cps = 16;
    dim3 grid((blk + NT - 1) / NT, (n_chunks + cps - 1) / cps);
    ger_reduce_kernel<<<grid, NT, 0, s>>>(gperm, gout, n_chunks, cps, gerp, h,
                                          out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
