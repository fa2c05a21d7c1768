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
// writes one per-chunk (128, 128) block of group-side q partials. Per
// real slot (hub row a of group in_id[t], window row b of window
// out_id[t]) and head it recomputes
//   acoef = exp(leaky(el_s + er_a) - lse_a)      (lse = mz + log den)
//   g     = <ft_s, ct_a> over the head's D features
//   q     = acoef * (g * mask - rho_a) * leaky'(el_s + er_a)
// then gel_s += q, the chunk's partial gerp[t, a] += q, and gft_s +=
// acoef * mask * ct_a.
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32) the data are a
// and b (43.4 MB), ft (173.4 MB) and el read once, the group rows (small),
// gft (173.4 MB) and gel written once, and the narrow partials (21.7 MB):
// ~126 us at 3.35 TB/s. A thread per (slot, head) gathering ft and ct rows
// from L2 and adding gft with a shared atomic per slot and column (the
// earlier design) waits on those gathers and atomics. This design:
//
// * A block owns one (window, stripe of heads) and walks the window's
//   chunks in batches of consecutive chunks of one group (up to 4,096
//   slots). It stages the group's ct rows of its stripe (128 rows, by
//   16-byte cp.async) and their er, lse and rho in shared memory once per
//   group, so no ct row is gathered from L2 per slot.
// * The batch's real slots are counting-sorted by window row b in shared
//   memory, stably (ranks within each 32-slot step from seven ballots on
//   b's bits), so within a row they keep the layout's order by hub row:
//   the slots of one (b, a) pair of one chunk are one run. The power-law
//   generator repeats edges (the arxiv layout's 4.39 M real slots form
//   1.25 M runs); all slots of a run share ft_b, ct_a, acoef and the dot,
//   and differ only in the dropout mask.
// * Warps own window rows, split by equal shares of the sorted slots. A
//   warp walks a row's runs R at a time: lane (run j, head k, part p)
//   holds up to 32 of head k's features (G parts a head, G a power of two
//   with 32 G >= D; R = 32 / (heads x G), 8 at H=8, D=32), takes its
//   run's dot from registers and shared memory and G-part shuffles, and
//   adds its run's terms to its registers: n_kept * acoef * inv_keep *
//   ct_a to gft, n_kept * q_kept + n_dropped * q_dropped to gel and to the
//   chunk's partial (one shared atomic per run and head; stored once per
//   chunk). At the row's end a reduce-scatter over the R lanes of each
//   (head, part) leaves each lane 32 / R summed features, stored once (the
//   first batch of a window stores, later ones add: no atomics).
// * 95 KB of shared memory a block at arxiv layer 1 (111 KB with
//   dropout), so two blocks share an SM and one's staging and sort run
//   under the other's walk.
//
// BF16 rounds ft and ct, each product ft * ct before the head sum, acoef *
// mask, its product with ct and q (before every sum it enters), and lse
// and rho only when 3H > 128 (below that the reference packs [er | lse |
// rho] into one float32 block it does not round). The slots of a run give
// equal rounded terms, so n * term is the sum the reference takes.
// ---------------------------------------------------------------------
constexpr int SRC_SORT = 4096;       // slots sorted per batch
constexpr int SRC_SORT_WIDE = 1024;  // ... when ct rows are over 128 wide
constexpr int SRC_GP = 8192;         // floats of chunk partials per batch
constexpr int SRC_SPL = SRC_SORT / NT;  // slots a lane loads for the sort
constexpr int SRC_COLS = 32;         // features a lane holds
constexpr size_t SRC_SMEM_MAX = 227 * 1024;  // sm_90's opt-in per block

// A K7 block's plan: G lanes per head part (32 G >= d), cpl features per
// part (a multiple of 4, at most 32), hs heads per stripe, R runs walked
// together, ct rows of w floats (the stripe's hs * d) at stride ws, maxs
// slots and nb chunks per batch.
struct SrcPlan {
  int g, cpl, hs, r, w, ws, maxs, nb;
};

size_t src_smem(const SrcPlan& p, bool drop) {
  return sizeof(float) * (static_cast<size_t>(BLK) * p.ws +
                          static_cast<size_t>(3 + p.nb) * BLK * p.hs) +
         sizeof(int) * (NWARPS * BLK + BLK + 1 + 4 + NWARPS * 33 +
                        (drop ? p.maxs : 0)) +
         sizeof(uint16_t) * p.maxs;
}

SrcPlan src_plan(int h, int d, int chunk, bool drop) {
  SrcPlan p;
  p.g = 1;
  while (SRC_COLS * p.g < d) p.g *= 2;
  p.cpl = ((d + p.g - 1) / p.g + 3) / 4 * 4;
  // Heads share a stripe only while it stays 128 wide (one head when d >
  // 128), so the staged ct rows fit in shared memory up to MAX_COLS.
  int cap = 32 / p.g;
  const int by_w = d < BLK ? BLK / d : 1;
  if (by_w < cap) cap = by_w;
  if (h < cap) cap = h;
  p.hs = 1;
  while (2 * p.hs <= cap) p.hs *= 2;
  p.r = 32 / (p.hs * p.g);
  p.w = p.hs * d;
  p.ws = (p.w + 3) / 4 * 4 + 4;  // +4: rows start in other bank groups
  p.maxs = p.w > BLK ? SRC_SORT_WIDE : SRC_SORT;
  const int by_gp = SRC_GP / (BLK * p.hs);
  p.nb = chunk > 0 ? p.maxs / chunk : 0;
  if (p.nb > (by_gp > 1 ? by_gp : 1)) p.nb = by_gp > 1 ? by_gp : 1;
  // Fewer chunks a batch where small chunks would pass the opt-in limit.
  while (p.nb > 1 && src_smem(p, drop) > SRC_SMEM_MAX) --p.nb;
  return p;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; `bytes` below the size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* s, const void* g, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The lanes of this step whose window row equals this lane's (7 bits).
__device__ __forceinline__ unsigned row_peers(bool real, int bb) {
  unsigned peers = __ballot_sync(0xffffffffu, real);
#pragma unroll
  for (int bit = 0; bit < 7; ++bit) {
    const bool on = (bb >> bit) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, real && on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// The first n (<= 32) features of a row segment; absent ones read 0.
template <bool BF16>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int n,
                                          bool vec, float (&v)[SRC_COLS]) {
#pragma unroll
  for (int c = 0; c < SRC_COLS; c += 4) {
    if (vec && c + 4 <= n) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + c));
      v[c] = x.x; v[c + 1] = x.y; v[c + 2] = x.z; v[c + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[c + e] = c + e < n ? __ldg(p + c + e) : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < SRC_COLS; ++c) v[c] = rnd<BF16>(v[c]);
}

// Four staged ct features from shared memory (16-byte aligned when vec,
// else the first n of them, the rest 0).
__device__ __forceinline__ float4 ct4(const float* p, bool vec, int n) {
  return vec ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                           n > 3 ? p[3] : 0.f);
}

// One step of a reduce-scatter over lanes o apart (none when o < 1):
// the lane keeps the half of v[0, 2 HALF) its bit o selects, summed with
// its partner's, in v[0, HALF).
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[SRC_COLS], int lj, int o) {
  if (o < 1) return;
  const bool up = (lj & o) != 0;
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float send = up ? v[c] : v[c + HALF];
    const float keep = up ? v[c + HALF] : v[c];
    v[c] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <bool DROP, bool BF16>
__global__ void __launch_bounds__(NT, 2)
    attn_bwd_src_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        const int* __restrict__ eid,
                        const int* __restrict__ in_id,
                        const int* __restrict__ out_id, int n_chunks,
                        int chunk, const float* __restrict__ el,
                        const float* __restrict__ er_g,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ rho_g,
                        const float* __restrict__ ft,
                        const float* __restrict__ ct_g, int h, int d,
                        SrcPlan pl, float slope, const int* __restrict__ seed,
                        int thresh, float inv_keep, float* __restrict__ gft,
                        float* __restrict__ gel, float* __restrict__ gerp) {
  extern __shared__ __align__(16) float smem[];
  const int hs = pl.hs, R = pl.r, ws = pl.ws;
  float* ct_sh = smem;                             // BLK x ws
  float* st_sh = ct_sh + BLK * ws;                 // er, lse, rho: 3 x BLK x hs
  float* gp_sh = st_sh + 3 * BLK * hs;             // nb x BLK x hs
  int* cnt_sh = reinterpret_cast<int*>(gp_sh + pl.nb * BLK * hs);  // 8 x BLK
  int* start_sh = cnt_sh + NWARPS * BLK;           // BLK + 1
  int* wsum_sh = start_sh + BLK + 1;               // 4
  int* runs_sh = wsum_sh + 4;                      // 8 x 33 run starts
  int* eid_sh = runs_sh + NWARPS * 33;             // maxs (DROP)
  uint16_t* key_sh =
      reinterpret_cast<uint16_t*>(eid_sh + (DROP ? pl.maxs : 0));  // maxs

  const Stripe st = stripe_of(blockIdx.y, hs, h, d);
  const int F = h * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Lane (run j, part p, head k): j fastest.
  const int lj = lane % R, lp = (lane / R) % pl.g, lk = lane / (R * pl.g);
  const bool live = lk < st.nh;
  const int hc0 = lp * pl.cpl;                     // first feature of part
  const int ncol = live ? max(0, min(pl.cpl, d - hc0)) : 0;
  const int w = blockIdx.x;
  const int64_t win0 = static_cast<int64_t>(w) * BLK;
  const int sd = DROP ? seed[0] : 0;
  const bool rstats = BF16 && 3 * h > BLK;
  const bool vec = (d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(ft) |
                     reinterpret_cast<uintptr_t>(ct_g)) & 15) == 0;
  int* my_runs = runs_sh + warp * 33;

  // This window's chunks: [lower_bound(w), lower_bound(w + 1)).
  const int t0 = first_chunk(out_id, n_chunks, w);
  const int t1 = first_chunk(out_id, n_chunks, w + 1);

  int staged = -1;
  bool first = true;
  for (int tb = t0;;) {
    // A batch: up to nb consecutive chunks of one group (none when the
    // window has no chunk: every row is then written as zeros).
    const int grp = tb < t1 ? in_id[tb] : -1;
    int te = tb;
    if (tb < t1) {
      te = tb + 1;
      while (te < t1 && te - tb < pl.nb && in_id[te] == grp) ++te;
    }
    const int nbc = te - tb, ns = nbc * chunk;
    const bool restage = grp >= 0 && grp != staged;
    if (restage) {
      staged = grp;
      const int64_t grp0 = static_cast<int64_t>(grp) * BLK;
      const int units = pl.w / 4;
      if (vec) {
        for (int idx = tid; idx < BLK * units; idx += NT) {
          const int r = idx / units, c = (idx - r * units) * 4;
          const bool ok = c < st.nf;
          cp_async16(ct_sh + r * ws + c,
                     ok ? ct_g + (grp0 + r) * F + st.c0 + c : ct_g,
                     ok ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < BLK * pl.w; idx += NT) {
          const int r = idx / pl.w, c = idx - r * pl.w;
          const bool ok = c < st.nf;
          cp_async4(ct_sh + r * ws + c,
                    ok ? ct_g + (grp0 + r) * F + st.c0 + c : ct_g, ok ? 4 : 0);
        }
      }
      for (int idx = tid; idx < BLK * hs; idx += NT) {
        const int r = idx / hs, k = idx - r * hs;
        float er = 0.f, lse = 0.f, rho = 0.f;
        if (k < st.nh) {
          const int64_t o = (grp0 + r) * h + st.h0 + k;
          er = er_g[o];
          lse = lse_g[o];
          rho = rho_g[o];
          if (rstats) {
            lse = rnd<true>(lse);
            rho = rnd<true>(rho);
          }
        }
        st_sh[idx] = er;
        st_sh[BLK * hs + idx] = lse;
        st_sh[2 * BLK * hs + idx] = rho;
      }
    }
    for (int i = tid; i < nbc * BLK * hs; i += NT) gp_sh[i] = 0.f;
    for (int i = tid; i < NWARPS * BLK; i += NT) cnt_sh[i] = 0;

    // Stable counting sort of the batch's real slots by window row b:
    // warp w takes the slots [w ns / 8, (w+1) ns / 8) in order, counts
    // them per b, and later scatters them after the counts of the warps
    // before it, ranked within each 32-slot step by row_peers.
    const int64_t slot0 = static_cast<int64_t>(tb) * chunk;
    const int s_lo = static_cast<int>(static_cast<int64_t>(warp) * ns / NWARPS);
    const int s_hi =
        static_cast<int>(static_cast<int64_t>(warp + 1) * ns / NWARPS);
    // The warp's slots, loaded together: (b << 7 | a), or -1 for padding.
    int pk[SRC_SPL], ek[DROP ? SRC_SPL : 1];
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      const int i = s_lo + 32 * u + lane;
      pk[u] = -1;
      if (i < s_hi) {
        const int aa = a[slot0 + i], bb = b[slot0 + i];
        if (aa >= 0 && bb >= 0) pk[u] = bb << 7 | aa;
        if constexpr (DROP) ek[u] = eid[slot0 + i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      if (s_lo + 32 * u >= s_hi) break;
      const bool real = pk[u] >= 0;
      const int bb = pk[u] >> 7;
      const unsigned peers = row_peers(real, bb);
      if (real && lane == __ffs(peers) - 1)
        cnt_sh[warp * BLK + bb] += __popc(peers);
    }
    __syncthreads();
    int tot = 0, incl = 0;
    if (tid < BLK) {
      for (int v = 0; v < NWARPS; ++v) tot += cnt_sh[v * BLK + tid];
      incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum_sh[warp] = incl;
    }
    __syncthreads();
    if (tid < BLK) {
      int run = incl - tot;
      for (int v = 0; v < warp; ++v) run += wsum_sh[v];
      start_sh[tid] = run;
      for (int v = 0; v < NWARPS; ++v) {
        const int c = cnt_sh[v * BLK + tid];
        cnt_sh[v * BLK + tid] = run;
        run += c;
      }
      if (tid == BLK - 1) start_sh[BLK] = run;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      if (s_lo + 32 * u >= s_hi) break;
      const bool real = pk[u] >= 0;
      const int bb = pk[u] >> 7;
      const unsigned peers = row_peers(real, bb);
      if (real) {
        const int i = s_lo + 32 * u + lane;
        const int dst =
            cnt_sh[warp * BLK + bb] + __popc(peers & ((1u << lane) - 1u));
        key_sh[dst] = static_cast<uint16_t>(((i / chunk) << 7) |
                                            (pk[u] & (BLK - 1)));
        if constexpr (DROP) eid_sh[dst] = ek[u];
      }
      __syncwarp();
      if (real && lane == __ffs(peers) - 1)
        cnt_sh[warp * BLK + bb] += __popc(peers);
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();
    if (BF16 && restage) {
      for (int i = tid; i < BLK * ws; i += NT) ct_sh[i] = rnd<true>(ct_sh[i]);
      __syncthreads();
    }

    // Warp w's rows: those whose sorted slots start in its equal share.
    const int S = start_sh[BLK];
    const int want_lo = static_cast<int>(static_cast<int64_t>(warp) * S / NWARPS);
    const int want_hi =
        warp == NWARPS - 1
            ? S + 1
            : static_cast<int>(static_cast<int64_t>(warp + 1) * S / NWARPS);
    int rb = 0, re = 0;
    for (int v = BLK; v > 0; v >>= 1) {  // first r with start[r] >= want
      if (rb + v <= BLK && start_sh[rb + v - 1] < want_lo) rb += v;
      if (re + v <= BLK && start_sh[re + v - 1] < want_hi) re += v;
    }
    for (int r = rb; r < re; ++r) {
      const int s0 = start_sh[r], s1 = start_sh[r + 1];
      if (s0 == s1 && !first) continue;
      const int64_t row = win0 + r;
      float acc[SRC_COLS];
#pragma unroll
      for (int c = 0; c < SRC_COLS; ++c) acc[c] = 0.f;
      float gacc = 0.f;
      if (s0 < s1) {
        float fv[SRC_COLS];
        load_cols<BF16>(ft + row * F + st.c0 + lk * d + hc0, ncol, vec, fv);
        const float elv = live ? el[row * h + st.h0 + lk] : 0.f;
        for (int pos = s0; pos < s1;) {
          // The runs of equal (chunk, hub row) keys that start in
          // [pos, pos + 32) and end by s1 or inside that window.
          const int i = pos + lane;
          const int kk = i < s1 ? key_sh[i] : -1;
          const int prev = __shfl_up_sync(0xffffffffu, kk, 1);
          const unsigned starts =
              __ballot_sync(0xffffffffu, i < s1 && (lane == 0 || kk != prev));
          if (starts & (1u << lane))
            my_runs[__popc(starts & ((1u << lane) - 1u))] = lane;
          const int nr = __popc(starts);
          const bool tail_open = pos + 32 < s1;  // the last run may go on
          if (!tail_open && lane == 0) my_runs[nr] = s1 - pos;
          __syncwarp();
          const int take = min(R, tail_open ? nr - 1 : nr);
          int s = 0, n = 0, next;
          if (take == 0) {
            // One run of 32 slots or more from pos: find its end.
            const int k0 = __shfl_sync(0xffffffffu, kk, 0);
            int e = pos + 32;
            for (;;) {
              const int ii = e + lane;
              const unsigned m =
                  __ballot_sync(0xffffffffu, ii < s1 && key_sh[ii] == k0);
              const int c = m == 0xffffffffu ? 32 : __ffs(~m) - 1;
              e += c;
              if (c < 32) break;
            }
            next = e;
            if (lj == 0) {
              s = pos;
              n = e - pos;
            }
          } else {
            next = pos + my_runs[take];
            if (lj < take) {
              s = pos + my_runs[lj];
              n = my_runs[lj + 1] - my_runs[lj];
            }
          }
          __syncwarp();
          // This lane's run: the dot over its part, then over the parts.
          const int key = key_sh[n > 0 ? s : pos];
          const int aa = key & (BLK - 1);
          const float* crow = ct_sh + aa * ws + lk * d + hc0;
          // Four partial sums: the 32 terms are not one dependent chain.
          float pp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < SRC_COLS; c += 4) {
            if (c < ncol) {
              const float4 v = ct4(crow + c, vec, ncol - c);
              const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                pp[e] = BF16 ? pp[e] + rnd<true>(fv[c + e] * vv[e])
                             : fmaf(fv[c + e], vv[e], pp[e]);
            }
          }
          float p = (pp[0] + pp[1]) + (pp[2] + pp[3]);
          for (int o = R; o < R * pl.g; o <<= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          if (n > 0 && live) {
            const int hr = aa * hs + lk;
            const float sv = elv + st_sh[hr];
            const float acoef = expf(leaky(sv, slope) - st_sh[BLK * hs + hr]);
            const float rho = st_sh[2 * BLK * hs + hr];
            const float dl = sv >= 0.f ? 1.f : slope;
            int kept = n;
            if (DROP) {
              kept = 0;
              for (int j = 0; j < n; ++j)
                kept += drop_scale(eid_sh[s + j], st.h0 + lk, sd, thresh,
                                   inv_keep) != 0.f;
            }
            const float m1 = DROP ? inv_keep : 1.f;
            float qs = static_cast<float>(kept) *
                       rnd<BF16>(acoef * (p * m1 - rho) * dl);
            if (DROP && kept < n)
              qs += static_cast<float>(n - kept) *
                    rnd<BF16>(acoef * (0.f - rho) * dl);
            const float am = rnd<BF16>(acoef * m1);
            const float wk = static_cast<float>(kept);
            gacc += qs;
            if (lp == 0) atomicAdd(&gp_sh[((key >> 7) * BLK + aa) * hs + lk], qs);
#pragma unroll
            for (int c = 0; c < SRC_COLS; c += 4) {
              if (c < ncol) {
                const float4 v = ct4(crow + c, vec, ncol - c);
                acc[c] = fmaf(wk, rnd<BF16>(am * v.x), acc[c]);
                acc[c + 1] = fmaf(wk, rnd<BF16>(am * v.y), acc[c + 1]);
                acc[c + 2] = fmaf(wk, rnd<BF16>(am * v.z), acc[c + 2]);
                acc[c + 3] = fmaf(wk, rnd<BF16>(am * v.w), acc[c + 3]);
              }
            }
          }
          pos = next;
        }
      }
      // Reduce-scatter over the R run lanes of each (head, part): lane j
      // ends with the features [j * 32 / R, (j + 1) * 32 / R) of its part
      // in acc[0 ..], and gel's sum.
      halve<16>(acc, lj, R >> 1);
      halve<8>(acc, lj, R >> 2);
      halve<4>(acc, lj, R >> 3);
      halve<2>(acc, lj, R >> 4);
      halve<1>(acc, lj, R >> 5);
      for (int o = 1; o < R; o <<= 1)
        gacc += __shfl_xor_sync(0xffffffffu, gacc, o);
      // gft_b and gel_b: the first batch stores, later ones add.
      if (live) {
        const int per = SRC_COLS / R, c0 = lj * per;
        float* gr = gft + row * F + st.c0 + lk * d + hc0 + c0;
        const int nc = min(per, ncol - c0);
        if (vec && per >= 4 && nc == per) {
#pragma unroll
          for (int c = 0; c < SRC_COLS; c += 4) {
            if (c < per) {
              float4* p4 = reinterpret_cast<float4*>(gr + c);
              float4 v = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
              if (!first) {
                const float4 o = *p4;
                v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
              }
              *p4 = v;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < SRC_COLS; ++c)
            if (c < nc) gr[c] = first ? acc[c] : gr[c] + acc[c];
        }
        if (lj == 0 && lp == 0) {
          float* gp = gel + row * h + st.h0 + lk;
          *gp = first ? gacc : *gp + gacc;
        }
      }
    }
    __syncthreads();
    // The batch's chunk partials: every (row, head) of the stripe, once.
    for (int idx = tid; idx < nbc * BLK * st.nh; idx += NT) {
      const int rr = idx / st.nh, k = idx - rr * st.nh;
      gerp[(static_cast<int64_t>(tb) * BLK + rr) * h + st.h0 + k] =
          gp_sh[rr * hs + k];
    }
    first = false;
    tb = te;
    if (tb >= t1) break;
    __syncthreads();  // gp_sh, the sort arrays and the stage are reused
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
// ~67 us at 3.35 TB/s. This design waits on the row gathers (ft and ct
// rows from L1/L2), not on HBM.
//
// BF16: as attn_bwd_src_kernel (ft, ct, their products, q; lse and rho
// when 3H > 128).
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
// mode. Chunks of more than 4,096 slots (1,024 when d > 128) are refused.
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
    SrcPlan pl = src_plan(h, d, chunk, seed != nullptr);
    if (n_chunks > 0 && (chunk < 1 || pl.nb < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if (pl.nb < 1) pl.nb = 1;
    const size_t smem = src_smem(pl, seed != nullptr);
    dim3 grid(n_win, (h + pl.hs - 1) / pl.hs);
    auto kern = PICK(attn_bwd_src_kernel, seed != nullptr, bf16);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, NT, smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, el, er_g, lse_g, rho_g, ft,
        ct_g, h, d, pl, slope, seed, seed != nullptr ? thresh : 0,
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
