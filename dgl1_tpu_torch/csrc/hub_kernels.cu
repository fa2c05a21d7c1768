// Hub-engine g-SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes by dgl1_tpu_torch/ops/hub_kernels.py, whose
// wrappers check devices, types and shapes, allocate every output and
// count launches. Each entry point launches on the given stream and
// returns cudaGetLastError(); the wrapper raises when it is not 0.
//
// The kernels replace the Pallas kernels of dgl1_tpu/ops/engine_hub.py:
//
//   K1  hub_dense_fwd      <- _dense_fwd_kernel       (engine_hub.py:170)
//   K2  hub_chunk_sum      <- _chunk_kernel, plain    (engine_hub.py:68)
//   K3  hub_expand         <- _expand_kernel          (engine_hub.py:303)
//   K4a hub_dense_bwd (fused tail)
//                          <- _dense_bwd_fused_kernel (engine_hub.py:215)
//   K4b hub_dense_bwd (no tail)
//                          <- _dense_bwd_kernel       (engine_hub.py:270)
//   K2  hub_chunk_weighted <- _chunk_kernel, mul/rhs  (engine_hub.py:68)
//   K5  hub_edge_grad      <- _edge_grad_kernel       (engine_hub.py:364)
//
// The TPU kernels gather and scatter through one-hot matmuls because the
// TPU has no atomics and a slow gather unit. Here gathers are direct row
// loads and scatters are float atomics. Arithmetic is float32 with float32
// accumulation (the counts in C are small exact integers). Every kernel but
// K3 has a BF16 instantiation, the reference's bf16 matmul mode
// (dgl1_tpu/ops/precision.py): it rounds to bfloat16 (nearest even, in
// registers, rnd() below) exactly the values the reference casts to dt
// before a matmul, and nothing else; inputs, outputs and sums stay float32.
//
// Feature widths are not padded to 128: every kernel takes the row width
// f and masks the ragged edge itself, and the source operand may have
// fewer rows than the padded count matrix (missing rows read as zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;               // hub group rows / window rows
constexpr int DENSE_RB = 1024;         // rows per fused-backward descriptor block
constexpr int EXPAND_RB = 512;         // rows per expand descriptor block
constexpr int EXPAND_PACK = 1 << 20;   // descriptor p = local_row * PACK + row

// Dense-tier GEMM tiling: a 256-thread block owns a BM x BN output tile;
// thread (ty, tx) of a 16 x 16 grid holds rows ty + 16 i and columns
// tx + 16 j (i, j < 8), so shared-memory reads are broadcasts or
// consecutive and global stores of a half-warp are consecutive.
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int NT = 256;

// bf16 mode: round to bfloat16, nearest even, and back.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j]
__device__ __forceinline__ void tile_fma(const float (&As)[BK][BM + 1],
                                         const float (&Bs)[BK][BN],
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------
// K1: out (kd, f) = C^T @ U over the first n_rows rows.
//
// Replaces _dense_fwd_kernel, which accumulates over the row-block grid
// axis in order. GPU blocks run in no order, so this is split-K: block z
// reduces rows [z * rows_per_split, ...) into a register tile and adds it
// to the zero-initialised output with float atomics. The order of those
// adds varies from run to run, so results agree with a sequential sum to
// float32 rounding of the partial sums, not bit for bit.
//
// BF16 rounds C (counts above 256 lose bits, as in the reference) and U as
// they are staged.
//
// Bound on the H100: at arxiv scale (Kd = 128, f = 128) it reads 22 MB of
// int8 C and 87 MB of U (33 us at 3.35 TB/s) and does 5.6 GFLOP (84 us
// on the 67 TFLOP/s of float32 CUDA cores), so exact float32 over the
// dense C is bound by arithmetic. (The data needs only C's nonzeros, ~5%
// at arxiv scale; skipping zero tiles is later work.) The split-K grid
// puts about two blocks on every SM; with only one output tile a row
// loop in one block would leave the card idle.
// ---------------------------------------------------------------------
template <typename CT, bool BF16>
__global__ void __launch_bounds__(NT)
    dense_fwd_kernel(const CT* __restrict__ c, const float* __restrict__ u,
                     float* __restrict__ out, int n_rows, int kd, int f,
                     int rows_per_split) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = r_begin; k0 < r_end; k0 += BK) {
    for (int i = tid; i < BK * BM; i += NT) {
      const int kk = i / BM, mm = i % BM;
      const int r = k0 + kk, m = m0 + mm;
      As[kk][mm] = (r < r_end && m < kd)
                       ? rnd<BF16>(to_f32(c[static_cast<size_t>(r) * kd + m]))
                       : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int r = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (r < r_end && n < f)
                       ? rnd<BF16>(u[static_cast<size_t>(r) * f + n])
                       : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= kd) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < f) atomicAdd(&out[static_cast<size_t>(m) * f + n], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------
// K4a / K4b: out (n_out, f) = C[:n_out] @ ct, and with FUSED, plus the
// compact tail-src stack row tail[t] on every row r that a descriptor
// p = (r % DENSE_RB) * EXPAND_PACK + t names.
//
// Replaces _dense_bwd_fused_kernel and _dense_bwd_kernel. The product is
// a tall matrix times a small one (Kd = 128 at arxiv scale) and every
// output tile is independent, so there is no reduction across blocks.
// The fused form reads the block's descriptors into shared memory first
// (tail_row[local row] = stack row) and adds the tail rows in registers
// before the single store. The reference applies descriptors one after
// another; here each row takes at most one, which holds because the
// layout emits one descriptor per source row (hub_format.py: gvalid is
// a set of distinct rows; tests/test_torch_layout.py checks it).
//
// BF16 rounds C and ct as they are staged (not the tail rows).
//
// Bound on the H100: the same count matrix and flops as K1, with an
// output of n_out x f floats written once instead of U read once.
// ---------------------------------------------------------------------
template <typename CT, bool FUSED, bool BF16>
__global__ void __launch_bounds__(NT)
    dense_bwd_kernel(const CT* __restrict__ c, const float* __restrict__ ct,
                     float* __restrict__ out, int n_out, int kd, int f,
                     const int* __restrict__ starts,
                     const int* __restrict__ desc,
                     const float* __restrict__ tail) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ int tail_row[BM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (FUSED) {
    for (int i = tid; i < BM; i += NT) tail_row[i] = -1;
    __syncthreads();
    const int rb = m0 / DENSE_RB;
    const int s = starts[rb], e = starts[rb + 1];
    for (int i = s + tid; i < e; i += NT) {
      const int p = desc[i];
      const int lr = rb * DENSE_RB + p / EXPAND_PACK - m0;
      if (lr >= 0 && lr < BM) tail_row[lr] = p % EXPAND_PACK;
    }
    __syncthreads();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kd; k0 += BK) {
    for (int i = tid; i < BK * BM; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < n_out && k < kd)
                       ? rnd<BF16>(to_f32(c[static_cast<size_t>(m) * kd + k]))
                       : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < kd && n < f)
                       ? rnd<BF16>(ct[static_cast<size_t>(k) * f + n])
                       : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= n_out) continue;
    const int t = FUSED ? tail_row[ty + 16 * i] : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= f) continue;
      float v = acc[i][j];
      if (t >= 0) v += tail[static_cast<size_t>(t) * f + n];
      out[static_cast<size_t>(m) * f + n] = v;
    }
  }
}

// ---------------------------------------------------------------------
// K2 (plain mode): for chunk t and slot s with a[s] >= 0 and b[s] >= 0,
//   out[out_id[t] * 128 + b[s]] += in[in_id[t] * 128 + a[s]].
//
// Replaces _chunk_kernel in plain mode, which builds the one-hots S_a and
// S_b of a chunk and computes S_b^T @ (S_a @ in_window) on the MXU. Here
// the one-hot product is a row gather and the transposed one a float
// atomic add: one block per chunk, one warp per slot, lanes over the
// feature row. The reference's first-chunk flag overwrites an output
// block; the output here is zero-initialised by the wrapper and every
// chunk adds, which gives the same values on every block that a chunk
// covers. Blocks no chunk covers are zero here and unspecified there.
//
// BF16 rounds the gathered row.
//
// Bound on the H100: memory for the work itself (each real slot reads
// one f-float row and adds one), but this design is held by its atomics,
// which resolve in L2 and serialise where thousands of slots share an
// output row, as they do on a chunked tier with few output blocks.
// ---------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(NT)
    chunk_sum_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     const int* __restrict__ in_id,
                     const int* __restrict__ out_id,
                     const float* __restrict__ in, int n_in_rows,
                     float* __restrict__ out, int n_out_rows, int f,
                     int chunk) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = NT / 32;
  const int64_t base_in = static_cast<int64_t>(in_id[t]) * BLK;
  const int64_t base_out = static_cast<int64_t>(out_id[t]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(t) * chunk;
  for (int s = warp; s < chunk; s += n_warps) {
    const int as = a[slot0 + s], bs = b[slot0 + s];
    if (as < 0 || bs < 0) continue;
    const int64_t ri = base_in + as, ro = base_out + bs;
    if (ri >= n_in_rows || ro >= n_out_rows) continue;
    const float* src = in + ri * f;
    float* dst = out + ro * f;
    for (int j = lane; j < f; j += 32) atomicAdd(dst + j, rnd<BF16>(src[j]));
  }
}

// ---------------------------------------------------------------------
// K3: out[v] = merged[t_inv[v]], zero rows elsewhere, from descriptors
// p = (v % EXPAND_RB) * EXPAND_PACK + merged_row with per-block
// [starts[rb], starts[rb + 1]).
//
// Replaces _expand_kernel, which zero-fills an output block and then
// copies its rows one descriptor at a time out of VMEM. Here a block
// first maps each of its EXPAND_RB rows to a source row in shared memory
// (descriptors name each row at most once), then writes every output row
// exactly once: a copy or zeros. No atomics.
//
// Bound on the H100: memory, one write of num_dst x f floats plus one
// read of the rows that exist.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
    expand_kernel(const int* __restrict__ starts,
                  const int* __restrict__ desc,
                  const float* __restrict__ merged, int m_rows,
                  float* __restrict__ out, int num_dst, int f) {
  __shared__ int src_row[EXPAND_RB];
  const int rb = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = NT / 32;
  for (int i = threadIdx.x; i < EXPAND_RB; i += NT) src_row[i] = -1;
  __syncthreads();
  const int s = starts[rb], e = starts[rb + 1];
  for (int i = s + threadIdx.x; i < e; i += NT) {
    const int p = desc[i];
    const int r = p / EXPAND_PACK;
    src_row[r] = p - r * EXPAND_PACK;
  }
  __syncthreads();
  const int row0 = rb * EXPAND_RB;
  const int n_rows = min(EXPAND_RB, num_dst - row0);
  for (int r = warp; r < n_rows; r += n_warps) {
    const int m = src_row[r];
    float* dst = out + static_cast<size_t>(row0 + r) * f;
    if (m >= 0 && m < m_rows) {
      const float* src = merged + static_cast<size_t>(m) * f;
      for (int j = lane; j < f; j += 32) dst[j] = src[j];
    } else {
      for (int j = lane; j < f; j += 32) dst[j] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------
// K2 (mul and rhs modes): for chunk t and real slot s (a[s] >= 0,
// b[s] >= 0, 0 <= eid[s] < n_e),
//   out[out_id[t] * 128 + b[s], j] += msg[j]
// with msg[j] = in[in_id[t] * 128 + a[s], j] * e2[eid[s], j / rep] (mul,
// j < f = he * rep) or e2[eid[s], j] (rhs, j < f = he).
//
// Replaces _chunk_kernel in mul and rhs modes, whose message is the
// one-hot gather S_a IN times W^T R: the chunk's gathered weights,
// spread over their features by a 0/1 matmul. Here each slot reads its
// weight from e2 through eid, so no per-slot weight tensor exists. On
// the graphs these modes serve, every hub edge (dense groups included)
// goes through the full_fwd layout, so millions of slots add into the
// same 128 output rows: one global atomic per slot and feature, as
// chunk_sum_kernel does, would serialise on 128 x f addresses. Instead a
// block owns a run of consecutive chunks and a stripe of WSTRIPE
// features, keeps the 128 x WSTRIPE partial of its current output block
// in shared memory (shared-memory atomics), and flushes it with one
// global atomic add per nonzero element when the output block changes or
// the run ends. Chunks are sorted by output block, so a run sees few
// changes. A warp owns a contiguous eighth of each chunk and takes 32
// slots at a time: each lane reads one slot's a, b and eid, a ballot
// keeps the real ones, and the warp walks those WUNROLL at a time, lanes
// over the stripe's columns, loading all the rows before adding any. The
// slots of a (group, window) run come in destination order, so runs of
// slots share b: the warp sums a run in registers and adds it to shared
// memory once, when b changes and at the end of the chunk. Padding
// slots' rows and weights are never read.
//
// BF16 rounds the message before its sum and, in mul mode, the input
// value before the product (the weight is not rounded).
//
// Bound on the H100: bytes. Each real slot needs its message row (rhs:
// he floats of e2; mul: f floats of in, which the 128-row window keeps
// in L2, and its weights) and the layout, each read once; the output is
// written once. The flush costs 128 x WSTRIPE atomics per run and
// output block.
// ---------------------------------------------------------------------
constexpr int WSTRIPE = 64;   // feature columns per block of weighted K2
constexpr int WUNROLL = 4;    // slots whose rows a warp loads together
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void flush_partial(float (&acc)[BLK][WSTRIPE],
                                              int blk, int f0, int width,
                                              float* __restrict__ out,
                                              int n_out_rows, int f) {
  for (int i = threadIdx.x; i < BLK * WSTRIPE; i += NT) {
    const int r = i / WSTRIPE, c = i % WSTRIPE;
    const float v = acc[r][c];
    if (v != 0.f) {
      const int64_t row = static_cast<int64_t>(blk) * BLK + r;
      if (c < width && row < n_out_rows) atomicAdd(out + row * f + f0 + c, v);
      acc[r][c] = 0.f;
    }
  }
}

template <bool MUL, bool BF16>
__global__ void __launch_bounds__(NT)
    chunk_weighted_kernel(const int* __restrict__ a,
                          const int* __restrict__ b,
                          const int* __restrict__ eid,
                          const int* __restrict__ in_id,
                          const int* __restrict__ out_id, int n_chunks,
                          int chunk, int run, const float* __restrict__ e2,
                          int n_e, int he, int rep,
                          const float* __restrict__ in, int n_in_rows,
                          float* __restrict__ out, int n_out_rows, int f) {
  __shared__ float acc[BLK][WSTRIPE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_begin = blockIdx.x * run;
  const int c_end = min(n_chunks, c_begin + run);
  const int f0 = blockIdx.y * WSTRIPE;
  const int width = min(WSTRIPE, f - f0);
  // The lane's two columns and, in mul mode, their heads.
  const bool has0 = lane < width, has1 = lane + 32 < width;
  const int head0 = (f0 + lane) / rep, head1 = (f0 + lane + 32) / rep;
  const int per_warp = (chunk + NT / 32 - 1) / (NT / 32);
  const int w_begin = warp * per_warp;
  const int w_end = min(chunk, w_begin + per_warp);
  for (int i = threadIdx.x; i < BLK * WSTRIPE; i += NT)
    acc[i / WSTRIPE][i % WSTRIPE] = 0.f;
  __syncthreads();
  int cur = out_id[c_begin];
  for (int t = c_begin; t < c_end; ++t) {
    const int o = out_id[t];
    if (o != cur) {  // the same for every thread of the block
      __syncthreads();
      flush_partial(acc, cur, f0, width, out, n_out_rows, f);
      __syncthreads();
      cur = o;
    }
    const int64_t base_in = static_cast<int64_t>(in_id[t]) * BLK;
    const int64_t slot0 = static_cast<int64_t>(t) * chunk;
    int run_b = -1;  // the warp's running output row and its partial sums
    float run0 = 0.f, run1 = 0.f;
    for (int s0 = w_begin; s0 < w_end; s0 += 32) {
      const int s = s0 + lane;
      int as = -1, bs = -1, es = 0;
      if (s < w_end) {
        as = a[slot0 + s];
        bs = b[slot0 + s];
        es = eid[slot0 + s];
      }
      bool ok = as >= 0 && bs >= 0 && es >= 0 && es < n_e;
      if (MUL) ok = ok && base_in + as < n_in_rows;
      float w1 = 0.f;  // mul with one head: the slot's weight
      if (MUL && he == 1 && ok) w1 = e2[es];
      unsigned todo = __ballot_sync(FULL, ok);
      while (todo) {  // todo is the same in every lane
        int ks[WUNROLL];
        int n = 0;
#pragma unroll
        for (int i = 0; i < WUNROLL; ++i) {
          ks[i] = todo ? __ffs(todo) - 1 : 0;
          if (todo) {
            todo &= todo - 1;
            ++n;
          }
        }
        float v[WUNROLL][2];
        int rows[WUNROLL];
#pragma unroll
        for (int i = 0; i < WUNROLL; ++i) {
          const int ak = __shfl_sync(FULL, as, ks[i]);
          const int bk = __shfl_sync(FULL, bs, ks[i]);
          const int ek = __shfl_sync(FULL, es, ks[i]);
          const float wk = __shfl_sync(FULL, w1, ks[i]);
          rows[i] = bk;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = f0 + lane + 32 * j;
            float x = 0.f;
            if (i < n && (j == 0 ? has0 : has1)) {
              if (MUL) {
                const float wt =
                    he == 1 ? wk
                            : e2[static_cast<int64_t>(ek) * he +
                                 (j == 0 ? head0 : head1)];
                x = rnd<BF16>(rnd<BF16>(in[(base_in + ak) * f + col]) * wt);
              } else {
                x = rnd<BF16>(e2[static_cast<int64_t>(ek) * he + col]);
              }
            }
            v[i][j] = x;
          }
        }
#pragma unroll
        for (int i = 0; i < WUNROLL; ++i) {
          if (i >= n) break;
          if (rows[i] != run_b) {  // the same in every lane
            if (run_b >= 0) {
              if (has0) atomicAdd(&acc[run_b][lane], run0);
              if (has1) atomicAdd(&acc[run_b][lane + 32], run1);
            }
            run_b = rows[i];
            run0 = run1 = 0.f;
          }
          run0 += v[i][0];
          run1 += v[i][1];
        }
      }
    }
    if (run_b >= 0) {
      if (has0) atomicAdd(&acc[run_b][lane], run0);
      if (has1) atomicAdd(&acc[run_b][lane + 32], run1);
    }
  }
  __syncthreads();
  flush_partial(acc, cur, f0, width, out, n_out_rows, f);
}

// ---------------------------------------------------------------------
// K5: per slot s of chunk t and head h, into out (n_slots, he),
//   mul: sum over j in [h * rep, (h + 1) * rep) of
//        u[in_id[t] * 128 + a[s], j] * ct[out_id[t] * 128 + b[s], j]
//   rhs: ct[out_id[t] * 128 + b[s], h]
// and zero on padding slots (a or b < 0).
//
// Replaces _edge_grad_kernel, which gathers both rows by one-hot matmuls
// and reduces each head's span by a matmul with R into the transposed
// (H_pad, n_slots) layout so the TPU's lanes stay 1024 wide. Here the
// output is (n_slots, he), the transpose of the reference's first he
// rows. mul: one block per chunk stages the chunk's 128-row source
// window of u and its group's 128 cotangent rows, GSTRIPE columns at a
// time, in shared memory (rows padded by one float against bank
// conflicts); a thread owns slots tid, tid + NT, ... and adds each head's
// partial dot over the stripe into its own output elements (zeroed by
// the wrapper; no other thread writes them, so no atomics). rhs: a copy
// of the cotangent rows, a thread per output element, every element of
// the output written (padding slots as zero), coalesced.
//
// BF16 rounds the staged u and ct values and, in mul mode, each product
// before the head sum.
//
// Bound on the H100: bytes. mul reads the layout, the source and
// cotangent rows once and writes n_slots x he floats; rhs reads the
// layout and the (small) cotangent block and writes n_slots x he floats.
// ---------------------------------------------------------------------
constexpr int GSTRIPE = 32;        // feature columns staged per pass
constexpr int MAX_SLOTS_PER_THREAD = 4;

template <bool BF16>
__global__ void __launch_bounds__(NT)
    edge_grad_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                         const int* __restrict__ in_id,
                         const int* __restrict__ out_id, int chunk,
                         const float* __restrict__ u, int n_u,
                         const float* __restrict__ ct, int n_ct,
                         float* __restrict__ out, int he, int rep) {
  __shared__ float us[BLK][GSTRIPE + 1];
  __shared__ float cs[BLK][GSTRIPE + 1];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int f = he * rep;
  const int64_t base_u = static_cast<int64_t>(in_id[t]) * BLK;
  const int64_t base_c = static_cast<int64_t>(out_id[t]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(t) * chunk;
  int sa[MAX_SLOTS_PER_THREAD], sb[MAX_SLOTS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_SLOTS_PER_THREAD; ++k) {
    const int s = tid + k * NT;
    sa[k] = sb[k] = -1;
    if (s < chunk) {
      const int as = a[slot0 + s], bs = b[slot0 + s];
      if (as >= 0 && bs >= 0 && base_u + as < n_u && base_c + bs < n_ct) {
        sa[k] = as;
        sb[k] = bs;
      }
    }
  }
  for (int f0 = 0; f0 < f; f0 += GSTRIPE) {
    const int w = min(GSTRIPE, f - f0);
    __syncthreads();  // the previous stripe's reads are done
    for (int i = tid; i < BLK * GSTRIPE; i += NT) {
      const int r = i / GSTRIPE, c = i % GSTRIPE;
      us[r][c] = (c < w && base_u + r < n_u)
                     ? rnd<BF16>(u[(base_u + r) * f + f0 + c])
                     : 0.f;
      cs[r][c] = (c < w && base_c + r < n_ct)
                     ? rnd<BF16>(ct[(base_c + r) * f + f0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_SLOTS_PER_THREAD; ++k) {
      if (sa[k] < 0) continue;
      const float* ur = us[sa[k]];
      const float* cr = cs[sb[k]];
      float* o = out + (slot0 + tid + k * NT) * he;
      int h = f0 / rep;
      int next = (h + 1) * rep - f0;  // first column of head h + 1
      float p = 0.f;
      for (int c = 0; c < w; ++c) {
        if (c == next) {
          o[h] += p;
          p = 0.f;
          ++h;
          next += rep;
        }
        p = BF16 ? p + rnd<true>(ur[c] * cr[c]) : fmaf(ur[c], cr[c], p);
      }
      o[h] += p;
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
    edge_grad_rhs_kernel(const int* __restrict__ a, const int* __restrict__ b,
                         const int* __restrict__ out_id, int chunk,
                         const float* __restrict__ ct, int n_ct,
                         float* __restrict__ out, int he) {
  const int t = blockIdx.x;
  const int64_t base_c = static_cast<int64_t>(out_id[t]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(t) * chunk;
  const int n = chunk * he;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int s = i / he, h = i - s * he;
    const int as = a[slot0 + s], bs = b[slot0 + s];
    float v = 0.f;
    if (as >= 0 && bs >= 0 && base_c + bs < n_ct)
      v = rnd<BF16>(ct[(base_c + bs) * he + h]);
    out[slot0 * he + i] = v;
  }
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

template <typename CT, bool BF16>
void launch_dense_fwd(const void* c, const float* u, float* out, int n_rows,
                      int kd, int f, cudaStream_t stream) {
  const int tiles_m = (kd + BM - 1) / BM, tiles_n = (f + BN - 1) / BN;
  // About two blocks per SM in all; each split a multiple of BK rows.
  int splits = (2 * num_sms() + tiles_m * tiles_n - 1) / (tiles_m * tiles_n);
  const int max_splits = (n_rows + BK - 1) / BK;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int rows_per_split = (n_rows + splits - 1) / splits;
  rows_per_split = ((rows_per_split + BK - 1) / BK) * BK;
  if (rows_per_split < BK) rows_per_split = BK;
  splits = (n_rows + rows_per_split - 1) / rows_per_split;
  if (splits < 1) return;
  dim3 grid(tiles_m, tiles_n, splits);
  dense_fwd_kernel<CT, BF16><<<grid, NT, 0, stream>>>(
      static_cast<const CT*>(c), u, out, n_rows, kd, f, rows_per_split);
}

template <typename CT, bool BF16>
void launch_dense_bwd(const void* c, const float* ct, float* out, int n_out,
                      int kd, int f, const int* starts, const int* desc,
                      const float* tail, cudaStream_t stream) {
  dim3 grid((n_out + BM - 1) / BM, (f + BN - 1) / BN);
  if (grid.x == 0 || grid.y == 0) return;
  if (starts != nullptr) {
    dense_bwd_kernel<CT, true, BF16><<<grid, NT, 0, stream>>>(
        static_cast<const CT*>(c), ct, out, n_out, kd, f, starts, desc, tail);
  } else {
    dense_bwd_kernel<CT, false, BF16><<<grid, NT, 0, stream>>>(
        static_cast<const CT*>(c), ct, out, n_out, kd, f, nullptr, nullptr,
        nullptr);
  }
}

template <bool BF16>
int dense_fwd_by_type(const void* c, int c_dtype, const float* u, float* out,
                      int n_rows, int kd, int f, cudaStream_t s) {
  switch (c_dtype) {
    case 0: launch_dense_fwd<int8_t, BF16>(c, u, out, n_rows, kd, f, s); break;
    case 1:
      launch_dense_fwd<__nv_bfloat16, BF16>(c, u, out, n_rows, kd, f, s);
      break;
    case 2: launch_dense_fwd<float, BF16>(c, u, out, n_rows, kd, f, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dense_bwd_by_type(const void* c, int c_dtype, const float* ct, float* out,
                      int n_out, int kd, int f, const int* starts,
                      const int* desc, const float* tail, cudaStream_t s) {
  switch (c_dtype) {
    case 0:
      launch_dense_bwd<int8_t, BF16>(c, ct, out, n_out, kd, f, starts, desc,
                                     tail, s);
      break;
    case 1:
      launch_dense_bwd<__nv_bfloat16, BF16>(c, ct, out, n_out, kd, f, starts,
                                            desc, tail, s);
      break;
    case 2:
      launch_dense_bwd<float, BF16>(c, ct, out, n_out, kd, f, starts, desc,
                                    tail, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c_dtype: 0 = int8, 1 = bfloat16, 2 = float32. `out` must be zeroed.
// bf16: 1 for the bf16 mode.
int hub_dense_fwd(const void* c, int c_dtype, const float* u, float* out,
                  int n_rows, int kd, int f, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dense_fwd_by_type<true>(c, c_dtype, u, out, n_rows, kd, f, s)
              : dense_fwd_by_type<false>(c, c_dtype, u, out, n_rows, kd, f, s);
}

// starts/desc/tail all null: K4b; all set: K4a.
int hub_dense_bwd(const void* c, int c_dtype, const float* ct, float* out,
                  int n_out, int kd, int f, const int* starts,
                  const int* desc, const float* tail, int bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dense_bwd_by_type<true>(c, c_dtype, ct, out, n_out, kd, f,
                                        starts, desc, tail, s)
              : dense_bwd_by_type<false>(c, c_dtype, ct, out, n_out, kd, f,
                                         starts, desc, tail, s);
}

// `out` must be zeroed.
int hub_chunk_sum(const int* a, const int* b, const int* in_id,
                  const int* out_id, int n_chunks, int chunk, const float* in,
                  int n_in_rows, float* out, int n_out_rows, int f, int bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0 && bf16) {
    chunk_sum_kernel<true><<<n_chunks, NT, 0, s>>>(
        a, b, in_id, out_id, in, n_in_rows, out, n_out_rows, f, chunk);
  } else if (n_chunks > 0) {
    chunk_sum_kernel<false><<<n_chunks, NT, 0, s>>>(
        a, b, in_id, out_id, in, n_in_rows, out, n_out_rows, f, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int hub_expand(const int* starts, const int* desc, const float* merged,
               int m_rows, float* out, int num_dst, int f, void* stream) {
  const int n_rb = (num_dst + EXPAND_RB - 1) / EXPAND_RB;
  if (n_rb > 0) {
    expand_kernel<<<n_rb, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        starts, desc, merged, m_rows, out, num_dst, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 = mul (in has n_in_rows x f, f = he * rep), 1 = rhs (in is
// null, f = he). `out` (n_out_rows x f) must be zeroed. bf16: 1 for the
// bf16 mode (as in every entry below but hub_expand).
int hub_chunk_weighted(int mode, const int* a, const int* b, const int* eid,
                       const int* in_id, const int* out_id, int n_chunks,
                       int chunk, const float* e2, int n_e, int he, int rep,
                       const float* in, int n_in_rows, float* out,
                       int n_out_rows, int f, int bf16, void* stream) {
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks > 0 && f > 0) {
    const int stripes = (f + WSTRIPE - 1) / WSTRIPE;
    // About eight blocks per SM in all, each a run of whole chunks.
    const int64_t target = 8LL * num_sms();
    int run = static_cast<int>((static_cast<int64_t>(n_chunks) * stripes +
                                target - 1) / target);
    if (run < 1) run = 1;
    dim3 grid((n_chunks + run - 1) / run, stripes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == 0) {
      auto kern = bf16 ? chunk_weighted_kernel<true, true>
                       : chunk_weighted_kernel<true, false>;
      kern<<<grid, NT, 0, s>>>(
          a, b, eid, in_id, out_id, n_chunks, chunk, run, e2, n_e, he, rep,
          in, n_in_rows, out, n_out_rows, f);
    } else {
      auto kern = bf16 ? chunk_weighted_kernel<false, true>
                       : chunk_weighted_kernel<false, false>;
      kern<<<grid, NT, 0, s>>>(
          a, b, eid, in_id, out_id, n_chunks, chunk, run, e2, n_e, he, 1,
          nullptr, 0, out, n_out_rows, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 = mul (u n_u x he * rep, ct n_ct x he * rep; `out` must be
// zeroed), 1 = rhs (u null, ct n_ct x he; every element of `out` is
// written). `out` is (n_chunks * chunk) x he.
int hub_edge_grad(int mode, const int* a, const int* b, const int* in_id,
                  const int* out_id, int n_chunks, int chunk, const float* u,
                  int n_u, const float* ct, int n_ct, float* out, int he,
                  int rep, int bf16, void* stream) {
  if (chunk > NT * MAX_SLOTS_PER_THREAD || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks > 0 && he > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == 0) {
      auto kern =
          bf16 ? edge_grad_mul_kernel<true> : edge_grad_mul_kernel<false>;
      kern<<<n_chunks, NT, 0, s>>>(
          a, b, in_id, out_id, chunk, u, n_u, ct, n_ct, out, he, rep);
    } else {
      auto kern =
          bf16 ? edge_grad_rhs_kernel<true> : edge_grad_rhs_kernel<false>;
      kern<<<n_chunks, NT, 0, s>>>(
          a, b, out_id, chunk, ct, n_ct, out, he);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
