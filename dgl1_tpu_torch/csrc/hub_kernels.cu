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
// TPU has no atomics and a slow gather unit, and multiply the dense-tier
// count matrix C as dense 128 x 128 MXU tiles. On this card C (95% zeros
// at arxiv scale) is walked instead: K1 column by column, K4 row by row,
// each over its nonzero counts only. The chunked tier's K2 (plain and mul)
// stages a chunk's slots sorted by destination and its input window in
// shared memory, sums each destination's slots in registers and keeps the
// 128-row partial of its output block in registers (plain) or shared
// memory (mul). Scatters into the output are float atomics only where
// blocks share output rows (K1, K2). Arithmetic is float32 with
// float32 accumulation (the counts in C are small exact integers).
// Every kernel but K3 has a BF16 instantiation, the reference's bf16 mode
// (dgl1_tpu/ops/precision.py): it rounds to bfloat16 (nearest even, in
// registers, rnd() below) exactly the values the reference casts to dt
// before a matmul, and nothing else; inputs, outputs and sums stay float32.
//
// Feature widths are not padded to 128: every kernel takes the row width
// f and masks the ragged edge itself (K1 and K2 copy rows 16 bytes at a
// time, so their wrappers pad an input whose rows are not a multiple of 4
// floats on a 16-byte boundary), and the source operand may have fewer
// rows than the padded count matrix (missing rows read as zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BLK = 128;               // hub group rows / window rows
constexpr int DENSE_RB = 1024;         // rows per fused-backward descriptor block
constexpr int EXPAND_RB = 512;         // rows per expand descriptor block
constexpr int EXPAND_PACK = 1 << 20;   // descriptor p = local_row * PACK + row

constexpr int NT = 256;               // threads of a K3 / K2 rhs / K5 block
constexpr unsigned FULL = 0xffffffffu;

// bf16 mode: round to bfloat16, nearest even, and back.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// cp.async: copy 4 or 16 bytes from global to shared memory without
// passing through registers; commit_group closes a batch and wait_all
// waits for every batch this thread committed.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Waits until at most the newest batch this thread committed is pending.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// K4a / K4b: out (n_out, f) = C[:n_out] @ ct, and with FUSED, plus the
// compact tail-src stack row tail[t] on every row r that a descriptor
// p = (r % DENSE_RB) * EXPAND_PACK + t names.
//
// Replaces _dense_bwd_fused_kernel (engine_hub.py:215) and
// _dense_bwd_kernel (:270), which run the product as dense 128 x 128 MXU
// tiles. On this card a dense tile GEMM is the wrong shape for it: at
// arxiv scale C is (169,984 x 128) int8 with 4.6% nonzeros (about six a
// row) and f is 40, so a register-tiled GEMM spends 70x the operations
// the nonzeros need, most of them on zero counts and padded columns.
//
// Design: a row-sparse walk. A 256-thread block owns rows_per_block rows
// (a DENSE_RB descriptor block or a power-of-two part of one, chosen by
// the launcher to fill the SMs) and a stripe of SW = 32 * NC columns. It
// copies the stripe of ct (kd x SW floats) into shared memory once with
// cp.async, and meanwhile maps its descriptors to tail_row[local row]
// (the layout emits at most one descriptor per source row: gvalid is a
// set of distinct rows, tests/test_torch_layout.py checks it). A warp
// then takes its rows RW_ROWS at a time, with the next group's counts
// and this group's tail values in flight while it walks: lane l loads
// counts 4l .. 4l + 3 of each 128-column segment of a row (4, 8 or 16
// bytes for int8, bf16 or float C). A ballot for each of a lane's four
// counts finds the lanes where it is nonzero; the warp walks them,
// broadcasts each count with __shfl_sync, and every lane adds count *
// ct_s[k][col] for its NC columns (col = lane + 32 j: conflict-free
// shared reads, coalesced stores), a few instructions a nonzero. The
// tail row is added in registers and the row is stored once. No atomics
// and a fixed order of summation, so results are the same on every run.
// Rows without a nonzero count store zeros (or their tail row).
//
// BF16 rounds ct as it is staged and C as it is read (not the tail rows).
//
// Bound on the H100: bytes. At arxiv layer 2 C (21.8 MB), the output
// (27.1 MB) and the tail rows read once: about 49 MB, 15 us at 3.35
// TB/s; the nonzeros need 80 MFLOP. The walk runs at about 4x that bound
// (PERF.md, section 6): each row is a chain of ballots, shuffles, shared loads
// and FMAs whose latency five blocks an SM do not hide.
// ---------------------------------------------------------------------
constexpr int RW_THREADS = 256;  // threads of a row-walk block (8 warps)
constexpr int RW_ROWS = 4;       // rows whose counts a warp loads together
constexpr int RW_MIN_ROWS = 128; // smallest rows_per_block
// Four consecutive counts of a row as one lane loads them: sizeof(CT)
// 32-bit words (int8: 4 bytes, bf16: 8, float: 16).
template <typename CT>
struct Quad {
  static constexpr int W = sizeof(CT);
  uint32_t v[W];
};

// A lane's quad of counts, read from global memory where the call stands:
// the load is volatile, so the compiler cannot sink it towards its use and
// the next rows' counts stay in flight during a walk.
template <typename CT>
__device__ __forceinline__ Quad<CT> load_quad(const CT* p, bool live) {
  Quad<CT> q;
#pragma unroll
  for (int w = 0; w < Quad<CT>::W; ++w) q.v[w] = 0u;
  if (!live) return q;
  if constexpr (Quad<CT>::W == 1) {
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(q.v[0]) : "l"(p));
  } else if constexpr (Quad<CT>::W == 2) {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
                 : "=r"(q.v[0]), "=r"(q.v[1]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(q.v[0]), "=r"(q.v[1]), "=r"(q.v[2]), "=r"(q.v[3])
                 : "l"(p));
  }
  return q;
}

// Count j (0..3) of a quad as float.
template <typename CT>
__device__ __forceinline__ float quad_count(const uint32_t (&v)[sizeof(CT)],
                                            int j) {
  if constexpr (sizeof(CT) == 1) {
    return static_cast<float>(static_cast<int8_t>((v[0] >> (8 * j)) & 0xff));
  } else if constexpr (sizeof(CT) == 2) {
    return __uint_as_float(((v[j / 2] >> (16 * (j % 2))) & 0xffffu) << 16);
  } else {
    return __uint_as_float(v[j]);
  }
}

// acc[q] += sum over the nonzero counts of one 128-column segment (from
// column k0) of count[k] * ct_s[k][lane + 32 q]: for j = 0 .. 3 a ballot
// finds the lanes whose count 4 lane + j is nonzero, and the warp walks
// them in ascending lane order, each count broadcast with __shfl_sync.
template <typename CT, int NC, bool BF16>
__device__ __forceinline__ void walk_segment(const Quad<CT>& quad, int k0,
                                             const float* __restrict__ ct_s,
                                             int lane, float (&acc)[NC]) {
  constexpr int SW = 32 * NC;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float cnt = rnd<BF16>(quad_count<CT>(quad.v, j));
    unsigned lanes = __ballot_sync(FULL, cnt != 0.f);
    while (lanes) {  // the same in every lane
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const float cv = __shfl_sync(FULL, cnt, src);
      const float* row =
          ct_s + static_cast<size_t>(k0 + 4 * src + j) * SW + lane;
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = fmaf(cv, row[32 * q], acc[q]);
    }
  }
}

template <typename CT, int NC, bool FUSED, bool BF16>
__global__ void __launch_bounds__(RW_THREADS)
    dense_bwd_kernel(const CT* __restrict__ c, const float* __restrict__ ct,
                     float* __restrict__ out, int n_out, int kd, int f,
                     int rows_per_block, const int* __restrict__ starts,
                     const int* __restrict__ desc,
                     const float* __restrict__ tail) {
  constexpr int SW = 32 * NC;
  extern __shared__ __align__(16) float ct_s[];  // [kd][SW], then tail_row
  int* tail_row = reinterpret_cast<int*>(ct_s + static_cast<size_t>(kd) * SW);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * rows_per_block;
  const int f0 = blockIdx.y * SW;
  const int width = min(SW, f - f0);
  for (int i = tid; i < kd * SW; i += RW_THREADS) {
    const int k = i / SW, col = i % SW;
    const float* src = ct + static_cast<size_t>(k) * f + f0 + col;
    if (col >= width) {
      ct_s[i] = 0.f;
    } else if (BF16) {
      ct_s[i] = rnd<true>(__ldg(src));
    } else {
      cp_async4(ct_s + i, src);
    }
  }
  cp_async_commit();
  if (FUSED) {  // overlaps the copy of ct
    for (int i = tid; i < rows_per_block; i += RW_THREADS) tail_row[i] = -1;
    __syncthreads();
    const int rb = m0 / DENSE_RB;
    const int s = starts[rb], e = starts[rb + 1];
    for (int i = s + tid; i < e; i += RW_THREADS) {
      const int p = desc[i];
      const int lr = rb * DENSE_RB + p / EXPAND_PACK - m0;
      if (lr >= 0 && lr < rows_per_block) tail_row[lr] = p % EXPAND_PACK;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int rows_per_warp = rows_per_block / (RW_THREADS / 32);
  const int r_begin = m0 + warp * rows_per_warp;
  const int r_end = min(n_out, r_begin + rows_per_warp);
  const int n_seg = (kd + BLK - 1) / BLK;
  const int k_lane = 4 * lane;
  // Segment 0 of the counts of RW_ROWS rows, the next group's loaded
  // while this group is walked.
  auto load_group = [&](int r0, Quad<CT> (&q)[RW_ROWS]) {
#pragma unroll
    for (int u = 0; u < RW_ROWS; ++u)
      q[u] = load_quad(c + static_cast<size_t>(r0 + u) * kd + k_lane,
                       r0 + u < r_end && k_lane < kd);
  };
  Quad<CT> cur[RW_ROWS], nxt[RW_ROWS];
  load_group(r_begin, cur);
  for (int r0 = r_begin; r0 < r_end; r0 += RW_ROWS) {
    load_group(r0 + RW_ROWS, nxt);
    // The rows' tail values, loaded before the walk.
    float tv[RW_ROWS][NC];
#pragma unroll
    for (int u = 0; u < RW_ROWS; ++u) {
      const int t = FUSED && r0 + u < r_end ? tail_row[r0 + u - m0] : -1;
      const float* tr = tail + static_cast<size_t>(t < 0 ? 0 : t) * f + f0;
#pragma unroll
      for (int q = 0; q < NC; ++q)
        tv[u][q] = t >= 0 && lane + 32 * q < width ? tr[lane + 32 * q] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RW_ROWS; ++u) {
      const int r = r0 + u;
      if (r >= r_end) break;  // the same in every lane
      float acc[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = 0.f;
      walk_segment<CT, NC, BF16>(cur[u], 0, ct_s, lane, acc);
      for (int sg = 1; sg < n_seg; ++sg) {
        const int k = sg * BLK + k_lane;
        walk_segment<CT, NC, BF16>(
            load_quad(c + static_cast<size_t>(r) * kd + k, k < kd),
            sg * BLK, ct_s, lane, acc);
      }
      float* o = out + static_cast<size_t>(r) * f + f0;
#pragma unroll
      for (int q = 0; q < NC; ++q)
        if (lane + 32 * q < width) o[lane + 32 * q] = acc[q] + tv[u][q];
    }
#pragma unroll
    for (int u = 0; u < RW_ROWS; ++u) cur[u] = nxt[u];
  }
}

// ---------------------------------------------------------------------
// K3: out[v] = merged[t_inv[v]], zero rows elsewhere, from descriptors
// p = (v % EXPAND_RB) * EXPAND_PACK + merged_row with per-block
// [starts[rb], starts[rb + 1]). With the diagonal epilogue, each row
// v < n_diag also gets the extracted self-loop edges' share,
//   + diag_w[v, j / rep] * diag_u[v, j]   (EPI == 2: copy_lhs, u_mul_e)
//   + diag_w[v, j / rep]                  (EPI == 1: copy_e)
// for column j < f = he * rep, rounded as torch rounds w * u, then +.
//
// Replaces _expand_kernel (engine_hub.py:303), which zero-fills an output
// block and then copies its rows one descriptor at a time out of VMEM;
// the epilogue replaces the glue's two passes after it (the product, then
// the add), each a full read and write of the output.
//
// Bound on the H100: bytes. At arxiv the merged block holds 2,052 of
// 169,343 rows, so K3 is a write pass: num_dst x f floats written once,
// the rows that exist read once, and with the epilogue diag_u's rows and
// diag_w read once.
//
// Design: a write-rate design. A block owns X_ROWS = 128 output rows (a
// quarter of a descriptor block) at a time, and the grid holds as many
// blocks as the SMs run at once, each walking tiles grid-stride. A block
// maps its rows to source rows in shared memory from its descriptor block
// (descriptors name each row at most once), then stores the tile, whose
// rows are one contiguous run of n_rows * f floats, 16 bytes a thread,
// consecutive threads on consecutive addresses and X_UNROLL pieces in
// flight a thread: at F <= 64 a warp covers two or more rows, wider rows
// split across lanes. Where rows are a multiple of 4 floats the stores
// are streaming (st.global.cs: at arxiv and F = 128 the output, 86.7 MB,
// is larger than L2). Each 16-byte piece's first float maps
// to (row, column) by an incremental divide. Where rows are a multiple of
// 4 floats and merged and diag_u start on 16-byte boundaries (VEC), a
// piece is four columns of one row and its loads are 16 bytes too; else
// (rows of 1, 3, 37 floats: the tail path) each float finds its row and
// is loaded alone, and the stores stay 16 bytes: out starts on a 16-byte
// boundary (the wrapper allocates it) and so does every tile (X_ROWS * f
// * 4 bytes), and a run that is not a multiple of 4 floats ends in scalar
// stores. Each output element is written exactly once, with no atomics,
// so out may come from torch.empty.
// ---------------------------------------------------------------------
constexpr int X_ROWS = 128;
constexpr int X_UNROLL = 4;

// One float of K3's output: row v, column j, source row m (or -1).
template <int EPI>
__device__ __forceinline__ float expand_value(
    const float* __restrict__ merged, int m, int v, int j, int f,
    const float* __restrict__ diag_w, int he, int rep,
    const float* __restrict__ diag_u, int n_diag) {
  float x = m >= 0 ? merged[static_cast<size_t>(m) * f + j] : 0.f;
  if (EPI > 0 && v < n_diag) {
    const float w =
        diag_w[static_cast<size_t>(v) * he + (he == 1 ? 0 : j / rep)];
    x = __fadd_rn(
        x, EPI == 2 ? __fmul_rn(w, diag_u[static_cast<size_t>(v) * f + j])
                    : w);
  }
  return x;
}

template <int EPI, bool VEC>
__global__ void __launch_bounds__(NT)
    expand_kernel(const int* __restrict__ starts,
                  const int* __restrict__ desc,
                  const float* __restrict__ merged, int m_rows,
                  float* __restrict__ out, int num_dst, int f,
                  const float* __restrict__ diag_w, int he, int rep,
                  const float* __restrict__ diag_u, int n_diag) {
  __shared__ int src_row[X_ROWS];
  const int n_tiles = (num_dst + X_ROWS - 1) / X_ROWS;
  // A thread's pieces are NT apart: 4 * NT floats, dr rows and dj columns.
  const int dr = 4 * NT / f, dj = 4 * NT - dr * f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * X_ROWS;
    const int rb = row0 / EXPAND_RB, lo = row0 - rb * EXPAND_RB;
    if (threadIdx.x < X_ROWS) src_row[threadIdx.x] = -1;
    __syncthreads();
    const int s = starts[rb], e = starts[rb + 1];
    for (int i = s + threadIdx.x; i < e; i += NT) {
      const int p = desc[i];
      const int r = p / EXPAND_PACK - lo;
      const int m = p % EXPAND_PACK;
      if (r >= 0 && r < X_ROWS) src_row[r] = m < m_rows ? m : -1;
    }
    __syncthreads();
    const int n_rows = min(X_ROWS, num_dst - row0);
    const int n_el = n_rows * f, n_pc = n_el / 4;
    float* o = out + static_cast<size_t>(row0) * f;
    int r = 4 * threadIdx.x / f, j = 4 * threadIdx.x - r * f;
    for (int k = threadIdx.x; k < n_pc; k += X_UNROLL * NT) {
      float4 val[X_UNROLL];
#pragma unroll
      for (int u = 0; u < X_UNROLL; ++u) {
        if (k + u * NT < n_pc) {
          if (VEC) {
            const int m = src_row[r], v = row0 + r;
            float4 x = m >= 0 ? *reinterpret_cast<const float4*>(
                                    merged + static_cast<size_t>(m) * f + j)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
            if (EPI > 0 && v < n_diag) {
              const float* w = diag_w + static_cast<size_t>(v) * he;
              float4 wv;
              if (he == 1) {
                wv = make_float4(w[0], w[0], w[0], w[0]);
              } else {
                wv = make_float4(w[j / rep], w[(j + 1) / rep],
                                 w[(j + 2) / rep], w[(j + 3) / rep]);
              }
              if (EPI == 2) {
                const float4 uv = *reinterpret_cast<const float4*>(
                    diag_u + static_cast<size_t>(v) * f + j);
                wv = make_float4(__fmul_rn(wv.x, uv.x), __fmul_rn(wv.y, uv.y),
                                 __fmul_rn(wv.z, uv.z), __fmul_rn(wv.w, uv.w));
              }
              x = make_float4(__fadd_rn(x.x, wv.x), __fadd_rn(x.y, wv.y),
                              __fadd_rn(x.z, wv.z), __fadd_rn(x.w, wv.w));
            }
            val[u] = x;
          } else {
            float x[4];
            int rr = r, jj = j;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              x[c] = expand_value<EPI>(merged, src_row[rr], row0 + rr, jj, f,
                                       diag_w, he, rep, diag_u, n_diag);
              if (++jj == f) {
                jj = 0;
                ++rr;
              }
            }
            val[u] = make_float4(x[0], x[1], x[2], x[3]);
          }
        }
        r += dr;
        j += dj;
        if (j >= f) {
          j -= f;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < X_UNROLL; ++u) {
        if (k + u * NT >= n_pc) continue;
        float4* dst = reinterpret_cast<float4*>(o) + k + u * NT;
        if (VEC)
          __stcs(dst, val[u]);  // streaming: no reuse from L2
        else
          *dst = val[u];
      }
    }
    // The last n_el % 4 floats of the run (rows that are not a multiple
    // of 4 floats only).
    const int tail = n_pc * 4 + threadIdx.x;
    if (tail < n_el) {
      const int rr = tail / f, jj = tail - rr * f;
      o[tail] = expand_value<EPI>(merged, src_row[rr], row0 + rr, jj, f,
                                  diag_w, he, rep, diag_u, n_diag);
    }
    __syncthreads();  // src_row is rewritten for the next tile
  }
}

// ---------------------------------------------------------------------
// K2 (all modes): for chunk t and real slot s (a[s] >= 0, b[s] >= 0, the
// input row in_id[t] * 128 + a[s] present, and in the weighted modes
// 0 <= eid[s] < n_e),
//   out[out_id[t] * 128 + b[s], j] += msg[j]
// with msg[j] = in[in_id[t] * 128 + a[s], j] (plain), that times
// e2[eid[s], j / rep] (mul, j < f = he * rep) or e2[eid[s], j] (rhs,
// j < f = he).
//
// Replaces _chunk_kernel (engine_hub.py:68), which builds the one-hots S_a
// and S_b of a chunk and computes S_b^T @ (S_a @ in_window), times the
// chunk's gathered weights spread over their features (W^T R) in mul and
// rhs modes, on the MXU. Its first-chunk flag overwrites an output block;
// here the output is zero-initialised by the wrapper and every chunk adds,
// which gives the same values on every block that a chunk covers. Blocks
// no chunk covers are zero here and unspecified there.
//
// On the graphs these layouts serve, millions of slots add into few output
// blocks: the mixed tier's four chunked groups (part_fwd) or, in the
// weighted modes, every hub edge (full_fwd) into the same 128 rows. One
// global atomic per slot and feature, the first plain design, serialised
// in L2 on those 128 x f addresses. So a block owns a run of consecutive
// chunks and a feature stripe, keeps the 128-row partial of its current
// output block in shared memory and flushes it with one global atomic add
// per nonzero element when the output block changes or the run ends.
// Chunks are sorted by output block (part_fwd in (group, window) order,
// part_bwd in (window, group) order, full_fwd by group), so a run sees few
// changes. A warp sums each run of slots with equal b in registers and
// adds it to the partial once. Padding slots' rows and weights are never
// read.
//
// BF16 rounds the gathered input value (plain: the reference's
// in_ref.astype(dt); its second cast, of the message, is exact there; each
// window is rounded once in shared memory, by the threads that copied it,
// once it has landed) or, in the weighted modes, the message before its
// sum and, in mul mode, the input value before the product (the weight is
// not rounded).
// ---------------------------------------------------------------------
constexpr int CW_UNROLL = 4;   // slots whose rows a warp reads together

// Threads tid, tid + n, ... add the 128 x sw partial of output block blk
// to the output (its nonzero elements, one atomic each) and zero it.
__device__ __forceinline__ void flush_partial(float* __restrict__ acc,
                                              int sw, int blk, int f0,
                                              int width,
                                              float* __restrict__ out,
                                              int n_out_rows, int f, int tid,
                                              int n) {
  for (int i = tid; i < BLK * sw; i += n) {
    const float v = acc[i];
    if (v != 0.f) {
      const int r = i / sw, c = i % sw;
      const int64_t row = static_cast<int64_t>(blk) * BLK + r;
      if (c < width && row < n_out_rows) atomicAdd(out + row * f + f0 + c, v);
      acc[i] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------
// K2 plain and mul: chunk_walk_kernel<VEC, MODE, BF16>, MODE kPlain
// (hub_chunk_sum), kOneHead or kHeads (hub_chunk_weighted, mul mode).
//
// Bound on the H100: bytes. The layout, the input rows the real slots
// gather (and in mul mode their weights) read once and the output written
// once. Mixed tier part_fwd at F = 128 (~1.66 M real slots, four output
// blocks): 0.0230 ms at 3.35 TB/s. The weighted GCN's layer 1 (arxiv
// full_fwd, F = 128, one weight per edge: 5,292 chunks, 4.39 M real
// slots, 1,323 input windows, one output block): 0.0506 ms.
//
// The first mul design read every slot's input row and weight from global
// memory inside the walk (three dependent L2 round trips per 32 slots,
// each window row fetched about 26 times) and added each run of equal b
// to the shared partial with float atomics, which shared memory runs as
// compare-and-swap loops. This design walks each chunk from shared memory
// without atomics, and splits a block's warps into producers and
// consumers. In step i the CM_PRODUCERS producer warps stage chunk i:
//   - its layout, loaded into registers during step i - 1 (16-byte loads);
//   - its real slots, counting-sorted by b (a histogram, a scan, a
//     scatter), each as b << 16 | a * SW, in the weighted modes
//     with the weight e2[eid] or, for several heads, the edge id, whose
//     head weights the walk then reads from e2, into one of two buffers;
//   - its 128-row input window at the block's stripe of SW = 32 * VEC
//     columns, only when in_id changes, into one of two buffers, by
//     16-byte cp.async copies (the input's rows are ld floats apart, ld a
//     multiple of 4; the wrapper pads a narrower input).
// Meanwhile the CM_CONSUMERS consumer warps walk chunk i - 1. In the
// weighted modes warp w takes the w-th share of the sorted real slots, a
// run of equal b at a time (its end found by a ballot), lanes over the
// stripe's columns (VEC contiguous ones a lane: one vector load a slot)
// summing in registers. Sorted, every b is one run of the chunk, so a run
// that starts and ends in a warp's share is added to the shared partial by
// that warp alone (a plain read-modify-write). A run that crosses into
// later warps' shares is added by the warp where it starts, after the
// consumers' barrier, together with the later warps' pieces (each left in
// bnd[warp]). The partial is flushed to the output with one global atomic
// add per nonzero element when out_id changes or the run of chunks ends.
// F = 128 takes one 128-column stripe (two 64 KB windows, the 64 KB
// partial, 16 KB of sorted slots); F <= 64 one of 64 or 32.
// The plain mode has no shared partial: warp w owns the output rows
// b = w + CM_CONSUMERS o and sums their slots (contiguous once sorted)
// into registers over the block's whole run, flushing them with vector
// atomics when out_id changes. One block barrier ends each step.
// The weighted modes need the shared partial: full_fwd's layout orders a
// group's hubs by falling in-degree, so owned rows would leave the
// heaviest destinations' slots to a few warps, while equal shares of the
// sorted slots keep the warps level. Owned rows took 3.0x as long at
// arxiv full_fwd F = 128 and 14x at he = 8 (and 0.70x on the window-major
// full_bwd, where destinations are spread); tools/chunk_walk_variants.py
// times both choices, PERF.md section 6 holds the numbers.
//
// What holds it back on the H100 (PERF.md, section 6): in mul mode, the
// producers' random weight gathers (one 4-byte load a slot, no locality in
// eid) share the SM's load/store pipeline with the walk's 512-byte window
// reads. In plain mode, the windows: on part_fwd a window serves only the
// few hundred real slots of one (group, window) run, so nearly every chunk
// stages a new one (~200 MB of copies at F = 128 on the mixed tier, each
// window once per group), and the copies reach an SM at about 15-30 bytes
// a cycle; the consumers' walk of ~4 slots per output row takes as long.
// ---------------------------------------------------------------------
constexpr int CM_THREADS = 512;    // threads of a chunk walk block
constexpr int CM_PRODUCERS = 4;    // its warps that stage chunks
constexpr int CM_CONSUMERS = CM_THREADS / 32 - CM_PRODUCERS;  // walkers
constexpr int CM_CTHREADS = 32 * CM_CONSUMERS;
constexpr int CM_PTHREADS = 32 * CM_PRODUCERS;
constexpr int CM_SLOTS = 8;        // slots a producer thread stages
constexpr int CM_MAX_CHUNK = CM_PTHREADS * CM_SLOTS;  // 1024
constexpr int PW_OWN = (BLK + CM_CONSUMERS - 1) / CM_CONSUMERS;  // rows a
                                   // plain consumer owns (11)

enum ChunkMode { kPlain = 0, kOneHead = 1, kHeads = 2 };

// A sorted slot: its key b << 16 | a * SW, and in the weighted modes the
// weight's bits (kOneHead) or the edge id (kHeads).
template <int MODE>
using ChunkSlot = std::conditional_t<MODE == kPlain, int, int2>;
__device__ __forceinline__ int slot_key(int q) { return q; }
__device__ __forceinline__ int slot_key(int2 q) { return q.x; }

// The block's barrier, reached from the producers' and the consumers'
// code, and the named barriers of each.
__device__ __forceinline__ void bar_all() {
  asm volatile("bar.sync 0, %0;" ::"n"(CM_THREADS) : "memory");
}
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(CM_CTHREADS) : "memory");
}
__device__ __forceinline__ void bar_producers() {
  asm volatile("bar.sync 2, %0;" ::"n"(CM_PTHREADS) : "memory");
}

// VEC consecutive floats from or to shared memory in one access.
template <int VEC>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (VEC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VEC]) {
  float a[VEC];
  ld_vec<VEC>(p, a);
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] += v[i];
  st_vec<VEC>(p, a);
}

// bf16 mode: round four floats in shared memory in place.
__device__ __forceinline__ void round4(float* p) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x = rnd<true>(v.x), v.y = rnd<true>(v.y), v.z = rnd<true>(v.z),
  v.w = rnd<true>(v.w);
  *reinterpret_cast<float4*>(p) = v;
}

// p[0 .. n) += v[0 .. n) (n <= VEC) in global memory, skipping zeros: one
// vector atomic where the whole vector is live and p is aligned to it
// (vec), else one float atomic an element.
template <int VEC>
__device__ __forceinline__ void add_out(float* p, const float (&v)[VEC],
                                        int n, bool vec) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < VEC; ++i) any |= i < n && v[i] != 0.f;
  if (!any) return;
  if constexpr (VEC == 4) {
    if (vec && n >= 4) {
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(v[0], v[1], v[2], v[3]));
      return;
    }
  } else if constexpr (VEC == 2) {
    if (vec && n >= 2) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < n && v[i] != 0.f) atomicAdd(p + i, v[i]);
}

template <int VEC, int MODE, bool BF16>
__global__ void __launch_bounds__(CM_THREADS, 1)
    chunk_walk_kernel(const int* __restrict__ a, const int* __restrict__ b,
                      const int* __restrict__ eid,
                      const int* __restrict__ in_id,
                      const int* __restrict__ out_id, int n_chunks,
                      int chunk, int run, const float* __restrict__ e2,
                      int n_e, int he, int rep, const float* __restrict__ in,
                      int n_in_rows, int ld, float* __restrict__ out,
                      int n_out_rows, int f) {
  constexpr bool PLAIN = MODE == kPlain;
  using Slot = ChunkSlot<MODE>;
  constexpr int SW = 32 * VEC;
  constexpr int NW = CM_CONSUMERS;
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                    // [2][BLK][SW] input windows
  // The weighted modes' shared partial and crossing runs' pieces; the
  // plain mode keeps its partial in registers.
  float* acc = win + 2 * BLK * SW;      // [BLK][SW] output partial
  float* bnd = acc + (PLAIN ? 0 : BLK * SW);  // [NW][SW] crossing runs
  Slot* sp = reinterpret_cast<Slot*>(bnd + (PLAIN ? 0 : NW * SW));
  int* cnt = reinterpret_cast<int*>(sp + 2 * chunk);  // [BLK] per b
  int* first = cnt + BLK;               // [2][BLK + 1] b's first slot
  int* meta = first + 2 * (BLK + 1);    // [2][3] real slots, window, out
  int* pass = meta + 6;                 // [NW] share is one crossing run
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c_begin = blockIdx.x * run;
  const int c_end = min(n_chunks, c_begin + run);
  const int f0 = blockIdx.y * SW;
  const int width = min(SW, f - f0);
  if (c_begin >= c_end) return;

  // Columns past the stripe's width are never copied: zero them once.
  if (!PLAIN)
    for (int i = tid; i < BLK * SW; i += CM_THREADS) acc[i] = 0.f;
  for (int i = tid; i < 2 * BLK * SW; i += CM_THREADS)
    if (i % SW >= width) win[i] = 0.f;
  for (int i = tid; i < BLK; i += CM_THREADS) cnt[i] = 0;
  __syncthreads();

  // Step i stages chunk i (producers, i < c_end) while chunk i - 1 is
  // walked (consumers, i > c_begin); one block barrier ends each step.
  if (warp >= CM_CONSUMERS) {
    // ---- producers: chunk i's layout (loaded during step i - 1) ->
    // sorted real slots (with their weights), and its window.
    const int ptid = tid - CM_CTHREADS, pwarp = warp - CM_CONSUMERS;
    int ra[CM_SLOTS], rb[CM_SLOTS], re[CM_SLOTS], r_in = 0, r_out = 0;
    // Thread ptid takes slots 4 ptid + 4 CM_PTHREADS g + j (j < 4): four
    // consecutive slots in one 16-byte load (chunk % 4 == 0).
    auto load = [&](int t) {  // chunk t's layout into registers
      const int64_t s0 = static_cast<int64_t>(t) * chunk;
      r_in = in_id[t];
      r_out = out_id[t];
#pragma unroll
      for (int g = 0; g < CM_SLOTS / 4; ++g) {
        const int s = 4 * (ptid + g * CM_PTHREADS);
        int4 qa = make_int4(-1, -1, -1, -1), qb = qa, qe = qa;
        if (s < chunk) {
          qa = *reinterpret_cast<const int4*>(a + s0 + s);
          qb = *reinterpret_cast<const int4*>(b + s0 + s);
          if constexpr (!PLAIN)
            qe = *reinterpret_cast<const int4*>(eid + s0 + s);
        }
        ra[4 * g] = qa.x, ra[4 * g + 1] = qa.y, ra[4 * g + 2] = qa.z,
        ra[4 * g + 3] = qa.w;
        rb[4 * g] = qb.x, rb[4 * g + 1] = qb.y, rb[4 * g + 2] = qb.z,
        rb[4 * g + 3] = qb.w;
        re[4 * g] = qe.x, re[4 * g + 1] = qe.y, re[4 * g + 2] = qe.z,
        re[4 * g + 3] = qe.w;
      }
    };
    // Window in_blk into buffer b; with round, instead, bf16 mode's
    // rounding of the values this thread copied there, once they landed
    // (plain mode: the reference rounds the gathered input values).
    auto copy_window = [&](int in_blk, int b, bool round) {
      const int64_t base = static_cast<int64_t>(in_blk) * BLK;
      float* dst = win + b * BLK * SW;
      for (int j = ptid; j < BLK * SW / 4; j += CM_PTHREADS) {
        const int r = j / (SW / 4), c = 4 * (j % (SW / 4));
        if (c < width && base + r < n_in_rows) {
          if (round)
            round4(dst + r * SW + c);
          else
            cp_async16(dst + r * SW + c, in + (base + r) * ld + f0 + c);
        }
      }
    };
    load(c_begin);
    int wb = 1, prev_in = -1;
    for (int i = c_begin; i <= c_end; ++i) {
      if (i < c_end) {
        const int buf = (i - c_begin) & 1;
        const int64_t base_in = static_cast<int64_t>(r_in) * BLK;
        int ca[CM_SLOTS], cb[CM_SLOTS], cw[CM_SLOTS];
#pragma unroll
        for (int k = 0; k < CM_SLOTS; ++k) {  // real slots; weight gathers
          const bool ok =
              rb[k] >= 0 && ra[k] >= 0 && base_in + ra[k] < n_in_rows &&
              (PLAIN || (re[k] >= 0 && re[k] < n_e));
          ca[k] = ra[k];
          cb[k] = ok ? rb[k] : -1;
          cw[k] = PLAIN || !ok ? 0
                  : MODE == kOneHead ? __float_as_int(__ldg(e2 + re[k]))
                                     : re[k];
        }
        const int c_in = r_in, c_out = r_out;
        if (i + 1 < c_end) load(i + 1);  // lands during this step
        const bool fresh = c_in != prev_in;
        if (fresh) {  // the window, into the buffer not in use
          wb ^= 1;
          copy_window(c_in, wb, false);
          cp_async_commit();
          prev_in = c_in;
        }
        // Counting sort by b: a histogram, a scan, a scatter. The
        // histogram takes one shared atomic a slot in plain mode and one a
        // run of equal b in a warp (__match_any_sync) in the weighted
        // modes, where full_fwd's heaviest hubs put long runs of one b into
        // a warp. Each is the faster for its mode on the H100: the match
        // costs plain mode, whose b are spread, 6-17%, and one atomic a
        // slot costs mul mode 3-5% on full_fwd, no more than 1% elsewhere
        // (tools/chunk_walk_variants.py, PERF.md section 6).
        int pos[CM_SLOTS];
#pragma unroll
        for (int k = 0; k < CM_SLOTS; ++k) {
          if constexpr (PLAIN) {
            pos[k] = cb[k] >= 0 ? atomicAdd(cnt + cb[k], 1) : 0;
          } else {
            const unsigned peers = __match_any_sync(FULL, cb[k]);
            const int leader = __ffs(peers) - 1;
            int base = 0;  // one atomic for each run of equal b in the warp
            if (cb[k] >= 0 && lane == leader)
              base = atomicAdd(cnt + cb[k], __popc(peers));
            base = __shfl_sync(FULL, base, leader);
            pos[k] = base + __popc(peers & ((1u << lane) - 1));
          }
        }
        bar_producers();
        if (pwarp == 0) {  // exclusive scan of the 128 counts, four a lane
          int c[4], sum = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            c[j] = cnt[4 * lane + j];
            sum += c[j];
          }
          int incl = sum;
#pragma unroll
          for (int d = 1; d < 32; d *= 2) {
            const int y = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += y;
          }
          int run_sum = incl - sum;
          int* fst = first + buf * (BLK + 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            fst[4 * lane + j] = run_sum;
            run_sum += c[j];
            cnt[4 * lane + j] = 0;
          }
          if (lane == 31) {
            fst[BLK] = incl;
            meta[3 * buf] = incl;
            meta[3 * buf + 1] = wb;
            meta[3 * buf + 2] = c_out;
          }
        }
        bar_producers();
        Slot* dst = sp + buf * chunk;
        const int* fst = first + buf * (BLK + 1);
#pragma unroll
        for (int k = 0; k < CM_SLOTS; ++k) {
          if (cb[k] >= 0) {
            const int key = (cb[k] << 16) | (ca[k] * SW);
            if constexpr (PLAIN)
              dst[fst[cb[k]] + pos[k]] = key;
            else
              dst[fst[cb[k]] + pos[k]] = make_int2(key, cw[k]);
          }
        }
        cp_async_wait_all();
        if (PLAIN && BF16 && fresh) copy_window(c_in, wb, true);
      }
      bar_all();
    }
    return;
  }

  const int col0 = lane * VEC;  // the lane's first column in the stripe
  if constexpr (PLAIN) {
    // ---- consumers, plain mode: warp w owns the output rows b = w + NW o
    // and sums their slots of every chunk of the run in registers (the
    // slots of one b are contiguous once sorted: first[b] .. first[b + 1]);
    // lane l reads 32 of them at a time and the warp walks them CW_UNROLL
    // at a time, every window row loaded before any sum.
    float part[PW_OWN][VEC];
#pragma unroll
    for (int o = 0; o < PW_OWN; ++o)
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[o][v] = 0.f;
    // Adds the owned rows of output block blk to the output, one atomic per
    // nonzero element, and zeroes them.
    auto flush = [&](int blk) {
#pragma unroll
      for (int o = 0; o < PW_OWN; ++o) {
        const int64_t row = static_cast<int64_t>(blk) * BLK + warp + NW * o;
        if (warp + NW * o < BLK && row < n_out_rows)
          add_out<VEC>(out + row * f + f0 + col0, part[o], width - col0,
                       f % VEC == 0);
#pragma unroll
        for (int v = 0; v < VEC; ++v) part[o][v] = 0.f;
      }
    };
    int cur = -1;
    bar_all();  // step c_begin: chunk c_begin is staged
    for (int i = c_begin + 1; i <= c_end; ++i) {
      const int buf = (i - 1 - c_begin) & 1;
      const int wbuf = meta[3 * buf + 1], out_t = meta[3 * buf + 2];
      if (out_t != cur) {  // the same for every consumer
        if (cur >= 0) flush(cur);
        cur = out_t;
      }
      const Slot* sq = sp + buf * chunk;
      const int* fst = first + buf * (BLK + 1);
      const float* wn = win + wbuf * BLK * SW + col0;
#pragma unroll
      for (int o = 0; o < PW_OWN; ++o) {
        const int bo = warp + NW * o;
        if (bo < BLK) {  // the same in every lane
          const int s0 = fst[bo], n_b = fst[bo + 1] - s0;
          for (int k = 0; k < n_b; k += 32) {
            const int key = k + lane < n_b ? slot_key(sq[s0 + k + lane]) : 0;
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
              }
            }
          }
        }
      }
      bar_all();
    }
    if (cur >= 0) flush(cur);
  } else {
    // ---- consumers, weighted modes: walk chunk i - 1, warp w over the w-th
    // share of its sorted real slots, a run of equal b at a time.
    int head[VEC];  // the heads of the lane's columns (several heads only)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      head[v] = MODE == kHeads && col0 + v < width ? (f0 + col0 + v) / rep : 0;
    // sum += the message of slot q (the window row a, times the weight).
    auto add_slot = [&](Slot q, const float* wn, float (&sum)[VEC]) {
      float x[VEC];
      ld_vec<VEC>(wn + (slot_key(q) & 0xffff), x);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float wt =
            MODE == kOneHead
                ? __int_as_float(q.y)
                : (col0 + v < width
                       ? __ldg(e2 + static_cast<int64_t>(q.y) * he + head[v])
                       : 0.f);
        sum[v] = BF16 ? sum[v] + rnd<true>(rnd<true>(x[v]) * wt)
                      : fmaf(x[v], wt, sum[v]);
      }
    };
    auto b_of = [&](const Slot* sq, int j) { return slot_key(sq[j]) >> 16; };
    int cur = -1;
    bar_all();  // step c_begin: chunk c_begin is staged
    for (int i = c_begin + 1; i <= c_end; ++i) {
      const int buf = (i - 1 - c_begin) & 1;
      const int n = meta[3 * buf], wbuf = meta[3 * buf + 1];
      const int out_t = meta[3 * buf + 2];
      if (out_t != cur) {  // the same for every consumer
        if (cur >= 0) {
          flush_partial(acc, SW, cur, f0, width, out, n_out_rows, f, tid,
                        CM_CTHREADS);
          bar_consumers();
        }
        cur = out_t;
      }
      const Slot* sq = sp + buf * chunk;
      const float* wn = win + wbuf * BLK * SW + col0;
      float* piece = bnd + warp * SW + col0;
      const int r0 = static_cast<int>(static_cast<int64_t>(n) * warp / NW);
      const int r1 =
          static_cast<int>(static_cast<int64_t>(n) * (warp + 1) / NW);
      // The first run continues the previous warp's last one.
      const bool cont_in =
          r0 > 0 && r0 < r1 && b_of(sq, r0 - 1) == b_of(sq, r0);
      int pass_w = r0 == r1;  // an empty share passes a crossing run on
      float own[VEC];         // a run that crosses into later warps' shares
      int own_b = -1;
      for (int s = r0; s < r1;) {
        const int rb = b_of(sq, s);
        int e = s + 1;  // the run's end: the first slot with another b
        for (;;) {
          const int j = e + lane;
          const unsigned ends =
              __ballot_sync(FULL, j >= r1 || b_of(sq, j) != rb);
          if (ends) {
            e += __ffs(ends) - 1;
            break;
          }
          e += 32;
        }
        float sum[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
        int j = s;
        for (; j + CW_UNROLL <= e; j += CW_UNROLL) {
          Slot q[CW_UNROLL];
#pragma unroll
          for (int u = 0; u < CW_UNROLL; ++u) q[u] = sq[j + u];
#pragma unroll
          for (int u = 0; u < CW_UNROLL; ++u) add_slot(q[u], wn, sum);
        }
        for (; j < e; ++j) add_slot(sq[j], wn, sum);
        const bool cont_out = e == r1 && r1 < n && b_of(sq, r1) == rb;
        if (s == r0 && cont_in) {
          st_vec<VEC>(piece, sum);
          pass_w = cont_out;
        } else if (cont_out) {
          own_b = rb;
#pragma unroll
          for (int v = 0; v < VEC; ++v) own[v] = sum[v];
        } else {
          add_vec<VEC>(acc + rb * SW + col0, sum);
        }
        s = e;
      }
      if (r0 == r1) {
        float zero[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) zero[v] = 0.f;
        st_vec<VEC>(piece, zero);
      }
      if (lane == 0) pass[warp] = pass_w;
      bar_consumers();
      if (own_b >= 0) {  // the crossing run and the later warps' pieces
        for (int k = warp + 1; k < NW; ++k) {
          float p[VEC];
          ld_vec<VEC>(bnd + k * SW + col0, p);
#pragma unroll
          for (int v = 0; v < VEC; ++v) own[v] += p[v];
          if (!pass[k]) break;
        }
        add_vec<VEC>(acc + own_b * SW + col0, own);
      }
      bar_all();
    }
    bar_consumers();
    flush_partial(acc, SW, cur, f0, width, out, n_out_rows, f, tid,
                  CM_CTHREADS);
  }
}

// ---------------------------------------------------------------------
// K1: out (kd, f) = C[:n_rows]^T @ U, for U of n_rows rows (rows of C
// past n_rows read as zero counts).
//
// Replaces _dense_fwd_kernel (engine_hub.py:170), which multiplies C^T's
// dense 128 x 128 tiles into U on the MXU and carries the sum over the
// row blocks of its sequential grid. At arxiv scale C is (169,984 x 128)
// int8 with 4.6% nonzeros (about six a row): the first design here, a
// split-K register-tiled SGEMM, did the dense tile's 5.6 GFLOP at every
// width, 95% of it on zero counts.
//
// Design: a walk over C's nonzeros, column by column. A 512-thread block
// owns a run of 128-row tiles of C, one 128-column group of it (output
// rows m0 .. m0 + 127) and a stripe of SW = 32 * VEC columns of U. For
// each tile it
//   - copies the tile's rows of U's stripe into shared memory with
//     16-byte cp.async (U's rows are ld floats apart, ld a multiple of 4;
//     the wrapper pads a narrower U), double-buffered: tile t + 1's rows
//     are in flight while tile t is walked;
//   - loads the tile's counts a tile ahead into registers (lane l reads
//     counts 4l .. 4l + 3 of a row, 4, 8 or 16 bytes: one coalesced load a
//     row, as K4 does) and stores them transposed, four rows of one column
//     a quad, into cq_s[m][row quad] (the quads of column m rotated by
//     m / 4, so that neither these stores nor the walk's loads conflict);
//   - walks it: each warp owns a few output rows (see CF_SPLIT), their
//     partial sums in registers (acc[i][VEC], indexed by unrolled loops,
//     so nothing spills). For an owned column, lane l reads the quad of
//     rows 4l .. 4l + 3; a ballot finds the lanes whose quad holds a
//     nonzero count, and the warp takes each such quad whole, broadcast
//     with __shfl_sync, every lane adding count * U_s[row][its VEC
//     columns] (one vector load from shared memory) for each nonzero count
//     in it. The heavy columns' quarters and halves are walked a count
//     position at a time instead, four nonzeros together, every load
//     before any product.
// No shared-memory atomics. At the end a block adds its partial sums to
// the zeroed output, one float4 (float2, float) atomic per vector with a
// nonzero element: blocks run in no order, so results agree with a
// sequential sum to float32 rounding of the partial sums, not bit for bit.
//
// BF16 rounds the counts (counts above 256 lose bits, as in the
// reference) as they are read and U's values once, in shared memory, by
// the threads that copied them, once they have landed.
//
// Bound on the H100: bytes. At arxiv (F = 128) C (21.8 MB), the rows of U
// that a nonzero needs (86.7 MB) and the output, once: 0.0324 ms at
// 3.35 TB/s; the nonzeros need 0.26 GFLOP. What holds it back (PERF.md,
// section 6): instructions. Every owned column of every tile costs a quad
// load, a ballot and a shuffle and four uniform branches per nonzero quad,
// whatever its counts, and the static split of the heavy columns by
// position balances the warps only roughly.
// ---------------------------------------------------------------------
constexpr int CF_THREADS = 512;                 // threads of a K1 block
constexpr int CF_WARPS = CF_THREADS / 32;       // 16
// The layout orders a group's hub slots by falling in-degree
// (hub_format.py), so its first few columns hold most of the nonzeros
// (on a power-law graph the first is nonzero in nearly every row). Each
// of the first CF_QUARTERS columns is walked by four warps, one count
// position each, and each of the next CF_HALVES by two, two positions
// each; every warp owns one quarter, one half and up to CF_OWN whole
// columns of the rest, dealt in alternating order so that no warp holds
// the heaviest of each round.
constexpr int CF_QUARTERS = CF_WARPS / 4;       // 4
constexpr int CF_HALVES = CF_WARPS / 2;         // 8
constexpr int CF_SPLIT = CF_QUARTERS + CF_HALVES;
constexpr int CF_OWN = (BLK - CF_SPLIT + CF_WARPS - 1) / CF_WARPS;  // 8
constexpr int CF_RQ = BLK / 4;                  // row quads of a tile (32)
constexpr int CF_STAGE = CF_RQ / CF_WARPS;      // row quads a warp stages
constexpr int CF_UNROLL = 4;                    // nonzeros walked together

// The four counts of column j (0..3) in four rows' quads, as one quad.
template <typename CT>
__device__ __forceinline__ Quad<CT> quad_column(const Quad<CT> (&q)[4],
                                                int j) {
  Quad<CT> o;
  if constexpr (sizeof(CT) == 1) {
    const unsigned sel = j | ((j + 4) << 4);  // byte j of x, byte j of y
    const unsigned lo = __byte_perm(q[0].v[0], q[1].v[0], sel);
    const unsigned hi = __byte_perm(q[2].v[0], q[3].v[0], sel);
    o.v[0] = __byte_perm(lo, hi, 0x5410);
  } else if constexpr (sizeof(CT) == 2) {
    const unsigned sel = j % 2 ? 0x7632 : 0x5410;  // high or low halves
    o.v[0] = __byte_perm(q[0].v[j / 2], q[1].v[j / 2], sel);
    o.v[1] = __byte_perm(q[2].v[j / 2], q[3].v[j / 2], sel);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o.v[i] = q[i].v[j];
  }
  return o;
}

// Quad slot (m, row quad rq) of the transposed tile: column m's quads are
// rotated by m / 4.
template <typename CT>
__device__ __forceinline__ uint32_t* quad_slot(uint32_t* cq, int m, int rq) {
  return cq + (m * CF_RQ + ((rq + m / 4) & (CF_RQ - 1))) * Quad<CT>::W;
}

template <typename CT>
__device__ __forceinline__ void st_quad(uint32_t* p, const Quad<CT>& q) {
  if constexpr (Quad<CT>::W == 1) {
    p[0] = q.v[0];
  } else if constexpr (Quad<CT>::W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(q.v[0], q.v[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(q.v[0], q.v[1], q.v[2], q.v[3]);
  }
}

template <typename CT>
__device__ __forceinline__ Quad<CT> ld_quad(const uint32_t* p) {
  Quad<CT> q;
  if constexpr (Quad<CT>::W == 1) {
    q.v[0] = p[0];
  } else if constexpr (Quad<CT>::W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    q.v[0] = x.x, q.v[1] = x.y;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    q.v[0] = x.x, q.v[1] = x.y, q.v[2] = x.z, q.v[3] = x.w;
  }
  return q;
}

template <typename CT, int VEC, bool BF16>
__global__ void __launch_bounds__(CF_THREADS, 1)
    dense_fwd_walk_kernel(const CT* __restrict__ c,
                          const float* __restrict__ u, int ld,
                          float* __restrict__ out, int n_rows, int kd, int f) {
  constexpr int SW = 32 * VEC;
  extern __shared__ __align__(16) float smem[];
  float* win = smem;  // [2][BLK][SW] the tiles' rows of U
  uint32_t* cq = reinterpret_cast<uint32_t*>(win + 2 * BLK * SW);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int stripes = (f + SW - 1) / SW;
  const int m0 = (blockIdx.y / stripes) * BLK;
  const int f0 = (blockIdx.y % stripes) * SW;
  const int width = min(SW, f - f0);
  const int n_tiles = (n_rows + BLK - 1) / BLK;
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(n_tiles) * blockIdx.x / gridDim.x);
  const int t_end = static_cast<int>(static_cast<int64_t>(n_tiles) *
                                     (blockIdx.x + 1) / gridDim.x);
  if (t_begin >= t_end) return;

  // Columns past the stripe's width are never copied: zero them once.
  for (int i = tid; i < 2 * BLK * SW; i += CF_THREADS)
    if (i % SW >= width) win[i] = 0.f;

  // Thread (warp, lane) stages row quads warp + CF_WARPS * k of a tile at
  // columns m0 + 4 lane .. + 3.
  const int k_col = m0 + 4 * lane;
  Quad<CT> rows[CF_STAGE][4];
  auto load_counts = [&](int t) {
#pragma unroll
    for (int k = 0; k < CF_STAGE; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t * BLK + 4 * (warp + CF_WARPS * k) + i;
        rows[k][i] = load_quad(c + static_cast<size_t>(r) * kd + k_col,
                               r < n_rows && k_col < kd);
      }
  };
  auto store_counts = [&]() {
#pragma unroll
    for (int k = 0; k < CF_STAGE; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_quad<CT>(quad_slot<CT>(cq, 4 * lane + j, warp + CF_WARPS * k),
                    quad_column<CT>(rows[k], j));
  };
  // Tile t's rows of U into buffer buf; with round, instead, bf16 mode's
  // rounding of the values this thread copied there, once they landed.
  auto stage_rows = [&](int t, int buf, bool round) {
    float* dst = win + buf * BLK * SW;
    const int64_t r0 = static_cast<int64_t>(t) * BLK;
    for (int j = tid; j < BLK * SW / 4; j += CF_THREADS) {
      const int r = j / (SW / 4), cc = 4 * (j % (SW / 4));
      if (cc < width && r0 + r < n_rows) {
        if (round)
          round4(dst + r * SW + cc);
        else
          cp_async16(dst + r * SW + cc, u + (r0 + r) * ld + f0 + cc);
      }
    }
    if (!round) cp_async_commit();
  };

  // acc[0]: column warp % 4 at count position warp / 4; acc[1]: column
  // CF_QUARTERS + warp / 2 at positions 2 (warp % 2) and 2 (warp % 2) + 1;
  // acc[2 + i]: column own_col(i).
  float acc[2 + CF_OWN][VEC];
#pragma unroll
  for (int i = 0; i < 2 + CF_OWN; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
  const int col0 = lane * VEC;
  auto own_col = [&](int i) {
    return CF_SPLIT + CF_WARPS * i + (i % 2 ? warp : CF_WARPS - 1 - warp);
  };
  // acc_m += the products of the counts cnt (position j of every lane's
  // quad: rows 4 l + j of the tile) with their rows of U, CF_UNROLL
  // nonzeros at a time, every load before any product. For a column whose
  // nonzeros crowd one position (the heavy columns' quarters).
  auto walk_position = [&](float cnt, int j, const float* wn,
                           float (&acc_m)[VEC]) {
    unsigned lanes = __ballot_sync(FULL, cnt != 0.f);
    while (lanes) {  // the same in every lane
      int src[CF_UNROLL], n = 0;
#pragma unroll
      for (int k = 0; k < CF_UNROLL; ++k) {
        src[k] = lanes ? __ffs(lanes) - 1 : src[0];
        if (lanes) {
          lanes &= lanes - 1;
          ++n;
        }
      }
      float cv[CF_UNROLL], x[CF_UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < CF_UNROLL; ++k) {
        cv[k] = __shfl_sync(FULL, cnt, src[k]);
        ld_vec<VEC>(wn + (4 * src[k] + j) * SW, x[k]);
      }
#pragma unroll
      for (int k = 0; k < CF_UNROLL; ++k) {
        if (k >= n) break;  // the same in every lane
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc_m[v] = fmaf(cv[k], x[k][v], acc_m[v]);
      }
    }
  };
  // The same over all four positions of a light column: one ballot finds
  // the lanes whose quad holds a nonzero count, and the warp takes each
  // such quad whole (broadcast with __shfl_sync), one uniform branch a
  // count.
  auto walk_quads = [&](const Quad<CT>& q, const float* wn,
                        float (&acc_m)[VEC]) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < Quad<CT>::W; ++w) any |= q.v[w];
    unsigned lanes = __ballot_sync(FULL, any != 0u);
    while (lanes) {  // the same in every lane
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      Quad<CT> qs;
#pragma unroll
      for (int w = 0; w < Quad<CT>::W; ++w)
        qs.v[w] = __shfl_sync(FULL, q.v[w], src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cv = rnd<BF16>(quad_count<CT>(qs.v, j));
        if (cv != 0.f) {  // the same in every lane
          float x[VEC];
          ld_vec<VEC>(wn + (4 * src + j) * SW, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc_m[v] = fmaf(cv, x[v], acc_m[v]);
        }
      }
    }
  };
  load_counts(t_begin);
  stage_rows(t_begin, 0, false);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    store_counts();  // the previous walk is done (barrier below)
    if (t + 1 < t_end) {
      load_counts(t + 1);  // lands during this walk
      stage_rows(t + 1, buf ^ 1, false);
    } else {
      cp_async_commit();  // an empty batch keeps the count of pending ones
    }
    cp_async_wait_prev();  // this tile's rows have landed
    if (BF16) stage_rows(t, buf, true);
    __syncthreads();
    const float* wn = win + buf * BLK * SW + col0;
    {
      const Quad<CT> q = ld_quad<CT>(quad_slot<CT>(cq, warp % 4, lane));
      const Quad<CT> h =
          ld_quad<CT>(quad_slot<CT>(cq, CF_QUARTERS + warp / 2, lane));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == warp / 4)
          walk_position(rnd<BF16>(quad_count<CT>(q.v, j)), j, wn, acc[0]);
        if (j / 2 == warp % 2)
          walk_position(rnd<BF16>(quad_count<CT>(h.v, j)), j, wn, acc[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < CF_OWN; ++i) {
      const int m = own_col(i);
      if (m < BLK) {  // the same in every lane
        walk_quads(ld_quad<CT>(quad_slot<CT>(cq, m, lane)), wn, acc[2 + i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2 + CF_OWN; ++i) {
    const int m = m0 + (i == 0   ? warp % 4
                        : i == 1 ? CF_QUARTERS + warp / 2
                                 : own_col(i - 2));
    if (m < min(kd, m0 + BLK))
      add_out<VEC>(out + static_cast<size_t>(m) * f + f0 + col0, acc[i],
                   width - col0, f % VEC == 0);
  }
}

// ---------------------------------------------------------------------
// K2 rhs: chunk_rhs_kernel<BF16, VEC, LG>, copy_e with sum:
// out[out_id[t] * 128 + b[s]] += e2[eid[s]] over the real slots whose edge
// id lies in e2 (hub_chunk_weighted, rhs mode).
//
// Bound on the H100: bytes. Each real slot needs its he floats of e2 and
// the layout, each read once; the output is written once. R-GCN layer 1
// (he = 64, 4.4 M real slots): 1.1 GB of 256-byte rows at random places
// (eid follows the destination, not the edge order), 0.355 ms at 3.35
// TB/s. No arithmetic to speak of: the kernel is a gather whose speed is
// the number of rows in flight.
//
// The first design gave each lane a column of a 64-wide stripe and
// walked four slots at a time with 4-byte loads: eight loads in flight a
// lane, 1 KB a warp. Its bf16 build took twice as long because ptxas
// placed each rounding (F2F.BF16.F32) right after its load, inside the
// walk of four slots, so a lane waited for each slot's row before it
// issued the next slot's loads: at most 3 loads in flight, against 8 in
// the float32 build (tools/sass_report.py, PERF.md section 6). This one:
//
// * Lanes over a slot's columns, 4 a lane, 16 bytes at a time where rows
//   allow (LG lanes a slot, 32 / LG slots a warp-wide load; at he <= 4
//   each lane takes a slot of its own). A block owns a run of chunks and
//   a stripe of RSTRIPE columns, a warp a contiguous eighth of each chunk.
// * A warp loads the layout of a pass of NS slots (the next pass's a
//   pass ahead, across chunk ends), then issues every row of the pass
//   (RHS_STEPS loads a lane: 2 KB a warp at he = 64; 8 loads took 80
//   registers and were slower at every width) before it adds any, each
//   load without a condition (one whose result is moved or selected at
//   once holds the next ones back), and rounds (BF16) only in the adding
//   loop.
// * Sums per hub row: while a step's slots all name the warp's current
//   row (most steps: a window's slots come in runs of equal b) the lanes
//   add into registers; a step that changes the row adds the sum over the
//   lanes to the block's shared (128 x RSTRIPE) partial, and the runs that
//   start and end inside the step are summed over their lanes first, one
//   shared add a run and column. The partial goes to the output with one
//   16-byte atomic a nonzero quad when out_id changes and at the run's
//   end (flush_rhs).
// ---------------------------------------------------------------------
constexpr int RSTRIPE = 64;   // feature columns per block of K2 rhs
constexpr int RHS_STEPS = 4;  // steps whose rows a lane loads at once

// Adds the 128 x RSTRIPE partial of output block blk to the output (16
// bytes at a time where its rows allow, one atomic each quad with a
// nonzero) and zeroes it.
__device__ void flush_rhs(float* __restrict__ acc, int blk, int f0,
                          int width, float* __restrict__ out, int n_out_rows,
                          int f) {
  constexpr int Q = RSTRIPE / 4;
  const bool vec = (f & 3) == 0;
  for (int i = threadIdx.x; i < BLK * Q; i += NT) {
    const int r = i / Q, c = (i - r * Q) * 4;
    float4* p = reinterpret_cast<float4*>(acc + r * RSTRIPE + c);
    const float4 v = *p;
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    *p = make_float4(0.f, 0.f, 0.f, 0.f);
    const int64_t row = static_cast<int64_t>(blk) * BLK + r;
    if (c >= width || row >= n_out_rows) continue;
    float* o = out + row * f + f0 + c;
    if (vec && c + 4 <= width) {
      atomicAdd(reinterpret_cast<float4*>(o), v);
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < width && vv[e] != 0.f) atomicAdd(o + e, vv[e]);
    }
  }
}

template <bool BF16, bool VEC, int LG>
__global__ void __launch_bounds__(NT)
    chunk_rhs_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     const int* __restrict__ eid,
                     const int* __restrict__ out_id, int n_chunks,
                     int chunk, int run, const float* __restrict__ e2,
                     int n_e, int he, float* __restrict__ out,
                     int n_out_rows, int f) {
  constexpr int P = 32 / LG;  // slots a step: lane group p takes slot p
  constexpr int NS = P * RHS_STEPS < 128 ? P * RHS_STEPS : 128;  // a pass
  constexpr int STEPS = NS / P;
  constexpr int K = (NS + 31) / 32;  // layout registers a lane
  __shared__ __align__(16) float acc[BLK * RSTRIPE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = lane / LG, c0 = 4 * (lane % LG);
  const int c_begin = blockIdx.x * run;
  const int c_end = min(n_chunks, c_begin + run);
  const int f0 = blockIdx.y * RSTRIPE;
  const int width = min(RSTRIPE, f - f0);
  const int ncol = max(0, min(4, width - c0));
  const int per_warp = (chunk + NT / 32 - 1) / (NT / 32);
  const int w_begin = min(chunk, warp * per_warp);
  const int w_end = min(chunk, w_begin + per_warp);
  for (int i = threadIdx.x; i < BLK * RSTRIPE; i += NT) acc[i] = 0.f;
  __syncthreads();

  // A pass's layout: lane i, register k holds slot s0 + 32 k + i's row b
  // and edge id, b = -1 where the slot is padding or its edge id falls
  // outside e2.
  int bq[K], eq[K];
  auto load_layout = [&](int t, int s0) {
    const int64_t slot0 = static_cast<int64_t>(t) * chunk;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = s0 + 32 * k + lane;
      bq[k] = -1;
      eq[k] = 0;
      if (32 * k + lane < NS && i < w_end && t < c_end) {
        const int aa = a[slot0 + i], bb = b[slot0 + i], ee = eid[slot0 + i];
        if (aa >= 0 && bb >= 0 && ee >= 0 && ee < n_e) {
          bq[k] = bb;
          eq[k] = ee;
        }
      }
    }
  };
  // Adds the lanes' running sums of row cur, summed over the lane groups,
  // to the shared partial.
  auto flush_run = [&](int cur, float (&sa)[4]) {
#pragma unroll
    for (int o = LG; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[e] += __shfl_xor_sync(FULL, sa[e], o);
    if (cur >= 0 && p == 0)
      for (int e = 0; e < ncol; ++e)
        atomicAdd(&acc[cur * RSTRIPE + c0 + e], sa[e]);
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[e] = 0.f;
  };

  int cur_o = c_begin < c_end ? out_id[c_begin] : -1;
  if (w_begin < w_end) load_layout(c_begin, w_begin);
  for (int t = c_begin; t < c_end; ++t) {
    const int o = out_id[t];
    if (o != cur_o) {  // the same for every thread of the block
      __syncthreads();
      flush_rhs(acc, cur_o, f0, width, out, n_out_rows, f);
      __syncthreads();
      cur_o = o;
    }
    int cur = -1;  // the warp's current row (the same in every lane)
    float sa[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = w_begin; s0 < w_end; s0 += NS) {
      // Every row of the pass is requested before any is added, without
      // conditions (a padding slot reads row 0, a lane past the stripe's
      // edge its first columns; both are zeroed when added): a load whose
      // result is moved or selected right away holds the next ones back.
      float v[STEPS][4];
      int rb[STEPS];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int src = (st * P) % 32 + p, k = (st * P) / 32;
        rb[st] = __shfl_sync(FULL, bq[k], src);
        const int ee = __shfl_sync(FULL, eq[k], src);
        const float* row = e2 + static_cast<int64_t>(ee) * he + f0;
        if (VEC) {
          const float4 x =
              __ldg(reinterpret_cast<const float4*>(row + (ncol ? c0 : 0)));
          v[st][0] = x.x;
          v[st][1] = x.y;
          v[st][2] = x.z;
          v[st][3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[st][e] = __ldg(row + min(c0 + e, width - 1));
        }
      }
      // The next pass's layout (the next chunk's first where this share
      // ends) lands while this pass adds.
      if (s0 + NS < w_end)
        load_layout(t, s0 + NS);
      else if (w_begin < w_end)
        load_layout(t + 1, w_begin);
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int bb = rb[st];
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = bb >= 0 && e < ncol ? rnd<BF16>(v[st][e]) : 0.f;
        if (__all_sync(FULL, bb < 0 || bb == cur)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[e] += x[e];
          continue;
        }
        // The row changes in this step: its last real slot's row goes on
        // in registers; runs of other rows are summed over their lane
        // groups and added once each.
        const int old = cur;
        const int last = 31 - __clz(__ballot_sync(FULL, bb >= 0));
        const int ncur = __shfl_sync(FULL, bb, last);
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[e] += bb >= 0 && bb == old ? x[e] : 0.f;
        if (ncur != old) {
          flush_run(old, sa);
          cur = ncur;
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[e] = bb == ncur ? x[e] : 0.f;
        }
        const bool rest = bb >= 0 && bb != old && bb != ncur;
        if (!__any_sync(FULL, rest)) continue;
        // Segments: runs of equal rows among the lane groups (lanes of
        // other slots each their own). e: this run's last lane group.
        const int key = rest ? bb : -1 - p;
        const int key_next = __shfl_down_sync(FULL, key, LG);
        const int key_prev = __shfl_up_sync(FULL, key, LG);
        const int lg0 = lane - lane % LG;  // this lane group's first lane
        const unsigned ends = __ballot_sync(
            FULL, lane == lg0 && (p == P - 1 || key_next != key));
        const int e_last = (lg0 + __ffs(ends >> lg0) - 1) / LG;
        float xr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) xr[e] = rest ? x[e] : 0.f;
#pragma unroll
        for (int o = 1; o < P; o <<= 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = __shfl_down_sync(FULL, xr[e], o * LG);
            if (p + o <= e_last) xr[e] += y;
          }
        }
        if (rest && (p == 0 || key_prev != key))
          for (int e = 0; e < ncol; ++e)
            atomicAdd(&acc[bb * RSTRIPE + c0 + e], xr[e]);
      }
    }
    flush_run(cur, sa);
  }
  __syncthreads();
  if (cur_o >= 0) flush_rhs(acc, cur_o, f0, width, out, n_out_rows, f);
}

// ---------------------------------------------------------------------
// K5: per slot s of chunk t and head h, into out (n_slots, he),
//   mul: sum over j in [h * rep, (h + 1) * rep) of
//        u[in_id[t] * 128 + a[s], j] * ct[out_id[t] * 128 + b[s], j]
//   rhs: ct[out_id[t] * 128 + b[s], h]
// and zero on padding slots (a or b < 0).
//
// Replaces _edge_grad_kernel (dgl1_tpu/ops/engine_hub.py:364), which
// gathers both rows by one-hot matmuls and reduces each head's span by a
// matmul with R into the transposed (H_pad, n_slots) layout so the TPU's
// lanes stay 1024 wide. Here the output is (n_slots, he), the transpose
// of the reference's first he rows. rhs: a copy of the cotangent rows, a
// thread per output element, every element written, coalesced.
//
// mul's bound on the H100: bytes. At the weighted GCN's layer 1 (arxiv
// full_fwd, F=128, he=1) it reads a and b (43.4 MB) and the u rows its
// real slots name (86.7 MB) once and writes n_slots floats (21.7 MB):
// ~45 us at 3.35 TB/s; its 1.1 GFLOP take ~17 us at 67 TFLOP/s. The
// earlier design (a block per chunk restaging both 128-row blocks 32
// columns at a time with a __syncthreads each, a thread's serial dot over
// rows 33 floats apart, and a read-modify-write of its output per stripe
// into zeroed memory) waited on its stages and on chains of dependent L2
// loads. This one (edge_grad_mul_kernel):
// * A block (16 warps; two an SM where the rows are narrow enough, so
//   registers are held to 64 a thread) walks a run of consecutive chunks. It
//   stages u's 128-row window, full width, by 16-byte cp.async only when
//   in_id changes (one window serves ~4 chunks at arxiv), and the group's
//   128 cotangent rows once per group (rows of up to 216 floats; wider
//   ones are read through L1, one hub row's for a run of slots).
// * A lane takes a slot (warp w the chunk's rounds of 32 slots w, w + 16,
//   ...): per head, its dot over 16-byte shared loads of the u and
//   cotangent rows, four partial sums (the terms are not one chain); no
//   shuffles, no reductions across lanes, no branch but the padding.
//   Lanes over columns with a reduction per slot (butterfly or
//   reduce-scatter over each head's lanes, as the port tried first) cost
//   several times the instructions a slot. The dot reads the u row at
//   random rows, so a warp's loads meet bank conflicts that contiguous
//   rows would not; the cotangent row is the same for a run of slots and
//   is read as a broadcast.
// * Each output element is written once, padding slots as 0 (a warp's 32
//   slots are 32 consecutive rows of out), so the wrapper allocates with
//   torch.empty. Duplicate (a, b) pairs are rarely adjacent in the layout
//   (arxiv: 4,357,535 adjacent runs among 4,390,906 real slots), so each
//   slot takes its own dot.
// Shapes it does not take (rows wider than 384 floats, or several heads
// whose rep is not a multiple of 4) go to edge_grad_items_kernel: a
// thread per (slot, head), both rows read from L1/L2, every output
// written once.
//
// BF16 rounds u and ct and each product before the head sum (a lane adds
// its products into four partial sums: only the order of the sum differs
// from the reference's).
// ---------------------------------------------------------------------
constexpr int EG_NT = 512;          // threads of a K5 mul block
constexpr int EG_NW = EG_NT / 32;
constexpr int EG_MAX_COLS = 384;    // widest row the staged walk takes
constexpr int EG_CT_COLS = 216;     // widest row whose group is staged too

// A lane's running dot: four partial sums (the terms are not one chain).
template <bool BF16>
__device__ __forceinline__ void dot4_add(float4 u4, float4 c4,
                                         float (&p)[4]) {
  if (BF16) {
    p[0] += rnd<true>(rnd<true>(u4.x) * rnd<true>(c4.x));
    p[1] += rnd<true>(rnd<true>(u4.y) * rnd<true>(c4.y));
    p[2] += rnd<true>(rnd<true>(u4.z) * rnd<true>(c4.z));
    p[3] += rnd<true>(rnd<true>(u4.w) * rnd<true>(c4.w));
  } else {
    p[0] = fmaf(u4.x, c4.x, p[0]);
    p[1] = fmaf(u4.y, c4.y, p[1]);
    p[2] = fmaf(u4.z, c4.z, p[2]);
    p[3] = fmaf(u4.w, c4.w, p[3]);
  }
}

// Stages 128 rows of `units` float4s (zeros past n_rows) at ws floats
// apart, by 16-byte cp.async, and waits for them.
__device__ void eg_stage(float* dst, const float* __restrict__ src,
                         int64_t row0, int n_rows, int ld, int units,
                         int ws) {
  for (int idx = threadIdx.x; idx < BLK * units; idx += EG_NT) {
    const int r = idx / units, c = (idx - r * units) * 4;
    const bool ok = row0 + r < n_rows;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ws + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(ok ? src + (row0 + r) * ld + c : src), "r"(ok ? 16 : 0));
  }
  cp_async_commit();
  cp_async_wait_all();
}

// CT_SH: the group's cotangent rows staged too (rows of at most
// EG_CT_COLS floats), else read through L1.
template <bool BF16, bool CT_SH>
__global__ void __launch_bounds__(EG_NT, 2)
    edge_grad_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                         const int* __restrict__ in_id,
                         const int* __restrict__ out_id, int n_chunks,
                         int chunk, int cpb, const float* __restrict__ u,
                         int n_u, int ldu, const float* __restrict__ ct,
                         int n_ct, int ldc, float* __restrict__ out, int he,
                         int rep, int ws) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;             // BLK x ws: u's window
  float* cs = us + BLK * ws;    // BLK x ws: the group's cotangent rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Four-column units a head spans, and of a row.
  const int hu = (rep + 3) / 4, units = he * hu;
  const int t0 = blockIdx.x * cpb, t1 = min(n_chunks, t0 + cpb);
  int staged_w = -1, staged_g = -1;
  for (int t = t0; t < t1; ++t) {
    const int w = in_id[t], g = out_id[t];
    const int64_t win0 = static_cast<int64_t>(w) * BLK;
    const int64_t grp0 = static_cast<int64_t>(g) * BLK;
    if (w != staged_w || (CT_SH && g != staged_g)) {
      __syncthreads();  // the last rows' reads are done
      if (w != staged_w) eg_stage(us, u, win0, n_u, ldu, units, ws);
      if (CT_SH && g != staged_g) eg_stage(cs, ct, grp0, n_ct, ldc, units, ws);
      __syncthreads();
      staged_w = w;
      staged_g = g;
    }
    // A lane a slot: warp w takes the chunk's rounds of 32 slots w, w +
    // 16, ... and each lane its slot's dots, one head after another.
    const int64_t slot0 = static_cast<int64_t>(t) * chunk;
    for (int base = 32 * warp; base < chunk; base += 32 * EG_NW) {
      const int i = base + lane;
      if (i >= chunk) break;
      const int aa = a[slot0 + i], bb = b[slot0 + i];
      const bool real = aa >= 0 && bb >= 0 && win0 + aa < n_u &&
                        grp0 + bb < n_ct;
      const float* ur = us + (real ? aa : 0) * ws;
      const float* cr =
          CT_SH ? cs + (real ? bb : 0) * ws : ct + (grp0 + (real ? bb : 0)) * ldc;
      float* o = out + (slot0 + i) * he;
      for (int hd = 0; hd < he; ++hd) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        if (real) {
#pragma unroll 8
          for (int j = hd * hu; j < (hd + 1) * hu; ++j) {
            const float4 c4 =
                CT_SH ? *reinterpret_cast<const float4*>(cr + 4 * j)
                      : __ldg(reinterpret_cast<const float4*>(cr + 4 * j));
            dot4_add<BF16>(*reinterpret_cast<const float4*>(ur + 4 * j), c4,
                           p);
          }
        }
        o[hd] = (p[0] + p[1]) + (p[2] + p[3]);
      }
    }
  }
}

// K5 mul for the shapes the staged walk does not take: a thread per (slot,
// head), both rows from L1/L2.
template <bool BF16>
__global__ void __launch_bounds__(NT)
    edge_grad_items_kernel(const int* __restrict__ a,
                           const int* __restrict__ b,
                           const int* __restrict__ in_id,
                           const int* __restrict__ out_id, int chunk,
                           const float* __restrict__ u, int n_u, int ldu,
                           const float* __restrict__ ct, int n_ct, int ldc,
                           float* __restrict__ out, int he, int rep) {
  const int t = blockIdx.x;
  const int64_t win0 = static_cast<int64_t>(in_id[t]) * BLK;
  const int64_t grp0 = static_cast<int64_t>(out_id[t]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(t) * chunk;
  for (int i = threadIdx.x; i < chunk * he; i += NT) {
    const int s = i / he, hd = i - s * he;
    const int aa = a[slot0 + s], bb = b[slot0 + s];
    float p = 0.f;
    if (aa >= 0 && bb >= 0 && win0 + aa < n_u && grp0 + bb < n_ct) {
      const float* ur = u + (win0 + aa) * ldu + hd * rep;
      const float* cr = ct + (grp0 + bb) * ldc + hd * rep;
      for (int c = 0; c < rep; ++c)
        p = BF16 ? p + rnd<true>(rnd<true>(__ldg(ur + c)) *
                                 rnd<true>(__ldg(cr + c)))
                 : fmaf(__ldg(ur + c), __ldg(cr + c), p);
    }
    out[slot0 * he + i] = p;
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

// Dynamic shared memory a block may use on the H100 (227 KB), and the cap
// on K4's staged ct stripe that leaves room for two blocks an SM.
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t RW_CT_CAP = 112 * 1024;

template <typename K>
cudaError_t allow_smem(K* kern, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kern,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename CT, int VEC, bool BF16>
int launch_dense_fwd(const CT* c, const float* u, int ld, float* out,
                     int n_rows, int kd, int f, cudaStream_t stream) {
  constexpr int SW = 32 * VEC;
  auto kern = dense_fwd_walk_kernel<CT, VEC, BF16>;
  // U's rows of two tiles (floats) and the transposed counts of one.
  const size_t smem = 2 * static_cast<size_t>(BLK) * SW * sizeof(float) +
                      static_cast<size_t>(BLK) * CF_RQ * 4 * sizeof(CT);
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // One wave of one block an SM: the (group, stripe) pairs, each split
  // into runs of whole tiles.
  const int pairs = ((kd + BLK - 1) / BLK) * ((f + SW - 1) / SW);
  const int n_tiles = (n_rows + BLK - 1) / BLK;
  int splits = (num_sms() + pairs - 1) / pairs;
  if (splits > n_tiles) splits = n_tiles;
  const dim3 grid(splits, pairs);
  kern<<<grid, CF_THREADS, smem, stream>>>(c, u, ld, out, n_rows, kd, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, bool BF16>
int dense_fwd_by_width(const void* c, const float* u, int ld, float* out,
                       int n_rows, int kd, int f, cudaStream_t s) {
  const CT* cc = static_cast<const CT*>(c);
  if (f <= 32)
    return launch_dense_fwd<CT, 1, BF16>(cc, u, ld, out, n_rows, kd, f, s);
  if (f <= 64)
    return launch_dense_fwd<CT, 2, BF16>(cc, u, ld, out, n_rows, kd, f, s);
  return launch_dense_fwd<CT, 4, BF16>(cc, u, ld, out, n_rows, kd, f, s);
}

// K1 loads four counts of a row at a time from a 16-byte boundary (kd is
// 128 x the dense groups in every layout) and copies U's rows 16 bytes at
// a time, each from a 16-byte boundary.
template <bool BF16>
int dense_fwd_by_type(const void* c, int c_dtype, const float* u, int ld,
                      float* out, int n_rows, int kd, int f, cudaStream_t s) {
  if (n_rows <= 0 || kd <= 0 || f <= 0) return static_cast<int>(cudaSuccess);
  if (kd % 4 != 0 || ld % 4 != 0 || ld < f ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (c_dtype) {
    case 0:
      return dense_fwd_by_width<int8_t, BF16>(c, u, ld, out, n_rows, kd, f,
                                              s);
    case 1:
      return dense_fwd_by_width<__nv_bfloat16, BF16>(c, u, ld, out, n_rows,
                                                     kd, f, s);
    case 2:
      return dense_fwd_by_width<float, BF16>(c, u, ld, out, n_rows, kd, f,
                                             s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename CT, int NC, bool FUSED, bool BF16>
int launch_dense_bwd_nc(const CT* c, const float* ct, float* out, int n_out,
                        int kd, int f, int rows_per_block, dim3 grid,
                        size_t smem, const int* starts, const int* desc,
                        const float* tail, cudaStream_t stream) {
  auto kern = dense_bwd_kernel<CT, NC, FUSED, BF16>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, RW_THREADS, smem, stream>>>(c, ct, out, n_out, kd, f,
                                            rows_per_block, starts, desc,
                                            tail);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, bool FUSED, bool BF16>
int launch_dense_bwd_fused(const CT* c, const float* ct, float* out,
                           int n_out, int kd, int f, int nc,
                           int rows_per_block, dim3 grid, size_t smem,
                           const int* starts, const int* desc,
                           const float* tail, cudaStream_t stream) {
  switch (nc) {
    case 1:
      return launch_dense_bwd_nc<CT, 1, FUSED, BF16>(
          c, ct, out, n_out, kd, f, rows_per_block, grid, smem, starts, desc,
          tail, stream);
    case 2:
      return launch_dense_bwd_nc<CT, 2, FUSED, BF16>(
          c, ct, out, n_out, kd, f, rows_per_block, grid, smem, starts, desc,
          tail, stream);
    default:
      return launch_dense_bwd_nc<CT, 4, FUSED, BF16>(
          c, ct, out, n_out, kd, f, rows_per_block, grid, smem, starts, desc,
          tail, stream);
  }
}

// The row walk needs kd % 4 == 0 and C aligned to 16 bytes (a lane's four
// counts in one load); kd is 128 x the dense groups in every layout.
template <typename CT, bool BF16>
int launch_dense_bwd(const void* c, const float* ct, float* out, int n_out,
                     int kd, int f, const int* starts, const int* desc,
                     const float* tail, cudaStream_t stream) {
  if (n_out <= 0 || f <= 0) return static_cast<int>(cudaSuccess);
  if (kd % 4 != 0 || reinterpret_cast<uintptr_t>(c) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Columns a lane: as few stripes as the width needs, narrower where the
  // staged ct stripe would crowd the SM.
  int nc = f <= 32 ? 1 : f <= 64 ? 2 : 4;
  while (nc > 1 && static_cast<size_t>(kd) * 32 * nc * 4 > RW_CT_CAP) nc /= 2;
  const int stripes = (f + 32 * nc - 1) / (32 * nc);
  // Rows a block: a DENSE_RB descriptor block, halved while that leaves
  // fewer than about four blocks an SM.
  int rows_per_block = DENSE_RB;
  while (rows_per_block > RW_MIN_ROWS &&
         static_cast<int64_t>((n_out + rows_per_block - 1) / rows_per_block) *
                 stripes <
             4LL * num_sms()) {
    rows_per_block /= 2;
  }
  const size_t smem = static_cast<size_t>(kd) * 32 * nc * sizeof(float) +
                      (starts != nullptr ? rows_per_block * sizeof(int) : 0);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + rows_per_block - 1) / rows_per_block, stripes);
  const CT* cc = static_cast<const CT*>(c);
  return starts != nullptr
             ? launch_dense_bwd_fused<CT, true, BF16>(
                   cc, ct, out, n_out, kd, f, nc, rows_per_block, grid, smem,
                   starts, desc, tail, stream)
             : launch_dense_bwd_fused<CT, false, BF16>(
                   cc, ct, out, n_out, kd, f, nc, rows_per_block, grid, smem,
                   nullptr, nullptr, nullptr, stream);
}

template <int VEC, int MODE, bool BF16>
int launch_chunk_walk(const int* a, const int* b, const int* eid,
                      const int* in_id, const int* out_id, int n_chunks,
                      int chunk, const float* e2, int n_e, int he, int rep,
                      const float* in, int n_in_rows, int ld, float* out,
                      int n_out_rows, int f, cudaStream_t stream) {
  constexpr int SW = 32 * VEC;
  auto kern = chunk_walk_kernel<VEC, MODE, BF16>;
  // Two windows, the partial and the crossing runs' pieces (floats), two
  // buffers of sorted slots, the counts, first slots, two chunks' (real
  // slots, window, out_id) and the pass flags (ints).
  const size_t smem =
      (MODE == kPlain ? 2 * BLK : 3 * BLK + CM_CONSUMERS) * SW *
          sizeof(float) +
      2 * static_cast<size_t>(chunk) * sizeof(ChunkSlot<MODE>) +
      (3 * BLK + 2 + 6 + CM_CONSUMERS) * sizeof(int);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, CM_THREADS,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  // One wave: as many blocks as fit on the card, each a run of chunks.
  const int stripes = (f + SW - 1) / SW;
  const int64_t target = static_cast<int64_t>(per_sm) * num_sms();
  int run = static_cast<int>(
      (static_cast<int64_t>(n_chunks) * stripes + target - 1) / target);
  if (run < 1) run = 1;
  const dim3 grid((n_chunks + run - 1) / run, stripes);
  kern<<<grid, CM_THREADS, smem, stream>>>(
      a, b, eid, in_id, out_id, n_chunks, chunk, run, e2, n_e, he, rep, in,
      n_in_rows, ld, out, n_out_rows, f);
  return static_cast<int>(cudaGetLastError());
}

// plain: K2 plain (eid and e2 null); else mul, one weight per edge
// (he == 1) or several heads.
template <int VEC, bool BF16>
int chunk_walk_by_mode(bool plain, const int* a, const int* b,
                       const int* eid, const int* in_id, const int* out_id,
                       int n_chunks, int chunk, const float* e2, int n_e,
                       int he, int rep, const float* in, int n_in_rows,
                       int ld, float* out, int n_out_rows, int f,
                       cudaStream_t s) {
  if (plain) {
    return launch_chunk_walk<VEC, kPlain, BF16>(
        a, b, eid, in_id, out_id, n_chunks, chunk, e2, n_e, he, rep, in,
        n_in_rows, ld, out, n_out_rows, f, s);
  }
  return he == 1 ? launch_chunk_walk<VEC, kOneHead, BF16>(
                       a, b, eid, in_id, out_id, n_chunks, chunk, e2, n_e, he,
                       rep, in, n_in_rows, ld, out, n_out_rows, f, s)
                 : launch_chunk_walk<VEC, kHeads, BF16>(
                       a, b, eid, in_id, out_id, n_chunks, chunk, e2, n_e, he,
                       rep, in, n_in_rows, ld, out, n_out_rows, f, s);
}

template <bool BF16>
int chunk_walk_by_width(bool plain, const int* a, const int* b,
                        const int* eid, const int* in_id, const int* out_id,
                        int n_chunks, int chunk, const float* e2, int n_e,
                        int he, int rep, const float* in, int n_in_rows,
                        int ld, float* out, int n_out_rows, int f,
                        cudaStream_t s) {
  // The producers load four slots at a time and copy the input's rows 16
  // bytes at a time, each from a 16-byte boundary.
  if (chunk > CM_MAX_CHUNK || chunk % 4 != 0 || ld % 4 != 0 || ld < f ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      (!plain && reinterpret_cast<uintptr_t>(eid) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f <= 32) {
    return chunk_walk_by_mode<1, BF16>(plain, a, b, eid, in_id, out_id,
                                       n_chunks, chunk, e2, n_e, he, rep, in,
                                       n_in_rows, ld, out, n_out_rows, f, s);
  }
  if (f <= 64) {
    return chunk_walk_by_mode<2, BF16>(plain, a, b, eid, in_id, out_id,
                                       n_chunks, chunk, e2, n_e, he, rep, in,
                                       n_in_rows, ld, out, n_out_rows, f, s);
  }
  return chunk_walk_by_mode<4, BF16>(plain, a, b, eid, in_id, out_id,
                                     n_chunks, chunk, e2, n_e, he, rep, in,
                                     n_in_rows, ld, out, n_out_rows, f, s);
}

// K2 rhs's instantiation: template <bool BF16, bool VEC, int LG>.
using RhsKernel = void (*)(const int*, const int*, const int*, const int*,
                           int, int, int, const float*, int, int, float*, int,
                           int);

template <bool BF16, bool VEC>
RhsKernel pick_rhs2(int lg) {
  switch (lg) {
    case 1: return chunk_rhs_kernel<BF16, VEC, 1>;
    case 2: return chunk_rhs_kernel<BF16, VEC, 2>;
    case 4: return chunk_rhs_kernel<BF16, VEC, 4>;
    case 8: return chunk_rhs_kernel<BF16, VEC, 8>;
    default: return chunk_rhs_kernel<BF16, VEC, 16>;
  }
}

RhsKernel pick_rhs(bool bf16, bool vec, int lg) {
  return bf16 ? (vec ? pick_rhs2<true, true>(lg) : pick_rhs2<true, false>(lg))
              : (vec ? pick_rhs2<false, true>(lg)
                     : pick_rhs2<false, false>(lg));
}

template <bool BF16>
int dense_bwd_by_type(const void* c, int c_dtype, const float* ct, float* out,
                      int n_out, int kd, int f, const int* starts,
                      const int* desc, const float* tail, cudaStream_t s) {
  switch (c_dtype) {
    case 0:
      return launch_dense_bwd<int8_t, BF16>(c, ct, out, n_out, kd, f, starts,
                                            desc, tail, s);
    case 1:
      return launch_dense_bwd<__nv_bfloat16, BF16>(c, ct, out, n_out, kd, f,
                                                   starts, desc, tail, s);
    case 2:
      return launch_dense_bwd<float, BF16>(c, ct, out, n_out, kd, f, starts,
                                           desc, tail, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int EPI, bool VEC>
cudaError_t launch_expand(const int* starts, const int* desc,
                          const float* merged, int m_rows, float* out,
                          int num_dst, int f, const float* diag_w, int he,
                          int rep, const float* diag_u, int n_diag,
                          cudaStream_t s) {
  static int per_sm = 0;
  auto kern = expand_kernel<EPI, VEC>;
  if (per_sm == 0) {
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, 0);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) per_sm = 1;
  }
  const int n_tiles = (num_dst + X_ROWS - 1) / X_ROWS;
  const int grid = n_tiles < per_sm * num_sms() ? n_tiles
                                                : per_sm * num_sms();
  kern<<<grid, NT, 0, s>>>(starts, desc, merged, m_rows, out, num_dst, f,
                           diag_w, he, rep, diag_u, n_diag);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t expand_by_vec(bool vec, const int* starts, const int* desc,
                          const float* merged, int m_rows, float* out,
                          int num_dst, int f, const float* diag_w, int he,
                          int rep, const float* diag_u, int n_diag,
                          cudaStream_t s) {
  return vec ? launch_expand<EPI, true>(starts, desc, merged, m_rows, out,
                                        num_dst, f, diag_w, he, rep, diag_u,
                                        n_diag, s)
             : launch_expand<EPI, false>(starts, desc, merged, m_rows, out,
                                         num_dst, f, diag_w, he, rep, diag_u,
                                         n_diag, s);
}

}  // namespace

extern "C" {

// c_dtype: 0 = int8, 1 = bfloat16, 2 = float32; c (rows x kd, kd a
// multiple of 4) on a 16-byte boundary. u has n_rows rows of f floats, ld
// floats apart (ld a multiple of 4, u on a 16-byte boundary). `out` (kd x
// f) must be zeroed. bf16: 1 for the bf16 mode.
int hub_dense_fwd(const void* c, int c_dtype, const float* u, float* out,
                  int n_rows, int kd, int f, int ld, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dense_fwd_by_type<true>(c, c_dtype, u, ld, out, n_rows, kd,
                                        f, s)
              : dense_fwd_by_type<false>(c, c_dtype, u, ld, out, n_rows, kd,
                                         f, s);
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

// in has n_in_rows rows of f floats, ld floats apart (ld a multiple of
// 4, in on a 16-byte boundary); chunks of at most 1024 slots, a multiple
// of 4, with a and b on 16-byte boundaries. `out` (n_out_rows x f) must be
// zeroed.
int hub_chunk_sum(const int* a, const int* b, const int* in_id,
                  const int* out_id, int n_chunks, int chunk, const float* in,
                  int n_in_rows, int ld, float* out, int n_out_rows, int f,
                  int bf16, void* stream) {
  if (n_chunks <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? chunk_walk_by_width<true>(true, a, b, nullptr, in_id, out_id,
                                          n_chunks, chunk, nullptr, 0, 1, 1,
                                          in, n_in_rows, ld, out, n_out_rows,
                                          f, s)
              : chunk_walk_by_width<false>(true, a, b, nullptr, in_id, out_id,
                                           n_chunks, chunk, nullptr, 0, 1, 1,
                                           in, n_in_rows, ld, out, n_out_rows,
                                           f, s);
}

// diag_w: null (no epilogue) or n_diag x he floats, f = he * rep;
// diag_u: null (EPI 1) or at least n_diag rows of f floats (EPI 2). out
// must start on a 16-byte boundary.
int hub_expand(const int* starts, const int* desc, const float* merged,
               int m_rows, float* out, int num_dst, int f,
               const float* diag_w, int he, int rep, const float* diag_u,
               int n_diag, void* stream) {
  if (num_dst <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = f % 4 == 0 && aligned(merged) &&
                   (diag_u == nullptr || aligned(diag_u));
  cudaError_t e;
  if (diag_w == nullptr)
    e = expand_by_vec<0>(vec, starts, desc, merged, m_rows, out, num_dst, f,
                         nullptr, 1, f, nullptr, 0, s);
  else if (diag_u == nullptr)
    e = expand_by_vec<1>(vec, starts, desc, merged, m_rows, out, num_dst, f,
                         diag_w, he, rep, nullptr, n_diag, s);
  else
    e = expand_by_vec<2>(vec, starts, desc, merged, m_rows, out, num_dst, f,
                         diag_w, he, rep, diag_u, n_diag, s);
  return static_cast<int>(e);
}

// mode: 0 = mul (in has n_in_rows rows of f = he * rep floats, ld floats
// apart: ld a multiple of 4 and in on a 16-byte boundary), 1 = rhs (in is
// null, f = he). `out` (n_out_rows x f) must be zeroed. bf16: 1 for the
// bf16 mode (as in every entry below but hub_expand).
int hub_chunk_weighted(int mode, const int* a, const int* b, const int* eid,
                       const int* in_id, const int* out_id, int n_chunks,
                       int chunk, const float* e2, int n_e, int he, int rep,
                       const float* in, int n_in_rows, int ld, float* out,
                       int n_out_rows, int f, int bf16, void* stream) {
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks <= 0 || f <= 0 || n_e <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    return bf16 ? chunk_walk_by_width<true>(false, a, b, eid, in_id, out_id,
                                            n_chunks, chunk, e2, n_e, he, rep,
                                            in, n_in_rows, ld, out,
                                            n_out_rows, f, s)
                : chunk_walk_by_width<false>(false, a, b, eid, in_id, out_id,
                                             n_chunks, chunk, e2, n_e, he,
                                             rep, in, n_in_rows, ld, out,
                                             n_out_rows, f, s);
  }
  const int stripes = (f + RSTRIPE - 1) / RSTRIPE;
  // Lanes a slot: the widest stripe's quads, rounded up to a power of two.
  const int quads = ((f < RSTRIPE ? f : RSTRIPE) + 3) / 4;
  const int lg = quads > 8 ? 16 : quads > 4 ? 8 : quads > 2 ? 4 : quads;
  const bool vec =
      (he & 3) == 0 && (reinterpret_cast<uintptr_t>(e2) & 15) == 0;
  RhsKernel kern = pick_rhs(bf16, vec, lg);
  int per_sm = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // One wave: as many blocks as fit on the card, each a run of chunks.
  const int64_t target = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) *
                         num_sms();
  int run = static_cast<int>(
      (static_cast<int64_t>(n_chunks) * stripes + target - 1) / target);
  if (run < 1) run = 1;
  dim3 grid((n_chunks + run - 1) / run, stripes);
  kern<<<grid, NT, 0, s>>>(a, b, eid, out_id, n_chunks, chunk, run, e2, n_e,
                           he, out, n_out_rows, f);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 = mul (u n_u rows and ct n_ct rows of he * rep floats, ldu and
// ldc floats apart), 1 = rhs (u null, ct n_ct x he). Every element of
// `out` ((n_chunks * chunk) x he) is written. mul: ws > 0 takes the staged
// walk with rows ws floats apart (ops/hub_kernels.py's edge_grad_plan; u
// and ct on 16-byte boundaries, ldu and ldc multiples of 4), ws = 0 the
// thread-per-item kernel.
int hub_edge_grad(int mode, const int* a, const int* b, const int* in_id,
                  const int* out_id, int n_chunks, int chunk, const float* u,
                  int n_u, int ldu, const float* ct, int n_ct, int ldc,
                  float* out, int he, int rep, int ws, int bf16,
                  void* stream) {
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks <= 0 || he <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    auto kern =
        bf16 ? edge_grad_rhs_kernel<true> : edge_grad_rhs_kernel<false>;
    kern<<<n_chunks, NT, 0, s>>>(a, b, out_id, chunk, ct, n_ct, out, he);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws == 0) {
    auto kern =
        bf16 ? edge_grad_items_kernel<true> : edge_grad_items_kernel<false>;
    kern<<<n_chunks, NT, 0, s>>>(a, b, in_id, out_id, chunk, u, n_u, ldu, ct,
                                 n_ct, ldc, out, he, rep);
    return static_cast<int>(cudaGetLastError());
  }
  const int f = he * rep, hu = (rep + 3) / 4;
  // Rows of whole heads: each head's units start on a 16-byte boundary.
  if (f > EG_MAX_COLS || (he > 1 && rep % 4 != 0) ||
      ws != 4 * he * hu + 4 || ldu % 4 != 0 || ldc % 4 != 0 ||
      ldu < 4 * he * hu || ldc < 4 * he * hu ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ct) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ct_sh = f <= EG_CT_COLS;
  auto kern = ct_sh ? (bf16 ? edge_grad_mul_kernel<true, true>
                            : edge_grad_mul_kernel<false, true>)
                    : (bf16 ? edge_grad_mul_kernel<true, false>
                            : edge_grad_mul_kernel<false, false>);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(BLK) * ws * (ct_sh ? 2 : 1);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, EG_NT,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  // One wave: as many blocks as fit on the card, each a run of chunks.
  const int target = per_sm * num_sms();
  const int cpb = (n_chunks + target - 1) / target;
  kern<<<(n_chunks + cpb - 1) / cpb, EG_NT, smem, s>>>(
      a, b, in_id, out_id, n_chunks, chunk, cpb, u, n_u, ldu, ct, n_ct, ldc,
      out, he, rep, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
