// Block-dense g-SpMM kernel (K11) for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes by dgl1_tpu_torch/ops/bdense_kernels.py, whose
// wrapper checks devices, types and shapes, allocates the output and counts
// launches. The entry point launches on the given stream and returns
// cudaGetLastError(); the wrapper raises when it is not 0.
//
// It replaces the Pallas kernel of dgl1_tpu/ops/engine_bdense.py:
//
//   K11  block_mm   <- _block_kernel / _block_call (engine_bdense.py:42,
//                      :70), forward and transpose
//
// Layout (bdense_format.py): K count blocks of 128 x 128 (bf16, exact
// small integers, or float32 when a count passes 256); block k is rows
// [k*128, (k+1)*128) of `a`, indexed (dst-local row, src-local column).
//
//   forward    out[rb*128 + i] = sum over the blocks k of rb row's run
//              ptr[rb] .. ptr[rb+1] (row_ptr over the rb-sorted `a`) of
//              sum_j A_k[i][j] * x[in_blk[k]*128 + j]     (in_blk = cb)
//   transpose  out[cb*128 + j] = sum over cb column's run (col_ptr over the
//              cb-sorted `ab`) of sum_i A_k[i][j] * x[in_blk[k]*128 + i]
//              (in_blk = rbb)
//
// x is (n_in, f) float32, unpadded: rows past n_in read as 0. out is
// (n_out, f) float32 and every element is written once; an output block
// row with an empty run gets zeros, so the reference's rb_mask / cb_mask
// pass is not needed.
//
// What bounds it on the card: operations, as written. Each block is dense
// float32 FMA over a 128 x 128 count matrix that is ~95% zeros on the
// geometric graphs: 2*K*128*128*f FLOP against K*32 KB of A and the rows
// of x and out. The TPU kernel ran the same product on the MXU and carried
// the output block across the sequential grid in VMEM. Here a thread block
// owns one output block row and one stripe of FS = 32 or 64 columns; it
// walks its run in order, stages A_k as float32 in shared memory (as its
// transpose in forward mode, as it is in transpose mode, so the compute
// loop is one and reads 8 consecutive floats per step either way, without
// bank conflicts) and the stripe of the 128 input rows, and accumulates the
// 128 x FS outputs in registers, 8 rows x 4 columns a thread, in float32.
// No atomics; the order of summation is fixed (blocks of the run in order,
// then the 128 terms in order), so the result does not change from run to
// run. Tensor cores, skipping zero sub-tiles and TMA staging are later
// work.
//
// BF16 (the reference's bf16 matmul mode, dgl1_tpu/ops/precision.py, which
// casts A and x to bfloat16 before the block product) rounds each count
// and each input value to bfloat16, nearest even, as it is staged; the
// sums stay float32 and so do the tensors in and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;
constexpr int TM = 8;                 // output rows per thread
constexpr int TN = 4;                 // output columns per thread
constexpr int ROW_GROUPS = BLK / TM;  // 16

template <typename AT>
__device__ __forceinline__ void load8(const AT* p, float v[8]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                    float v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// bf16 mode: round to bfloat16, nearest even, and back.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <int FS>
struct Tile {
  static constexpr int THREADS = ROW_GROUPS * (FS / TN);
  // sA (128 x 128) and sX (128 x FS) floats: 80 or 96 KB.
  static constexpr size_t SMEM = sizeof(float) * (size_t)BLK * (BLK + FS);
};

template <typename AT, int FS, bool TRANSPOSE, bool BF16>
__global__ void __launch_bounds__(Tile<FS>::THREADS)
block_mm_kernel(const AT* __restrict__ a, const int* __restrict__ ptr,
                const int* __restrict__ in_blk, const float* __restrict__ x,
                int n_in, int f, float* __restrict__ out, int n_out) {
  constexpr int THREADS = Tile<FS>::THREADS;
  constexpr int COL_GROUPS = FS / TN;
  extern __shared__ float4 smem4[];
  // sA[kk][r]: the kk-th term of output row r of this block (kk runs over
  // the reduced index: src-local j forward, dst-local i transposed).
  float* sA = reinterpret_cast<float*>(smem4);
  float* sX = sA + BLK * BLK;  // sX[kk][c]: input row kk, stripe column c

  const int ob = blockIdx.x;
  const int col0 = blockIdx.y * FS;
  const int tid = threadIdx.x;
  const int tx = tid % COL_GROUPS, ty = tid / COL_GROUPS;
  const int k0 = __ldg(ptr + ob), k1 = __ldg(ptr + ob + 1);

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  for (int k = k0; k < k1; ++k) {
    const AT* ak = a + (size_t)k * BLK * BLK;
    const int ib = __ldg(in_blk + k);
    for (int idx = tid; idx < BLK * BLK / 8; idx += THREADS) {
      float v[8];
      if (TRANSPOSE) {
        // sA[i][j] = A[i][j]: row i, eight columns, two float4 stores.
        const int i = idx / (BLK / 8), c8 = idx % (BLK / 8);
        load8<AT>(ak + i * BLK + c8 * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<BF16>(v[e]);
        float4* d = reinterpret_cast<float4*>(sA + i * BLK + c8 * 8);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        // sA[j][i] = A[i][j]: consecutive lanes take consecutive rows i,
        // so each of the eight stores is conflict-free.
        const int i = idx % BLK, c8 = idx / BLK;
        load8<AT>(ak + i * BLK + c8 * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sA[(c8 * 8 + e) * BLK + i] = rnd<BF16>(v[e]);
      }
    }
    const int row0 = ib * BLK;
    for (int idx = tid; idx < BLK * FS; idx += THREADS) {
      const int r = idx / FS, c = idx % FS;
      const int row = row0 + r, col = col0 + c;
      sX[idx] = (row < n_in && col < f)
                    ? rnd<BF16>(__ldg(x + (size_t)row * f + col))
                    : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLK; ++kk) {
      const float4* arow = reinterpret_cast<const float4*>(sA + kk * BLK);
      const float4 a0 = arow[ty * 2], a1 = arow[ty * 2 + 1];
      const float4 b = reinterpret_cast<const float4*>(sX + kk * FS)[tx];
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();  // sA / sX are rewritten for the next block
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = ob * BLK + ty * TM + r;
    if (row >= n_out) break;
    float* o = out + (size_t)row * f;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = col0 + tx * TN + c;
      if (col < f) o[col] = acc[r][c];
    }
  }
}

template <typename AT, int FS, bool TRANSPOSE, bool BF16>
int launch(const void* a, const int* ptr, const int* in_blk, const float* x,
           int n_in, int f, float* out, int n_out, int n_out_blocks,
           cudaStream_t stream) {
  auto kern = block_mm_kernel<AT, FS, TRANSPOSE, BF16>;
  constexpr size_t smem = Tile<FS>::SMEM;  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_out_blocks, (f + FS - 1) / FS);
  kern<<<grid, Tile<FS>::THREADS, smem, stream>>>(
      static_cast<const AT*>(a), ptr, in_blk, x, n_in, f, out, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, int FS, bool BF16>
int launch_dir(int transpose, const void* a, const int* ptr,
               const int* in_blk, const float* x, int n_in, int f,
               float* out, int n_out, int n_out_blocks, cudaStream_t s) {
  return transpose
             ? launch<AT, FS, true, BF16>(a, ptr, in_blk, x, n_in, f, out,
                                          n_out, n_out_blocks, s)
             : launch<AT, FS, false, BF16>(a, ptr, in_blk, x, n_in, f, out,
                                           n_out, n_out_blocks, s);
}

template <typename AT, bool BF16>
int launch_fs(int fs, int transpose, const void* a, const int* ptr,
              const int* in_blk, const float* x, int n_in, int f, float* out,
              int n_out, int n_out_blocks, cudaStream_t s) {
  return fs == 32
             ? launch_dir<AT, 32, BF16>(transpose, a, ptr, in_blk, x, n_in, f,
                                        out, n_out, n_out_blocks, s)
             : launch_dir<AT, 64, BF16>(transpose, a, ptr, in_blk, x, n_in, f,
                                        out, n_out, n_out_blocks, s);
}

template <bool BF16>
int launch_at(int a_is_bf16, int fs, int transpose, const void* a,
              const int* ptr, const int* in_blk, const float* x, int n_in,
              int f, float* out, int n_out, int n_out_blocks,
              cudaStream_t s) {
  return a_is_bf16
             ? launch_fs<__nv_bfloat16, BF16>(fs, transpose, a, ptr, in_blk,
                                              x, n_in, f, out, n_out,
                                              n_out_blocks, s)
             : launch_fs<float, BF16>(fs, transpose, a, ptr, in_blk, x, n_in,
                                      f, out, n_out, n_out_blocks, s);
}

}  // namespace

extern "C" {

// a: (K*128, 128) counts, bf16 when a_is_bf16 else float32; ptr:
// (n_out_blocks + 1,) run pointers; in_blk: (K,) input block per block; x:
// (n_in, f) float32; out: (n_out, f) float32, every element written.
// fs: the stripe width, 32 or 64. bf16: 1 for the bf16 mode.
int block_mm(int transpose, int a_is_bf16, const void* a, const int* ptr,
             const int* in_blk, const float* x, int n_in, int f, float* out,
             int n_out, int n_out_blocks, int fs, int bf16, void* stream) {
  if (fs != 32 && fs != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_at<true>(a_is_bf16, fs, transpose, a, ptr, in_blk, x,
                                n_in, f, out, n_out, n_out_blocks, s)
              : launch_at<false>(a_is_bf16, fs, transpose, a, ptr, in_blk, x,
                                 n_in, f, out, n_out, n_out_blocks, s);
}

}  // extern "C"
