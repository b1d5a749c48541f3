// Fused LGCNHS serving for Hopper (sm_90a): G = u.i^T, F = A.W, the fused
// score G*F with seen items excluded, and top-k, without writing any (U, I)
// intermediate to device memory.
//
// Replaces lgcnhs_tpu/ops/pallas/fusion_serve.py fused_lgcnhs_serve
// (pl.pallas_call at :157).
//
// What bounds it: F = A.W. Dense it is U*I*I FMAs (166 GFLOP at ML-1M);
// the kernel takes A as CSR (built by the wrapper) and skips its zeros,
// which is exact for finite W, so the work is nnz(A)*I FMAs (A is about 4%
// dense there) plus the W rows those terms read: about nnz(A) * I * 4
// bytes through L2, ~9 GB at ML-1M, against a 55 MB W. Operands and sums
// are f32 (the TPU kernel runs native bf16-rounded operands; f32 is
// stricter).
//
// Design. A block owns kRows users and keeps their fused rows (kRows * I
// f32) in dynamic shared memory. F is built one column tile of kColTile
// items at a time, every block walking the tiles in the same order, so the
// blocks resident together read each W column tile (I x kColTile f32,
// 15 MB at ML-1M) from L2 rather than from device memory; within a tile a
// thread owns kColsPerThread columns and sums a_n * W[l_n, j] over the
// user's nonzeros in ascending column order (deterministic). Then G comes
// from the transposed item table as in retrieval.cu, the row becomes
// where(seen, -3e38, G*F), and one warp per user selects the top k.
//
// Exclusion and ties follow the plain serving chain (_serve_unfused): seen
// items score -3e38, and selected entries are knocked out to -inf, below
// it. A user with fewer than k unseen items therefore gets distinct ids,
// its seen items lowest id first. (The Pallas kernel knocks out to -3e38
// and repeats an id in that tail; that is its quirk, not this contract.)
#include "common.cuh"

namespace {

using namespace lgcnhs;

constexpr int kRows = 4;  // users per block; ops/cuda/fusion_serve.py ROWS
constexpr int kColsPerThread = 4;
constexpr int kColTile = kThreads * kColsPerThread;

__global__ void __launch_bounds__(kThreads)
    fused_serve_kernel(const float* __restrict__ u,
                       const float* __restrict__ itT,
                       const int* __restrict__ a_ptr,
                       const int* __restrict__ a_col,
                       const float* __restrict__ a_val,
                       const float* __restrict__ W,
                       const uint8_t* __restrict__ seen, int U, int I, int D,
                       int k, int32_t* __restrict__ idx,
                       float* __restrict__ vals) {
  extern __shared__ float smem[];
  float* us = smem;            // (kRows, D)
  float* sc = us + kRows * D;  // (kRows, I)
  const int u0 = blockIdx.x * kRows;
  const int nr = min(kRows, U - u0);

  load_user_rows<kRows>(us, u, u0, U, D);

  // F rows, one column tile at a time (see above): thread t owns columns
  // c0 + t + m * kThreads of the tile
  for (int c0 = 0; c0 < I; c0 += kColTile) {
    for (int r = 0; r < nr; ++r) {
      float f[kColsPerThread];
#pragma unroll
      for (int m = 0; m < kColsPerThread; ++m) f[m] = 0.0f;
      const int end = __ldg(a_ptr + u0 + r + 1);
      for (int n = __ldg(a_ptr + u0 + r); n < end; ++n) {
        const float a = __ldg(a_val + n);
        const float* wrow = W + (size_t)__ldg(a_col + n) * I + c0 + threadIdx.x;
#pragma unroll
        for (int m = 0; m < kColsPerThread; ++m) {
          if (c0 + threadIdx.x + m * kThreads < I)
            f[m] = fmaf(a, __ldg(wrow + m * kThreads), f[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kColsPerThread; ++m) {
        const int j = c0 + threadIdx.x + m * kThreads;
        if (j < I) sc[r * I + j] = f[m];
      }
    }
  }
  __syncthreads();

  // fused rows: where(seen, -3e38, G * F)
  for (int j = threadIdx.x; j < I; j += blockDim.x) {
    float g[kRows];
    user_item_dots<kRows>(us, itT, I, D, j, g);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
        const float f = sc[r * I + j];
        sc[r * I + j] =
            seen[(size_t)(u0 + r) * I + j] ? kExcluded : g[r] * f;
      }
    }
  }
  __syncthreads();

  const int w = threadIdx.x >> 5;
  for (int r = w; r < nr; r += kWarps) {
    const size_t o = (size_t)(u0 + r) * k;
    warp_select_row(sc + r * I, I, k, idx + o, vals + o);
  }
}

}  // namespace

extern "C" int fused_lgcnhs_serve_launch(const float* u, const float* itT,
                                         const int* a_ptr, const int* a_col,
                                         const float* a_val, const float* W,
                                         const uint8_t* seen, int U, int I,
                                         int D, int k, int32_t* idx,
                                         float* vals, void* stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * (D + I);
  return lgcnhs_launch(fused_serve_kernel, (U + kRows - 1) / kRows, smem,
                       stream, u, itT, a_ptr, a_col, a_val, W, seen, U, I, D,
                       k, idx, vals);
}
