// Device helpers shared by the hand-written Hopper kernels of this package.
//
// Selection contract (ops/topk.select_topk, XLA's top_k): value
// descending in IEEE total order (+0 above -0), ties to the LOWEST item id.
// Values are compared through order_key, a signed int monotone in the float.
// A selected entry is knocked out to -inf, strictly below every value a
// score row holds (finite scores, the -1024 seen sentinel, the -3e38
// exclusion sentinel), so k selections give k distinct ids whenever a row
// holds at least k entries.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace lgcnhs {

constexpr int kThreads = 256;  // 8 warps per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr float kSeenValue = -1024.0f;  // ops/topk.MASK_VALUE
constexpr float kExcluded = -3.0e38f;   // serving: seen items

__device__ __forceinline__ float knocked_out() { return -CUDART_INF_F; }

// Signed int with the float's total order (non-NaN): flip the magnitude
// bits of negatives. An involution, so it also maps a key back to bits.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// (key, i) ranks before (bkey, bi): value descending, then id ascending.
__device__ __forceinline__ bool ranks_before(int key, int i, int bkey, int bi) {
  return key > bkey || (key == bkey && i < bi);
}

// Warp-wide best (key, i, p) under ranks_before; every lane ends with it.
// p rides along (the position of the winner in its buffer).
__device__ __forceinline__ void warp_best(int& key, int& i, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const int op = __shfl_xor_sync(0xffffffffu, p, off);
    if (ranks_before(ok, oi, key, i)) {
      key = ok;
      i = oi;
      p = op;
    }
  }
}

// One warp selects the k best of n >= k entries, in rank order. Entry p is
// read through at(p, key, id); emit(t, key, id) receives the t-th best;
// knock(p) must knock entry p out (to -inf). Segment-cached: lane s keeps
// the best of the contiguous segment s of ceil(n/32) entries, so each of
// the k steps is one warp reduction over the 32 cached bests plus a rescan
// of the winner's segment by all lanes (coalesced, about n/1024 reads per
// lane), not a pass over all n entries.
template <typename At, typename Knock, typename Emit>
__device__ __forceinline__ void warp_select(int n, int k, At at, Knock knock,
                                            Emit emit) {
  const int lane = threadIdx.x & 31;
  const int none = order_key(knocked_out());
  const int seg = (n + 31) >> 5;
  auto seg_best = [&](int s, int& bk, int& bi, int& bp) {
    bk = none;
    bi = INT_MAX;
    bp = -1;
    const int hi = min(n, (s + 1) * seg);
    for (int p = s * seg + lane; p < hi; p += 32) {
      int key, id;
      at(p, key, id);
      if (ranks_before(key, id, bk, bi)) {
        bk = key;
        bi = id;
        bp = p;
      }
    }
    warp_best(bk, bi, bp);
  };
  int my_key = none, my_id = INT_MAX, my_pos = -1;  // best of segment `lane`
  for (int s = 0; s < 32; ++s) {
    int bk, bi, bp;
    seg_best(s, bk, bi, bp);
    if (lane == s) {
      my_key = bk;
      my_id = bi;
      my_pos = bp;
    }
  }
  for (int t = 0; t < k; ++t) {
    int bk = my_key, bi = my_id, bs = lane;
    warp_best(bk, bi, bs);  // bs: the winning segment
    const int bp = __shfl_sync(0xffffffffu, my_pos, bs);
    if (lane == 0) {
      emit(t, bk, bi);
      if (bp >= 0) knock(bp);
    }
    __syncwarp();
    int sk, si, sp;
    seg_best(bs, sk, si, sp);
    if (lane == bs) {
      my_key = sk;
      my_id = si;
      my_pos = sp;
    }
  }
}

// One warp selects the k best entries of row[0, n) (ids = positions) into
// out_idx/out_val (global memory, k slots), knocking each out in row.
__device__ __forceinline__ void warp_select_row(float* row, int n, int k,
                                                int32_t* out_idx,
                                                float* out_val) {
  warp_select(
      n, k,
      [&](int p, int& key, int& id) {
        key = order_key(row[p]);
        id = p;
      },
      [&](int p) { row[p] = knocked_out(); },
      [&](int t, int key, int id) {
        out_idx[t] = id;
        out_val[t] = key_value(key);
      });
}

// Scores of R users (rows of us, D wide, in shared memory) against item j,
// read from the transposed (D, I) item table: coalesced across threads that
// hold neighbouring j. Summation over d in ascending order, f32 FMA. The
// item column is fetched kDepth values at a time, all loads issued before
// the FMAs, so a thread waits on L2 once per kDepth values, not per value.
constexpr int kDepth = 8;

template <int R>
__device__ __forceinline__ void user_item_dots(const float* us,
                                               const float* __restrict__ itT,
                                               int I, int D, int j,
                                               float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  const float* col = itT + j;
  int d = 0;
  for (; d + kDepth <= D; d += kDepth) {
    float x[kDepth];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) x[q] = __ldg(col + (size_t)(d + q) * I);
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(us[r * D + d + q], x[q], acc[r]);
    }
  }
  for (; d < D; ++d) {
    const float x = __ldg(col + (size_t)d * I);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(us[r * D + d], x, acc[r]);
  }
}

// Copies R user rows (zeros past row U) into shared memory.
template <int R>
__device__ __forceinline__ void load_user_rows(float* us,
                                               const float* __restrict__ u,
                                               int u0, int U, int D) {
  for (int p = threadIdx.x; p < R * D; p += blockDim.x) {
    const int r = p / D;
    us[p] = (u0 + r < U) ? u[(size_t)(u0 + r) * D + p % D] : 0.0f;
  }
}

}  // namespace lgcnhs

// Largest dynamic shared memory one block may opt in to on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin); the Python dispatch guards
// size every kernel against it. -1 on error.
extern "C" int lgcnhs_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

extern "C" const char* lgcnhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sets the block's dynamic shared memory and launches; returns the launch's
// cudaError_t (a refused launch never runs and is only seen here).
template <typename Kernel, typename... Args>
static int lgcnhs_launch(Kernel kernel, int blocks, size_t smem,
                         void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, lgcnhs::kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
