// Dual propagation product for Hopper (sm_90a): (R @ X, R^T @ Y) with f32
// outputs, the two half-steps of one LightGCN layer.
//
// Replaces lgcnhs_tpu/ops/pallas/propagation.py dual_matmul (_dual_impl,
// pl.pallas_call at :142). Its custom VJP (:163-194) is this same launcher
// on the swapped cotangents, so the backward is this kernel too.
//
// Operands (R, X = Y's dtype): (f32, f32), (bf16, bf16), (int8, bf16),
// (int8, f32). Every product is formed and summed in f32 (fmaf); products
// of bf16 or 0/1 operands are exact there.
//
// What bounds it: bytes. Dense, one call is 4*U*I*D operations (5.7 GFLOP
// at ML-1M, 6040 x 3706, D=64), but the training incidence is 2.4% dense,
// and skipping R's zeros is exact for finite X and Y: the data needs
// 4*nnz*D operations (0.14 GFLOP), while R alone is 22.4 MB of int8 to
// read, about 7 us at 3.35 TB/s.
//
// Design. The TPU kernel keeps the R^T @ Y accumulator resident across a
// sequential grid of user tiles. Hopper blocks run in parallel, and a
// column of R is a strided read, so the kernel takes R and its transpose
// RT (built once by its caller: the trainer, once per run, as the
// incidence is constant) and computes both products as the same row scan,
// in one launch with two block roles: blocks [0, I) give out_i = RT @ Y,
// the rest out_u = R @ X. The two reads of R cost 2x the bound's bytes;
// at ML-1M the int8 R and RT fit the 50 MB L2.
//
// One block owns one output row r; its 8 warps split the row's columns
// into 8 contiguous segments, so a row with thousands of nonzeros (a hot
// item's column) is shared by the whole block. Each warp
// - reads its segment of A[r, :] in 16-byte vectors (one per lane per
//   pass: 512 int8 entries a warp), and compacts the nonzeros (column, value) into its
//   shared-memory buffer, columns ascending;
// - walks the buffer kBatch entries at a time: the kBatch B rows are
//   loaded together, then accumulated in order into its partial of
//   out[r, d] (lane owns d = lane + 32 m, m < DPL).
// The block then sums the 8 partials in warp order. Every output element
// is summed in one fixed order, with no atomics: two launches on the same
// inputs give bitwise equal results.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

using namespace lgcnhs;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCap = 512;   // buffer entries per warp >= one chunk of 32 int8 vectors
constexpr int kChunks = 1;  // 16-byte vectors per lane per pass
constexpr int kBatch = 8;   // B rows loaded together (more costs occupancy)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// Per element type: V elements per 16-byte vector, the V-bit mask of its
// nonzero elements (-0 counts as zero), and element v as f32.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int V = 4;
  __device__ static unsigned nonzero(const uint4& r) {
    return ((r.x & 0x7fffffffu) != 0) | (((r.y & 0x7fffffffu) != 0) << 1) |
           (((r.z & 0x7fffffffu) != 0) << 2) | (((r.w & 0x7fffffffu) != 0) << 3);
  }
  __device__ static float get(const uint4& r, int v) { return __uint_as_float(word(r, v)); }
};
template <>
struct Elem<__nv_bfloat16> {  // bf16 bits are the high half of the f32
  static constexpr int V = 8;
  __device__ static unsigned pair(unsigned w) {
    return ((w & 0x7fffu) != 0) | (((w & 0x7fff0000u) != 0) << 1);
  }
  __device__ static unsigned nonzero(const uint4& r) {
    return pair(r.x) | (pair(r.y) << 2) | (pair(r.z) << 4) | (pair(r.w) << 6);
  }
  __device__ static float get(const uint4& r, int v) {
    const unsigned w = word(r, v >> 1);
    return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <>
struct Elem<int8_t> {
  static constexpr int V = 16;
  // byte flags 0/1 at bits 0, 8, 16, 24; the multiply moves byte i's flag
  // to bit 28 + i (the products' bit positions 8i + 7j are all distinct)
  __device__ static unsigned quad(unsigned w) {
    return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204081u) >> 28;
  }
  __device__ static unsigned nonzero(const uint4& r) {
    return quad(r.x) | (quad(r.y) << 4) | (quad(r.z) << 8) | (quad(r.w) << 12);
  }
  __device__ static float get(const uint4& r, int v) {
    return static_cast<float>(static_cast<int8_t>((word(r, v >> 2) >> (8 * (v & 3))) & 0xffu));
  }
};

// The 16 bytes at ptr (16-byte aligned); bytes at or past `end` read as
// zero and are not read.
__device__ __forceinline__ uint4 load_vec(const void* ptr, const void* end) {
  const unsigned char* b = static_cast<const unsigned char*>(ptr);
  const unsigned char* e = static_cast<const unsigned char*>(end);
  if (b + 16 <= e) return __ldg(static_cast<const uint4*>(ptr));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (b + i < e) w[i >> 2] |= (unsigned)b[i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Accumulates the buffered entries [0, n) into acc, kBatch B rows at a time.
template <typename TB, int DPL>
__device__ __forceinline__ void drain(const int* idx, const float* val, int n,
                                      const TB* __restrict__ B, int D,
                                      float (&acc)[DPL]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int p = 0; p < n; p += kBatch) {
    float rv[kBatch], x[kBatch][DPL];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool on = p + b < n;
      const int j = on ? idx[p + b] : 0;
      rv[b] = on ? val[p + b] : 0.0f;
#pragma unroll
      for (int m = 0; m < DPL; ++m) {
        const int d = lane + 32 * m;
        x[b][m] = (on && d < D) ? to_f(B[(size_t)j * D + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (p + b < n) {
#pragma unroll
        for (int m = 0; m < DPL; ++m) acc[m] = fmaf(rv[b], x[b][m], acc[m]);
      }
    }
  }
  __syncwarp();
}

// acc = sum over nonzero A[r, c], c in [c_lo, c_hi) ascending, of
// A[r, c] * B[c, :] (lane's d = lane + 32 m).
template <typename TA, typename TB, int DPL>
__device__ __forceinline__ void segment_product(const TA* __restrict__ A, int rows, int cols,
                                                const TB* __restrict__ B, int D, int r,
                                                int c_lo, int c_hi, int* idx, float* val,
                                                float (&acc)[DPL]) {
  constexpr int V = Elem<TA>::V;
  const int lane = threadIdx.x & 31;
  const TA* end = A + (size_t)rows * cols;
  const TA* row = A + (size_t)r * cols;
  const int mis = (int)(((size_t)r * cols) % V);  // row - mis is 16-byte aligned
#pragma unroll
  for (int m = 0; m < DPL; ++m) acc[m] = 0.0f;
  int count = 0;
  for (int c0 = c_lo - (c_lo + mis) % V; c0 < c_hi; c0 += 32 * V * kChunks) {
    uint4 raw[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = c0 + (k * 32 + lane) * V;
      raw[k] = c < c_hi ? load_vec(row + c, end) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = c0 + (k * 32 + lane) * V;
      const int lo = max(0, c_lo - c), hi = min(V, c_hi - c);
      unsigned bits = hi > lo ? Elem<TA>::nonzero(raw[k]) & ((1u << hi) - (1u << lo)) : 0u;
      const int n = __popc(bits);
      int incl = n;  // inclusive scan of n over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int total_k = __shfl_sync(kFull, incl, 31);
      if (total_k == 0) continue;  // warp-uniform
      if (count + total_k > kCap) {
        drain<TB, DPL>(idx, val, count, B, D, acc);
        count = 0;
      }
      int o = count + incl - n;
      while (bits) {
        const int v = __ffs(bits) - 1;
        bits &= bits - 1;
        idx[o] = c + v;
        val[o] = Elem<TA>::get(raw[k], v);
        ++o;
      }
      count += total_k;
    }
  }
  drain<TB, DPL>(idx, val, count, B, D, acc);
}

// Block b < I: out_i row b of RT @ Y; block I + u: out_u row u of R @ X.
// The item rows go first: the hottest rows are items (thousands of users),
// and started first their long chains overlap the many short rows.
template <typename TR, typename TE, int DPL>
__global__ void __launch_bounds__(kThreads)
    dual_kernel(const TR* __restrict__ R, const TR* __restrict__ RT,
                const TE* __restrict__ X, const TE* __restrict__ Y,
                float* __restrict__ out_u, float* __restrict__ out_i, int U, int I, int D) {
  __shared__ int s_idx[kWarps][kCap];
  __shared__ float s_val[kWarps][kCap];
  __shared__ float s_part[kWarps][32 * DPL];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const bool users = (int)blockIdx.x >= I;
  const int r = users ? blockIdx.x - I : blockIdx.x;
  const int cols = users ? I : U;
  // 8 column segments, each a whole number of 16-byte vectors
  constexpr int V = Elem<TR>::V;
  const int seg = ((cols + kWarps - 1) / kWarps + V - 1) / V * V;
  const int c_lo = min(cols, w * seg), c_hi = min(cols, c_lo + seg);
  float acc[DPL];
  if (users)
    segment_product<TR, TE, DPL>(R, U, I, X, D, r, c_lo, c_hi, s_idx[w], s_val[w], acc);
  else
    segment_product<TR, TE, DPL>(RT, I, U, Y, D, r, c_lo, c_hi, s_idx[w], s_val[w], acc);
#pragma unroll
  for (int m = 0; m < DPL; ++m) s_part[w][lane + 32 * m] = acc[m];
  __syncthreads();
  if (w == 0) {
    float* out = users ? out_u : out_i;
#pragma unroll
    for (int m = 0; m < DPL; ++m) {
      const int d = lane + 32 * m;
      float sum = s_part[0][d];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) sum += s_part[v][d];
      if (d < D) out[(size_t)r * D + d] = sum;
    }
  }
}

template <typename TR, typename TE, int DPL>
int launch_dual(const void* R, const void* RT, const void* X, const void* Y, int U,
                int I, int D, float* out_u, float* out_i, void* stream) {
  return lgcnhs_launch(dual_kernel<TR, TE, DPL>, U + I, 0, stream,
                       static_cast<const TR*>(R), static_cast<const TR*>(RT),
                       static_cast<const TE*>(X), static_cast<const TE*>(Y), out_u,
                       out_i, U, I, D);
}

template <typename TR, typename TE>
int launch_width(const void* R, const void* RT, const void* X, const void* Y, int U,
                 int I, int D, float* out_u, float* out_i, void* stream) {
  if (D <= 32) return launch_dual<TR, TE, 1>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
  if (D <= 64) return launch_dual<TR, TE, 2>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
  return launch_dual<TR, TE, 4>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (ops/cuda/propagation.py).
// R (U, I) and RT (I, U) contiguous and 16-byte aligned; 1 <= D <= 128.
extern "C" int dual_matmul_launch(int r_code, int e_code, const void* R, const void* RT,
                                  const void* X, const void* Y, int U, int I, int D,
                                  float* out_u, float* out_i, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (e_code == 0 && r_code == 0)
    return launch_width<float, float>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
  if (e_code == 0 && r_code == 2)
    return launch_width<int8_t, float>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
  if (e_code == 1 && r_code == 1)
    return launch_width<__nv_bfloat16, __nv_bfloat16>(R, RT, X, Y, U, I, D, out_u, out_i,
                                                      stream);
  if (e_code == 1 && r_code == 2)
    return launch_width<int8_t, __nv_bfloat16>(R, RT, X, Y, U, I, D, out_u, out_i, stream);
  return (int)cudaErrorInvalidValue;
}
