// Dual propagation product for Hopper (sm_90a): (R @ X, R^T @ Y) with f32
// outputs, the two half-steps of one LightGCN layer.
//
// Replaces lgcnhs_tpu/ops/pallas/propagation.py dual_matmul (_dual_impl,
// pl.pallas_call at :142). Its custom VJP (:163-194) is this same launcher
// on the swapped cotangents, so the backward is this kernel too.
//
// Operands (R, X = Y's dtype): (f32, f32), (bf16, bf16), (int8, bf16),
// (int8, f32). Outputs are f32.
//
// What bounds it: bytes. At ML-1M (6040 x 3706, D=64) the int8 R alone is
// 22.4 MB, 6.7 us at 3.35 TB/s, and with X, Y and the two outputs the
// call moves 26 MB: 7.8 us. The dense product is 4*U*I*D = 5.7 GFLOP,
// 5.8 us at the bf16 tensor-core rate (989 TFLOP/s), under the bytes even
// though the training incidence is only 2.4% dense.
//
// Design. A dense tile product on the tensor cores, so that neither the
// nonzeros' gather latency nor the degree skew (hot items have thousands
// of users) sets the time: every tile costs the same. One launch, two
// block roles over R in its own (row-major) layout, no transposed copy:
// - role I: out_i[j0:j0+BM, :] = R[:, j0:j0+BM]^T Y, over chunks of 64 users;
// - role U: out_u[u0:u0+BM, :] = R[u0:u0+BM, :] X, over chunks of 64 items.
// BM is 128 rows for the bf16 pairs up to D=64 (X and Y are re-read from
// L2 once per tile, so tall tiles halve that traffic), else 64. A chunk is
// the R tile (rows are users, columns items) and 64 rows of X or Y (DT
// wide: D rounded up to 16, 32, 64 or 128), brought through a kStages ring
// of 16-byte cp.async copies (zero-filled past the edges), so the loads of
// later chunks overlap this chunk's products.
// Filling the card: role I has ceil(I/BM) tiles, role U ceil(U/BM), too few
// and too long (95 chunks for a role-I tile at ML-1M) for 132 SMs. So the
// depth is split (split-K): tile t, split s sums chunks [s*cs, (s+1)*cs),
// the splits chosen by the caller (ops/cuda/propagation.py dual_splits) so
// that all blocks are resident at once. With more than one split a block
// writes its partial to the caller's workspace, and a second kernel sums
// the partials in split order: a fixed order, no atomics.
// R's rows must be 16-byte aligned: the caller passes R with a padded row
// stride (pad_for_dual); entries past column I never reach an output.
// - bf16 pairs: mma.sync m16n8k16 (bf16 in, f32 accumulate); each warp owns
//   32 rows (two m16 strips) x DT/kWN columns of the tile. X and Y fragments come through
//   ldmatrix.trans from a swizzled tile (conflict-free rows).
//   * int8 R is widened in registers, never in shared memory: a thread
//     reads 32-bit words of the raw int8 chunk and turns each byte pair
//     into a bf16 pair (non-negative bytes take a bit-level path,
//     bf16(128 + b) - 128, with no int-to-float conversions; both exact).
//     A word holds 4 consecutive k, where the mma wants k pairs 8 apart, so
//     k is permuted within each 16 (slots 2t, 2t+1, 2t+8, 2t+9 hold k 4t..
//     4t+3) and the X/Y rows are loaded in the same permuted order: the sum
//     over k is unchanged. Role I reads R^T without a transposed copy: a
//     thread reads 4 items at 4 consecutive users (four words), transposes
//     the 4x4 bytes with byte permutes and owns those 4 items as rows of
//     its two m16 strips (the output rows are permuted to match).
//   * bf16 R is loaded by ldmatrix (role U) or ldmatrix.trans (role I, R^T
//     without a transposed copy).
//   The f32 sums are two-level: each 64-deep chunk is summed from zero in
//   the mma's accumulators, and the chunk's sum is added into f32 registers
//   (a rounded add), chunks in ascending order. The mma's own adds do not
//   round to nearest: kept across a whole depth, the sums of 100,000
//   positive bf16-exact products sat 1.5e-4 of scale below the exact (f64)
//   sums, all of one sign, against 4e-7 for the f32 matmul; the two-level
//   sum holds them within 1.8e-6 (2.3e-7 at 30,000), for ~3% more time at
//   ML-1M (0.0896 against 0.0869 ms; tools/dual_accum.py on an H100 80GB
//   HBM3 at 700 W). The contract is f32 accumulation (JAX's
//   preferred_element_type=f32).
// - f32 pairs (kept full f32: no TF32): the same chunks, f32 FMAs on the
//   CUDA cores, one fmaf chain per output over a split's ascending k.
// Every output element is summed in one fixed order with no atomics: two
// launches on the same inputs and device are bitwise equal, and products
// and sums of dyadic inputs are exact. As a dense product it also gives the
// twin's 0 * inf = NaN.
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

using namespace lgcnhs;

constexpr int kTile = 64;   // depth of one chunk
constexpr int kStages = 4;  // chunks in the copy ring

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Tile shapes and shared-memory layout of one block (exported below; the
// CPU tests hold ops/cuda/propagation.py smem_bytes against it).
template <typename TR, typename TE, int DT>
struct Layout {
  static constexpr bool kMma = std::is_same<TE, __nv_bfloat16>::value;
  static constexpr bool kRegA = kMma && sizeof(TR) == 1;  // int8 R widened in registers
  static constexpr int kBM = (kMma && DT <= 64) ? 128 : 64;  // output rows of a block
  // warps: kWM along the rows (kMI m16 strips each, an even number) x kWN
  // along the columns (kNW n8 blocks each)
  static constexpr int kMI = 2;
  static constexpr int kWM = kBM / (16 * kMI), kWN = kWarps / kWM, kNW = DT / (8 * kWN);
  // blocks an SM that the registers must allow (__launch_bounds__)
  static constexpr int kMinBlocks = (kMma && DT <= 64) ? 2 : 1;
  // the raw R chunk: role U kBM x 64 (users x items), role I 64 x kBM;
  // rows padded by 16 bytes (bank spread), but role I's int8 rows are
  // swizzled instead (ri_chunk)
  static constexpr int kVR = 16 / (int)sizeof(TR);
  static constexpr int kRawU = kBM * (kTile + kVR) * (int)sizeof(TR);
  static constexpr int kRawI = kTile * (kBM + (kRegA ? 0 : kVR)) * (int)sizeof(TR);
  static constexpr int kRawBytes = cmax(kRawU, kRawI);
  // X/Y rows: swizzled bf16 (e_chunk), f32 padded by 8 entries
  static constexpr int kES = kMma ? DT : DT + 8;
  static constexpr int kEBytes = kTile * kES * (int)sizeof(TE);
  static constexpr int kStageBytes = kRawBytes + kEBytes;
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(!kMma || kNW >= 1, "a warp owns at least one n8 block");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// Bytes 0,1 (kHi false) or 2,3 (kHi true) of x, int8, as a bf16 pair.
template <bool kHi>
__device__ __forceinline__ unsigned widen_pair(unsigned x, bool nonneg) {
  if (nonneg) {  // b in [0, 127]: the bf16 with bits 0x4300 | b is 128 + b exactly
    const unsigned v = __byte_perm(x, 0x43434343u, kHi ? 0x7362 : 0x5140);
    const __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     __floats2bfloat162_rn(128.0f, 128.0f));
    return *reinterpret_cast<const unsigned*>(&h);
  }
  const int lo = static_cast<int8_t>(x >> (kHi ? 16 : 0)), hi = static_cast<int8_t>(x >> (kHi ? 24 : 8));
  const __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const unsigned*>(&h);
}

// Physical 16-byte chunk of chunk c in row r of the X/Y tile (CPR chunks a
// row, no padding): the 8 rows that one ldmatrix phase reads (0..7 or
// 8..15; with the permuted k, 0,1,4,5,8,9,12,13 or those + 2) land in 8
// different bank groups (two-way conflicts remain at CPR = 2).
template <int CPR, bool kPerm>
__device__ __forceinline__ int e_chunk(int r, int c) {
  int h;
  if constexpr (CPR >= 8)
    h = kPerm ? (((r >> 1) & 6) | (r & 1)) : (r & 7);
  else if constexpr (CPR == 4)
    h = kPerm ? ((r >> 2) & 3) : ((r >> 1) & 3);
  else
    h = (r >> 2) & 1;
  return c ^ h;
}

// Physical 16-byte chunk of chunk c in row r of role I's raw int8 tile
// (CR chunks a row, no padding): a thread reads rows 16kk + 4t + j (t =
// lane & 3), so rows 4 apart go to different bank groups.
template <int CR>
__device__ __forceinline__ int ri_chunk(int r, int c) {
  return c ^ ((2 * ((r >> 2) & 3)) & (CR - 1));
}

// The chunk's R tile, rows [r0, r0+RR) x columns [c0, c0+RC): its copies
// into the raw buffer rs (row stride RC + 16 bytes, or RC swizzled).
template <typename TR, int RR, int RC, bool kSwz>
__device__ __forceinline__ void load_r(TR* rs, const TR* __restrict__ R, int ldr, int r0,
                                       int c0, int U, int I) {
  constexpr int V = 16 / (int)sizeof(TR), CR = RC / V, RS = kSwz ? RC : RC + V;
  for (int p = threadIdx.x; p < RR * CR; p += kThreads) {
    const int row = p / CR, ch = p % CR;
    const bool ok = r0 + row < U && c0 + ch * V < I;
    const int pc = kSwz ? ri_chunk<CR>(row, ch) : ch;
    cp_async16(rs + row * RS + pc * V, ok ? R + (size_t)(r0 + row) * ldr + c0 + ch * V : R, ok);
  }
}

// Copies of rows [k0, k0+64) of E (X or Y: kl rows, lde columns), swizzled
// for the tensor-core path.
template <typename TE, int DT, bool kMma, bool kPerm>
__device__ __forceinline__ void load_e(TE* es, const TE* __restrict__ E, int lde, int k0,
                                       int kl) {
  constexpr int V = 16 / (int)sizeof(TE), CE = DT / V, ES = kMma ? DT : DT + 8;
  for (int p = threadIdx.x; p < kTile * CE; p += kThreads) {
    const int row = p / CE, ch = p % CE;
    const bool ok = k0 + row < kl && ch * V < lde;
    const int pc = kMma ? e_chunk<CE, kPerm>(row, ch) : ch;
    cp_async16(es + row * ES + pc * V, ok ? E + (size_t)(k0 + row) * lde + ch * V : E, ok);
  }
}

// A fragments of the warp's MI m16 strips (rows mb..mb+16MI-1) for k
// [16kk, 16kk+16) from the raw int8 chunk, widened in registers, with k
// permuted (slots 2t, 2t+1, 2t+8, 2t+9 hold k 4t..4t+3). Role U: strip i
// row r is tile row mb + 16i + r. Role I (R^T): strips 2p and 2p+1 cover
// items mb + 32p .. +31; strip 2p+h rows g and g+8 are items
// mb + 32p + 4g + 2h and that + 1.
template <bool kItems, int BM, int MI>
__device__ __forceinline__ void int8_frags(const int8_t* rs, int kk, int mb, int lane,
                                           unsigned (&a)[MI][4]) {
  const unsigned* rw = reinterpret_cast<const unsigned*>(rs);
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kItems) {
    constexpr int RW = BM / 4;  // words a row
#pragma unroll
    for (int p = 0; p < MI / 2; ++p) {
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 16 * kk + 4 * t + j;
        w[j] = rw[row * RW + ri_chunk<BM / 16>(row, ((mb + 32 * p) >> 4) + (g >> 2)) * 4 +
                  (g & 3)];
      }
      const bool nonneg = ((w[0] | w[1] | w[2] | w[3]) & 0x80808080u) == 0;
      // 4x4 byte transpose: x01[h] holds items 2h, 2h+1 at k 4t, 4t+1; x23[h] at 4t+2, 4t+3
      const unsigned x01[2] = {__byte_perm(w[0], w[1], 0x5140), __byte_perm(w[0], w[1], 0x7362)};
      const unsigned x23[2] = {__byte_perm(w[2], w[3], 0x5140), __byte_perm(w[2], w[3], 0x7362)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[2 * p + h][0] = widen_pair<false>(x01[h], nonneg);
        a[2 * p + h][1] = widen_pair<true>(x01[h], nonneg);
        a[2 * p + h][2] = widen_pair<false>(x23[h], nonneg);
        a[2 * p + h][3] = widen_pair<true>(x23[h], nonneg);
      }
    }
  } else {
    constexpr int RW = (kTile + 16) / 4;  // words a padded row
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = mb + 16 * i + g;
      const unsigned w0 = rw[row * RW + 4 * kk + t], w1 = rw[(row + 8) * RW + 4 * kk + t];
      const bool nonneg = ((w0 | w1) & 0x80808080u) == 0;
      a[i][0] = widen_pair<false>(w0, nonneg);
      a[i][1] = widen_pair<false>(w1, nonneg);
      a[i][2] = widen_pair<true>(w0, nonneg);
      a[i][3] = widen_pair<true>(w1, nonneg);
    }
  }
}

// One block's unit: split `split` (chunks [s_lo, s_hi)) of the output tile
// rows [o0, o0+BM) of out_i (kItems) or out_u; the sums go to out (rows ol,
// row stride D).
template <typename TR, typename TE, int DT, bool kItems>
__device__ __forceinline__ void block_unit(unsigned char* smem, const TR* __restrict__ R,
                                           int ldr, const TE* __restrict__ E, int lde, int U,
                                           int I, int D, float* __restrict__ out, int o0,
                                           int s_lo, int s_hi) {
  using L = Layout<TR, TE, DT>;
  constexpr int BM = L::kBM;
  constexpr int RR = kItems ? kTile : BM, RC = kItems ? BM : kTile;  // R chunk shape
  constexpr bool kSwzR = kItems && L::kRegA;
  constexpr int RS = kSwzR ? RC : RC + L::kVR;  // raw row stride (entries)
  const int kl = kItems ? U : I;  // depth of the product
  const int ol = kItems ? I : U;  // rows of out
  const int n = s_hi - s_lo;
  auto stage = [&](int s) { return smem + (s % kStages) * L::kStageBytes; };
  auto load = [&](int s) {
    const int k0 = (s_lo + s) * kTile;
    load_r<TR, RR, RC, kSwzR>(reinterpret_cast<TR*>(stage(s)), R, ldr, kItems ? k0 : o0,
                              kItems ? o0 : k0, U, I);
    load_e<TE, DT, L::kMma, L::kRegA>(reinterpret_cast<TE*>(stage(s) + L::kRawBytes), E, lde,
                                      k0, kl);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if constexpr (L::kMma) {
    constexpr int MI = L::kMI, NW = L::kNW, CPR = DT / 8;
    const int mb = (w % L::kWM) * 16 * MI, n0 = (w / L::kWM) * (DT / L::kWN);
    const int q = lane >> 3, i8 = lane & 7;
    float acc[MI][NW][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    for (int s = 0; s < n; ++s) {
      cp_async_wait<kStages - 2>();  // chunk s
      __syncthreads();  // chunk s landed for all; chunk s - 1's buffers are free
      if (s + kStages - 1 < n) load(s + kStages - 1);
      cp_async_commit();
      TR* rs = reinterpret_cast<TR*>(stage(s));
      const __nv_bfloat16* es =
          reinterpret_cast<const __nv_bfloat16*>(stage(s) + L::kRawBytes);
      if constexpr (!kItems && !L::kRegA) {
        // bf16 R, role U: a copy that straddles column I brought entries
        // past it; zero them (X's rows past I are zero, and 0 * a NaN there
        // would not be)
        const int c0 = (s_lo + s) * kTile, from = I - c0;
        if (from < kTile && (from & 7)) {
          for (int p = threadIdx.x; p < BM * 8; p += kThreads) {
            const int col = (from & ~7) + (p & 7);
            if (col >= from) rs[(p >> 3) * RS + col] = TR(0.0f);
          }
          __syncthreads();
        }
      }
      float part[MI][NW][4];  // this chunk's sums, from zero
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        unsigned a[MI][4];
        if constexpr (L::kRegA) {
          int8_frags<kItems, BM, MI>(reinterpret_cast<const int8_t*>(rs), kk, mb, lane, a);
        } else {
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int m = mb + 16 * i;
            if constexpr (kItems)  // A[m][k] = rs[k][m]: R^T through the transposing load
              ldsm_x4_t(a[i], rs + (16 * kk + i8 + (q >> 1) * 8) * RS + m + (q & 1) * 8);
            else
              ldsm_x4(a[i], rs + (m + (lane & 15)) * RS + 16 * kk + (lane >> 4) * 8);
          }
        }
        // the X/Y row this lane addresses: slot i8 of matrix q & 1
        const int kr = L::kRegA ? 16 * kk + ((i8 >> 1) << 2) + (i8 & 1) + ((q & 1) << 1)
                                : 16 * kk + i8 + (q & 1) * 8;
        const __nv_bfloat16* erow = es + kr * DT;
        if constexpr (NW == 1) {
          unsigned b[2];
          ldsm_x2_t(b, erow + e_chunk<CPR, L::kRegA>(kr, n0 >> 3) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_bf16(part[i][0], a[i], b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NW; j += 2) {
            unsigned b[4];
            ldsm_x4_t(b, erow + e_chunk<CPR, L::kRegA>(kr, (n0 >> 3) + j + (q >> 1)) * 8);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              mma_bf16(part[i][j], a[i], b[0], b[1]);
              mma_bf16(part[i][j + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (kItems && L::kRegA)
                              ? mb + 32 * (i >> 1) + 4 * g + 2 * (i & 1) + (e >> 1)
                              : mb + 16 * i + g + (e >> 1) * 8;
          const int r = o0 + row, c = n0 + 8 * j + t2 + (e & 1);
          if (r < ol && c < D) out[(size_t)r * D + c] = acc[i][j][e];
        }
      }
    }
  } else {
    // f32 FMAs: a thread owns rows tr + 16 i (i < BM/16), columns tc + 16 j
    constexpr int MI = BM / 16, NJ = DT / 16;
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
    float acc[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < n; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < n) load(s + kStages - 1);
      cp_async_commit();
      const TR* rs = reinterpret_cast<const TR*>(stage(s));
      const float* es = reinterpret_cast<const float*>(stage(s) + L::kRawBytes);
      const int kmax = min(kTile, kl - (s_lo + s) * kTile);
      for (int k = 0; k < kmax; ++k) {
        float a[MI], b[NJ];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int m = tr + 16 * i;
          a[i] = to_f(kItems ? rs[k * RS + m] : rs[m * RS + k]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = es[k * L::kES + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = o0 + tr + 16 * i, c = tc + 16 * j;
        if (r < ol && c < D) out[(size_t)r * D + c] = acc[i][j];
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Block b: role I units first, (tile, split) with the split fastest, then
// role U's. A split's sums go to out when the role has one split, else to
// its slice of the workspace.
template <typename TR, typename TE, int DT>
__global__ void __launch_bounds__(kThreads, Layout<TR, TE, DT>::kMinBlocks)
    dual_kernel(const TR* __restrict__ R, int ldr, const TE* __restrict__ X,
                const TE* __restrict__ Y, int lde, int U, int I, int D, int su, int si,
                float* __restrict__ ws_u, float* __restrict__ ws_i, float* __restrict__ out_u,
                float* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<TR, TE, DT>;
  const int item_units = (I + L::kBM - 1) / L::kBM * si;
  const int b = blockIdx.x;
  if (b < item_units) {
    const int nk = (U + kTile - 1) / kTile, cs = (nk + si - 1) / si, s = b % si;
    float* out = si > 1 ? ws_i + (size_t)s * I * D : out_i;
    block_unit<TR, TE, DT, true>(smem, R, ldr, Y, lde, U, I, D, out, (b / si) * L::kBM,
                                 min(nk, s * cs), min(nk, (s + 1) * cs));
  } else {
    const int bu = b - item_units;
    const int nk = (I + kTile - 1) / kTile, cs = (nk + su - 1) / su, s = bu % su;
    float* out = su > 1 ? ws_u + (size_t)s * U * D : out_u;
    block_unit<TR, TE, DT, false>(smem, R, ldr, X, lde, U, I, D, out, (bu / su) * L::kBM,
                                  min(nk, s * cs), min(nk, (s + 1) * cs));
  }
}

// out = the sum of the role's split partials, in split order.
__global__ void __launch_bounds__(kThreads)
    dual_reduce_kernel(const float* __restrict__ ws_u, int su, long long nu,
                       const float* __restrict__ ws_i, int si, long long ni,
                       float* __restrict__ out_u, float* __restrict__ out_i) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < nu + ni;
       e += (long long)gridDim.x * kThreads) {
    const bool users = e < nu;
    const int S = users ? su : si;
    if (S < 2) continue;
    const long long n = users ? nu : ni, o = users ? e : e - nu;
    const float* ws = users ? ws_u : ws_i;
    float sum = ws[o];
    for (int s = 1; s < S; ++s) sum += ws[s * n + o];
    (users ? out_u : out_i)[o] = sum;
  }
}

int tile_width(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<TR>, Tag<TE>, integral_constant<DT>) for the dtype codes' pair at
// width D (0 float32, 1 bfloat16, 2 int8: ops/cuda/propagation.py); `bad`
// for a pair or width the kernel does not take.
template <typename F>
int with_pair(int r_code, int e_code, int D, int bad, F&& f) {
  if (D < 1 || D > 128) return bad;
  auto widths = [&](auto r, auto e) {
    switch (tile_width(D)) {
      case 16: return f(r, e, std::integral_constant<int, 16>{});
      case 32: return f(r, e, std::integral_constant<int, 32>{});
      case 64: return f(r, e, std::integral_constant<int, 64>{});
      default: return f(r, e, std::integral_constant<int, 128>{});
    }
  };
  if (e_code == 0 && r_code == 0) return widths(Tag<float>{}, Tag<float>{});
  if (e_code == 0 && r_code == 2) return widths(Tag<int8_t>{}, Tag<float>{});
  if (e_code == 1 && r_code == 1) return widths(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  if (e_code == 1 && r_code == 2) return widths(Tag<int8_t>{}, Tag<__nv_bfloat16>{});
  return bad;
}

#define DUAL_TYPES(r, e, dt)              \
  using TR = typename decltype(r)::type; \
  using TE = typename decltype(e)::type; \
  constexpr int DT = decltype(dt)::value; \
  using L = Layout<TR, TE, DT>

}  // namespace

// Output rows of one block for the pair at width D (Layout::kBM).
extern "C" int dual_matmul_block_rows(int r_code, int e_code, int D) {
  return with_pair(r_code, e_code, D, -1, [](auto r, auto e, auto dt) {
    DUAL_TYPES(r, e, dt);
    return L::kBM;
  });
}

// Dynamic shared memory of one block for the pair at width D; -1 for a pair
// or width the kernel does not take.
extern "C" int dual_matmul_smem_bytes(int r_code, int e_code, int D) {
  return with_pair(r_code, e_code, D, -1, [](auto r, auto e, auto dt) {
    DUAL_TYPES(r, e, dt);
    return L::kBytes;
  });
}

// Blocks of the pair's kernel at width D that one SM of the current device
// holds at once (registers and shared memory); -1 on error.
extern "C" int dual_matmul_resident_blocks(int r_code, int e_code, int D) {
  return with_pair(r_code, e_code, D, -1, [](auto r, auto e, auto dt) {
    DUAL_TYPES(r, e, dt);
    const auto kernel = dual_kernel<TR, TE, DT>;
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, L::kBytes) !=
            cudaSuccess)
      return -1;
    return n;
  });
}

// R (U, I) with row stride ldr elements: 16-byte aligned rows, each
// readable up to column I rounded up to 16 bytes. X (I, .) and Y (U, .)
// contiguous with row stride lde >= D, lde * element size a multiple of 16
// and lde <= D rounded up to 16; columns [D, lde) are read and not used.
// 1 <= D <= 128. su, si >= 1 splits of role U's and role I's depth; ws
// holds su * U * D floats when su > 1, then si * I * D when si > 1.
extern "C" int dual_matmul_launch(int r_code, int e_code, const void* R, int ldr,
                                  const void* X, const void* Y, int lde, int U, int I, int D,
                                  int su, int si, float* ws, float* out_u, float* out_i,
                                  void* stream) {
  if (D < 1 || D > 128 || lde < D || lde > tile_width(D) || su < 1 || si < 1)
    return (int)cudaErrorInvalidValue;
  return with_pair(r_code, e_code, D, (int)cudaErrorInvalidValue, [&](auto r, auto e, auto dt) {
    DUAL_TYPES(r, e, dt);
    const int blocks = (I + L::kBM - 1) / L::kBM * si + (U + L::kBM - 1) / L::kBM * su;
    float* ws_u = ws;
    float* ws_i = ws + (su > 1 ? (size_t)su * U * D : 0);
    int rc = lgcnhs_launch(dual_kernel<TR, TE, DT>, blocks, L::kBytes, stream,
                           static_cast<const TR*>(R), ldr, static_cast<const TE*>(X),
                           static_cast<const TE*>(Y), lde, U, I, D, su, si, ws_u, ws_i, out_u,
                           out_i);
    if (rc != 0 || (su < 2 && si < 2)) return rc;
    const long long nu = (long long)U * D, ni = (long long)I * D;
    const long long want = (nu + ni + kThreads - 1) / kThreads;
    return lgcnhs_launch(dual_reduce_kernel, (int)(want < 4096 ? want : 4096), 0, stream,
                         (const float*)ws_u, su, nu, (const float*)ws_i, si, ni, out_u, out_i);
  });
}
