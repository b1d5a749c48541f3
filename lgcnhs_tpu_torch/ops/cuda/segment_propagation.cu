// One LightGCN propagation layer over the edge list for Hopper (sm_90a):
// the pair (A x_i, A^T x_u), A = D_u^-1/2 R D_i^-1/2, in one launch, with
// the layer mean's running sum fused into the epilogue.
//
// Replaces no Pallas kernel: the JAX package propagates its large (COO)
// graphs by XLA gathers and segment sums (lgcnhs_tpu/ops/propagation.py),
// which the port first carried over as library calls over a degree-bucketed
// ELL layout (ops/propagation.py _bucketed_aggregate): per bucket a padded
// (Nb, Pb, D) gather, a product, a sum over the pad axis, then a concat and
// a gather back to node order, ~300 library launches a pair and each padded
// row written and read again several times. This kernel does the pair in
// one pass over the edges.
//
// Layout (ops/cuda/segment_propagation.py build_segment_graph): the edges
// sorted by destination, once a job, users' rows first and then items',
// each row's neighbour ids (int32) and f32 weights contiguous. The chunk
// plan splits the rows into units of at most CHUNK (256, the wrapper's)
// edges: a row up to CHUNK long is one unit, a longer one
// ceil(deg / CHUNK). A unit is (row, first edge, end edge, slot): slot -1
// writes the row itself, else the unit's partial sum goes to the slot's
// row of the workspace. Units come longest first.
//
// What bounds it: bytes, and the gathers' traffic at that. Its least work
// is the edge list (8 nnz bytes) and each table read and written once
// ((U + I) D 4 bytes each way): 42.7 MB at Gowalla (29,741 x 40,848, 822 k
// edges, D 64), 12.7 us at 3.35 TB/s. The 4 nnz D FLOP are nothing beside
// that. What it moves is more: every edge gathers a whole neighbour row in
// each direction, 2 nnz D 4 bytes (421 MB at Gowalla). The tables (7.6 MB
// of users, 10.5 MB of items) sit in the 50 MB L2, so those are L2 reads
// and only the edge list and the tables cross DRAM.
//
// Design:
// - A warp owns one unit; each lane holds VEC adjacent columns (2 at
//   D = 64), so each gathered neighbour is one coalesced 256-byte row read.
// - The unit's ids and weights are loaded 32 at a time, one edge a lane,
//   and broadcast by shuffles; kInFlight gathers are started before their
//   products are summed, so each warp keeps that many L2 reads in flight.
// - The degree skew does not set the time: a hot item (15,749 edges in the
//   Gowalla cell's graph) is ceil(deg / CHUNK) units spread over the card,
//   and the longest units start first (in row order a launch took 14% more
//   time; with no split rows, 1.45 ms against 0.08). A second kernel sums
//   each split row's partials in chunk order (segment_pair_reduce_kernel),
//   kInFlight loads in flight ahead of the adds.
// - Every output is summed in one fixed order with no atomics: a unit's
//   edges in edge order by fmaf from zero, then a split row's partials in
//   chunk order. Two launches on the same inputs are bitwise equal.
// - The epilogue writes the layer's output (skipped for the last layer,
//   whose output feeds nothing) and acc = (acc_in + out) * scale, the layer
//   mean's running sum (scale 1, or 1 / (K + 1) at the last layer).
// Tables, weights, products and sums are f32 (no TF32, no bf16 copies).
#include "common.cuh"

namespace {

using namespace lgcnhs;

constexpr int kInFlight = 8;  // gathers a warp starts before it sums them
constexpr unsigned kFull = 0xffffffffu;

// The layer's tables. Rows 0..U-1 of the unit space are users (they gather
// x_i), U.. items (they gather x_u). out_* and acc_* may be null; acc_in_*
// may be acc_* itself (the sum kept in place) or the layer's input.
struct Tables {
  const float* x_u;
  const float* x_i;
  int U, D;
  float* out_u;
  float* out_i;
  const float* acc_in_u;
  const float* acc_in_i;
  float* acc_u;
  float* acc_i;
  float scale;
};

template <int VEC>
__device__ __forceinline__ void load_cached(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// A plain load: acc_in may be the buffer this launch writes.
template <int VEC>
__device__ __forceinline__ void load_plain(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = p[k];
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Row `row`'s finished sum at columns col..col+VEC-1: the output and the
// running layer sum.
template <int VEC>
__device__ __forceinline__ void finish(const Tables& t, int row, int col, const float (&v)[VEC]) {
  const bool users = row < t.U;
  const size_t o = (size_t)(users ? row : row - t.U) * t.D + col;
  float* out = users ? t.out_u : t.out_i;
  if (out) store<VEC>(out + o, v);
  float* acc = users ? t.acc_u : t.acc_i;
  if (acc) {
    float a[VEC];
    load_plain<VEC>((users ? t.acc_in_u : t.acc_in_i) + o, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = (a[k] + v[k]) * t.scale;
    store<VEC>(acc + o, a);
  }
}

// One warp a unit (row, first edge, end edge, slot).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_pair_kernel(Tables t, const int* __restrict__ cols, const float* __restrict__ w,
                        const int4* __restrict__ units, int n_units, float* __restrict__ ws) {
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int4 u = units[unit];
  const float* x = u.x < t.U ? t.x_i : t.x_u;
  for (int c0 = 0; c0 < t.D; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool live = col < t.D;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int e0 = u.y; e0 < u.z; e0 += 32) {
      const int n = min(32, u.z - e0);  // the same in every lane
      int my_c = 0;
      float my_w = 0.0f;
      if (lane < n) {
        my_c = __ldg(cols + e0 + lane);
        my_w = __ldg(w + e0 + lane);
      }
      for (int j0 = 0; j0 < n; j0 += kInFlight) {
        float v[kInFlight][VEC];
        float wt[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int src = __shfl_sync(kFull, my_c, j0 + j);
          wt[j] = __shfl_sync(kFull, my_w, j0 + j);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[j][k] = 0.0f;
          if (live && j0 + j < n) load_cached<VEC>(x + (size_t)src * t.D + col, v[j]);
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          if (j0 + j < n) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wt[j], v[j][k], acc[k]);
          }
        }
      }
    }
    if (!live) continue;
    if (u.w >= 0)
      store<VEC>(ws + (size_t)u.w * t.D + col, acc);
    else
      finish<VEC>(t, u.x, col, acc);
  }
}

// One warp a split row (row, first slot, chunks): its partials summed in
// chunk order, then the epilogue.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_pair_reduce_kernel(Tables t, const int4* __restrict__ splits, int n_splits,
                               const float* __restrict__ ws) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_splits) return;
  const int4 sp = splits[s];
  for (int c0 = 0; c0 < t.D; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    if (col >= t.D) continue;
    float sum[VEC];
    load_cached<VEC>(ws + (size_t)sp.y * t.D + col, sum);
    for (int c0 = 1; c0 < sp.z; c0 += kInFlight) {  // the loads in flight, the adds in order
      float part[kInFlight][VEC];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (c0 + j < sp.z) load_cached<VEC>(ws + (size_t)(sp.y + c0 + j) * t.D + col, part[j]);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (c0 + j < sp.z) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) sum[k] += part[j][k];
        }
      }
    }
    finish<VEC>(t, sp.x, col, sum);
  }
}

// Columns a lane holds: 4 from D = 128, 2 from 64, else 1 (D a multiple).
int vec_width(int D) { return D % 4 == 0 && D >= 128 ? 4 : D % 2 == 0 && D >= 64 ? 2 : 1; }

template <int VEC>
int launch(const Tables& t, const int* cols, const float* w, const int4* units, int n_units,
           const int4* splits, int n_splits, float* ws, void* stream) {
  int rc = lgcnhs_launch(segment_pair_kernel<VEC>, (n_units + kWarps - 1) / kWarps, 0, stream,
                         t, cols, w, units, n_units, ws);
  if (rc != 0 || n_splits == 0) return rc;
  return lgcnhs_launch(segment_pair_reduce_kernel<VEC>, (n_splits + kWarps - 1) / kWarps, 0,
                       stream, t, splits, n_splits, (const float*)ws);
}

}  // namespace

// x_u (U, D), x_i (I, D), out_*, acc_in_*, acc_* contiguous f32 with
// 16-byte aligned starts (vector loads of 2 or 4 columns); cols and
// w the 2 nnz sorted edges (users' rows, then items'); units (n_units, 4)
// and splits (n_splits, 4) int32 (the wrapper's chunk plan); ws n_slots * D
// floats when n_splits > 0. out_* or acc_* null: not written (acc_in_* then
// unread). n_units >= 1, D >= 1.
extern "C" int segment_pair_launch(const float* x_u, const float* x_i, int U, int D,
                                   const int* cols, const float* w, const void* units,
                                   int n_units, const void* splits, int n_splits, float* ws,
                                   float* out_u, float* out_i, const float* acc_in_u,
                                   const float* acc_in_i, float* acc_u, float* acc_i,
                                   float scale, void* stream) {
  if (D < 1 || n_units < 1 || n_splits < 0 || (n_splits > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Tables t{x_u, x_i, U, D, out_u, out_i, acc_in_u, acc_in_i, acc_u, acc_i, scale};
  const int4* u = static_cast<const int4*>(units);
  const int4* s = static_cast<const int4*>(splits);
  switch (vec_width(D)) {
    case 4: return launch<4>(t, cols, w, u, n_units, s, n_splits, ws, stream);
    case 2: return launch<2>(t, cols, w, u, n_units, s, n_splits, ws, stream);
    default: return launch<1>(t, cols, w, u, n_units, s, n_splits, ws, stream);
  }
}
