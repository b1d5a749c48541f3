// Fused retrieval for Hopper (sm_90a): layer-0 scores + seen mask + top-k,
// without writing the (U, I) score matrix to device memory.
//
// Replaces lgcnhs_tpu/ops/pallas/retrieval.py:
//   fused_topk_retrieval      (one-shot; pl.pallas_call at :136)
//   streaming_topk_retrieval  (item tiles with a running top-k; :320)
//
// What bounds it: the f32 dot products, U*I*D FMAs on the CUDA cores (no
// tensor cores: the contract is full f32), plus k selection passes per
// user. Bytes are small: the (U, I) seen mask is the largest input.
//
// Design. The TPU kernels keep a (128, I_pad) f32 score block in VMEM; a
// Hopper block has at most 227 KB of shared memory, so a block here owns
// kRows users and keeps only their score rows (kRows * I * 4 bytes) in
// dynamic shared memory. Threads walk the items; the item table arrives
// transposed (D, I) so that neighbouring threads read neighbouring items,
// and each loaded item value serves all kRows users. Selection then runs
// one warp per user (common.cuh). The streaming kernel keeps a (kRows,
// tile) score block plus a running (value, id) top-k per user, so its shared memory does not grow with the catalog. Each tile is
// filtered against the running k-th entry (whatever ranks after it cannot
// reach the top k); the best min(survivors, k) are selected in rank order
// and merged with the running list by rank (binary search), so after the
// first tile a tile costs about as many selection steps as it has
// survivors, not k.
//
// Mask: seen items score the finite -1024 sentinel (they can still be
// emitted when every unseen score lies below it). Items past I are never
// visited, so no padding state exists.
#include "common.cuh"

namespace {

using namespace lgcnhs;

constexpr int kRows = 8;  // users per block; ops/cuda/retrieval.py ROWS

__global__ void __launch_bounds__(kThreads)
    fused_topk_kernel(const float* __restrict__ u,
                      const float* __restrict__ itT,
                      const uint8_t* __restrict__ seen, int U, int I, int D,
                      int k, int32_t* __restrict__ idx,
                      float* __restrict__ vals) {
  extern __shared__ float smem[];
  float* us = smem;               // (kRows, D)
  float* sc = smem + kRows * D;   // (kRows, I)
  const int u0 = blockIdx.x * kRows;
  const int nr = min(kRows, U - u0);

  load_user_rows<kRows>(us, u, u0, U, D);
  __syncthreads();

  for (int j = threadIdx.x; j < I; j += blockDim.x) {
    float acc[kRows];
    user_item_dots<kRows>(us, itT, I, D, j, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr)
        sc[r * I + j] = seen[(size_t)(u0 + r) * I + j] ? kSeenValue : acc[r];
    }
  }
  __syncthreads();

  const int w = threadIdx.x >> 5;
  for (int r = w; r < nr; r += kWarps) {
    const size_t o = (size_t)(u0 + r) * k;
    warp_select_row(sc + r * I, I, k, idx + o, vals + o);
  }
}

static_assert(kRows == kWarps, "streaming: warp w owns user w of the block");

// Rank of x among the m entries of a list sorted in rank order: how many
// of them rank before x.
__device__ __forceinline__ int rank_in(const float* v, const int* id, int m,
                                       int xkey, int xid) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ranks_before(order_key(v[mid]), id[mid], xkey, xid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    streaming_topk_kernel(const float* __restrict__ u,
                          const float* __restrict__ itT,
                          const uint8_t* __restrict__ seen, int U, int I,
                          int D, int k, int tile, int32_t* __restrict__ idx,
                          float* __restrict__ vals) {
  extern __shared__ float smem[];
  float* us = smem;                          // (kRows, D)
  float* tv = us + kRows * D;                // (kRows, tile) scores, then survivors
  int* tid = (int*)(tv + kRows * tile);      // (kRows, tile) survivor ids
  float* rv = (float*)(tid + kRows * tile);  // (kRows, k) running top-k values
  int* ri = (int*)(rv + kRows * k);          // (kRows, k) running top-k ids
  float* sv = (float*)(ri + kRows * k);      // (kRows, k) sorted best survivors
  int* si = (int*)(sv + kRows * k);          // (kRows, k)
  const int u0 = blockIdx.x * kRows;
  const int nr = min(kRows, U - u0);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_user_rows<kRows>(us, u, u0, U, D);
  __syncthreads();

  for (int base = 0; base < I; base += tile) {
    const int tn = min(tile, I - base);
    for (int jj = threadIdx.x; jj < tn; jj += blockDim.x) {
      const int j = base + jj;
      float acc[kRows];
      user_item_dots<kRows>(us, itT, I, D, j, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr)
          tv[r * tile + jj] =
              seen[(size_t)(u0 + r) * I + j] ? kSeenValue : acc[r];
      }
    }
    __syncthreads();

    if (w < nr) {
      float* cv = rv + w * k;
      int* ci = ri + w * k;
      float* row = tv + w * tile;
      int* cid = tid + w * tile;
      float* bv = sv + w * k;
      int* bi = si + w * k;
      // survivors: tile entries that rank before the running k-th (all of
      // the first tile), compacted in place in id order. Nothing else can
      // reach the top k.
      const bool first = base == 0;
      const int thr_key = first ? 0 : order_key(cv[k - 1]);
      const int thr_id = first ? 0 : ci[k - 1];
      int c = 0;
      for (int q = 0; q < tn; q += 32) {
        const int p = q + lane;
        const float v = p < tn ? row[p] : 0.0f;
        const bool in = p < tn && (first || ranks_before(order_key(v), base + p,
                                                         thr_key, thr_id));
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (in) {
          const int dst = c + __popc(m & ((1u << lane) - 1u));
          row[dst] = v;
          cid[dst] = base + p;
        }
        c += __popc(m);
        __syncwarp();
      }
      if (c > 0) {
        // the best min(c, k) survivors, in rank order
        const int m = min(c, k);
        warp_select(
            c, m,
            [&](int p, int& key, int& id) {
              key = order_key(row[p]);
              id = cid[p];
            },
            [&](int p) { row[p] = knocked_out(); },
            [&](int t, int key, int id) {
              bv[t] = key_value(key);
              bi[t] = id;
            });
        __syncwarp();
        if (first) {  // tile >= k, so the first tile fills the running list
          for (int t = lane; t < k; t += 32) {
            cv[t] = bv[t];
            ci[t] = bi[t];
          }
        } else {
          // merge two rank-ordered lists (ids distinct: survivors come
          // from this tile, the running list from earlier ones): an
          // entry's new slot is its own index plus its rank in the other
          // list. The tile buffer holds the result, then it is copied.
          for (int t = lane; t < k; t += 32) {
            const int pos = t + rank_in(bv, bi, m, order_key(cv[t]), ci[t]);
            if (pos < k) {
              row[pos] = cv[t];
              cid[pos] = ci[t];
            }
          }
          for (int t = lane; t < m; t += 32) {
            const int pos = t + rank_in(cv, ci, k, order_key(bv[t]), bi[t]);
            if (pos < k) {
              row[pos] = bv[t];
              cid[pos] = bi[t];
            }
          }
          __syncwarp();
          for (int t = lane; t < k; t += 32) {
            cv[t] = row[t];
            ci[t] = cid[t];
          }
        }
      }
    }
    __syncthreads();
  }

  if (w < nr) {
    const size_t o = (size_t)(u0 + w) * k;
    for (int t = lane; t < k; t += 32) {
      idx[o + t] = ri[w * k + t];
      vals[o + t] = rv[w * k + t];
    }
  }
}

}  // namespace

extern "C" int fused_topk_retrieval_launch(const float* u, const float* itT,
                                           const uint8_t* seen, int U, int I,
                                           int D, int k, int32_t* idx,
                                           float* vals, void* stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * (D + I);
  return lgcnhs_launch(fused_topk_kernel, (U + kRows - 1) / kRows, smem,
                       stream, u, itT, seen, U, I, D, k, idx, vals);
}

extern "C" int streaming_topk_retrieval_launch(const float* u,
                                               const float* itT,
                                               const uint8_t* seen, int U,
                                               int I, int D, int k, int tile,
                                               int32_t* idx, float* vals,
                                               void* stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * (D + 2 * tile + 4 * k);
  return lgcnhs_launch(streaming_topk_kernel, (U + kRows - 1) / kRows, smem,
                       stream, u, itT, seen, U, I, D, k, tile, idx, vals);
}
