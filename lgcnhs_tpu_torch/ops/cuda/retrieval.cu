// Fused retrieval for Hopper (sm_90a): layer-0 scores + seen mask + top-k,
// without writing the (U, I) score matrix to device memory.
//
// Replaces lgcnhs_tpu/ops/pallas/retrieval.py:
//   fused_topk_retrieval      (one-shot; pl.pallas_call at :136)
//   streaming_topk_retrieval  (item tiles with a running top-k; :320)
//
// What bounds it: the f32 dot products, U*I*D FMAs on the CUDA cores (no
// tensor cores: the contract is full f32): at the streaming cell (6040 x
// 49,410 x 64) 38 GFLOP, 0.57 ms at 67 TFLOP/s. Bytes are small beside it
// (the (U, I) seen mask is the largest input, 298 MB there: 0.09 ms).
//
// One-shot design. The TPU kernels keep a (128, I_pad) f32 score block in
// VMEM; a Hopper block has at most 227 KB of shared memory, so a block here
// owns kRows users and keeps only their score rows (kRows * I * 4 bytes) in
// dynamic shared memory. Threads walk the items; the item table arrives
// transposed (D, I) so that neighbouring threads read neighbouring items,
// and each loaded item value serves all kRows users. Selection then runs
// one warp per user (common.cuh).
//
// Streaming design (no catalog cap). A block owns 32 users and one part of
// the catalog, and walks it in steps of 128 items:
// - Scores: a register tile. Each thread computes 4 users x 4 items, each
//   score one fmaf chain over ascending d (as user_item_dots, so the
//   scores are bitwise the one-shot kernel's), from 16-deep slices of the
//   transposed user and item tables staged in shared memory by cp.async,
//   double-buffered: per d a thread reads one broadcast float4 of users and
//   one float4 of items for 16 FMAs, and a block reads each item once per
//   32 users (the earlier kernel: once per 8).
// - Selection: each user keeps its running top-k (order keys and ids,
//   ranked) and the running k-th entry as a threshold. The score epilogue
//   drops, in registers, every score that does not rank before the
//   threshold (the seen flags are read while the products run); only
//   survivors are appended (shared-memory counter) to the user's survivor
//   area, of one step plus a slack of item_tile entries. A user's
//   survivors are folded in (ranked among themselves, then a rank merge)
//   only when the area could overflow in the next step, and once at the
//   end. A user's scores, survivors and folds all belong to one warp, so
//   selection needs warp barriers only: a fold holds up its own warp, not
//   the block. After the first ~k items the threshold is high and almost
//   nothing survives, so selection costs about survivors x log k per user,
//   not a pass per tile. The slack grows with k (ops/cuda/retrieval.py
//   pick_stream_tile), and the long lists of a large k that do not fit a
//   block's shared memory go to a workspace in device memory (StreamSmem),
//   so any k runs.
// - Filling the card: 6040 users make 189 blocks of 32; the catalog is
//   split into parts (ops/cuda/retrieval.py stream_parts) so that the
//   blocks spread evenly over the SMs, two resident on each, and a second
//   kernel merges each user's part lists (one warp a user) in rank order.
//
// Mask: seen items score the finite -1024 sentinel (they can still be
// emitted when every unseen score lies below it). Items past I are never
// emitted, so no padding state exists.
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

// -- streaming: no catalog cap ---------------------------------------------

constexpr int kSU = 32;     // users per streaming block; ops/cuda/retrieval.py STREAM_USERS
constexpr int kStep = 128;  // items scored per step; STREAM_STEP
constexpr int kDC = 16;     // depth of one staged operand slice
constexpr int kSlices = 3;  // staged slices in flight
static_assert(kSU == 4 * kWarps, "a warp scores and selects for 4 users");

// Memory of one streaming block (ops/cuda/retrieval.py stream_smem_bytes).
// In shared memory: kSlices operand slices, four counters a user, each
// user's survivor area (kStep + slack entries: order keys, ids) and each
// warp's ranked survivors of a fold (min(area, k)). The long lists, each
// warp's merged list of a fold and each user's running top-k (k entries
// each), follow in shared memory as far as they fit (ListPlace); the rest
// live in the block's slice of a workspace in device memory. A fold reads
// the running list in coalesced passes and searches only the ranked
// survivors, so no search waits on device memory. No list is shared
// between warps.
struct StreamSmem {
  float* us;  // [kSlices][kDC][kSU] user slices (d-major)
  float* is;  // [kSlices][kDC][kStep] item slices
  int *run_n, *new_n, *thr_key, *thr_id;
  int *new_key, *new_id, *sc_key, *sc_id;  // always in shared memory
  LongLists<kSU> lists;
  int sc_len;
  __device__ StreamSmem(unsigned char* base, int* ws, int place, int k, int area)
      : lists(reinterpret_cast<int*>(base + near_bytes(k, area)), ws, place, k) {
    us = reinterpret_cast<float*>(base);
    is = us + kSlices * kDC * kSU;
    run_n = reinterpret_cast<int*>(is + kSlices * kDC * kStep);
    new_n = run_n + kSU;
    thr_key = new_n + kSU;
    thr_id = thr_key + kSU;
    sc_len = min(area, k);
    new_key = thr_id + kSU;
    new_id = new_key + kSU * area;
    sc_key = new_id + kSU * area;
    sc_id = sc_key + kWarps * sc_len;
  }
  // shared memory before the long lists
  __host__ __device__ static size_t near_bytes(int k, int area) {
    const int sc = area < k ? area : k;
    return 4 * (kSlices * (size_t)kDC * (kSU + kStep) + 4 * kSU + (size_t)kSU * 2 * area +
                (size_t)kWarps * 2 * sc);
  }
  __host__ __device__ static size_t ws_ints(int place, int k) {
    return LongLists<kSU>::ws_ints(place, k);
  }
  static size_t smem_bytes(int place, int k, int area) {
    return near_bytes(k, area) + 4 * LongLists<kSU>::shared_ints(place, k);
  }
  static int place(int k, int area, int limit) {
    return LongLists<kSU>::place(near_bytes(k, area), k, limit);
  }
};

// One warp folds user u's survivors into its running top-k: ranks them
// (rank_entries), then merges them in (merge_ranked).
__device__ void fold_survivors(StreamSmem& sm, int u, int k, int area) {
  const int w = threadIdx.x >> 5;
  const int m = sm.new_n[u];
  if (m == 0) return;
  int* sk = sm.sc_key + w * sm.sc_len;
  int* si = sm.sc_id + w * sm.sc_len;
  rank_entries(sm.new_key + u * area, sm.new_id + u * area, m, k, sk, si);
  merge_ranked(sk, si, min(m, k), sm.lists.run_key + u * k, sm.lists.run_id + u * k,
               sm.run_n + u, sm.thr_key + u, sm.thr_id + u, sm.lists.mg_key + w * k,
               sm.lists.mg_id + w * k, k);
  if ((threadIdx.x & 31) == 0) sm.new_n[u] = 0;
  __syncwarp();
}

// Block (user group, catalog part): users [u0, u0+32), items [j_lo, j_hi).
// Writes the part's top-k of each user (ranked; past the part's item count
// the value -inf with id INT_MAX) to row (part * U + u) of out_idx/out_val.
// kPlace (ListPlace): where the long lists live; ws has the block's slice.
template <int kPlace>
__global__ void __launch_bounds__(kThreads, 2)
    streaming_topk_kernel(const float* __restrict__ uT, int ldu,
                          const float* __restrict__ itT, int ldi,
                          const uint8_t* __restrict__ seen, int U, int I, int D, int k,
                          int slack, int parts, int part_len, int* __restrict__ ws,
                          int32_t* __restrict__ out_idx, float* __restrict__ out_val) {
  extern __shared__ float smem[];  // dynamic shared memory starts 16-byte aligned
  const int area = kStep + slack;
  StreamSmem sm(reinterpret_cast<unsigned char*>(smem),
                kPlace == kListsShared ? nullptr
                                       : ws + blockIdx.x * StreamSmem::ws_ints(kPlace, k),
                kPlace, k, area);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int part = blockIdx.x % parts, u0 = (blockIdx.x / parts) * kSU;
  const int j_lo = part * part_len, j_hi = min(I, j_lo + part_len);
  for (int u = threadIdx.x; u < kSU; u += kThreads) {
    sm.run_n[u] = 0;
    sm.new_n[u] = 0;
    sm.thr_key[u] = INT_MIN;  // nothing to beat yet: every entry ranks before it
    sm.thr_id[u] = -1;
  }
  const int nd = (D + kDC - 1) / kDC;
  const int nsteps = (j_hi - j_lo + kStep - 1) / kStep;
  const int nc = nsteps * nd;
  auto load = [&](int c) {
    if (c < nc) {
      const int j0 = j_lo + (c / nd) * kStep, d0 = (c % nd) * kDC;
      float* ub = sm.us + (c % kSlices) * kDC * kSU;
      float* ib = sm.is + (c % kSlices) * kDC * kStep;
      for (int p = threadIdx.x; p < kDC * (kStep / 4); p += kThreads) {
        const int r = p / (kStep / 4), q = 4 * (p % (kStep / 4));
        const bool ok = d0 + r < D && j0 + q < ldi;
        cp_async16(ib + r * kStep + q, ok ? itT + (size_t)(d0 + r) * ldi + j0 + q : itT, ok);
      }
      for (int p = threadIdx.x; p < kDC * (kSU / 4); p += kThreads) {
        const int r = p / (kSU / 4), q = 4 * (p % (kSU / 4));
        const bool ok = d0 + r < D && u0 + q < ldu;
        cp_async16(ub + r * kSU + q, ok ? uT + (size_t)(d0 + r) * ldu + u0 + q : uT, ok);
      }
    }
    cp_async_commit();  // empty past the end
  };
  // thread: users w*4 + r (r < 4), items lane*4 + c (c < 4) of the step;
  // a user's survivors, running list and threshold belong to warp w alone
  float acc[4][4];
  uint8_t flag[4][4];
  for (int c = 0; c < kSlices - 1; ++c) load(c);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kSlices - 2>();
    __syncthreads();  // slice c landed; slice c - 1 is no longer read
    load(c + kSlices - 1);
    const int st = c / nd, dc = c % nd;
    if (dc == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // the step's seen flags, read now so that they arrive during the
        // products (read in the epilogue, their latency would stall it)
        const int j = j_lo + st * kStep + lane * 4;
        const uint8_t* srow = seen + (size_t)min(u0 + w * 4 + r, U - 1) * I;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] = 0.0f;
          flag[r][q] = j + q < j_hi ? srow[j + q] : 0;
        }
      }
    }
    const float* ub = sm.us + (c % kSlices) * kDC * kSU + w * 4;
    const float* ib = sm.is + (c % kSlices) * kDC * kStep + lane * 4;
    const int dn = min(kDC, D - dc * kDC);
    // each score is one fmaf chain over ascending d, as user_item_dots
    auto dot_step = [&](int d) {
      const float4 uv = *reinterpret_cast<const float4*>(ub + d * kSU);
      const float4 iv = *reinterpret_cast<const float4*>(ib + d * kStep);
      const float uu[4] = {uv.x, uv.y, uv.z, uv.w}, ii[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(uu[r], ii[q], acc[r][q]);
    };
    if (dn == kDC) {  // a whole slice, unrolled so that loads run ahead
#pragma unroll
      for (int d = 0; d < kDC; ++d) dot_step(d);
    } else {
      for (int d = 0; d < dn; ++d) dot_step(d);
    }
    if (dc != nd - 1) continue;
    // epilogue: mask, drop what cannot reach the top k, append survivors
    const int j0 = j_lo + st * kStep + lane * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = w * 4 + r;
      if (u0 + u >= U) continue;
      const int tk = sm.thr_key[u], ti = sm.thr_id[u];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        if (j >= j_hi) continue;
        const int key = order_key(flag[r][q] ? kSeenValue : acc[r][q]);
        if (ranks_before(key, j, tk, ti)) {
          const int pos = atomicAdd(&sm.new_n[u], 1);
          sm.new_key[u * area + pos] = key;
          sm.new_id[u * area + pos] = j;
        }
      }
    }
    __syncwarp();
    // fold a user's survivors once they could overflow in the next step,
    // and everyone's after the last step
    const bool last = st == nsteps - 1;
    for (int u = w * 4; u < w * 4 + 4; ++u) {
      if (last || sm.new_n[u] > slack) fold_survivors(sm, u, k, area);
    }
  }
  cp_async_wait<0>();
  for (int u = w * 4; u < w * 4 + 4; ++u) {
    if (u0 + u >= U) continue;
    const size_t o = ((size_t)part * U + u0 + u) * k;
    const int n = sm.run_n[u];
    for (int t = lane; t < k; t += 32) {
      const bool real = t < n;
      out_idx[o + t] = real ? sm.lists.run_id[u * k + t] : INT_MAX;
      out_val[o + t] = real ? key_value(sm.lists.run_key[u * k + t]) : knocked_out();
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

// uT (D, ldu) and itT (D, ldi): the transposed user and item tables, row
// strides multiples of 4 floats (zero padding past U and I), 16-byte
// aligned. slack >= 0: survivors a user absorbs between folds. parts
// catalog parts of part_len items (a multiple of kStep); with parts > 1,
// part_idx/part_val hold (parts, U, k) entries for the merge. smem_limit:
// the device's shared memory a block may take; the long lists not in it go
// to ws, streaming_workspace_bytes for each of the ceil(U / 32) * parts
// blocks (null when that is 0).
extern "C" int streaming_topk_retrieval_launch(const float* uT, int ldu, const float* itT,
                                               int ldi, const uint8_t* seen, int U, int I,
                                               int D, int k, int slack, int parts,
                                               int part_len, int smem_limit, int* ws,
                                               int32_t* part_idx, float* part_val,
                                               int32_t* idx, float* vals, void* stream) {
  const int area = kStep + slack;
  const int place = StreamSmem::place(k, area, smem_limit);
  if (slack < 0 || parts < 1 || part_len % kStep != 0 || place < 0 ||
      (place != kListsShared && !ws))
    return (int)cudaErrorInvalidValue;
  const int blocks = (U + kSU - 1) / kSU * parts;
  const size_t smem = StreamSmem::smem_bytes(place, k, area);
  int32_t* out_idx = parts > 1 ? part_idx : idx;
  float* out_val = parts > 1 ? part_val : vals;
  auto launch = [&](auto kernel) {
    return lgcnhs_launch(kernel, blocks, smem, stream, uT, ldu, itT, ldi, seen, U, I, D, k,
                         slack, parts, part_len, ws, out_idx, out_val);
  };
  int rc = place == kListsShared ? launch(streaming_topk_kernel<kListsShared>)
           : place == kRunGlobal ? launch(streaming_topk_kernel<kRunGlobal>)
                                 : launch(streaming_topk_kernel<kAllGlobal>);
  if (rc != 0 || parts == 1) return rc;
  return lgcnhs_launch_part_merge(part_idx, part_val, U, k, parts, smem_limit, idx, vals, stream);
}

// Shared memory of one streaming block with all its long lists in it.
extern "C" long long streaming_smem_bytes(int k, int slack) {
  return (long long)StreamSmem::smem_bytes(kListsShared, k, kStep + slack);
}

// Workspace bytes of one streaming block: its long lists that do not fit
// smem_limit; -1 when the block does not fit even without them.
extern "C" long long streaming_workspace_bytes(int k, int slack, int smem_limit) {
  const int place = StreamSmem::place(k, kStep + slack, smem_limit);
  return place < 0 ? -1 : 4 * (long long)StreamSmem::ws_ints(place, k);
}
