// Fused retrieval for Hopper (sm_90a): layer-0 scores + seen mask + top-k,
// without writing the (U, I) score matrix to device memory, for any
// catalog and any k, in one kernel (fused_topk_kernel) and one launcher.
//
// Replaces both Pallas kernels of lgcnhs_tpu/ops/pallas/retrieval.py:
//   fused_topk_retrieval      (one-shot; pl.pallas_call at :136)
//   streaming_topk_retrieval  (item tiles with a running top-k; :320)
// One kernel serves both: on an H100 it measured faster than a kernel of
// each design at every catalog and k timed (PERF.md).
//
// What bounds it: the f32 dot products, U*I*D FMAs on the CUDA cores (no
// tensor cores: the contract is full f32): 2.9 GFLOP at ML-1M (6040 x
// 3706 x 64), 0.043 ms at 67 TFLOP/s; 38 GFLOP at 6040 x 49,410, 0.57 ms.
// Bytes are small beside it (the (U, I) seen mask is the largest input,
// 298 MB there: 0.09 ms).
//
// Design. The TPU kernel keeps a (128, I_pad) f32 score block in VMEM and
// takes k arg-max steps over it. The first Hopper port kept 8 users' score
// rows in shared memory instead: one block an SM, each item read from L2
// once per 8 users, and k dependent warp arg-max steps per user. Here a
// block owns 48 users and one part of the catalog, walked in steps of 128
// items:
// - Scores: each thread computes 6 users x 4 items in registers (each
//   score one fmaf chain over ascending d, bitwise the plain f32 dot
//   product on inputs exact in f32) from 16-deep slices of the transposed
//   user and item tables staged in shared memory by cp.async,
//   double-buffered: per d three broadcast float2s of users and one float4
//   of items feed 24 FMAs, and each item value a block stages serves 48
//   users (ML-1M's 6040 users make 126 groups: at two parts, 252 blocks
//   fill 95% of the card's 264 block slots).
// - Selection by threshold: each user keeps its running top-k (ranked order
//   keys and ids) and its k-th entry. Right after a step's products, the
//   warp that owns a user drops, in registers, every score that does not
//   rank before that k-th entry, and appends the survivors to the user's
//   buffer of 48. Only when a step's survivors would overflow the buffer
//   is it merged: ranked by counting and merged into the list (common.cuh
//   merge_into_list; up to k = 128 in place, in registers), which raises
//   the threshold; a step with more than 48 survivors (a part's first two
//   steps) is sorted in registers (warp_sort128) and merged. After the
//   first ~k items most steps leave a user few or no survivors: a test and
//   an append. Those first steps' sorts are what selection costs (on an
//   H100 they took ~0.54 of 0.75 ms at ML-1M before the shared bound
//   below, PERF.md).
// - Filling the card: the block's memory (TopkSmem) does not grow with I;
//   at k = 100 two blocks (16 warps) fit an SM. The catalog is split into
//   parts (ops/cuda/retrieval.py topk_plan, from the kernel's own
//   occupancy), part_lists_merge_kernel merges each user's part lists by
//   rank counting, and each user's best k-th entry so far is shared
//   between the parts in device memory (fused_topk_kernel), so parts that
//   start later skip their first steps' sorting. Long lists of a large k
//   go to a device-memory workspace, so any k runs.
//
// Mask: seen items score the finite -1024 sentinel (they can still be
// emitted when every unseen score lies below it). Items past I are never
// emitted, so no padding state exists.
#include "common.cuh"

namespace {

using namespace lgcnhs;

constexpr int kStep = 128;  // items scored per step; ops/cuda/retrieval.py STEP
constexpr int kDC = 16;     // depth of one staged operand slice; SLICE

constexpr int kTU = 48;            // users a block; ops/cuda/retrieval.py TOPK_USERS
constexpr int kTR = kTU / kWarps;  // users a warp scores and selects for
constexpr int kTSlices = 2;        // staged slices in flight; TOPK_SLICES
constexpr int kBuf = 48;           // survivors a user buffers between merges; TOPK_BUFFER
static_assert(kTR % 2 == 0 && kTR <= 8 && kStep == 128,
              "a thread scores kTR users (float2 reads) x 4 items of a step");
static_assert(kBuf >= 32, "a buffer also stages the compaction of up to 32 survivors");

// Memory of one block (ops/cuda/retrieval.py topk_block_bytes): kTSlices
// operand slices (kDC deep, kTU users and kStep items); four ints a user
// (list length, threshold key and id, buffered survivors); per user a
// buffer of kBuf survivors (keys, ids); per warp the ranked survivors of a
// merge (min(kStep, k)); then the long lists (LongLists: shared memory as
// far as they fit, the rest in the block's slice of a device-memory
// workspace).
struct TopkSmem {
  float* us;  // [kTSlices][kDC][kTU] user slices (d-major)
  float* is;  // [kTSlices][kDC][kStep] item slices
  int *run_n, *thr_key, *thr_id, *buf_n;
  int *buf_key, *buf_id, *sc_key, *sc_id;
  LongLists<kTU> lists;
  int sc_len;
  __host__ __device__ static size_t near_bytes(int k) {
    const int sc = k < kStep ? k : kStep;
    return 4 * ((size_t)kTSlices * kDC * (kTU + kStep) + 4 * kTU + (size_t)kTU * 2 * kBuf +
                (size_t)kWarps * 2 * sc);
  }
  static size_t smem_bytes(int place, int k) {
    return near_bytes(k) + 4 * LongLists<kTU>::shared_ints(place, k);
  }
  static int place(int k, int limit) { return LongLists<kTU>::place(near_bytes(k), k, limit); }
  __device__ TopkSmem(unsigned char* base, int* ws, int place, int k)
      : lists(reinterpret_cast<int*>(base + near_bytes(k)), ws, place, k) {
    us = reinterpret_cast<float*>(base);
    is = us + kTSlices * kDC * kTU;
    run_n = reinterpret_cast<int*>(is + kTSlices * kDC * kStep);
    thr_key = run_n + kTU;
    thr_id = thr_key + kTU;
    buf_n = thr_id + kTU;
    buf_key = buf_n + kTU;
    buf_id = buf_key + kTU * kBuf;
    sc_len = min(kStep, k);
    sc_key = buf_id + kTU * kBuf;
    sc_id = sc_key + kWarps * sc_len;
  }
};

// Bytes p[0..3] as one word (byte q in bits 8q..8q+7), read as two aligned
// words and a funnel shift (p need not be aligned), so that a thread's
// reads of its flags are independent of each other; bytes at or past `end`
// read as 0 (what lies past a row's last item is never used).
__device__ __forceinline__ unsigned load_4_bytes(const uint8_t* p, const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
  if (reinterpret_cast<const uint8_t*>(w + 2) <= end)
    return __funnelshift_r(__ldg(w), __ldg(w + 1), 8 * (unsigned)(a & 3));
  unsigned f = 0;
  for (int q = 0; q < 4; ++q)
    if (p + q < end) f |= (unsigned)p[q] << (8 * q);
  return f;
}

// An entry (key, id) as one 64-bit word that orders as ranks_before does:
// a larger word ranks before. 0 ranks after every entry of a score row.
__device__ __forceinline__ unsigned long long pack_entry(int key, int id) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)(INT_MAX - id);
}
// Raises the threshold (tk, ti) to the packed entry b when b ranks before it.
__device__ __forceinline__ void raise_threshold(unsigned long long b, int& tk, int& ti) {
  const int bk = (int)((unsigned)(b >> 32) ^ 0x80000000u), bi = INT_MAX - (int)(unsigned)b;
  if (ranks_before(bk, bi, tk, ti)) {
    tk = bk;
    ti = bi;
  }
}

// Block (catalog part, user group): users [u0, u0+48), items [j_lo, j_hi),
// walked in steps of 128 items. Writes the part's top-k of each user
// (ranked; past the part's item count, or past what the shared bound
// dropped, -inf with id INT_MAX) to row (part * U + u) of out_idx/out_val.
// kPlace (ListPlace): where the long lists live; ws has the block's slice.
// bound (U entries, 0 at launch): per user the best k-th entry any block
// has reached so far, packed (pack_entry). The catalog's k-th entry ranks
// at or before any part's k-th, so what ranks after a part's k-th cannot
// be among the user's k best: every block tests its scores against the
// better of its own k-th and this bound. Blocks run part-major, so
// the parts of later waves start from the k-th entries of finished parts
// and skip the sorting that a part's first steps otherwise need.
template <int kPlace>
__global__ void __launch_bounds__(kThreads, 2)
    fused_topk_kernel(const float* __restrict__ uT, int ldu, const float* __restrict__ itT,
                      int ldi, const uint8_t* __restrict__ seen, int U, int I, int D, int k,
                      int parts, int part_len, int* __restrict__ ws,
                      unsigned long long* __restrict__ bound, int32_t* __restrict__ out_idx,
                      float* __restrict__ out_val) {
  extern __shared__ float smem[];  // dynamic shared memory starts 16-byte aligned
  TopkSmem sm(reinterpret_cast<unsigned char*>(smem),
              kPlace == kListsShared ? nullptr
                                     : ws + blockIdx.x * LongLists<kTU>::ws_ints(kPlace, k),
              kPlace, k);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int groups = (U + kTU - 1) / kTU;
  const int part = blockIdx.x / groups, u0 = (blockIdx.x % groups) * kTU;
  const int j_lo = part * part_len, j_hi = min(I, j_lo + part_len);
  for (int u = threadIdx.x; u < kTU; u += kThreads) {
    sm.run_n[u] = 0;
    sm.buf_n[u] = 0;
    sm.thr_key[u] = INT_MIN;  // nothing to beat yet: every entry ranks before it
    sm.thr_id[u] = -1;
  }
  const int nd = (D + kDC - 1) / kDC;
  const int nsteps = (j_hi - j_lo + kStep - 1) / kStep;
  const int nc = nsteps * nd;
  auto load = [&](int c) {
    if (c < nc) {
      const int j0 = j_lo + (c / nd) * kStep, d0 = (c % nd) * kDC;
      float* ub = sm.us + (c % kTSlices) * kDC * kTU;
      float* ib = sm.is + (c % kTSlices) * kDC * kStep;
      for (int p = threadIdx.x; p < kDC * (kStep / 4); p += kThreads) {
        const int r = p / (kStep / 4), q = 4 * (p % (kStep / 4));
        const bool ok = d0 + r < D && j0 + q < ldi;
        cp_async16(ib + r * kStep + q, ok ? itT + (size_t)(d0 + r) * ldi + j0 + q : itT, ok);
      }
      for (int p = threadIdx.x; p < kDC * (kTU / 4); p += kThreads) {
        const int r = p / (kTU / 4), q = 4 * (p % (kTU / 4));
        const bool ok = d0 + r < D && u0 + q < ldu;
        cp_async16(ub + r * kTU + q, ok ? uT + (size_t)(d0 + r) * ldu + u0 + q : uT, ok);
      }
    }
    cp_async_commit();  // empty past the end
  };
  // thread: users w*6 + r (r < 6), items lane*4 + q (q < 4) of the step; a
  // user's survivors, running list and threshold belong to warp w alone
  float acc[kTR][4];
  unsigned flag[kTR];  // seen bytes of items lane*4 + q, byte q
  int* sk = sm.sc_key + w * sm.sc_len;  // the warp's ranked survivors of a merge
  int* si = sm.sc_id + w * sm.sc_len;
  const bool small = k <= 128;
  // one warp ranks user u's n buffered survivors and merges them into its
  // running list (in place for k <= 128); its threshold rises
  auto flush = [&](int u, int n) {
    rank_entries(sm.buf_key + u * kBuf, sm.buf_id + u * kBuf, n, k, sk, si);
    int run_key[4], run_id[4];
    const int run_n = sm.run_n[u];
    if (small) load_run_small(sm.lists.run_key + u * k, sm.lists.run_id + u * k, run_n, run_key,
                              run_id);
    merge_into_list(sk, si, min(n, k), run_n, run_key, run_id, sm.lists.run_key + u * k,
                    sm.lists.run_id + u * k, sm.run_n + u, sm.thr_key + u, sm.thr_id + u,
                    sm.lists.mg_key + w * k, sm.lists.mg_id + w * k, k);
    if (lane == 0) sm.buf_n[u] = 0;
    __syncwarp();
  };
  // lane 0 offers user u's k-th entry, once its list holds k, to the bound
  auto publish = [&](int u) {
    if (lane == 0 && sm.run_n[u] == k)
      atomicMax(bound + u0 + u, pack_entry(sm.thr_key[u], sm.thr_id[u]));
  };
  unsigned long long gb = 0;  // lane r < 6: the bound of user w*6 + r at this step
  const int seen_key = order_key(kSeenValue);
  const uint8_t* seen_end = seen + (size_t)U * I;
  for (int c = 0; c < kTSlices - 1; ++c) load(c);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kTSlices - 2>();
    __syncthreads();  // slice c landed; slice c - 1 is no longer read
    load(c + kTSlices - 1);
    const int st = c / nd, dc = c % nd;
    const int j0 = j_lo + st * kStep + lane * 4;
    if (dc == 0) {
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        // the step's seen flags, read now so that they arrive during the
        // products (read in the epilogue, their latency would stall it)
        flag[r] = load_4_bytes(seen + (size_t)min(u0 + w * kTR + r, U - 1) * I + j0, seen_end);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
      if (lane < kTR) gb = __ldcg(bound + min(u0 + w * kTR + lane, U - 1));
    }
    const float* ub = sm.us + (c % kTSlices) * kDC * kTU + w * kTR;
    const float* ib = sm.is + (c % kTSlices) * kDC * kStep + lane * 4;
    const int dn = min(kDC, D - dc * kDC);
    // each score is one fmaf chain over ascending d: three broadcast
    // float2s of users and one float4 of items for 24 FMAs
    auto dot_step = [&](int d) {
      float uu[kTR];
#pragma unroll
      for (int p = 0; p < kTR / 2; ++p) {
        const float2 t = *reinterpret_cast<const float2*>(ub + d * kTU + 2 * p);
        uu[2 * p] = t.x;
        uu[2 * p + 1] = t.y;
      }
      const float4 iv = *reinterpret_cast<const float4*>(ib + d * kStep);
      const float ii[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
      for (int r = 0; r < kTR; ++r)
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
    // selection. First every user's threshold test, in registers: a score
    // survives when it ranks before the user's running k-th (pass bits 4r..
    // 4r+3 of `pass_bits`, bit r of `busy` when any lane of the warp has one).
    // A busy user appends its survivors to its buffer; only when they would
    // overflow it is the buffer merged first (the threshold rises, so the
    // step's survivors are tested again), and a step with more than kBuf
    // survivors (a part's first steps) is sorted in registers and merged.
    unsigned pass_bits = 0, busy = 0;
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int u = kTR * w + r;
      int tk = sm.thr_key[u], ti = sm.thr_id[u];
      raise_threshold(__shfl_sync(0xffffffffu, gb, r), tk, ti);
      unsigned bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = ((flag[r] >> (8 * q)) & 0xffu) ? seen_key : order_key(acc[r][q]);
        if (j0 + q < j_hi && ranks_before(key, j0 + q, tk, ti)) bits |= 1u << q;
      }
      pass_bits |= bits << (4 * r);
      if (u0 + u < U && __any_sync(0xffffffffu, bits != 0)) busy |= 1u << r;
    }
    while (busy) {
      const int r = __ffs(busy) - 1;
      busy &= busy - 1;
      const int u = kTR * w + r;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      unsigned f = 0;
#pragma unroll
      for (int r2 = 0; r2 < kTR; ++r2) {  // row r of the register tile
        if (r2 == r) {
          f = flag[r2];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = acc[r2][q];
        }
      }
      int key[4], id[4];
      bool pass[4];
      int m = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        id[q] = j0 + q;
        key[q] = ((f >> (8 * q)) & 0xffu) ? seen_key : order_key(v[q]);
        pass[q] = (pass_bits >> (4 * r + q)) & 1u;
        m += __popc(__ballot_sync(0xffffffffu, pass[q]));
      }
      int n = sm.buf_n[u];
      int* bk = sm.buf_key + u * kBuf;
      int* bi = sm.buf_id + u * kBuf;
      if (n + m > kBuf) {
        if (n > 0) {
          flush(u, n);
          publish(u);
          n = 0;
          int tk = sm.thr_key[u], ti = sm.thr_id[u];
          raise_threshold(__shfl_sync(0xffffffffu, gb, r), tk, ti);
          m = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pass[q] = pass[q] && ranks_before(key[q], id[q], tk, ti);
            m += __popc(__ballot_sync(0xffffffffu, pass[q]));
          }
        }
        if (m > kBuf) {
          int run_key[4], run_id[4];
          const int run_n = sm.run_n[u];
          if (small) load_run_small(sm.lists.run_key + u * k, sm.lists.run_id + u * k, run_n,
                                    run_key, run_id);
          merge_row_survivors(key, id, pass, m, bk, bi, sk, si, run_n, run_key, run_id,
                              sm.lists.run_key + u * k, sm.lists.run_id + u * k, sm.run_n + u,
                              sm.thr_key + u, sm.thr_id + u, sm.lists.mg_key + w * k,
                              sm.lists.mg_id + w * k, k);
          publish(u);
          continue;
        }
      }
      // append (ballots: a fixed order)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned bal = __ballot_sync(0xffffffffu, pass[q]);
        if (pass[q]) {
          const int pos = n + __popc(bal & ((1u << lane) - 1u));
          bk[pos] = key[q];
          bi[pos] = id[q];
        }
        n += __popc(bal);
      }
      if (lane == 0) sm.buf_n[u] = n;
      __syncwarp();
    }
  }
  for (int r = 0; r < kTR; ++r) {  // what the buffers still hold
    const int u = kTR * w + r;
    if (u0 + u >= U) break;
    const int n = sm.buf_n[u];
    if (n > 0) flush(u, n);
  }
  cp_async_wait<0>();
  for (int r = 0; r < kTR; ++r) {
    const int u = kTR * w + r;
    if (u0 + u >= U) break;
    const size_t o = ((size_t)part * U + u0 + u) * k;
    const int n = sm.run_n[u];
    for (int t = lane; t < k; t += 32) {
      const bool real = t < n;
      out_idx[o + t] = real ? sm.lists.run_id[u * k + t] : INT_MAX;
      out_val[o + t] = real ? key_value(sm.lists.run_key[u * k + t]) : knocked_out();
    }
  }
}

// f(kernel) for the instance whose long lists live at `place`; `bad` for
// other values.
template <typename F>
int with_topk_kernel(int place, int bad, F&& f) {
  if (place == kListsShared) return f(fused_topk_kernel<kListsShared>);
  if (place == kRunGlobal) return f(fused_topk_kernel<kRunGlobal>);
  if (place == kAllGlobal) return f(fused_topk_kernel<kAllGlobal>);
  return bad;
}

}  // namespace

// uT (D, ldu) and itT (D, ldi): the transposed user and item tables, row
// strides multiples of 4 floats (zero padding past U and I), 16-byte
// aligned; seen (U, I) bytes; 1 <= k <= I. parts catalog parts of part_len
// items (a multiple of 128) covering I; with parts > 1, part_idx/part_val
// hold (parts, U, k) entries for the merge. smem_limit: the device's shared
// memory a block may take; the long lists not in it go to ws,
// fused_topk_workspace_bytes for each of the ceil(U / 48) * parts blocks
// (null when that is 0). bound: U 64-bit words of scratch, cleared here.
extern "C" int fused_topk_retrieval_launch(const float* uT, int ldu, const float* itT, int ldi,
                                           const uint8_t* seen, int U, int I, int D, int k,
                                           int parts, int part_len, int smem_limit, int* ws,
                                           unsigned long long* bound, int32_t* part_idx,
                                           float* part_val, int32_t* idx, float* vals,
                                           void* stream) {
  const int place = TopkSmem::place(k, smem_limit);
  if (U < 1 || I < 1 || D < 1 || k < 1 || k > I || ldu < U || ldu % 4 || ldi < I || ldi % 4 ||
      parts < 1 || part_len < kStep || part_len % kStep ||
      (long long)parts * part_len < I || (long long)(parts - 1) * part_len >= I || place < 0 ||
      (place != kListsShared && !ws) || !bound || (parts > 1 && (!part_idx || !part_val)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(bound, 0, sizeof(unsigned long long) * U, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (U + kTU - 1) / kTU * parts;
  const size_t smem = TopkSmem::smem_bytes(place, k);
  int32_t* out_idx = parts > 1 ? part_idx : idx;
  float* out_val = parts > 1 ? part_val : vals;
  int rc = with_topk_kernel(place, (int)cudaErrorInvalidValue, [&](auto kernel) {
    return lgcnhs_launch(kernel, blocks, smem, stream, uT, ldu, itT, ldi, seen, U, I, D, k,
                         parts, part_len, ws, bound, out_idx, out_val);
  });
  if (rc != 0 || parts == 1) return rc;
  return lgcnhs_launch_part_merge(part_idx, part_val, U, k, parts, smem_limit, idx, vals, stream);
}

// Shared memory of one block at k, its long lists placed within
// smem_limit; -1 when the block does not fit.
extern "C" long long fused_topk_smem_bytes(int k, int smem_limit) {
  const int place = TopkSmem::place(k, smem_limit);
  return place < 0 ? -1 : (long long)TopkSmem::smem_bytes(place, k);
}

// Workspace bytes of one block: its long lists that do not fit
// smem_limit; -1 when the block does not fit even without them.
extern "C" long long fused_topk_workspace_bytes(int k, int smem_limit) {
  const int place = TopkSmem::place(k, smem_limit);
  return place < 0 ? -1 : 4 * (long long)LongLists<kTU>::ws_ints(place, k);
}

// One-shot blocks at k that one SM of the current device holds at once
// (registers and shared memory); -1 on error.
extern "C" int fused_topk_resident_blocks(int k, int smem_limit) {
  const int place = TopkSmem::place(k, smem_limit);
  if (place < 0) return -1;
  const int smem = (int)TopkSmem::smem_bytes(place, k);
  return with_topk_kernel(place, -1, [&](auto kernel) {
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
      return -1;
    return n;
  });
}
