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

// -- copies, tensor-core fragments and products ------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled (src not read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row-major) b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- selection over a walked catalog: running top-k lists, the merge of parts -
//
// A block that walks the catalog keeps, per user, a running top-k (order
// keys and ids, in rank order) and its k-th entry as a threshold; scores
// that do not rank before the threshold are dropped where they are made,
// and the survivors are ranked (rank_entries, or warp_sort128 for many) and
// merged into the list (merge_ranked, merge_ranked_small). A block covers
// one part of the catalog; part_lists_merge_kernel merges each user's
// part lists.

// Rank of (xkey, xid) among the m entries of a list sorted in rank order:
// how many of them rank before it.
__device__ __forceinline__ int rank_in(const int* key, const int* id, int m, int xkey,
                                       int xid) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ranks_before(key[mid], id[mid], xkey, xid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// rank_in for m <= 255 in a fixed number of steps, so that several
// searches interleave: the true prefix of "ranks before x", found by
// halving steps.
__device__ __forceinline__ int rank_in_short(const int* key, const int* id, int m, int xkey,
                                             int xid) {
  int lo = 0;
#pragma unroll
  for (int step = 128; step > 0; step >>= 1)
    if (lo + step <= m && ranks_before(key[lo + step - 1], id[lo + step - 1], xkey, xid))
      lo += step;
  return lo;
}

// Where a block's long lists live: all in shared memory; the running lists
// in device memory; the merge lists there too.
enum ListPlace : int { kListsShared = 0, kRunGlobal = 1, kAllGlobal = 2 };

// The long lists of a block of NU users (k entries each, keys and ids):
// each warp's merge list and each user's running top-k. Those
// that `place` puts in shared memory follow the block's other shared
// memory (`near` bytes); the rest live in the block's slice of a
// workspace in device memory.
template <int NU>
struct LongLists {
  int *mg_key, *mg_id, *run_key, *run_id;
  __device__ LongLists(int* shared, int* ws, int place, int k) {
    mg_key = place == kAllGlobal ? ws : shared;
    mg_id = mg_key + kWarps * k;
    run_key = place == kRunGlobal ? ws : mg_id + kWarps * k;
    run_id = run_key + NU * k;
  }
  // ints of the long lists in shared memory and in the workspace
  __host__ __device__ static size_t shared_ints(int place, int k) {
    return place == kListsShared ? (size_t)(NU + kWarps) * 2 * k
                                 : place == kRunGlobal ? (size_t)kWarps * 2 * k : 0;
  }
  __host__ __device__ static size_t ws_ints(int place, int k) {
    return (size_t)(NU + kWarps) * 2 * k - shared_ints(place, k);
  }
  // the first place whose shared memory fits `limit`; -1 when none does
  static int place(size_t near, int k, int limit) {
    for (int p = kListsShared; p <= kAllGlobal; ++p)
      if (near + 4 * shared_ints(p, k) <= (size_t)limit) return p;
    return -1;
  }
};

// One warp ranks m unranked entries (nk, ni: distinct ids): an entry's
// rank among them is the number that rank before it (ids are distinct, so
// ranks are too), and the best min(m, k) land at their ranks in (sk, si),
// now sorted. O(m^2 / 32) a lane: for short lists.
__device__ inline void rank_entries(const int* nk, const int* ni, int m, int k, int* sk,
                                    int* si) {
  const int lane = threadIdx.x & 31, sel = min(m, k);
  for (int p = lane; p < m; p += 32) {
    const int key = nk[p], id = ni[p];
    int r = 0;
    for (int q = 0; q < m; ++q) r += ranks_before(nk[q], ni[q], key, id);
    if (r < sel) {
      sk[r] = key;
      si[r] = id;
    }
  }
  __syncwarp();
}

// One warp sorts 128 entries, 4 a lane (entry 4 lane + r in register r),
// into rank order: a bitonic network, 28 compare-exchange steps (strides
// below 4 within a lane, the others across lanes by shuffles). Unused
// slots hold (INT_MIN, INT_MAX), which rank after every entry of a score.
__device__ __forceinline__ void warp_sort128(int (&key)[4], int (&id)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * lane + r;
          const int ok = __shfl_xor_sync(0xffffffffu, key[r], stride >> 2);
          const int oi = __shfl_xor_sync(0xffffffffu, id[r], stride >> 2);
          // the lower index of a pair takes the entry that ranks first in an
          // ascending run, the other in a descending one
          const bool first = ((i & stride) == 0) == ((i & size) == 0);
          if (ranks_before(key[r], id[r], ok, oi) != first) {
            key[r] = ok;
            id[r] = oi;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r & stride) continue;
          const int r2 = r | stride, i = 4 * lane + r;
          const bool up = (i & size) == 0;
          if (ranks_before(key[r2], id[r2], key[r], id[r]) == up) {
            const int tk = key[r], ti = id[r];
            key[r] = key[r2];
            id[r] = id[r2];
            key[r2] = tk;
            id[r2] = ti;
          }
        }
      }
    }
  }
}

// One warp merges sel ranked entries (sk, si: distinct ids, none in the
// running list) into a user's running top-k (rk, ri: *run_n entries in
// rank order), in one counted pass rather than k selection passes:
// running entry t goes to t + c(t), c(t) the ranked entries before it (a
// binary search of that short list); ranked entries c(t) .. c(t+1) - 1
// rank after entries 0..t and before t + 1, so they follow entry t
// directly. A lane takes entries lane, lane + 32, ...; entry t + 1's rank
// is lane + 1's (lane 31: lane 0's next), and each pass loads the entries
// of the pass after next, so a load's latency hides behind a pass. Into
// the warp's merge list (mk, mi: k entries), then copied back. Once the
// list holds k entries its k-th becomes the threshold (*thr_key,
// *thr_id): from then on only what ranks before it can enter.
__device__ inline void merge_ranked(const int* sk, const int* si, int sel, int* rk, int* ri,
                                    int* run_n, int* thr_key, int* thr_id, int* mk, int* mi,
                                    int k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nr = *run_n;
  const int total = min(k, nr + sel);
  int key = 0, id = 0, key2 = 0, id2 = 0, c = sel;
  if (lane < nr) {
    key = rk[lane];
    id = ri[lane];
  }
  if (lane + 32 < nr) {
    key2 = rk[lane + 32];
    id2 = ri[lane + 32];
  }
  if (lane < nr) c = rank_in(sk, si, sel, key, id);
  const int c0 = __shfl_sync(full, c, 0);  // ranked entries before entry 0 (all when nr = 0)
  for (int t = lane; t - lane < nr; t += 32) {
    int key3 = 0, id3 = 0;
    if (t + 64 < nr) {
      key3 = rk[t + 64];
      id3 = ri[t + 64];
    }
    const int c2 = t + 32 < nr ? rank_in(sk, si, sel, key2, id2) : sel;
    int c1 = __shfl_down_sync(full, c, 1);
    const int c2_lane0 = __shfl_sync(full, c2, 0);
    if (lane == 31) c1 = c2_lane0;
    if (t < nr) {
      if (t + c < k) {
        mk[t + c] = key;
        mi[t + c] = id;
      }
      for (int j = c; j < c1 && j + t + 1 < k; ++j) {
        mk[j + t + 1] = sk[j];
        mi[j + t + 1] = si[j];
      }
    }
    key = key2;
    id = id2;
    c = c2;
    key2 = key3;
    id2 = id3;
  }
  for (int j = lane; j < c0; j += 32) {  // j < sel <= k
    mk[j] = sk[j];
    mi[j] = si[j];
  }
  __syncwarp();
  for (int t = lane; t < total; t += 32) {
    rk[t] = mk[t];
    ri[t] = mi[t];
  }
  __syncwarp();
  if (lane == 0) {
    *run_n = total;
    if (total == k) {
      *thr_key = mk[k - 1];
      *thr_id = mi[k - 1];
    }
  }
  __syncwarp();
}

// A warp's registers hold a running list of nr <= 128 entries: lane + 32 i
// in (key[i], id[i]), i < 4. One round trip, so it can be issued early.
__device__ __forceinline__ void load_run_small(const int* rk, const int* ri, int nr,
                                               int (&key)[4], int (&id)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = 0;
    id[i] = 0;
    if (lane + 32 * i < nr) {
      key[i] = rk[lane + 32 * i];
      id[i] = ri[lane + 32 * i];
    }
  }
}

// merge_ranked for k <= 128, in place: the running list's nr entries are
// already in registers (load_run_small), so there is no merge list and no
// copy back; an entry's place comes from the ranked entries before it,
// counted for up to 16 of them, else found by four independent searches.
// The lane that writes entry k - 1 sets the threshold.
__device__ __forceinline__ void merge_ranked_small(const int* sk, const int* si, int sel,
                                                   int nr, const int (&key)[4],
                                                   const int (&id)[4], int* rk, int* ri,
                                                   int* run_n, int* thr_key, int* thr_id,
                                                   int k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int c[4];
  if (sel <= 16) {  // a few: count them, independent reads, no search chain
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = 0;
    for (int s = 0; s < sel; ++s) {
      const int a = sk[s], b = si[s];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] += ranks_before(a, b, key[i], id[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)  // past the list: after every ranked entry
      if (lane + 32 * i >= nr) c[i] = sel;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = lane + 32 * i < nr ? rank_in_short(sk, si, sel, key[i], id[i]) : sel;
  }
  int cn[4];  // c of the next entry: lane + 1's (lane 31: lane 0's of the next i)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int down = __shfl_down_sync(full, c[i], 1);
    const int wrap = __shfl_sync(full, i < 3 ? c[i < 3 ? i + 1 : 3] : sel, 0);
    cn[i] = lane == 31 ? wrap : down;
  }
  const int c0 = __shfl_sync(full, c[0], 0);  // ranked entries before entry 0 (all when nr = 0)
  __syncwarp();  // every lane's entries were read before any is overwritten
  auto put = [&](int p, int pk, int pi) {
    rk[p] = pk;
    ri[p] = pi;
    if (p == k - 1) {
      *thr_key = pk;
      *thr_id = pi;
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = lane + 32 * i;
    if (t < nr) {
      if (t + c[i] < k) put(t + c[i], key[i], id[i]);
      for (int j = c[i]; j < cn[i] && j + t + 1 < k; ++j) put(j + t + 1, sk[j], si[j]);
    }
  }
  for (int j = lane; j < c0; j += 32) put(j, sk[j], si[j]);  // j < sel <= k
  __syncwarp();
  if (lane == 0) *run_n = min(k, nr + sel);
  __syncwarp();
}

// One warp merges sel ranked entries (sk, si) into a user's running top-k
// (rk, ri; *run_n entries, threshold *thr_key, *thr_id): for k <= 128 in
// place, the list's run_n entries already in registers (run_key, run_id:
// load_run_small), else through the warp's merge list (mk, mi).
__device__ __forceinline__ void merge_into_list(const int* sk, const int* si, int sel, int run_n,
                                                const int (&run_key)[4], const int (&run_id)[4],
                                                int* rk, int* ri, int* run_n_p, int* thr_key,
                                                int* thr_id, int* mk, int* mi, int k) {
  if (k <= 128)
    merge_ranked_small(sk, si, sel, run_n, run_key, run_id, rk, ri, run_n_p, thr_key, thr_id, k);
  else
    merge_ranked(sk, si, sel, rk, ri, run_n_p, thr_key, thr_id, mk, mi, k);
}

// One warp merges the survivors of one 128-entry row into a user's running
// top-k. Lane `lane` holds entries (key[b], id[b]), b < 4 (distinct ids,
// none in the list); pass[b] marks a survivor, m >= 1 of them in all. Many
// survivors (> 32: the first rows, where nearly all pass) are ranked by a
// bitonic sort in registers (warp_sort128: O(log^2) steps, not O(m^2));
// a few are compacted (ballots: a fixed order) into (sv_key, sv_id) and
// ranked by counting. The ranked survivors go to (sk, si), min(m, k) of
// them, and are merged into the list (merge_into_list).
__device__ __forceinline__ void merge_row_survivors(int (&key)[4], int (&id)[4],
                                                    const bool (&pass)[4], int m, int* sv_key,
                                                    int* sv_id, int* sk, int* si, int run_n,
                                                    const int (&run_key)[4],
                                                    const int (&run_id)[4], int* rk, int* ri,
                                                    int* run_n_p, int* thr_key, int* thr_id,
                                                    int* mk, int* mi, int k) {
  const int lane = threadIdx.x & 31;
  if (m > 32) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (!pass[b]) {
        key[b] = INT_MIN;
        id[b] = INT_MAX;
      }
    }
    warp_sort128(key, id);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (4 * lane + b < min(m, k)) {
        sk[4 * lane + b] = key[b];
        si[4 * lane + b] = id[b];
      }
    }
    __syncwarp();
  } else {
    int pos = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned bal = __ballot_sync(0xffffffffu, pass[b]);
      if (pass[b]) {
        sv_key[pos + __popc(bal & ((1u << lane) - 1u))] = key[b];
        sv_id[pos + __popc(bal & ((1u << lane) - 1u))] = id[b];
      }
      pos += __popc(bal);
    }
    __syncwarp();
    rank_entries(sv_key, sv_id, m, k, sk, si);
  }
  merge_into_list(sk, si, min(m, k), run_n, run_key, run_id, rk, ri, run_n_p, thr_key, thr_id,
                  mk, mi, k);
}

// The k best of each user's `parts` ranked part lists, in rank order, one
// warp a user, `upb` users a block. Part list p of user u is row
// (p * U + u) of part_idx/part_val, k entries, ranked; a list may end in
// padding, -inf with id INT_MAX, and all lists together hold at least k
// real entries.
// kStaged: rank counting over the user's lists staged in shared memory
// (8 parts k bytes a user): an entry's place in the merged order is its
// place in its own list plus, in every other list, the entries that rank
// before it (a binary search of each other list); padding is never placed,
// as k real entries rank before it. Otherwise warp_select over the lists
// in device memory, knocking selected entries out to -inf there.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    part_lists_merge_kernel(int32_t* __restrict__ part_idx, float* __restrict__ part_val,
                            int U, int k, int parts, int upb, int32_t* __restrict__ idx,
                            float* __restrict__ vals) {
  extern __shared__ int staged[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int u = blockIdx.x * upb + w;
  if (w >= upb || u >= U) return;
  auto at = [&](int p) { return ((size_t)(p / k) * U + u) * k + p % k; };
  if constexpr (kStaged) {
    const int n = parts * k;
    int* key = staged + (size_t)w * 2 * n;
    int* id = key + n;
    for (int p = lane; p < n; p += 32) {
      key[p] = order_key(part_val[at(p)]);
      id[p] = part_idx[at(p)];
    }
    __syncwarp();
    for (int p = lane; p < n; p += 32) {
      const int own = p / k, xk = key[p], xi = id[p];
      if (xi == INT_MAX) continue;  // padding: the lists hold at least k real entries
      int r = p % k;
      for (int q = 0; q < parts && r < k; ++q) {
        if (q == own) continue;
        const int* qk = key + q * k;
        const int* qi = id + q * k;
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ranks_before(qk[mid], qi[mid], xk, xi))
            lo = mid + 1;
          else
            hi = mid;
        }
        r += lo;
      }
      if (r < k) {
        idx[(size_t)u * k + r] = xi;
        vals[(size_t)u * k + r] = key_value(xk);
      }
    }
  } else {
    warp_select(
        parts * k, k,
        [&](int p, int& key, int& id) {
          key = order_key(part_val[at(p)]);
          id = part_idx[at(p)];
        },
        [&](int p) { part_val[at(p)] = knocked_out(); },
        [&](int t, int key, int id) {
          idx[(size_t)u * k + t] = id;
          vals[(size_t)u * k + t] = key_value(key);
        });
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

// Launches the merge of each user's `parts` ranked part lists (k entries
// each) into idx/vals: staged in shared memory when one user's lists fit
// smem_limit, as many users a block as fit (at most a warp each), else
// through device memory.
static int lgcnhs_launch_part_merge(int32_t* part_idx, float* part_val, int U, int k, int parts,
                                    int smem_limit, int32_t* idx, float* vals, void* stream) {
  const size_t per_user = 8 * (size_t)parts * k;
  const size_t fit = smem_limit > 0 ? (size_t)smem_limit / per_user : 0;
  const int upb = (int)(fit < (size_t)lgcnhs::kWarps ? fit : lgcnhs::kWarps);
  if (upb >= 1)
    return lgcnhs_launch(lgcnhs::part_lists_merge_kernel<true>, (U + upb - 1) / upb,
                         upb * per_user, stream, part_idx, part_val, U, k, parts, upb, idx, vals);
  return lgcnhs_launch(lgcnhs::part_lists_merge_kernel<false>,
                       (U + lgcnhs::kWarps - 1) / lgcnhs::kWarps, 0, stream, part_idx, part_val,
                       U, k, parts, lgcnhs::kWarps, idx, vals);
}
