// Fused LGCNHS serving for Hopper (sm_90a): G = u.i^T, F = A.W, the fused
// score G*F with seen items excluded, and top-k, without writing any (U, I)
// intermediate to device memory, at any catalog size.
//
// Replaces lgcnhs_tpu/ops/pallas/fusion_serve.py fused_lgcnhs_serve
// (pl.pallas_call at :157).
//
// What bounds it: F = A.W. Its sparse work is nnz(A) * I multiply-adds
// (0.2 TFLOP at ML-1M, 6040 x 3706); as a gather (the earlier design)
// every nonzero re-reads a W row through L2, ~9 GB there, latency-bound.
// This design does the product on the tensor cores instead, a tile of 128
// users reading each W tile once for all 128. It walks the contraction one
// of two ways:
// - dense: over all I, 3 x 2 x U x I x I = 0.50 TFLOP at ML-1M (0.50 ms at
//   989 TFLOP/s), where most of a block's A columns are nonzero;
// - compacted: a block of 128 users over J_b alone, the sorted union of its
//   users' items (padded to a multiple of kKC), so the zero columns of A
//   are skipped: at Gowalla and Amazon-Book densities (0.06-0.08%) J_b is
//   5-6% of the catalog. The terms left out are products with A = 0, so F
//   changes in f32 summation order only.
// The serving path picks the walk from its input (models/fusion
// compact_walk): compacted where a block's rows, 128 n / U on average for n
// train+val rows and a bound on |J_b|, are at most half the catalog.
//
// Operands. A is 0/1 on the serving path, exact in bf16 (its one-part
// split flags an A that is not, which then goes in as three parts, NA =
// 3). W goes in as three bf16 parts, W_hi + W_mid + W_lo = W exactly (each
// holds the next 8 significand bits; ops/cuda/fusion_serve.py bf16_parts).
// Dense walk: parts of W^T, so that both operands are K-major. Compacted
// walk: A restricted to J_b, block b's 128 rows of |J_b| entries
// (K-major), and parts of W itself, N-major (row l holds W[l, :]), so that
// the 128 items of a tile are one contiguous 256-byte piece of each
// gathered row l of J_b; the tensor cores read that B tile MN-major (the
// transpose bit of bf16 wgmma). Every product of parts is exact in f32 and
// the sums run in f32 (wgmma, bf16 in, f32 accumulators), so F differs
// from the plain f32 matmul only in summation order: bitwise equal on
// dyadic inputs.
//
// Design. A block owns kBM = 128 users and one part of the catalog, which
// it walks in item tiles of kBN = 128. For a tile:
// 1. F tile = A[users, :] W[:, tile], the contraction over the walk's
//    columns (all I, or J_b) in chunks of kKC = 32 through a ring of 4
//    cp.async chunks (zero filled past the edges), laid out in the tensor
//    cores' 64-byte swizzle; copies run 2 chunks ahead and one chunk's
//    products stay in flight while the next is issued. On the compacted
//    walk a thread reads its W rows' indices one chunk before it copies
//    them. Two warpgroups, each 64 users x the 128 items: wgmma
//    m64n128k16 reads both operands from shared memory (no ldmatrix
//    traffic through the registers, which bounded an mma.sync design), one
//    product per part pair and 16-deep step.
// 2. G for the same 128 x 128 on the CUDA cores in f32, each score one
//    fmaf chain over ascending d, from 16-deep slices of the transposed
//    user and item tables; then G * F into a fused tile in shared memory
//    (the ring's space, drained by then).
// 3. Selection, with the retrieval kernel's lists (common.cuh):
//    a warp owns 16 users; per user it drops every score that does not
//    rank before the user's running k-th and merges the tile's survivors
//    into the running top-k. Survivors are ranked by a bitonic sort in
//    registers when there are many (the first tiles of a part, where
//    nearly all survive: O(log^2) steps, not O(m^2)), else compacted
//    (ballots: a fixed order) and ranked by counting. Up to k = 128 a
//    user's running list fits the warp's registers: it is loaded while the
//    previous user is selected and merged in place (merge_ranked_small).
//    Seen items score -3e38 (their flags are loaded when the tile starts)
//    and stay candidates, so a user with fewer than k unseen items gets its
//    seen items, lowest id first.
// The wrapper splits A and W^T with bf16_parts_kernel, one pass each;
// serving sets A's one part (or its compacted operands) from its edges and
// splits W a block of items at a time into the parts buffer: rows of W^T,
// or columns of W's rows (models/fusion.kernel_operands).
// No array grows with I: the running lists (k entries a user) sit in
// shared memory as far as they fit and in a device-memory workspace past
// that (LongLists), so every catalog size and every k runs. The catalog
// is split into parts so that the blocks fill the card (the plan comes
// from this kernel's own occupancy, ops/cuda/fusion_serve.py serve_plan);
// with more than one part, part_lists_merge_kernel merges each user's part
// lists. Every sum has one fixed order and no atomics: two launches on the
// same inputs are bitwise equal.
//
// Ties follow the plain serving chain (_serve_unfused): value descending in
// the float's total order (+0 above -0), then the lowest id; a list holds
// k distinct ids, and items past I or users past U are never emitted. (The
// Pallas kernel knocks out to -3e38 and repeats an id in a short list's
// tail; that is its quirk, not this contract.)
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

using namespace lgcnhs;

constexpr int kBM = 128;      // users a block; ops/cuda/fusion_serve.py BLOCK_USERS
constexpr int kBN = 128;      // items a tile; BLOCK_ITEMS
constexpr int kKC = 32;       // contraction depth of one chunk; CHUNK
constexpr int kStages = 4;    // chunks in the copy ring; STAGES
constexpr int kAhead = kStages - 2;  // chunks copied ahead; one product group stays in flight
constexpr int kWP = 3;        // bf16 parts of W; W_PARTS
constexpr int kGD = 16;       // depth of one staged slice of the G operands; G_SLICE
constexpr int kKT = kBN + 8;  // row stride (floats) of the fused tile: spreads the banks
constexpr int kUW = kBM / kWarps;            // users a warp selects for
constexpr int kABytes = kBM * kKC * 2;       // one A part of a chunk (bf16)
constexpr int kWBytes = kKC * kBN * 2;       // one W part of a chunk (bf16)
static_assert(kBM == kBN, "the G slices are staged as one array of float4s");
static_assert(kUW == 16 && kBN == 128, "a lane selects 4 items of a tile");

// Tiles of 64-byte rows (kKC bf16 entries of the contraction) in the
// tensor cores' 64-byte swizzle: 16-byte chunk c of row r sits at chunk
// c ^ ((r >> 1) & 3), so 8 rows of one chunk fall in 8 bank groups.
__device__ __forceinline__ int sw64_chunk(int r, int c) { return c ^ ((r >> 1) & 3); }

// wgmma shared-memory descriptor of a K-major tile of 64-byte rows in the
// 64-byte swizzle (rows of 8-row groups 512 bytes apart), starting at p
// (the tile 512-byte aligned; +32 bytes for the second 16-deep step).
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// wgmma shared-memory descriptor of the compacted walk's N-major W tile:
// kKC rows of the contraction, each row's 128 items as four 64-byte pieces
// of 32 items, piece g of every row in a sub-tile of its own (kKC rows of 64
// bytes, 2 KB, at g * 2 KB), in the 64-byte swizzle. Read MN-major: 8-row
// groups 512 bytes apart (the stride offset), the 32-item sub-tiles 2 KB
// apart (the leading offset); p the tile, +1 KB for the second 16-deep step.
__device__ __forceinline__ uint64_t sw64_desc_mn(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((kKC * 64) >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// The copies a thread made (cp.async, the generic proxy), visible to the
// tensor cores' reads of shared memory (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence(float (&d)[64]) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_operands(d);
}

// d (64 x 128, f32, the warpgroup's) += A (64 x 16) B^T (B: 128 x 16), A
// and B bf16 tiles in shared memory (descriptors da, db), A K-major, B
// K-major (kTB = 0) or MN-major (kTB = 1, the transpose bit).
template <int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTB));
}

// Memory of one block (ops/cuda/fusion_serve.py serve_block_bytes): the
// region of the copy ring (kStages chunks of NA A parts and kWP W parts),
// which the epilogue then holds the fused tile and the G slices in; per
// user its list length and threshold; per warp one tile's survivors (kBN
// entries: order keys, ids) and a fold's ranked survivors (min(kBN, k));
// then the long lists (LongLists: shared memory as far as they fit, the
// rest in the workspace).
struct ServeSmem {
  unsigned char* region;
  int *run_n, *thr_key, *thr_id;
  int *sv_key, *sv_id, *sc_key, *sc_id;
  LongLists<kBM> lists;
  int sc_len;
  __host__ __device__ static size_t region_bytes(int na) {
    const size_t ring = (size_t)kStages * (na * kABytes + kWP * kWBytes);
    const size_t epi = 4 * ((size_t)kBM * kKT + (size_t)kGD * (kBM + kBN));
    return ring > epi ? ring : epi;
  }
  __host__ __device__ static size_t near_bytes(int k, int na) {
    const int sc = k < kBN ? k : kBN;
    return region_bytes(na) +
           4 * (3 * (size_t)kBM + (size_t)kWarps * 2 * kBN + (size_t)kWarps * 2 * sc);
  }
  static size_t smem_bytes(int place, int k, int na) {
    return near_bytes(k, na) + 4 * LongLists<kBM>::shared_ints(place, k);
  }
  static int place(int k, int na, int limit) {
    return LongLists<kBM>::place(near_bytes(k, na), k, limit);
  }
  __device__ ServeSmem(unsigned char* base, int* ws, int place, int k, int na)
      : lists(reinterpret_cast<int*>(base + near_bytes(k, na)), ws, place, k) {
    region = base;
    run_n = reinterpret_cast<int*>(base + region_bytes(na));
    thr_key = run_n + kBM;
    thr_id = thr_key + kBM;
    sv_key = thr_id + kBM;
    sv_id = sv_key + kWarps * kBN;
    sc_len = min(kBN, k);
    sc_key = sv_id + kWarps * kBN;
    sc_id = sc_key + kWarps * sc_len;
  }
};

// Block (user group, catalog part): users [u0, u0+kBM), items [j_lo, j_hi).
// Writes the part's top-k of each user (ranked; past the part's item count
// -inf with id INT_MAX) to row (part * U + u) of out_idx/out_val.
// NA: bf16 parts of A; kPlace (ListPlace): where the long lists live, ws
// has the block's slice. kCompact: the compacted walk (NA = 1): user block
// b contracts over columns col_ptr[b] .. col_ptr[b + 1] - 1 (a multiple of
// kKC), cols[l] the item of column l, Ap block b's kBM rows of A over them
// from kBM * col_ptr[b] (zero rows past U), Wp W's parts N-major (row l is
// W[l, :]); else the dense walk over all I, Ap (NA, U, ldk) and Wp W^T's
// parts (col_ptr and cols unused).
template <int NA, int kPlace, bool kCompact>
__global__ void __launch_bounds__(kThreads, 1)
    fused_serve_kernel(const float* __restrict__ uT, int ldu, const float* __restrict__ itT,
                       int ldi, const __nv_bfloat16* __restrict__ Ap, int ldk,
                       const int* __restrict__ col_ptr, const int* __restrict__ cols,
                       const __nv_bfloat16* __restrict__ Wp, int ldw,
                       const uint8_t* __restrict__ seen, int U, int I, int D, int k, int parts,
                       int part_len, int* __restrict__ ws, int32_t* __restrict__ out_idx,
                       float* __restrict__ out_val) {
  static_assert(!kCompact || NA == 1, "the compacted walk takes A's one part");
  extern __shared__ __align__(1024) unsigned char smem[];  // swizzled tiles: 512-byte aligned
  ServeSmem sm(smem,
               kPlace == kListsShared ? nullptr
                                      : ws + blockIdx.x * LongLists<kBM>::ws_ints(kPlace, k),
               kPlace, k, NA);
  constexpr int kStageBytes = NA * kABytes + kWP * kWBytes;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = blockIdx.x % parts, ub = blockIdx.x / parts, u0 = ub * kBM;
  const int j_lo = part * part_len, j_hi = min(I, j_lo + part_len);
  const int wg = w >> 2;                      // warpgroup: users 64 wg .. 64 wg + 63
  const int rb = 64 * wg + 16 * (w & 3) + g;  // the thread's accumulator rows: rb, rb + 8
  const int l_lo = kCompact ? col_ptr[ub] : 0;  // the walk's first column
  const int nk = kCompact ? (col_ptr[ub + 1] - l_lo) / kKC : (I + kKC - 1) / kKC;
  const size_t a_stride = (size_t)U * ldk, w_stride = (size_t)I * ldw;
  const int excluded = order_key(kExcluded);
  for (int u = threadIdx.x; u < kBM; u += kThreads) {
    sm.run_n[u] = 0;
    sm.thr_key[u] = INT_MIN;  // nothing to beat yet: every entry ranks before it
    sm.thr_id[u] = -1;
  }
  float* kt = reinterpret_cast<float*>(sm.region);  // [kBM][kKT] fused tile
  float* gu = kt + kBM * kKT;                        // [kGD][kBM] user slice
  float* gi = gu + kGD * kBM;                        // [kGD][kBN] item slice
  int* sv_key = sm.sv_key + w * kBN;
  int* sv_id = sm.sv_id + w * kBN;

  // this thread's 16-byte copies of a chunk: part m / 2 of A (or of W^T),
  // row c_row + 64 (m & 1), chunk c_ch (rows are 64 bytes: kKC entries)
  constexpr int kACopies = 2 * NA, kWCopies = 2 * kWP;
  static_assert(kBM * (kKC / 8) == 2 * kThreads && kBN == kBM, "two copies a thread per part");
  const int c_row = threadIdx.x / (kKC / 8), c_ch = threadIdx.x % (kKC / 8);
  const int c_dst = c_row * (2 * kKC) + (sw64_chunk(c_row, c_ch) << 4);  // + 64 rows: same chunk
  // compacted walk: this thread's 16-byte copies of a W part's chunk are
  // piece n_q of rows n_row and n_row + 16 (a row's 128 items: 16 pieces,
  // 4 to a 32-item sub-tile), at the same swizzled place in both
  static_assert(kKC * (kBN / 8) == 2 * kThreads, "two W copies a thread per part");
  const int n_q = threadIdx.x % (kBN / 8), n_row = threadIdx.x / (kBN / 8);
  const int n_dst = (n_q >> 2) * (kKC * 64) + n_row * 64 + (sw64_chunk(n_row, n_q & 3) << 4);
  const int a_len = nk * kKC;  // compacted walk: A's row length in the block

  for (int j0 = j_lo; j0 < j_hi; j0 += kBN) {
    const __nv_bfloat16* a_src[kACopies];
    const __nv_bfloat16* w_src[kWCopies];
    bool a_ok[2], w_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_ok[h] = kCompact || u0 + c_row + 64 * h < U;
      w_ok[h] = kCompact ? j0 + 8 * n_q < I : j0 + c_row + 64 * h < I;
    }
#pragma unroll
    for (int m = 0; m < kACopies; ++m)
      a_src[m] = kCompact ? Ap + (size_t)kBM * l_lo + (size_t)(c_row + 64 * (m & 1)) * a_len +
                                8 * c_ch
                          : Ap + (m >> 1) * a_stride +
                                (size_t)(a_ok[m & 1] ? u0 + c_row + 64 * (m & 1) : 0) * ldk +
                                8 * c_ch;
#pragma unroll
    for (int m = 0; m < kWCopies; ++m)
      w_src[m] = kCompact ? Wp + (m >> 1) * w_stride + (w_ok[0] ? j0 + 8 * n_q : 0)
                          : Wp + (m >> 1) * w_stride +
                                (size_t)(w_ok[m & 1] ? j0 + c_row + 64 * (m & 1) : 0) * ldw +
                                8 * c_ch;
    // compacted walk: the W rows (items of cols) of the next chunk to copy,
    // read a chunk ahead so that the copies do not wait for them
    int n_rows[2] = {0, 0};
    auto read_rows = [&](int c) {
      if constexpr (kCompact) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          n_rows[h] = c < nk ? cols[l_lo + c * kKC + n_row + 16 * h] : 0;
      }
    };
    read_rows(0);
    auto load = [&](int c) {
      if (c < nk) {
        unsigned char* st = sm.region + (c % kStages) * kStageBytes;
        const int l0 = c * kKC;
        const bool in_a = kCompact || l0 + 8 * c_ch < ldk;
        const bool in_w = kCompact || l0 + 8 * c_ch < ldw;
#pragma unroll
        for (int m = 0; m < kACopies; ++m) {
          const bool ok = a_ok[m & 1] && in_a;
          cp_async16(st + (m >> 1) * kABytes + 64 * (m & 1) * (2 * kKC) + c_dst,
                     ok ? a_src[m] + l0 : Ap, ok);
        }
#pragma unroll
        for (int m = 0; m < kWCopies; ++m) {
          if constexpr (kCompact) {
            const bool ok = w_ok[0];
            cp_async16(st + NA * kABytes + (m >> 1) * kWBytes + 16 * 64 * (m & 1) + n_dst,
                       ok ? w_src[m] + (size_t)n_rows[m & 1] * ldw : Wp, ok);
          } else {
            const bool ok = w_ok[m & 1] && in_w;
            cp_async16(st + NA * kABytes + (m >> 1) * kWBytes + 64 * (m & 1) * (2 * kKC) + c_dst,
                       ok ? w_src[m] + l0 : Wp, ok);
          }
        }
        read_rows(c + 1);
      }
      cp_async_commit();  // empty past the end
    };
    for (int c = 0; c < kAhead; ++c) load(c);

    // the seen flags of the warp's users in this tile, as selection reads
    // them (user kUW*w + r, items j0 + 4 lane + b in byte b): loaded now so
    // that they have arrived by the epilogue
    unsigned flags[kUW];
#pragma unroll
    for (int r = 0; r < kUW; ++r) {
      const int u = u0 + kUW * w + r;
      unsigned f = 0;
      if (u < U) {
        const uint8_t* srow = seen + (size_t)u * I;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + 4 * lane + b;
          if (j < j_hi && srow[j]) f |= 1u << (8 * b);
        }
      }
      flags[r] = f;
    }

    // 1. F tile on the tensor cores: warpgroup wg's 64 users x the 128
    //    items, acc[4 j + e] at row rb + 8 (e >> 1), item 8 j + 2 t + (e & 1)
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    for (int c = 0; c < nk; ++c) {
      cp_async_wait<kAhead - 1>();  // chunk c
      fence_proxy_async();          // the copies, visible to the tensor cores' reads
      __syncthreads();  // chunk c landed for all; chunk c - 2's products are done
      load(c + kAhead);  // into chunk c - 2's stage
      const unsigned char* st = sm.region + (c % kStages) * kStageBytes;
      wgmma_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
#pragma unroll
        for (int pa = 0; pa < NA; ++pa) {
          const uint64_t da = sw64_desc(st + pa * kABytes + wg * 64 * (2 * kKC) + 32 * kk);
#pragma unroll
          for (int pw = 0; pw < kWP; ++pw) {
            const unsigned char* wt = st + NA * kABytes + pw * kWBytes;
            if constexpr (kCompact)
              wgmma_m64n128k16<1>(acc, da, sw64_desc_mn(wt + 16 * 64 * kk));
            else
              wgmma_m64n128k16<0>(acc, da, sw64_desc(wt + 32 * kk));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>(acc);  // chunk c - 1's products: done; chunk c's may run on
    }
    wgmma_wait<0>(acc);
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: its region holds the epilogue's tiles

    // 2. G for the thread's accumulators: users rb + 8 s (s < 2), items
    //    8 (c >> 1) + 2t + (c & 1) (c < 32)
    float gs[2][32];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
      for (int c = 0; c < 32; ++c) gs[s2][c] = 0.0f;
    float4 pre[4];  // the thread's share of the next slice: users first, then items
    auto fetch = [&](int d0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int e = threadIdx.x + p * kThreads;
        const bool users = e < kGD * kBM / 4;
        const int f = users ? e : e - kGD * kBM / 4;
        const int r = f / (kBM / 4), c0 = (users ? u0 : j0) + 4 * (f % (kBM / 4));
        const int ld = users ? ldu : ldi;
        const float* src = users ? uT : itT;
        pre[p] = d0 + r < D && c0 < ld
                     ? *reinterpret_cast<const float4*>(src + (size_t)(d0 + r) * ld + c0)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    fetch(0);
    for (int d0 = 0; d0 < D; d0 += kGD) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        reinterpret_cast<float4*>(gu)[threadIdx.x + p * kThreads] = pre[p];
      __syncthreads();
      if (d0 + kGD < D) fetch(d0 + kGD);
      auto g_step = [&](int d) {
        const float ua = gu[d * kBM + rb], ub = gu[d * kBM + rb + 8];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 iv = *reinterpret_cast<const float2*>(gi + d * kBN + 8 * j + 2 * t);
          gs[0][2 * j] = fmaf(ua, iv.x, gs[0][2 * j]);
          gs[0][2 * j + 1] = fmaf(ua, iv.y, gs[0][2 * j + 1]);
          gs[1][2 * j] = fmaf(ub, iv.x, gs[1][2 * j]);
          gs[1][2 * j + 1] = fmaf(ub, iv.y, gs[1][2 * j + 1]);
        }
      };
      const int dn = min(kGD, D - d0);
      if (dn == kGD) {
#pragma unroll
        for (int d = 0; d < kGD; ++d) g_step(d);
      } else {
        for (int d = 0; d < dn; ++d) g_step(d);
      }
      __syncthreads();
    }
    // G * F into the fused tile
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
        *reinterpret_cast<float2*>(kt + (rb + 8 * s2) * kKT + 8 * j + 2 * t) =
            make_float2(gs[s2][2 * j] * acc[4 * j + 2 * s2],
                        gs[s2][2 * j + 1] * acc[4 * j + 2 * s2 + 1]);
    __syncthreads();

    // 3. selection: lane `lane` holds items j0 + 4 lane + b of each user row.
    //    With k <= 128 a user's running list fits the warp's registers: the
    //    next user's is loaded while this one's is selected, and merged in
    //    place (merge_ranked_small).
    const bool small = k <= 128;
    int nx_key[4], nx_id[4], nx_n = 0;  // the next user's running list
    if (small && u0 + kUW * w < U) {
      nx_n = sm.run_n[kUW * w];
      load_run_small(sm.lists.run_key + kUW * w * k, sm.lists.run_id + kUW * w * k, nx_n,
                     nx_key, nx_id);
    }
    for (int r = 0; r < kUW; ++r) {
      const int u = kUW * w + r;
      if (u0 + u >= U) break;
      int run_key[4], run_id[4];
      const int run_n = nx_n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run_key[i] = nx_key[i];
        run_id[i] = nx_id[i];
      }
      if (small && r + 1 < kUW && u0 + u + 1 < U) {
        nx_n = sm.run_n[u + 1];
        load_run_small(sm.lists.run_key + (u + 1) * k, sm.lists.run_id + (u + 1) * k, nx_n,
                       nx_key, nx_id);
      }
      unsigned f = 0;
#pragma unroll
      for (int r2 = 0; r2 < kUW; ++r2)
        if (r2 == r) f = flags[r2];
      const float4 v = *reinterpret_cast<const float4*>(kt + u * kKT + 4 * lane);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int tk = sm.thr_key[u], ti = sm.thr_id[u];
      int key[4], id[4];
      bool pass[4];
      int m = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        id[b] = j0 + 4 * lane + b;
        key[b] = ((f >> (8 * b)) & 0xffu) ? excluded : order_key(vv[b]);
        pass[b] = id[b] < j_hi && ranks_before(key[b], id[b], tk, ti);
        m += __popc(__ballot_sync(0xffffffffu, pass[b]));
      }
      if (m == 0) continue;
      merge_row_survivors(key, id, pass, m, sv_key, sv_id, sm.sc_key + w * sm.sc_len,
                          sm.sc_id + w * sm.sc_len, run_n, run_key, run_id,
                          sm.lists.run_key + u * k, sm.lists.run_id + u * k, sm.run_n + u,
                          sm.thr_key + u, sm.thr_id + u, sm.lists.mg_key + w * k,
                          sm.lists.mg_id + w * k, k);
    }
    __syncthreads();  // the fused tile is read: the next tile's copies may land
  }

  for (int r = 0; r < kUW; ++r) {
    const int u = kUW * w + r;
    if (u0 + u >= U) break;
    const size_t o = ((size_t)part * U + u0 + u) * k;
    const int n = sm.run_n[u];
    for (int tt = lane; tt < k; tt += 32) {
      const bool real = tt < n;
      out_idx[o + tt] = real ? sm.lists.run_id[u * k + tt] : INT_MAX;
      out_val[o + tt] = real ? key_value(sm.lists.run_key[u * k + tt]) : knocked_out();
    }
  }
}

// One entry's n bf16 parts (n = 3: the significand 8 bits at a time, by
// truncation: the top 16 bits of the f32, then of the remainder, then the
// remainder rounded, exact for normal floats; n = 1: v rounded, and
// *inexact set to 1 when that is not v), part p at out[p * part].
__device__ __forceinline__ void split_entry(float v, int n, size_t part, __nv_bfloat16* out,
                                            int* inexact = nullptr) {
  for (int p = 0; p < n - 1; ++p) {
    const float hi = __int_as_float(__float_as_int(v) & (int)0xffff0000u);
    out[p * part] = __float2bfloat16_rn(hi);
    v -= hi;
  }
  const __nv_bfloat16 last = __float2bfloat16_rn(v);
  out[(n - 1) * part] = last;
  if (inexact && __bfloat162float(last) != v) *inexact = 1;  // every writer writes 1
}

// x (rows, cols) f32 as n bf16 parts (ops/cuda/fusion_serve.py bf16_parts
// is the plain version), part p starting at out + p * part: of x, rows of
// ld entries ldo apart, entries past column cols zero, a block a row at a
// time, with n = 1 flagging an x not exact in bf16 in *inexact (when not
// null); or of x^T (kT), cols rows of ld entries ldo apart, entries past
// column rows zero, through 32 x 32 tiles in shared memory so that reads
// and writes are both coalesced. One pass.
template <bool kT>
__global__ void __launch_bounds__(kThreads)
    bf16_parts_kernel(const float* __restrict__ x, int rows, int cols, int ld, size_t ldo, int n,
                      size_t part, __nv_bfloat16* __restrict__ out, int* __restrict__ inexact) {
  if constexpr (!kT) {
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      for (int c = threadIdx.x; c < ld; c += kThreads)
        split_entry(c < cols ? x[(size_t)r * cols + c] : 0.0f, n, part, out + r * ldo + c,
                    n == 1 ? inexact : nullptr);
  } else {
    __shared__ float tile[32][33];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int tr = (ld + 31) / 32, tc = (cols + 31) / 32;
    for (long long b = blockIdx.x; b < (long long)tr * tc; b += gridDim.x) {
      const int r0 = (int)(b % tr) * 32, c0 = (int)(b / tr) * 32;
      for (int i = ty; i < 32; i += kWarps) {
        const int r = r0 + i, c = c0 + tx;
        tile[i][tx] = r < rows && c < cols ? x[(size_t)r * cols + c] : 0.0f;
      }
      __syncthreads();
      for (int i = ty; i < 32; i += kWarps) {
        const int c = c0 + i, r = r0 + tx;  // out row c, column r
        if (c < cols && r < ld) split_entry(tile[tx][i], n, part, out + c * ldo + r);
      }
      __syncthreads();
    }
  }
}

// f(kernel) for the instance of NA parts of A and the walk (compact) whose
// long lists live at `place`; `bad` for other values. Only the instances
// that run are made: the compacted walk takes A's one part.
template <typename F>
int with_kernel(int na, bool compact, int place, int bad, F&& f) {
  if (compact) {
    if (na != 1) return bad;
    if (place == kListsShared) return f(fused_serve_kernel<1, kListsShared, true>);
    if (place == kRunGlobal) return f(fused_serve_kernel<1, kRunGlobal, true>);
    if (place == kAllGlobal) return f(fused_serve_kernel<1, kAllGlobal, true>);
  } else if (na == 1) {
    if (place == kListsShared) return f(fused_serve_kernel<1, kListsShared, false>);
    if (place == kRunGlobal) return f(fused_serve_kernel<1, kRunGlobal, false>);
    if (place == kAllGlobal) return f(fused_serve_kernel<1, kAllGlobal, false>);
  } else if (na == 3) {
    if (place == kListsShared) return f(fused_serve_kernel<3, kListsShared, false>);
    if (place == kRunGlobal) return f(fused_serve_kernel<3, kRunGlobal, false>);
    if (place == kAllGlobal) return f(fused_serve_kernel<3, kAllGlobal, false>);
  }
  return bad;
}

// One launch of either walk (compact: col_ptr and cols given) and, with
// parts > 1, the merge of the part lists; the arguments as the exported
// launchers below take them.
int serve_launch(const float* uT, int ldu, const float* itT, int ldi, const void* a, int na,
                 int ldk, const int* col_ptr, const int* cols, const void* w_parts, int ldw,
                 const uint8_t* seen, int U, int I, int D, int k, int parts, int part_len,
                 int smem_limit, int* ws, int32_t* part_idx, float* part_val, int32_t* idx,
                 float* vals, void* stream) {
  const bool compact = col_ptr != nullptr;
  const int place = ServeSmem::place(k, na, smem_limit);
  if (U < 1 || I < 1 || D < 1 || k < 1 || k > I || (na != 1 && na != 3) || ldu < U ||
      ldu % 4 || ldi < I || ldi % 4 || (!compact && (ldk < I || ldk % 8)) || ldw < I ||
      ldw % 8 || (compact && (na != 1 || !cols)) || parts < 1 || part_len < kBN ||
      part_len % kBN || (long long)parts * part_len < I || place < 0 ||
      (place != kListsShared && !ws))
    return (int)cudaErrorInvalidValue;
  const int blocks = (U + kBM - 1) / kBM * parts;
  const size_t smem = ServeSmem::smem_bytes(place, k, na);
  int32_t* out_idx = parts > 1 ? part_idx : idx;
  float* out_val = parts > 1 ? part_val : vals;
  const auto* A16 = static_cast<const __nv_bfloat16*>(a);
  const auto* W16 = static_cast<const __nv_bfloat16*>(w_parts);
  int rc = with_kernel(na, compact, place, (int)cudaErrorInvalidValue, [&](auto kernel) {
    return lgcnhs_launch(kernel, blocks, smem, stream, uT, ldu, itT, ldi, A16, ldk, col_ptr,
                         cols, W16, ldw, seen, U, I, D, k, parts, part_len, ws, out_idx,
                         out_val);
  });
  if (rc != 0 || parts == 1) return rc;
  return lgcnhs_launch_part_merge(part_idx, part_val, U, k, parts, smem_limit, idx, vals, stream);
}

}  // namespace

// uT (D, ldu) and itT (D, ldi): the transposed user and item tables, row
// strides multiples of 4 floats (zero padding past U and I), 16-byte
// aligned. a_parts (na, U, ldk) and w_parts (3, I, ldw): bf16 parts of A
// and of W^T (na 1 or 3), row strides multiples of 8 with zero padding
// past column I (multiples of 64 keep each 64-byte chunk of a row on one
// 128-byte line; off them the k-loop runs ~2x longer). seen (U, I) bytes. 1 <= k <= I; parts catalog parts of
// part_len items (a multiple of 128) covering I; with parts > 1,
// part_idx/part_val hold (parts, U, k) entries for the merge. smem_limit:
// the device's shared memory a block may take; the long lists not in it
// go to ws, fused_serve_workspace_bytes for each of the ceil(U / 128) *
// parts blocks (null when that is 0).
extern "C" int fused_lgcnhs_serve_launch(const float* uT, int ldu, const float* itT, int ldi,
                                         const void* a_parts, int na, int ldk,
                                         const void* w_parts, int ldw, const uint8_t* seen,
                                         int U, int I, int D, int k, int parts, int part_len,
                                         int smem_limit, int* ws, int32_t* part_idx,
                                         float* part_val, int32_t* idx, float* vals,
                                         void* stream) {
  return serve_launch(uT, ldu, itT, ldi, a_parts, na, ldk, nullptr, nullptr, w_parts, ldw, seen,
                      U, I, D, k, parts, part_len, smem_limit, ws, part_idx, part_val, idx, vals,
                      stream);
}

// The compacted walk (the kernel's header): as fused_lgcnhs_serve_launch,
// with A as col_ptr (ceil(U / 128) + 1 column offsets, multiples of 32),
// cols (the item of each column, all < I) and a_cols (block b's 128 rows
// of col_ptr[b + 1] - col_ptr[b] bf16 entries from 128 col_ptr[b], zero
// rows past U), and w_parts (3, I, ldw) the bf16 parts of W itself, zero
// past column I.
extern "C" int fused_lgcnhs_serve_compact_launch(
    const float* uT, int ldu, const float* itT, int ldi, const void* a_cols,
    const int* col_ptr, const int* cols, const void* w_parts, int ldw, const uint8_t* seen,
    int U, int I, int D, int k, int parts, int part_len, int smem_limit, int* ws,
    int32_t* part_idx, float* part_val, int32_t* idx, float* vals, void* stream) {
  if (!col_ptr) return (int)cudaErrorInvalidValue;
  return serve_launch(uT, ldu, itT, ldi, a_cols, 1, 0, col_ptr, cols, w_parts, ldw, seen, U, I,
                      D, k, parts, part_len, smem_limit, ws, part_idx, part_val, idx, vals,
                      stream);
}

// x (rows, cols) f32, contiguous, into out: n bf16 parts of x, rows of ld
// >= cols entries, or with transpose of x^T, cols rows of ld >= rows
// entries (bf16_parts_kernel); part p starts at out + p * part, part at
// least the rows written times ld (more where out holds rows of a larger
// matrix's parts: a block of its rows is written, the rest left as it
// is). n 1 or 3. inexact: null, or (n = 1, no transpose) one int on the
// device, set to 1 where x is not exact in bf16 and left as it was
// otherwise.
extern "C" int bf16_parts_launch(const float* x, int rows, int cols, int ld, int n,
                                 int transpose, long long part, void* out, int* inexact,
                                 void* stream) {
  if (rows < 1 || cols < 1 || ld < (transpose ? rows : cols) || (n != 1 && n != 3) ||
      part < (long long)(transpose ? cols : rows) * ld || (inexact && (n != 1 || transpose)))
    return (int)cudaErrorInvalidValue;
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (transpose)
    return lgcnhs_launch(bf16_parts_kernel<true>, 4096, 0, stream, x, rows, cols, ld, (size_t)ld,
                         n, (size_t)part, o, static_cast<int*>(nullptr));
  return lgcnhs_launch(bf16_parts_kernel<false>, rows < 4096 ? rows : 4096, 0, stream, x, rows,
                       cols, ld, (size_t)ld, n, (size_t)part, o, inexact);
}

// x (rows, cols) f32, contiguous, as its three bf16 parts into a block of
// columns of a larger parts buffer: row r of part p at out + p * part + r *
// ldo, its cols entries written, the rest of each row left as it is
// (bf16_parts_kernel). The compacted walk's W parts are made so, a block of
// items at a time.
extern "C" int bf16_parts_cols_launch(const float* x, int rows, int cols, long long ldo,
                                      long long part, void* out, void* stream) {
  if (rows < 1 || cols < 1 || ldo < cols || part < (long long)(rows - 1) * ldo + cols)
    return (int)cudaErrorInvalidValue;
  return lgcnhs_launch(bf16_parts_kernel<false>, rows < 4096 ? rows : 4096, 0, stream, x, rows,
                       cols, cols, (size_t)ldo, 3, (size_t)part,
                       static_cast<__nv_bfloat16*>(out), static_cast<int*>(nullptr));
}

// Shared memory of one block at k with na parts of A, its long lists
// placed within smem_limit; -1 when the block does not fit.
extern "C" long long fused_serve_smem_bytes(int k, int na, int smem_limit) {
  const int place = ServeSmem::place(k, na, smem_limit);
  return place < 0 ? -1 : (long long)ServeSmem::smem_bytes(place, k, na);
}

// Workspace bytes of one block: its long lists that do not fit
// smem_limit; -1 when the block does not fit even without them.
extern "C" long long fused_serve_workspace_bytes(int k, int na, int smem_limit) {
  const int place = ServeSmem::place(k, na, smem_limit);
  return place < 0 ? -1 : 4 * (long long)LongLists<kBM>::ws_ints(place, k);
}

// Blocks of the kernel at k, na that one SM of the current device holds at
// once (registers and shared memory); -1 on error. The compacted walk's
// instance takes NA = 1's shared memory, which holds one block an SM.
extern "C" int fused_serve_resident_blocks(int k, int na, int smem_limit) {
  const int place = ServeSmem::place(k, na, smem_limit);
  if (place < 0) return -1;
  const int smem = (int)ServeSmem::smem_bytes(place, k, na);
  return with_kernel(na, false, place, -1, [&](auto kernel) {
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
      return -1;
    return n;
  });
}
