// Fused top-k kernel of the flat index's exact k-NN for 32 < k <= 128 (and,
// chained, any k), and per-tile top-c kernel for 128 < k <= 2048, on
// Hopper's tensor cores: wgmma fed by TMA, all five scoring lanes (fp32 as a
// 3xTF32 split, bf16, fp16, int8, uint8), L2 / IP / Cosine.
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_kernel` with
// `_pop_merge` (K3), launched by `_one_pass` under `pallas_topk`, and
// `_make_tile_topc_kernel` (K4), launched by `pallas_topk_bigk`, each with
// the scoring prologue `_tile_scores` (K2) in its tensor-core form. One
// kernel serves both: it writes the exact m <= 128 lex-smallest (distance,
// id) pairs per query over the rows < count of each `list_rows` rows of its
// row range, optionally only pairs lex-greater than a per-query lower bound
// (lo_d, lo_i), unfilled slots (+inf, -1), ties by the lower id, one sorted
// list per query and list in part_d, part_i [B, n_lists, m].
//   K3 (`bf_topk_fused_tc`): list_rows = range_rows, one list per range;
//     what bf_topk_fused.cu (the CUDA-core K3, which serves the shapes this
//     kernel refuses) computes. The host part (ops/kernels/bf_topk.py
//     `fused_topk`) merges a query's lists with one exact top-m.
//   K4 (`bf_topk_topc_tc`): list_rows = tile_n, ranges of whole tiles, one
//     list of m = c per tile: [B, n_tiles, c], what bf_topk_topc.cu (the
//     CUDA-core K4) computes. The host part (`topk_bigk`) takes one exact
//     top-k over a query's lists.
//
// What bounds it on an H100. The products, as for the tensor-core K1
// (bf_topk_gm_tc.cu): 2 B N D = 1.6e12 operations at 1M x 768 and B = 1024,
// 1.6 ms at 989 TFLOP/s (bf16, fp16), 0.8 ms at 1,979 TOP/s (int8, uint8),
// 9.5 ms for fp32's three TF32 passes at 495 TFLOP/s. A block re-reads its
// range of the store once per 64 queries (B / 64 = 16 times), from L2: the
// grid puts the query blocks of one range next to each other in launch
// order, so that they run together.
//
// Scoring. K1's producer/consumer scheme: 384 threads; one thread of the
// producer warpgroup (40 registers, the rest handed to the consumers with
// setmaxnreg) starts TMA loads of 128-byte depth slices, the block's 64
// queries [64 x 128 B] and a sub-tile of 128 consecutive store rows [128 x
// 128 B], both with the 128-byte swizzle, into a ring of stages with
// full/empty mbarriers. Two consumer warpgroups each run m64n64 wgmma on
// their half of the sub-tile (rows 64 wg .. 64 wg + 63) against all 64
// queries, with fp32 (float lanes) or s32 (integer lanes) accumulators, keep
// one wgmma group in flight while the next slice is waited for, and after
// the sub-tile's last slice apply bf_scores.cuh's `finish` (the metric a
// template argument). The rows' floats (float L2 sqnorms, integer Cosine
// norms) are loaded before the products and handed to the epilogue through
// shared memory; integer L2 reads the rows' sums of squares from a
// `row_sumsq` pass of the same call.
//
// fp32 as 3xTF32, as in K1: each landed slice is split in shared memory,
// hi = tf32(x) in place and lo = tf32(x - hi) into one of three rotating lo
// buffers (bf_tc.cuh's `split_share`, with the split's error bound), and ip
// = lo_q.hi_x + hi_q.lo_x + hi_q.hi_x per depth step. A warpgroup splits its
// own half of the store tile and half of the query tile (which both read),
// then both pass a named barrier. The card checks hold it to 1e-5 against
// the plain version.
//
// Chaining (k > 128 runs passes on (lo_d, lo_i)) needs a pair to score
// bit-identically in every pass. A row always lands in the same column of
// its sub-tile (ranges start on a multiple of 128 rows) and a query in the
// same row of its block, and the sum runs over the same slices in the same
// order; nothing of k, lo, the range split or list_rows enters the
// arithmetic.
//
// Selection. Each consumer thread holds 2 queries x 16 columns of the
// sub-tile's scores and, in registers, its two queries' thresholds: the
// m-th (distance, id) of the query's list. It drops every score that is not
// lex-smaller than the threshold (or not lex-greater than the lower bound)
// before anything touches shared memory. A survivor takes a slot of its
// query's candidate buffer ([CAP] pairs) through a shared-memory atomic on
// the query's count. After the sub-tile, one barrier of both warpgroups
// (bar.red.or) tells whether any buffer filled or overflowed; only then
// each warp merges the non-empty buffers of its 8 queries into their sorted
// lists ([m] pairs in shared memory) and the thresholds are refreshed;
// survivors that found a full buffer are filtered again and placed. A merge
// ranks each candidate and list entry by its new position (the candidates
// lex-smaller than it, plus a binary search in the list for a candidate;
// a list of m <= 32 is one slot a lane) and writes the first m. On random
// data the threshold settles after a few sub-tiles, almost every score
// fails it, and merges take a few dozen rounds per range. At the end of
// each list's rows (and of the range's live rows) every buffer is merged,
// the lists are written and reset to (+inf, -1) with both thresholds at
// +inf; the producer and the ring do not see list boundaries, so the ring
// stays full across them. A reset list floods the buffers: its first
// sub-tile passes all 128 scores of a query, so K4 (a list per 4096 rows)
// merges about c (1 + ln(tile_n / c)) candidates per query and tile,
// several times K3's rate per row. What that costs and what bounds it:
// tools/k4_trials.py, PERF.md.
//
// Budget: lists 64 m x 8 B (64 KB at m = 128), candidate buffers 64 CAP x 8
// B, the ring of 24 KB stages (4 stages; fp32 3 and its 72 KB of lo
// buffers): 195 KB (fp32 226 KB) at m = 128, one block per SM. The wrapper
// cuts the store into about (SMs / query blocks) ranges of a multiple of
// 128 rows (K4: of whole tiles), so that one wave of blocks fills the card.
//
// Shapes. TMA needs the row stride D * esize to be a multiple of 16 bytes
// and 16-byte aligned bases, and K4 a tile_n that is a multiple of 128; the
// wrappers' gates (`fused_tc_admits`, `topc_tc_admits`) send every other
// shape to bf_topk_fused.cu and bf_topk_topc.cu. Query rows past B, store
// rows past the tensor and depth past D arrive as zeros from TMA and are
// masked.

#include "bf_select.cuh"
#include "bf_tc.cuh"

namespace {

using namespace bft;

constexpr int BM = 64;                 // queries per block: one wgmma M
constexpr int SUB = 128;               // store rows per sub-tile
constexpr int HALF = SUB / 2;          // sub-tile rows per consumer warpgroup: wgmma n64
constexpr int Q_BYTES = BM * SLICE;    // the query tile [64 x 128 B]
constexpr int X_BYTES = SUB * SLICE;   // the store tile [128 x 128 B]
constexpr int STAGE_BYTES = Q_BYTES + X_BYTES;
constexpr int CONSUMERS = 256;
constexpr int THREADS_TC = CONSUMERS + 128;  // + one producer warpgroup
constexpr int LO_BUFS = 3;                   // rotating lo buffers of the fp32 split
constexpr int MAX_M = bfs::SEL_MAX_M;        // longest list
constexpr int BAR_SPLIT = 1;                 // named barriers of the consumers
constexpr int BAR_ROUND = 2;
constexpr int BAR_ANY = 3;
constexpr int BAR_RF = 4;  // + warpgroup

// Trial switches, chosen at build time (nvcc -DTC_TRIAL=n) by
// tools/k4_trials.py to measure what K4's list resets cost; 0, the default,
// is the kernel as the package builds it. 1: merges rank every candidate
// against all MAX_M list slots, also for lists of m <= 32; 2: a merge round
// when a buffer is half full, not full; 3: both (the selection as K3 first
// shipped it).
#ifndef TC_TRIAL
#define TC_TRIAL 0
#endif
constexpr bool SHORT_MERGE = TC_TRIAL != 1 && TC_TRIAL != 3;
constexpr int ROUND_AT = TC_TRIAL >= 2 ? 2 : 1;  // a round when a buffer is CAP / ROUND_AT full

// Per-lane wgmma, TMA element type, ring depth and candidate buffer length.
template <class Lane>
struct Tc;
template <>
struct Tc<bfs::LaneF32> {
  using acc_t = float;
  static constexpr bool SPLIT = true;
  static constexpr int STAGES = 3;
  static constexpr int CAP = 32;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_tf32_n64(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneBF16> {
  using acc_t = float;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = 4;
  static constexpr int CAP = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_bf16_n64(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneF16> {
  using acc_t = float;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = 4;
  static constexpr int CAP = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_f16_n64(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneS8> {
  using acc_t = int;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = 4;
  static constexpr int CAP = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes as is
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b, uint32_t acc) {
    wgmma_s8_n64(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneU8> {
  using acc_t = int;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = 4;
  static constexpr int CAP = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b, uint32_t acc) {
    wgmma_u8_n64(d, a, b, acc);
  }
};

// Shared memory, in this order: the ring, the fp32 split's lo buffers, the
// ring's full and empty mbarriers, per consumer warpgroup two [64] buffers
// of the sub-tile rows' floats, the [64] candidate counts, the candidate
// buffers [64][CAP] (distances, then ids) and the lists [64][m] (likewise).
template <class Lane>
size_t smem_bytes(int m) {
  using TC = Tc<Lane>;
  return 1024 /* alignment slack */ + (size_t)TC::STAGES * STAGE_BYTES +
         (TC::SPLIT ? (size_t)LO_BUFS * STAGE_BYTES : 0) + 2 * TC::STAGES * 8 + 2 * 2 * HALF * 4 +
         BM * 4 + (size_t)BM * TC::CAP * 8 + (size_t)BM * m * 8;
}

// Adds to each list entry's position (ep, the first U of EU slots a lane
// holds) and each candidate's (xp) the candidates lex-smaller than it.
template <int U, int EU, int CU>
__device__ __forceinline__ void rank_candidates(const float* cd, const int* ci, int n,
                                                const float (&ed)[EU], const int (&ei)[EU],
                                                int (&ep)[EU], const float (&xd)[CU],
                                                const int (&xi)[CU], int (&xp)[CU]) {
  for (int j = 0; j < n; ++j) {
    const float d = cd[j];
    const int id = ci[j];
#pragma unroll
    for (int u = 0; u < U; ++u) ep[u] += bfs::lex_less(d, id, ed[u], ei[u]) ? 1 : 0;
#pragma unroll
    for (int u = 0; u < CU; ++u) xp[u] += bfs::lex_less(d, id, xd[u], xi[u]) ? 1 : 0;
  }
}

// Merges the n <= CAP candidates (cd, ci) (unsorted, each lex-smaller than
// the list's last entry when it was filtered) into the sorted list (ld, li)
// of m entries, keeping the m lex-smallest. One warp; every lane calls it
// with the same arguments. Pairs are distinct (a row is scored once per
// launch), so the new positions are a permutation: an entry's is its index
// plus the candidates lex-smaller than it, a candidate's the candidates and
// the entries lex-smaller than it.
template <int CAP>
__device__ __forceinline__ void merge_list(float* ld, int* li, const float* cd, const int* ci,
                                           int n, int m, int lane) {
  constexpr int EU = MAX_M / 32;  // list entries per lane
  constexpr int CU = CAP / 32;    // candidates per lane
  const float inf = __int_as_float(0x7f800000);
  float ed[EU], xd[CU];
  int ei[EU], ep[EU], xi[CU], xp[CU];
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    const int e = lane + 32 * u;
    ed[u] = e < m ? ld[e] : inf;
    ei[u] = e < m ? li[e] : -1;
    ep[u] = e;
  }
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    const int j = lane + 32 * u;
    xd[u] = j < n ? cd[j] : inf;
    xi[u] = j < n ? ci[j] : -1;
    xp[u] = 0;
  }
  // A list of m <= 32 (K4's) has its entries in each lane's first slot.
  if (SHORT_MERGE && m <= 32) rank_candidates<1>(cd, ci, n, ed, ei, ep, xd, xi, xp);
  else rank_candidates<EU>(cd, ci, n, ed, ei, ep, xd, xi, xp);
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    int lo = 0, hi = m;  // first entry not lex-smaller than the candidate
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (bfs::lex_less(ld[mid], li[mid], xd[u], xi[u])) lo = mid + 1;
      else hi = mid;
    }
    xp[u] += lo;
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    if (lane + 32 * u < m && ep[u] < m) {
      ld[ep[u]] = ed[u];
      li[ep[u]] = ei[u];
    }
  }
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    if (lane + 32 * u < n && xp[u] < m) {
      ld[xp[u]] = xd[u];
      li[xp[u]] = xi[u];
    }
  }
  __syncwarp();
}

// One merge round of the consumers: each warp merges the non-empty buffers
// of queries warp, warp + 8, ... (those below B) into their lists and empties
// them; ends on a barrier of all consumers.
template <int CAP>
__device__ __forceinline__ void merge_round(float* list_d, int* list_i, const float* cand_d,
                                            const int* cand_i, int* cnt, int m, int live_q) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int q = warp; q < BM; q += CONSUMERS / 32) {
    const int n = min(cnt[q], CAP);
    if (n > 0 && q < live_q)
      merge_list<CAP>(list_d + q * m, list_i + q * m, cand_d + q * CAP, cand_i + q * CAP, n, m,
                      lane);
    if (lane == 0) cnt[q] = 0;
  }
  bar_sync(BAR_ROUND, CONSUMERS);
}

// Writes the block's lists (queries below B) to list `at_list` of part_d,
// part_i [B, n_lists, m] (nothing when at_list >= n_lists) and resets them
// to (+inf, -1). A thread resets the entries it wrote, so a call needs no
// barrier against the one before; the list merges after it need one.
__device__ __forceinline__ void flush_lists(float* list_d, int* list_i, float* part_d,
                                            int* part_i, int m, int live_q, int m0, int n_lists,
                                            int at_list) {
  for (int e = threadIdx.x; e < BM * m; e += CONSUMERS) {
    const int q = e / m;
    if (q < live_q && at_list < n_lists) {
      const long long at = ((long long)(m0 + q) * n_lists + at_list) * m + (e - q * m);
      part_d[at] = list_d[e];
      part_i[at] = list_i[e];
    }
    list_d[e] = __int_as_float(0x7f800000);
    list_i[e] = -1;
  }
}

template <class Lane, int METRIC>
__global__ void __launch_bounds__(THREADS_TC, 1)
fused_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
                bfs::Aux aux, const int* __restrict__ dsq, const float* __restrict__ lo_d,
                const int* __restrict__ lo_i, float* __restrict__ part_d,
                int* __restrict__ part_i, int B, int range_rows, int list_rows, int n_lists,
                int m, int count, int n_slices, int qblocks) {
  using TC = Tc<Lane>;
  using A = typename TC::acc_t;
  constexpr int S = TC::STAGES;
  constexpr int CAP = TC::CAP;
  constexpr int SLICE_ELEMS = SLICE / sizeof(typename Lane::elem_t);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* lo_base = smem + S * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + (TC::SPLIT ? LO_BUFS * STAGE_BYTES : 0));
  uint64_t* empty = full + S;
  float* rf_bufs = reinterpret_cast<float*>(empty + S);
  int* cnt = reinterpret_cast<int*>(rf_bufs + 2 * 2 * HALF);
  float* cand_d = reinterpret_cast<float*>(cnt + BM);
  int* cand_i = reinterpret_cast<int*>(cand_d + BM * CAP);
  float* list_d = reinterpret_cast<float*>(cand_i + BM * CAP);
  int* list_i = reinterpret_cast<int*>(list_d + BM * m);

  // Query block fastest: the query blocks of one range run together, so the
  // range's re-reads come from L2.
  const int qb = blockIdx.x % qblocks;
  const int range = blockIdx.x / qblocks;
  const int m0 = qb * BM;
  const long long r_begin = (long long)range * range_rows;
  const long long r_end = r_begin + range_rows;
  const long long r_lim = r_end < count ? r_end : count;  // rows past it are masked
  const int L = r_lim > r_begin ? (int)((r_lim - r_begin + SUB - 1) / SUB) : 0;
  const int per_range = range_rows / list_rows;  // lists of a range
  const int list_subs = list_rows / SUB;         // sub-tiles of a list

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: gives its registers to the consumers; one thread
    // keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const int total = L * n_slices;
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        const int l = it / n_slices;
        const int col = (it - l * n_slices) * SLICE_ELEMS;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* st = smem + s * STAGE_BYTES;
        tma_load_2d(st, &qmap, &full[s], col, m0);
        tma_load_2d(st + Q_BYTES, &xmap, &full[s], col, (int)(r_begin + (long long)l * SUB));
      }
    }
    return;
  }

  // Consumers: warpgroup wg scores rows 64 wg .. 64 wg + 63 of each
  // sub-tile against all 64 queries.
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const float inf = __int_as_float(0x7f800000);
  const bool has_lo = lo_d != nullptr;
  // Float L2 and integer Cosine read a per-row float (sqnorm, norm).
  constexpr bool ROW_F = Lane::INT ? METRIC == bfs::METRIC_COS : METRIC == bfs::METRIC_L2;

  // The two queries (block rows ql[h]) of this thread's accumulators, their
  // auxiliaries, lower bounds and current thresholds.
  int ql[2];
  bool qlive[2];
  float qf[2] = {0.f, 0.f}, bd[2] = {-inf, -inf}, thr_d[2] = {inf, inf};
  int qi[2] = {0, 0}, bi[2] = {-1, -1}, thr_i[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ql[h] = (t / 32) * 16 + lane / 4 + 8 * h;
    const int q = m0 + ql[h];
    qlive[h] = q < B;
    if (qlive[h]) {
      if (aux.qf != nullptr) qf[h] = aux.qf[q];
      if (aux.qi != nullptr) qi[h] = aux.qi[q];
      if (has_lo) {
        bd[h] = lo_d[q];
        bi[h] = lo_i[q];
      }
    }
  }

  for (int e = threadIdx.x; e < BM * m; e += CONSUMERS) {
    list_d[e] = inf;
    list_i[e] = -1;
  }
  if (threadIdx.x < BM) cnt[threadIdx.x] = 0;
  bar_sync(BAR_ROUND, CONSUMERS);

  A acc[32];
  int it = 0;
  int held = -1;  // stage whose wgmma group is still in flight
  for (int l = 0; l < L; ++l) {
    const long long row0 = r_begin + (long long)l * SUB + wg * HALF;  // this warpgroup's rows
    float* rf_buf = rf_bufs + (2 * wg + (l & 1)) * HALF;
    float rf_t = 0.f;
    if constexpr (ROW_F) {
      if (t < HALF && aux.rf != nullptr && row0 + t < r_lim) rf_t = aux.rf[row0 + t];
    }

    for (int kc = 0; kc < n_slices; ++kc, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      uint8_t* qt = smem + s * STAGE_BYTES;
      uint8_t* xt = qt + Q_BYTES + wg * (X_BYTES / 2);
      uint8_t* lo = lo_base + (it % LO_BUFS) * STAGE_BYTES;
      uint8_t* xlo = lo + Q_BYTES + wg * (X_BYTES / 2);
      if constexpr (TC::SPLIT) {
        split_share<2>(qt + wg * (Q_BYTES / 2), lo + wg * (Q_BYTES / 2), t);
        split_share<4>(xt, xlo, t);
        fence_proxy_async();
        bar_sync(BAR_SPLIT, CONSUMERS);  // both halves of the query tile are split
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < SLICE / 32; ++ks) {
        const uint64_t dq = desc_sw128(smem_u32(qt) + 32 * ks);
        const uint64_t dx = desc_sw128(smem_u32(xt) + 32 * ks);
        const uint32_t keep = (kc > 0 || ks > 0) ? 1u : 0u;
        if constexpr (TC::SPLIT) {
          const uint64_t dql = desc_sw128(smem_u32(lo) + 32 * ks);
          const uint64_t dxl = desc_sw128(smem_u32(xlo) + 32 * ks);
          TC::mma(acc, dql, dx, keep);
          TC::mma(acc, dq, dxl, 1u);
          TC::mma(acc, dq, dx, 1u);
        } else {
          TC::mma(acc, dq, dx, keep);
        }
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous slice's products are done
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);
    held = -1;
    if constexpr (ROW_F) {
      // Two buffers: a thread writes this one again two sub-tiles later,
      // past the round barrier that every thread reaches after this epilogue.
      if (t < HALF) rf_buf[t] = rf_t;
      bar_sync(BAR_RF + wg, 128);
    }

    // Epilogue: score, filter, place the survivors; merge when a buffer is
    // full or overflowed, then place what did not fit.
    uint32_t todo = 0xffffffffu;  // accumulators still to look at
    bool round;
    do {
      uint32_t left = 0;
      bool want = false;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!((todo >> i) & 1u)) continue;
        const int h = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const long long r = row0 + col;
        if (!qlive[h] || r >= r_lim) continue;
        const float rf = ROW_F ? rf_buf[col] : 0.f;
        const A ds = dsq != nullptr ? (A)dsq[r] : A(0);
        const float v = bfs::finish<Lane>((typename Lane::acc_t)acc[i], METRIC, qf[h], qi[h], rf,
                                          (typename Lane::acc_t)ds);
        const int id = (int)r;
        if (!bfs::lex_less(v, id, thr_d[h], thr_i[h])) continue;
        if (has_lo && !bfs::lex_less(bd[h], bi[h], v, id)) continue;
        const int slot = atomicAdd(&cnt[ql[h]], 1);
        if (slot < CAP) {
          cand_d[ql[h] * CAP + slot] = v;
          cand_i[ql[h] * CAP + slot] = id;
        } else {
          left |= 1u << i;
        }
        want |= slot >= CAP / ROUND_AT - 1;
      }
      todo = left;
      round = bar_any(BAR_ANY, CONSUMERS, want || left != 0u);
      if (round) {
        merge_round<CAP>(list_d, list_i, cand_d, cand_i, cnt, m, B - m0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          thr_d[h] = list_d[ql[h] * m + m - 1];
          thr_i[h] = list_i[ql[h] * m + m - 1];
        }
      }
    } while (round);

    // The list's (or the range's live rows') last sub-tile: every buffer
    // into its list, the lists out, empty lists and thresholds for the next.
    if (l + 1 == L || (l + 1) % list_subs == 0) {
      merge_round<CAP>(list_d, list_i, cand_d, cand_i, cnt, m, B - m0);
      flush_lists(list_d, list_i, part_d, part_i, m, B - m0, m0, n_lists,
                  range * per_range + l / list_subs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr_d[h] = inf;
        thr_i[h] = -1;
      }
      bar_sync(BAR_ROUND, CONSUMERS);
    }
  }

  // The range's lists with no live row: (+inf, -1) throughout.
  for (int j = L > 0 ? (L - 1) / list_subs + 1 : 0; j < per_range; ++j)
    flush_lists(list_d, list_i, part_d, part_i, m, B - m0, m0, n_lists, range * per_range + j);
}

// A launch's row split: ranges of range_rows rows (a multiple of 128), one
// block per range and query block, each writing a list per list_rows rows
// of its range (list_rows a multiple of 128 that divides range_rows) to list
// index range * (range_rows / list_rows) + j of n_lists.
struct Split {
  int range_rows, n_ranges, list_rows, n_lists;
};

template <class Lane, int METRIC>
int launch_metric(const CUtensorMap& qmap, const CUtensorMap& xmap, bfs::Aux aux, const int* dsq,
                  const float* lo_d, const int* lo_i, float* part_d, int* part_i, int B, int D,
                  Split sp, int m, int count, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  const int qblocks = (B + BM - 1) / BM;
  const long long blocks = (long long)sp.n_ranges * qblocks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int n_slices = (D * (int)sizeof(E) + SLICE - 1) / SLICE;
  const size_t bytes = smem_bytes<Lane>(m);
  auto kernel = fused_tc_kernel<Lane, METRIC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS_TC, bytes, stream>>>(
      qmap, xmap, aux, dsq, lo_d, lo_i, part_d, part_i, B, sp.range_rows, sp.list_rows,
      sp.n_lists, m, count, n_slices, qblocks);
  return (int)cudaGetLastError();
}

template <class Lane>
int launch(const void* q, const void* data, bfs::Aux aux, int* dsq, const float* lo_d,
           const int* lo_i, float* part_d, int* part_i, int B, int D, int N, Split sp, int m,
           int count, int metric, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  if ((D * (int)sizeof(E)) % 16 != 0 || (uintptr_t)q % 16 != 0 || (uintptr_t)data % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, xmap;
  constexpr CUtensorMapDataType type = Tc<Lane>::TYPE;
  if (!make_map(&qmap, type, sizeof(E), q, B, D, BM) ||
      !make_map(&xmap, type, sizeof(E), data, N, D, SUB))
    return (int)cudaErrorInvalidValue;
  if (!Lane::INT || metric != bfs::METRIC_L2) {
    dsq = nullptr;
  } else {
    if (dsq == nullptr) return (int)cudaErrorInvalidValue;
    if (count > 0) {
      row_sumsq<E><<<(count + 7) / 8, 256, 0, stream>>>(static_cast<const E*>(data), dsq, count, D);
      const int err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
#define FUSED_TC_ARGS qmap, xmap, aux, dsq, lo_d, lo_i, part_d, part_i, B, D, sp, m, count, stream
  switch (metric) {
    case bfs::METRIC_L2:
      return launch_metric<Lane, bfs::METRIC_L2>(FUSED_TC_ARGS);
    case bfs::METRIC_IP:
      return launch_metric<Lane, bfs::METRIC_IP>(FUSED_TC_ARGS);
    default:
      return launch_metric<Lane, bfs::METRIC_COS>(FUSED_TC_ARGS);
  }
#undef FUSED_TC_ARGS
}

// Checks the split and runs the lane's launch; count is clamped to [0, N].
int launch_lane(int lane, const void* q, const void* data, bfs::Aux aux, int* dsq,
                const float* lo_d, const int* lo_i, float* part_d, int* part_i, int B, int D,
                int N, Split sp, int m, int count, int metric, void* stream) {
  count = count < 0 ? 0 : count < N ? count : N;
  if (B <= 0 || D <= 0 || N <= 0 || sp.range_rows <= 0 || sp.list_rows <= 0 ||
      sp.list_rows % SUB != 0 || sp.range_rows % sp.list_rows != 0 || sp.n_ranges <= 0 ||
      sp.n_lists <= 0 || m <= 0 || m > MAX_M || metric < 0 || metric > 2 ||
      (lo_d == nullptr) != (lo_i == nullptr) || (long long)sp.n_ranges * sp.range_rows < count)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_TC_CALL(Lane)                                                                  \
  return launch<Lane>(q, data, aux, dsq, lo_d, lo_i, part_d, part_i, B, D, N, sp, m, count, \
                      metric, s)
  switch (lane) {
    case bfs::LANE_F32:
      FUSED_TC_CALL(bfs::LaneF32);
    case bfs::LANE_BF16:
      FUSED_TC_CALL(bfs::LaneBF16);
    case bfs::LANE_F16:
      FUSED_TC_CALL(bfs::LaneF16);
    case bfs::LANE_S8:
      FUSED_TC_CALL(bfs::LaneS8);
    case bfs::LANE_U8:
      FUSED_TC_CALL(bfs::LaneU8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_TC_CALL
}

}  // namespace

// The entry points launch on `stream` and return a cudaError_t (0 on
// success). `dsq`: int32 scratch of at least `count` entries for integer L2
// (the rows' sums of squares), else null. Both refuse
// (cudaErrorInvalidValue) a row stride D * esize that is not a multiple of
// 16 bytes or a base that is not 16-byte aligned.

// K3. Arguments as bf_topk_fused.cu's entry point, plus `dsq`. range_rows
// is a multiple of 128 and n_ranges * range_rows covers the rows < min(count,
// N); one list per range: part_d, part_i [B, n_ranges, m].
extern "C" int bf_topk_fused_tc(const void* q, const void* data, const float* qaux_f,
                                const int* qaux_i, const float* raux, int* dsq,
                                const float* lo_d, const int* lo_i, float* part_d, int* part_i,
                                int lane, int B, int D, int N, int range_rows, int n_ranges,
                                int m, int count, int metric, void* stream) {
  return launch_lane(lane, q, data, {qaux_f, qaux_i, raux}, dsq, lo_d, lo_i, part_d, part_i, B,
                     D, N, {range_rows, n_ranges, range_rows, n_ranges}, m, count, metric, stream);
}

// K4. Arguments as bf_topk_topc.cu's entry point, plus `dsq` and the split:
// n_ranges ranges of range_tiles whole tiles (tile_n a multiple of 128), one
// list of c per tile: out_d, out_i [B, n_tiles, c]. The ranges must cover
// the rows < min(count, n_tiles * tile_n); the kernel writes every list of
// index < min(n_ranges * range_tiles, n_tiles), (+inf, -1) where a tile has
// no live row, and leaves the rest to the caller.
extern "C" int bf_topk_topc_tc(const void* q, const void* data, const float* qaux_f,
                               const int* qaux_i, const float* raux, int* dsq, float* out_d,
                               int* out_i, int lane, int B, int D, int n_tiles, int tile_n, int c,
                               int count, int range_tiles, int n_ranges, int metric,
                               void* stream) {
  if (n_tiles <= 0 || tile_n <= 0 || range_tiles <= 0 ||
      (long long)n_tiles * tile_n >= (1LL << 31) || (long long)range_tiles * tile_n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return launch_lane(lane, q, data, {qaux_f, qaux_i, raux}, dsq, nullptr, nullptr, out_d, out_i,
                     B, D, n_tiles * tile_n, {range_tiles * tile_n, n_ranges, tile_n, n_tiles}, c,
                     count, metric, stream);
}
