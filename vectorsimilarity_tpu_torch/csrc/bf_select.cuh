// Running lexicographic top-m of a row range for a block of queries: the
// selection routine shared by the fused top-k kernel (bf_topk_fused.cu) and
// the per-tile top-c kernel (bf_topk_topc.cu).
//
// Replaces the selection bodies of vectorsimilarity_tpu/ops/pallas/bf_topk.py
// `_make_kernel` with `_pop_merge` (K3) and `_make_tile_topc_kernel` (K4).
// Their contract is the exact m smallest (distance, id) pairs in
// lexicographic order, lower id first on equal distance; the TPU's group
// view, census and repair are its way of making m pops cheap on a vector
// unit and are not carried over.
//
// Design. A block owns BM = 64 queries and one range of store rows. It walks
// the range in sub-tiles of BN = 128 rows. Each sub-tile is scored through
// the shared prologue (bf_scores.cuh) into registers, passed through the
// metric epilogue, the count mask and the optional lower bound, and written
// to a [BM][BN] score tile in shared memory. Then each warp takes every
// eighth query: its 32 lanes scan that query's BN scores against the query's
// current m-th best (the last entry of its list) and insert the few that
// beat it into the query's list, which is kept sorted in shared memory
// ([BM][m] distances and ids). An insert counts the entries that are
// lex-smaller (the position), shifts the tail by one from the top chunk
// down, and writes the pair. On random data a query sees about m (1 + ln(n /
// m)) inserts over n rows, so nearly all of the time goes to the dot
// products.
//
// Lists start as (+inf, -1). A masked row scores +inf with id >= 0, which is
// not lex-smaller than (+inf, -1), so it is never inserted and unfilled
// slots come out as (+inf, -1).
//
// Shared memory: As 4.3 KB + Bs 8.4 KB + score tile 33.8 KB + lists 512 m
// bytes: 112 KB at m = 128, 62.5 KB at m = 32. Above 48 KB the launcher
// raises the kernel's dynamic shared-memory limit.

#pragma once

#include "bf_scores.cuh"

namespace bfs {

constexpr int SEL_TM = 4;             // accumulator rows per thread
constexpr int SEL_BM = 16 * SEL_TM;   // queries per block
constexpr int SEL_MAX_M = 128;        // longest list
constexpr unsigned FULL = 0xffffffffu;

inline size_t select_smem_bytes(int m) {
  return sizeof(float) * (KW * (SEL_BM + PAD) + KW * (BN + PAD) + SEL_BM * (BN + PAD)) +
         (sizeof(float) + sizeof(int)) * (size_t)SEL_BM * m;
}

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Inserts (s, id), which is lex-smaller than the list's last entry, into the
// sorted list (ld, li) of m entries; the last entry drops out. Called by all
// 32 lanes of a warp with the same arguments.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int m, float s, int id,
                                            int lane) {
  int p = 0;  // entries lex-smaller than (s, id)
  for (int e = lane; e < m; e += 32) p += lex_less(ld[e], li[e], s, id) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
  // Entries p .. m-2 move up by one. Chunks run from the top down, so the
  // slot a chunk writes past its end was read by the chunk before it.
  for (int base = ((m - 2) >> 5) << 5; base >= 0 && base + 31 >= p; base -= 32) {
    const int e = base + lane;
    const bool moves = e >= p && e <= m - 2;
    float d = 0.f;
    int i = 0;
    if (moves) {
      d = ld[e];
      i = li[e];
    }
    __syncwarp();
    if (moves) {
      ld[e + 1] = d;
      li[e + 1] = i;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ld[p] = s;
    li[p] = id;
  }
  __syncwarp();
}

// The exact m lex-smallest (distance, id) of rows [r_begin, r_end) for queries
// [m0, m0 + SEL_BM), written to out_d / out_i at (query * n_lists + list) * m.
// Rows >= count score +inf. With lo_d / lo_i (both or neither), a query
// keeps only pairs lex-greater than its (lo_d, lo_i). Every thread of the
// block must call it; `smem` is select_smem_bytes(m) of dynamic shared memory.
template <class Lane>
__device__ __forceinline__ void range_topm(
    const typename Lane::elem_t* __restrict__ q, const typename Lane::elem_t* __restrict__ data,
    Aux aux, const float* __restrict__ lo_d, const int* __restrict__ lo_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int B, int D, long long r_begin,
    long long r_end, int m0, int list, int n_lists, int m, int count, int metric,
    unsigned char* smem) {
  using W = typename Lane::word_t;
  using A = typename Lane::acc_t;
  W(*As)[SEL_BM + PAD] = reinterpret_cast<W(*)[SEL_BM + PAD]>(smem);
  W(*Bs)[BN + PAD] = reinterpret_cast<W(*)[BN + PAD]>(As + KW);
  float(*S)[BN + PAD] = reinterpret_cast<float(*)[BN + PAD]>(Bs + KW);
  float* list_d = reinterpret_cast<float*>(S + SEL_BM);
  int* list_i = reinterpret_cast<int*>(list_d + SEL_BM * m);

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int a_rows = B - m0;
  const float inf = __int_as_float(0x7f800000);
  const bool need_dsq = Lane::INT && metric == METRIC_L2;

  for (int e = tid; e < SEL_BM * m; e += THREADS) {
    list_d[e] = inf;
    list_i[e] = -1;
  }
  __syncthreads();

  for (long long row0 = r_begin; row0 < r_end && row0 < count; row0 += BN) {
    const int b_rows = (int)(r_end - row0 < BN ? r_end - row0 : BN);
    A acc[SEL_TM][8], dsq[8];
    tile_dots<Lane, SEL_TM>(q, data, m0, a_rows, row0, b_rows, D, need_dsq, As, Bs, acc, dsq);

    // Metric epilogue, masks, score tile.
#pragma unroll
    for (int i = 0; i < SEL_TM; ++i) {
      const int ml = row_of(tr, i);
      const bool qlive = ml < a_rows;
      const float qf = (aux.qf != nullptr && qlive) ? aux.qf[m0 + ml] : 0.f;
      const int qi = (aux.qi != nullptr && qlive) ? aux.qi[m0 + ml] : 0;
      const float bound_d = (lo_d != nullptr && qlive) ? lo_d[m0 + ml] : -inf;
      const int bound_i = (lo_d != nullptr && qlive) ? lo_i[m0 + ml] : -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = col_of(tc, j);
        const long long r = row0 + n;
        const float rf = (aux.rf != nullptr && n < b_rows) ? aux.rf[r] : 0.f;
        float s = finish<Lane>(acc[i][j], metric, qf, qi, rf, dsq[j]);
        if (n >= b_rows || r >= count) s = inf;
        if (lo_d != nullptr && !(s > bound_d || (s == bound_d && (int)r > bound_i))) s = inf;
        S[ml][n] = s;
      }
    }
    __syncthreads();

    // Each warp merges the sub-tile into the lists of its queries.
    for (int ql = warp; ql < SEL_BM && ql < a_rows; ql += THREADS / 32) {
      float* ld = list_d + ql * m;
      int* li = list_i + ql * m;
      float thr_d = ld[m - 1];
      int thr_i = li[m - 1];
#pragma unroll
      for (int c = 0; c < BN; c += 32) {
        const float s = S[ql][c + lane];
        const int id = (int)row0 + c + lane;
        unsigned pass = __ballot_sync(FULL, lex_less(s, id, thr_d, thr_i));
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float cs = __shfl_sync(FULL, s, src);
          const int cid = __shfl_sync(FULL, id, src);
          if (lex_less(cs, cid, thr_d, thr_i)) {  // the bound may have tightened
            warp_insert(ld, li, m, cs, cid, lane);
            thr_d = ld[m - 1];
            thr_i = li[m - 1];
          }
        }
      }
    }
    __syncthreads();  // the score tile is free for the next sub-tile
  }

  for (int e = tid; e < SEL_BM * m; e += THREADS) {
    const int ql = e / m;
    if (ql < a_rows) {
      const long long at = ((long long)(m0 + ql) * n_lists + list) * m + (e - ql * m);
      out_d[at] = list_d[e];
      out_i[at] = list_i[e];
    }
  }
}

}  // namespace bfs
