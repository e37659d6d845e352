// Scoring prologue shared by the flat index's CUDA-core top-k kernels
// (bf_topk_gm.cu, bf_topk_fused.cu, bf_topk_topc.cu); its lane types and
// metric epilogue `finish` also serve the tensor-core kernels
// (bf_topk_gm_tc.cu, bf_topk_fused_tc.cu).
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_tile_scores` (K2) and
// the device half of `_mode_and_aux`. One block scores a tile of BM queries
// against BN store rows, in one of five lanes:
//
//   lane    store type   product                      sum
//   F32     float        IEEE fp32 FMA                fp32  (the TPU's bf16_3x mode)
//   BF16    bfloat16     widened to fp32, exact       fp32  (mode `native`)
//   F16     half         widened to fp32, exact       fp32  (mode `native`)
//   S8      int8         __dp4a, exact                int32 (mode `int`)
//   U8      uint8        unsigned __dp4a, exact       int32 (mode `uint`)
//
// The TPU's `uint` mode shifts u8 into s8 because its matrix unit has no u8
// path, and corrects the dot in int32. CUDA multiplies u8 directly, so the U8
// lane is the plain integer dot: the value is the same integer.
//
// Metric epilogue (`finish`), as `ops/distances.py` scores_float / scores_int:
//   float lanes  L2: qsq - 2 ip + sqn[row]      IP, Cosine: 1 - ip
//   int lanes    L2: float(qsq - 2 ip + dsq)    exact integer algebra, one cast;
//                    dsq (the row's sum of squares) is summed in the kernel
//                    from the slices already in shared memory
//                IP: 1 - float(ip)
//                Cosine: 1 - float(ip) / (qnorm * norm[row])
//
// Rounding. The build uses no --use_fast_math, so `/` and the intrinsics below
// are IEEE. nvcc may contract `qa - 2.f * ip + sq` into one FMA and an add,
// and the dot products are FMA chains by construction: both stay inside the
// float lanes' 1e-5 tolerance (see the precision note in bf_topk_gm.cu). The
// integer lanes hold no expression that can contract: the L2 and IP values
// are an exact integer cast once (round to nearest even, as torch casts), and
// Cosine's multiply, divide and subtract are written with the _rn intrinsics
// so each rounds once on its own.
//
// Shared-memory layout. Depth runs in slices of KW = 16 32-bit words: a word
// is one fp32 value (float lanes, 16 elements a slice) or four packed bytes
// (integer lanes, 64 elements a slice). As[KW][BM + PAD] and Bs[KW][BN + PAD]
// hold the slice transposed, so that a thread reads its TM query words and 8
// row words of one depth step as 16-byte vectors. 256 threads each own a
// TM x 8 tile of accumulators (BM = 16 TM; TM = 8 or 4); the tile's rows
// (columns) are blocks of 4, 64 apart: row_of / col_of.
//
// Loads. A thread loads quads of 4 consecutive words of one row, element by
// element with a bounds test: these kernels serve the rows the tensor-core
// kernels' TMA gate refuses (a row that is not a multiple of 16 bytes, a
// base off 16 bytes), and K4's tiles that are not a multiple of 128 rows.
// Rows past the valid count and depth past D read as 0, which adds nothing to
// a dot product or to dsq. The next slice's loads are issued before the
// current slice's products and are held in registers as loaded: BF16 and F16
// stay packed two to a register and are widened only when the slice is
// stored to shared memory, so that no conversion waits on a load ahead of the
// products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bfs {

constexpr int BN = 128;  // store rows (score columns) per block tile
constexpr int KW = 16;   // 32-bit words of depth per shared-memory slice
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps 16-byte rows aligned, halves bank conflicts

constexpr int METRIC_L2 = 0;  // VecSimMetric values
constexpr int METRIC_IP = 1;
constexpr int METRIC_COS = 2;

constexpr int LANE_F32 = 0;  // lane codes of the C entry points
constexpr int LANE_BF16 = 1;
constexpr int LANE_F16 = 2;
constexpr int LANE_S8 = 3;
constexpr int LANE_U8 = 4;

// elem_t: the store's type; word_t: a shared-memory word; acc_t: a sum;
// stage_t: a register of a loaded quad (SPQ of them) before it is stored.
struct LaneF32 {
  using elem_t = float;
  using word_t = float;
  using acc_t = float;
  using stage_t = float;
  static constexpr int EPW = 1;  // elements per word
  static constexpr int SPQ = 4;  // staging registers per quad
  static constexpr bool INT = false;
};
struct LaneBF16 {
  using elem_t = __nv_bfloat16;
  using word_t = float;
  using acc_t = float;
  using stage_t = uint32_t;  // two elements, the first in the low half
  static constexpr int EPW = 1;
  static constexpr int SPQ = 2;
  static constexpr bool INT = false;
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ float widen(uint32_t b) { return __uint_as_float(b << 16); }
};
struct LaneF16 {
  using elem_t = __half;
  using word_t = float;
  using acc_t = float;
  using stage_t = uint32_t;
  static constexpr int EPW = 1;
  static constexpr int SPQ = 2;
  static constexpr bool INT = false;
  static __device__ __forceinline__ uint32_t bits(__half v) { return __half_as_ushort(v); }
  static __device__ __forceinline__ float widen(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
};
struct LaneS8 {
  using elem_t = int8_t;
  using word_t = int;
  using acc_t = int;
  using stage_t = int;
  static constexpr int EPW = 4;
  static constexpr int SPQ = 4;
  static constexpr bool INT = true;
};
struct LaneU8 {
  using elem_t = uint8_t;
  using word_t = unsigned;
  using acc_t = unsigned;
  using stage_t = unsigned;
  static constexpr int EPW = 4;
  static constexpr int SPQ = 4;
  static constexpr bool INT = true;
};

template <class W>
struct alignas(16) Quad {
  W x, y, z, w;
};

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mad(int a, int b, int c) { return __dp4a(a, b, c); }
__device__ __forceinline__ unsigned mad(unsigned a, unsigned b, unsigned c) {
  return __dp4a(a, b, c);
}

// Local row (column) of a thread's i-th accumulator row (column).
__device__ __forceinline__ int row_of(int t, int i) { return (i >> 2) * 64 + t * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int t, int j) { return row_of(t, j); }

// Loads one slice (KW words deep, starting at element k0) of ROWS consecutive
// rows from `row0` on into staging registers, one quad of 4 words at a time,
// ROWS / 64 quads a thread. Rows at or past `rows_valid` and elements at or
// past D read as 0.
template <class Lane, int ROWS>
__device__ __forceinline__ void load_slice(const typename Lane::elem_t* __restrict__ src,
                                           long long row0, int rows_valid, int D, int k0,
                                           int tid,
                                           typename Lane::stage_t (&r)[ROWS / 64 * Lane::SPQ]) {
  using E = typename Lane::elem_t;
  using T = typename Lane::stage_t;
#pragma unroll
  for (int p = 0; p < ROWS / 64; ++p) {
    const int lin = tid + p * THREADS;
    const int row = lin / (KW / 4);
    const int e0 = k0 + (lin % (KW / 4)) * 4 * Lane::EPW;  // first element of the quad
    const E* at = src + (row0 + row) * D + e0;
    const bool live = row < rows_valid;
    T* out = &r[p * Lane::SPQ];
    if constexpr (sizeof(E) == 2) {  // 4 elements packed in 2 registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = (live && e0 + 2 * h < D) ? Lane::bits(at[2 * h]) : 0u;
        const uint32_t hi = (live && e0 + 2 * h + 1 < D) ? Lane::bits(at[2 * h + 1]) : 0u;
        out[h] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if constexpr (Lane::INT) {
          uint32_t packed = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int e = e0 + 4 * w + b;
            if (live && e < D) packed |= (uint32_t)(uint8_t)at[4 * w + b] << (8 * b);
          }
          out[w] = (T)packed;
        } else {
          out[w] = (live && e0 + w < D) ? at[w] : 0.f;
        }
      }
    }
  }
}

// Stores a slice loaded by load_slice transposed, as words: S[word][row].
template <class Lane, int ROWS>
__device__ __forceinline__ void store_slice(
    typename Lane::word_t (*S)[ROWS + PAD], int tid,
    const typename Lane::stage_t (&r)[ROWS / 64 * Lane::SPQ]) {
#pragma unroll
  for (int p = 0; p < ROWS / 64; ++p) {
    const int lin = tid + p * THREADS;
    const int row = lin / (KW / 4);
    const int col = (lin % (KW / 4)) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (Lane::SPQ == 2)
        S[col + e][row] = Lane::widen((r[2 * p + e / 2] >> (16 * (e & 1))) & 0xffffu);
      else
        S[col + e][row] = r[4 * p + e];
    }
  }
}

// Dot products of the BM = 16 TM queries from row `m0` of q against the BN
// store rows from `row0`: acc[i][j] = <q[m0 + row_of(tr, i)], data[row0 +
// col_of(tc, j)]>, summed over D in ascending order. With `need_dsq` (integer
// L2) dsq[j] becomes the sum of squares of store row col_of(tc, j). Every
// thread of the block must call it; it ends after the last slice's products,
// without a barrier.
template <class Lane, int TM>
__device__ __forceinline__ void tile_dots(const typename Lane::elem_t* __restrict__ q,
                                          const typename Lane::elem_t* __restrict__ data,
                                          long long m0, int a_rows, long long row0, int b_rows,
                                          int D, bool need_dsq,
                                          typename Lane::word_t (*As)[16 * TM + PAD],
                                          typename Lane::word_t (*Bs)[BN + PAD],
                                          typename Lane::acc_t (&acc)[TM][8],
                                          typename Lane::acc_t (&dsq)[8]) {
  using W = typename Lane::word_t;
  using A = typename Lane::acc_t;
  constexpr int BM = 16 * TM;
  constexpr int KE = KW * Lane::EPW;  // elements per slice
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = A(0);
#pragma unroll
  for (int j = 0; j < 8; ++j) dsq[j] = A(0);

  typename Lane::stage_t ra[BM / 64 * Lane::SPQ], rb[BN / 64 * Lane::SPQ];
  load_slice<Lane, BM>(q, m0, a_rows, D, 0, tid, ra);
  load_slice<Lane, BN>(data, row0, b_rows, D, 0, tid, rb);
  for (int k0 = 0; k0 < D; k0 += KE) {
    __syncthreads();  // the previous slice's readers are done
    store_slice<Lane, BM>(As, tid, ra);
    store_slice<Lane, BN>(Bs, tid, rb);
    __syncthreads();
    if (k0 + KE < D) {  // next slice in flight during the products
      load_slice<Lane, BM>(q, m0, a_rows, D, k0 + KE, tid, ra);
      load_slice<Lane, BN>(data, row0, b_rows, D, k0 + KE, tid, rb);
    }
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      W a[TM], b[8];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const Quad<W> v = *reinterpret_cast<const Quad<W>*>(&As[kk][h * 64 + tr * 4]);
        a[4 * h + 0] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Quad<W> v = *reinterpret_cast<const Quad<W>*>(&Bs[kk][h * 64 + tc * 4]);
        b[4 * h + 0] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
      if constexpr (Lane::INT) {
        if (need_dsq) {
#pragma unroll
          for (int j = 0; j < 8; ++j) dsq[j] = mad(b[j], b[j], dsq[j]);
        }
      }
    }
  }
}

// Per-query and per-row auxiliaries of the metric epilogue; null where the
// lane and metric do not use them.
struct Aux {
  const float* qf;  // [B]  float L2: |q|^2; integer Cosine: the query's norm
  const int* qi;    // [B]  integer L2: |q|^2, exact
  const float* rf;  // [N]  float L2: |x|^2; integer Cosine: the row's stored norm
};

// The distance from one finished dot product.
template <class Lane>
__device__ __forceinline__ float finish(typename Lane::acc_t ip, int metric, float qf, int qi,
                                        float rf, typename Lane::acc_t dsq) {
  if constexpr (!Lane::INT) {
    if (metric == METRIC_L2) return qf - 2.f * ip + rf;
    return 1.f - ip;
  } else {
    // |q - x|^2 <= 255^2 D < 2^31 (the wrappers refuse larger D), so the
    // sum taken mod 2^32 is the exact distance whatever its terms' sizes.
    if (metric == METRIC_L2)
      return __int2float_rn((int)((unsigned)qi - 2u * (unsigned)ip + (unsigned)dsq));
    float f = (float)ip;
    if (metric == METRIC_COS) f = __fdiv_rn(f, __fmul_rn(qf, rf));
    return __fsub_rn(1.f, f);
  }
}

}  // namespace bfs
