// Group-min scoring kernel of the flat index's exact k-NN for k <= 32, all five
// scoring lanes (fp32, bf16, fp16, int8, uint8), L2 / IP / Cosine.
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_gm_kernel` (K1),
// launched by `pallas_topk_gm`, with the scoring prologue `_tile_scores` (K2)
// fused in through bf_scores.cuh.
//
// What it computes. For each tile j of tile_n store rows and each strided
// group g < G of that tile (rows j*tile_n + l*G + g for l < L = tile_n / G):
//
//   gm[b, j*G + g] = min over l of score(q_b, row),   rows >= count at +inf,
//   score = qsq_b - 2 <q_b, x> + sqn_x   (L2)   or   1 - <q_b, x>   (IP, Cosine).
//
// The [B, tile_n] score tile never reaches device memory: the kernel writes
// B * T * 4 bytes (T = n_tiles * G), 1/L of the scores.
//
// What bounds it on an H100. At 1M x 768 and B = 1024 the dot products are
// 1024 * 2^20 * 768 = 8.2e11 FMAs, 1.6 TFLOP of fp32 on the CUDA cores (IEEE
// fp32 is the precision contract, see below, so no tensor cores). A block of
// BM queries reads the whole store once: 3.2 GB * B / BM = 26 GB at BM = 128.
// At the card's 67 TFLOP/s fp32 and 3.35 TB/s that is ~24 ms of FMAs against
// ~8 ms of reads (less where L2 serves the re-reads): compute-bound. The
// bf16 and fp16 lanes widen to fp32 and run the same FMAs on half the bytes;
// the integer lanes run a quarter as many __dp4a instructions, which an SM
// issues at half its FMA rate (64 INT32 lanes against 128 FP32): ~12 ms.
//
// Design (simple first). A block owns BM = 128 queries x BN = 128 group
// columns of one tile. It loops over the L strided sub-tiles; for each one it
// runs the dot products over D in slices of 16 words staged through shared
// memory (bf_scores.cuh `tile_dots`), the next slice loaded from global memory
// into registers while the current one is multiplied. 256 threads each hold
// an 8 x 8 register tile of accumulators. After each sub-tile the metric
// epilogue and the count mask fold the scores into a running minimum, also
// held in registers. A thread's 8 x 8 tile is two 4-row by two 4-column
// halves 64 apart, so the 16-byte shared-memory reads of each quarter warp
// are contiguous.
//
// Precision of the float lanes. Every dot product is a chain of IEEE fp32
// FMAs over D. Its error is at most gamma_D * sum_i |q_i x_i|, gamma_D =
// D*u / (1 - D*u) with u = 2^-24 (4.6e-5 at D = 768 for unit vectors), and in
// practice about sqrt(D) * u (~2e-6), since rounding errors do not line up.
// The host's coverage test (ops/kernels/bf_topk.py) accepts a result only if
// the rescored k-th distance lies below the first unselected group minimum by
// eps = 1e-5 * max(1, |v|, |m|): the kernel-vs-rescore skew must stay below
// eps for that test to be exact. Plain TF32 (~1e-3 relative) would break it;
// the tensor-core kernel (bf_topk_gm_tc.cu), which serves every shape its
// gate admits, splits fp32 into three TF32 products for that reason. The
// rescore runs in IEEE fp32. The integer lanes are exact, and the host tests
// them with eps = 0.
//
// Since the tensor-core kernel came, this one serves the shapes it refuses:
// rows whose byte length is not a multiple of 16 (config.gm_tc_ok) or
// tensors whose bases are not 16-byte aligned. 16-byte vector loads could
// serve none of those, so bf_scores.cuh loads element by element; that takes
// any shape.

#include "bf_scores.cuh"

namespace {

using namespace bfs;

constexpr int TM = 8;        // accumulator rows per thread
constexpr int BM = 16 * TM;  // queries per block

template <class Lane>
__global__ void __launch_bounds__(THREADS)
gm_kernel(const typename Lane::elem_t* __restrict__ q,
          const typename Lane::elem_t* __restrict__ data, Aux aux, float* __restrict__ gm, int B,
          int D, int tile_n, int G, int count, int metric, long long T) {
  using W = typename Lane::word_t;
  using A = typename Lane::acc_t;
  __shared__ __align__(16) W As[KW][BM + PAD];
  __shared__ __align__(16) W Bs[KW][BN + PAD];

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // accumulator rows: row_of(tr, 0..7)
  const int tc = tid % 16;  // accumulator columns: col_of(tc, 0..7)
  const int gblocks = (G + BN - 1) / BN;
  const int tile = blockIdx.x / gblocks;
  const int g0 = (blockIdx.x - tile * gblocks) * BN;
  const int m0 = blockIdx.y * BM;
  const int L = tile_n / G;
  const int a_rows = B - m0;  // valid query rows of this block
  const int b_rows = G - g0;  // valid group columns of this block
  const float inf = __int_as_float(0x7f800000);
  const bool need_dsq = Lane::INT && metric == METRIC_L2;

  float mn[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mn[i][j] = inf;

  for (int l = 0; l < L; ++l) {
    // Store row of group column g0 + n in sub-tile l is row0 + n.
    const long long row0 = (long long)tile * tile_n + (long long)l * G + g0;
    A acc[TM][8], dsq[8];
    tile_dots<Lane, TM>(q, data, m0, a_rows, row0, b_rows, D, need_dsq, As, Bs, acc, dsq);

    // Metric epilogue, count mask, running group minimum.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ml = row_of(tr, i);
      const bool qlive = ml < a_rows;
      const float qf = (aux.qf != nullptr && qlive) ? aux.qf[m0 + ml] : 0.f;
      const int qi = (aux.qi != nullptr && qlive) ? aux.qi[m0 + ml] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = col_of(tc, j);
        const long long r = row0 + n;
        const float rf = (aux.rf != nullptr && n < b_rows) ? aux.rf[r] : 0.f;
        float s = finish<Lane>(acc[i][j], metric, qf, qi, rf, dsq[j]);
        if (r >= count) s = inf;
        mn[i][j] = fminf(mn[i][j], s);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row_of(tr, i);
    if (m >= B) continue;
    float* out = gm + (long long)m * T + (long long)tile * G + g0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = col_of(tc, j);
      if (n < b_rows) out[n] = mn[i][j];
    }
  }
}

template <class Lane>
int launch(const void* q, const void* data, Aux aux, float* gm, int B, int D, int n_tiles,
           int tile_n, int G, int count, int metric, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  const int gblocks = (G + BN - 1) / BN;
  const dim3 grid((unsigned)(n_tiles * gblocks), (unsigned)((B + BM - 1) / BM));
  gm_kernel<Lane><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(data), aux, gm, B, D, tile_n, G, count,
      metric, (long long)n_tiles * G);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). q [B, D] and data [n_tiles * tile_n, D] in the lane's type;
// qaux_f [B], qaux_i [B], raux [n_tiles * tile_n] as bf_scores.cuh's Aux, null
// where unused; gm [B, n_tiles * G] fp32. Contiguous, on the current device.
// G must divide tile_n.
extern "C" int bf_topk_gm(const void* q, const void* data, const float* qaux_f,
                          const int* qaux_i, const float* raux, float* gm, int lane, int B,
                          int D, int n_tiles, int tile_n, int G, int count, int metric,
                          void* stream) {
  if (B <= 0 || D <= 0 || n_tiles <= 0 || G <= 0 || tile_n % G != 0 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const Aux aux = {qaux_f, qaux_i, raux};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GM_CALL(Lane) \
  return launch<Lane>(q, data, aux, gm, B, D, n_tiles, tile_n, G, count, metric, s)
  switch (lane) {
    case LANE_F32:
      GM_CALL(LaneF32);
    case LANE_BF16:
      GM_CALL(LaneBF16);
    case LANE_F16:
      GM_CALL(LaneF16);
    case LANE_S8:
      GM_CALL(LaneS8);
    case LANE_U8:
      GM_CALL(LaneU8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GM_CALL
}
