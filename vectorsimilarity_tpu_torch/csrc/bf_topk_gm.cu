// Group-min scoring kernel of the flat index's exact k-NN (fp32; L2, IP, Cosine).
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_gm_kernel` (K1),
// launched by `pallas_topk_gm`, with its fp32 scoring prologue `_tile_scores`
// (K2, mode bf16_3x) fused in.
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
// ~8 ms of reads (less where L2 serves the re-reads): compute-bound.
//
// Design (simple first). A block owns BM = 128 queries x BN = 128 group
// columns of one tile. It loops over the L strided sub-tiles; for each one it
// runs the dot products over D in BK = 16 slices staged through shared
// memory, the next slice loaded from global memory into registers while the
// current one is multiplied. 256 threads each hold an 8 x 8 register tile of
// fp32 FMA accumulators. After each sub-tile the metric epilogue and the
// count mask fold the scores into a running minimum, also held in registers.
// A thread's 8 x 8 tile is two 4-row by two 4-column halves 64 apart, so the
// float4 shared-memory reads of each quarter warp are contiguous.
//
// Precision. Every dot product is a chain of IEEE fp32 FMAs over D. Its
// error is at most gamma_D * sum_i |q_i x_i|, gamma_D = D*u / (1 - D*u) with
// u = 2^-24 (4.6e-5 at D = 768 for unit vectors), and in practice about
// sqrt(D) * u (~2e-6), since rounding errors do not line up. The host's
// coverage test (ops/kernels/bf_topk.py) accepts a result only if the
// rescored k-th distance lies below the first unselected group minimum by
// eps = 1e-5 * max(1, |v|, |m|): the kernel-vs-rescore skew must stay below
// eps for that test to be exact. TF32 (~1e-3 relative) would break it; the
// rescore also runs in IEEE fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // queries per block
constexpr int BN = 128;  // group columns per block
constexpr int BK = 16;   // depth of one shared-memory slice
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // floats of one slice per thread: 8
constexpr int PAD = 4;                    // keeps float4 rows aligned, halves bank conflicts

static_assert(BM == BN, "one slice loader serves both operands");

// Loads one BK-deep slice of `rows` consecutive rows starting at `row0` into
// registers; rows at or past `rows_valid` and columns past D read as 0.
template <bool VEC4>
__device__ __forceinline__ void load_slice(const float* __restrict__ src, long long row0,
                                           int rows_valid, int D, int k0, int tid,
                                           float (&r)[LOADS]) {
  if (VEC4) {
#pragma unroll
    for (int p = 0; p < LOADS / 4; ++p) {
      const int lin = tid + p * THREADS;
      const int row = lin / (BK / 4);
      const int col = (lin % (BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows_valid && k0 + col < D)
        v = *reinterpret_cast<const float4*>(src + (row0 + row) * D + k0 + col);
      r[4 * p + 0] = v.x;
      r[4 * p + 1] = v.y;
      r[4 * p + 2] = v.z;
      r[4 * p + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < LOADS; ++p) {
      const int lin = tid + p * THREADS;
      const int row = lin / BK;
      const int col = lin % BK;
      r[p] = (row < rows_valid && k0 + col < D) ? src[(row0 + row) * D + k0 + col] : 0.f;
    }
  }
}

// Stores a slice loaded by load_slice transposed: S[k][row].
template <bool VEC4>
__device__ __forceinline__ void store_slice(float (*S)[BM + PAD], int tid,
                                            const float (&r)[LOADS]) {
  if (VEC4) {
#pragma unroll
    for (int p = 0; p < LOADS / 4; ++p) {
      const int lin = tid + p * THREADS;
      const int row = lin / (BK / 4);
      const int col = (lin % (BK / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) S[col + e][row] = r[4 * p + e];
    }
  } else {
#pragma unroll
    for (int p = 0; p < LOADS; ++p) {
      const int lin = tid + p * THREADS;
      S[lin % BK][lin / BK] = r[p];
    }
  }
}

// Local row (or column) of a thread's i-th accumulator row (column).
__device__ __forceinline__ int lane_of(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
gm_f32_kernel(const float* __restrict__ q, const float* __restrict__ data,
              const float* __restrict__ qaux, const float* __restrict__ sqn,
              float* __restrict__ gm, int B, int D, int tile_n, int G, int count,
              int metric_l2, long long T) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // accumulator rows: lane_of(tr, 0..7)
  const int tc = tid % 16;  // accumulator columns: lane_of(tc, 0..7)
  const int gblocks = (G + BN - 1) / BN;
  const int tile = blockIdx.x / gblocks;
  const int g0 = (blockIdx.x - tile * gblocks) * BN;
  const int m0 = blockIdx.y * BM;
  const int L = tile_n / G;
  const int a_rows = B - m0;  // valid query rows of this block
  const int b_rows = G - g0;  // valid group columns of this block
  const float inf = __int_as_float(0x7f800000);

  float mn[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mn[i][j] = inf;

  for (int l = 0; l < L; ++l) {
    // Store row of group column g0 + n in sub-tile l is row0 + n.
    const long long row0 = (long long)tile * tile_n + (long long)l * G + g0;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float ra[LOADS], rb[LOADS];
    load_slice<VEC4>(q, m0, a_rows, D, 0, tid, ra);
    load_slice<VEC4>(data, row0, b_rows, D, 0, tid, rb);
    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();  // the previous slice's readers are done
      store_slice<VEC4>(As, tid, ra);
      store_slice<VEC4>(Bs, tid, rb);
      __syncthreads();
      if (k0 + BK < D) {  // next slice in flight during the FMAs
        load_slice<VEC4>(q, m0, a_rows, D, k0 + BK, tid, ra);
        load_slice<VEC4>(data, row0, b_rows, D, k0 + BK, tid, rb);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tr * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tc * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // Metric epilogue, count mask, running group minimum.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + lane_of(tr, i);
      const float qa = (metric_l2 && m < B) ? qaux[m] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = lane_of(tc, j);
        const long long r = row0 + n;
        float s;
        if (metric_l2) {
          const float sq = n < b_rows ? sqn[r] : 0.f;
          s = qa - 2.f * acc[i][j] + sq;
        } else {
          s = 1.f - acc[i][j];
        }
        if (r >= count) s = inf;
        mn[i][j] = fminf(mn[i][j], s);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + lane_of(tr, i);
    if (m >= B) continue;
    float* out = gm + (long long)m * T + (long long)tile * G + g0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = lane_of(tc, j);
      if (n < b_rows) out[n] = mn[i][j];
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). q [B, D], data [n_tiles * tile_n, D], qaux [B] (L2 only, else
// null), sqn [n_tiles * tile_n] (L2 only, else null), gm [B, n_tiles * G]:
// fp32, contiguous, on the current device. G must divide tile_n.
extern "C" int bf_topk_gm_f32(const float* q, const float* data, const float* qaux,
                              const float* sqn, float* gm, int B, int D, int n_tiles,
                              int tile_n, int G, int count, int metric_l2, void* stream) {
  if (B <= 0 || D <= 0 || n_tiles <= 0 || G <= 0 || tile_n % G != 0)
    return (int)cudaErrorInvalidValue;
  if (metric_l2 && (qaux == nullptr || sqn == nullptr)) return (int)cudaErrorInvalidValue;
  const int gblocks = (G + BN - 1) / BN;
  const dim3 grid((unsigned)(n_tiles * gblocks), (unsigned)((B + BM - 1) / BM));
  const long long T = (long long)n_tiles * G;
  const bool vec4 = D % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)data % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    gm_f32_kernel<true><<<grid, THREADS, 0, s>>>(q, data, qaux, sqn, gm, B, D, tile_n, G,
                                                 count, metric_l2, T);
  else
    gm_f32_kernel<false><<<grid, THREADS, 0, s>>>(q, data, qaux, sqn, gm, B, D, tile_n, G,
                                                  count, metric_l2, T);
  return (int)cudaGetLastError();
}
