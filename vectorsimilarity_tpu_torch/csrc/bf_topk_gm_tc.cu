// Group-min scoring kernel of the flat index's exact k-NN for k <= 32 on
// Hopper's tensor cores: wgmma fed by TMA, all five scoring lanes (fp32 as a
// 3xTF32 split, bf16, fp16, int8, uint8), L2 / IP / Cosine.
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_gm_kernel` (K1),
// launched by `pallas_topk_gm`, with the scoring prologue `_tile_scores` (K2)
// in its tensor-core form. It computes what bf_topk_gm.cu computes (the
// CUDA-core K1, which serves the shapes this kernel refuses):
//
//   gm[b, j*G + g] = min over l < tile_n / G of score(q_b, row j*tile_n + l*G + g),
//   rows >= count at +inf, score as bf_scores.cuh's `finish`.
//
// What bounds it on an H100. At 1M x 768 and B = 1024 the products are
// 2 B N D = 1.6e12 operations a pass: 1.6 ms at 989 TFLOP/s (bf16, fp16),
// 0.8 ms at 1,979 TOP/s (int8, uint8), and 9.5 ms for fp32's three TF32
// passes at 495 TFLOP/s (the least time for fp32 on the tensor cores is the
// TPU reference's bf16_3x, three bf16 passes: 4.8 ms). Every operation
// bound. A block re-reads the store once per 128 queries (B / 128 = 8 times:
// 25 GB in fp32, 12 GB in bf16, 6 GB in int8), which HBM alone could not
// feed for the narrow lanes (1.8 to 7.3 ms at 3.35 TB/s): the grid puts the
// query blocks of one store range next to each other in launch order, so
// that they run together and the store's re-reads come from the 50 MB L2.
//
// Design. A block owns 128 queries x 128 group columns of one tile and folds
// the tile's L = tile_n / G strided sub-tiles into a running minimum held in
// registers, as the CUDA-core kernel does: sub-tile l is the 128 consecutive
// store rows from j*tile_n + l*G + g0, one TMA box. 384 threads: one thread
// of the producer warpgroup (which hands its registers to the consumers
// with setmaxnreg: 40 against 232) starts TMA loads of 128-byte depth
// slices (the query block's [128 x 128 B] and the sub-tile's [128 x 128 B],
// 128-byte swizzle) into a ring of stages with full/empty mbarriers; two
// consumer warpgroups each run m64n128 wgmma over their 64 queries with
// fp32 (float lanes) or s32 (integer lanes) accumulators, keep one wgmma
// group in flight while the next slice is waited for, and after the
// sub-tile's last slice apply `finish` (the metric a template argument),
// the count mask and the minimum. Columns past G (G < 128) are computed
// and not written. Integer L2 needs each row's sum of squares: a pass of
// its own (bf_tc.cuh's `row_sumsq`, one warp per row) writes them to a
// scratch [count] int32 buffer before the main kernel, inside the same call.
//
// fp32 as 3xTF32. A TF32 operand keeps 11 significant bits. Each landed
// fp32 slice is split in shared memory by the consumer warps, in place, into
// hi and a separate lo buffer with the same layout (bf_tc.cuh's
// `split_share`, which states the split's error bound), and ip = lo_q.hi_x +
// hi_q.lo_x + hi_q.hi_x per depth step, all operands from shared memory (a
// trial with the query fragments split in registers and fed to wgmma from
// there was no faster: PERF.md). The bound sits below the host's coverage
// eps, 1e-5 relative (ops/kernels/bf_topk.py `topk_gm`), which stays as it
// is. The split needs its lo tiles in three rotating buffers: a warpgroup
// writes buffer (i mod 3) for slice i only after both warpgroups passed the
// barrier of slice i - 1, when neither can still be reading slice i - 3's.
//
// Shapes. TMA needs the row stride D * esize to be a multiple of 16 bytes
// and 16-byte aligned bases; `config.gm_tc_ok` is that gate and the wrapper
// sends every other shape to bf_topk_gm.cu. Rows past B or past the store
// and depth past D arrive as zeros from TMA.

#include "bf_scores.cuh"
#include "bf_tc.cuh"

namespace {

using namespace bft;

constexpr int BM = 128;             // queries per block: two warpgroups of 64
constexpr int BNC = 128;            // group columns per block: wgmma n128
constexpr int TILE_BYTES = 128 * SLICE;  // one [128 x 128 B] operand tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int CONSUMERS = 256;
constexpr int THREADS_TC = CONSUMERS + 128;  // + one producer warpgroup
constexpr int LO_BUFS = 3;  // rotating lo buffers of the fp32 split

// Trial switches, chosen at build time (nvcc -DK1_TRIAL=n) by
// tools/k1_trials.py to take the kernel apart on the card; 0, the default, is
// the kernel as the package builds it. 1: the metric epilogue cut to 1 - ip;
// 2: the rows' floats loaded in the epilogue, next to their use; 3: fp32 in
// one TF32 pass (not fp32-exact); 4: a 4-stage ring in the half and integer
// lanes; 5: the grid in query-slowest order.
#ifndef K1_TRIAL
#define K1_TRIAL 0
#endif

// Per-lane wgmma, TMA element type and ring depth.
template <class Lane>
struct Tc;
template <>
struct Tc<bfs::LaneF32> {
  using acc_t = float;
  static constexpr bool SPLIT = K1_TRIAL != 3;
  static constexpr int STAGES = 3;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_tf32(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneBF16> {
  using acc_t = float;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = K1_TRIAL == 4 ? 4 : 6;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_bf16(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneF16> {
  using acc_t = float;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = K1_TRIAL == 4 ? 4 : 6;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             uint32_t acc) {
    wgmma_f16(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneS8> {
  using acc_t = int;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = K1_TRIAL == 4 ? 4 : 6;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes as is
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, uint32_t acc) {
    wgmma_s8(d, a, b, acc);
  }
};
template <>
struct Tc<bfs::LaneU8> {
  using acc_t = int;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = K1_TRIAL == 4 ? 4 : 6;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, uint32_t acc) {
    wgmma_u8(d, a, b, acc);
  }
};

// Shared memory: the ring, the fp32 split's lo buffers, the ring's full and
// empty mbarriers, and per consumer warpgroup two [128] buffers of the
// sub-tile rows' norms.
template <class Lane>
constexpr int smem_bytes() {
  return 1024 /* alignment slack */ + Tc<Lane>::STAGES * STAGE_BYTES +
         (Tc<Lane>::SPLIT ? LO_BUFS * STAGE_BYTES : 0) + 2 * Tc<Lane>::STAGES * 8 +
         2 * 2 * BNC * 4;
}

// METRIC is a template argument so that `finish` compiles to its one branch:
// with the metric read at run time the epilogue's other branches (the integer
// L2 algebra, the IEEE divide of integer Cosine) cost the integer lanes
// about half their time and the float lanes spills.
template <class Lane, int METRIC>
__global__ void __launch_bounds__(THREADS_TC, 1)
gm_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
             bfs::Aux aux, const int* __restrict__ dsq, float* __restrict__ gm, int B, int tile_n,
             int G, int count, long long T, int n_slices, int gblocks, int qblocks) {
  using TC = Tc<Lane>;
  using A = typename TC::acc_t;
  constexpr int S = TC::STAGES;
  constexpr int SLICE_ELEMS = SLICE / sizeof(typename Lane::elem_t);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* lo_base = smem + S * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + (TC::SPLIT ? LO_BUFS * STAGE_BYTES : 0));
  uint64_t* empty = full + S;
  float* rf_bufs = reinterpret_cast<float*>(empty + S);

  // Query block fastest: the query blocks of one store range run together,
  // so the store's re-reads come from L2 (trial 5 is the other order).
  const int per_qb = gridDim.x / qblocks;
  const int qb = K1_TRIAL == 5 ? blockIdx.x / per_qb : blockIdx.x % qblocks;
  const int rest = K1_TRIAL == 5 ? blockIdx.x % per_qb : blockIdx.x / qblocks;
  const int gb = rest % gblocks;
  const int tile = rest / gblocks;
  const int m0 = qb * BM;
  const int g0 = gb * BNC;
  const int L = tile_n / G;
  const int total = L * n_slices;

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
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        const int l = it / n_slices;
        const int col = (it - l * n_slices) * SLICE_ELEMS;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* st = smem + s * STAGE_BYTES;
        tma_load_2d(st, &qmap, &full[s], col, m0);
        tma_load_2d(st + TILE_BYTES, &xmap, &full[s], col, tile * tile_n + l * G + g0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg holds queries m0 + 64 wg .. + 63.
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const float inf = __int_as_float(0x7f800000);
  const int b_rows = G - g0;  // valid group columns of this block
  // Float L2 and integer Cosine read a per-row float (sqnorm, norm).
  constexpr bool ROW_F = Lane::INT ? METRIC == bfs::METRIC_COS : METRIC == bfs::METRIC_L2;
  constexpr bool RF_EARLY = ROW_F && K1_TRIAL != 2;

  // The two query rows and 32 columns of this thread's accumulators.
  const int row_base = wg * 64 + (t / 32) * 16 + lane / 4;
  float qf[2] = {0.f, 0.f};
  int qi[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row_base + 8 * h;
    if (m < B) {
      if (aux.qf != nullptr) qf[h] = aux.qf[m];
      if (aux.qi != nullptr) qi[h] = aux.qi[m];
    }
  }

  float mn[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mn[i] = inf;
  A acc[64];

  int it = 0;
  int held = -1;  // stage whose wgmma group is still in flight
  for (int l = 0; l < L; ++l) {
    // The sub-tile rows' floats, one load per thread before the products,
    // so that its latency hides behind them; the epilogue reads them from
    // shared memory. Loaded in the epilogue, between the integer Cosine
    // lane's divides, each load's latency showed (trial 2); holding a
    // thread's 32 values in registers across the products spilled.
    const long long row0 = (long long)tile * tile_n + (long long)l * G + g0;
    float* rf_buf = rf_bufs + (2 * wg + (l & 1)) * BNC;
    float rf_t = 0.f;
    if constexpr (RF_EARLY) {
      if (aux.rf != nullptr && row0 + t < count) rf_t = aux.rf[row0 + t];
    }

    for (int kc = 0; kc < n_slices; ++kc, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      uint8_t* qt = smem + s * STAGE_BYTES + wg * (TILE_BYTES / 2);
      uint8_t* xt = smem + s * STAGE_BYTES + TILE_BYTES;
      uint8_t* lo = lo_base + (it % LO_BUFS) * STAGE_BYTES;
      if constexpr (TC::SPLIT) {
        split_share<4>(qt, lo + wg * (TILE_BYTES / 2), t);
        split_share<4>(xt + wg * (TILE_BYTES / 2), lo + TILE_BYTES + wg * (TILE_BYTES / 2), t);
        fence_proxy_async();
        bar_sync(1, CONSUMERS);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < SLICE / 32; ++ks) {
        const uint64_t dq = desc_sw128(smem_u32(qt) + 32 * ks);
        const uint64_t dx = desc_sw128(smem_u32(xt) + 32 * ks);
        const uint32_t keep = (kc > 0 || ks > 0) ? 1u : 0u;
        if constexpr (TC::SPLIT) {
          const uint64_t dql = desc_sw128(smem_u32(lo + wg * (TILE_BYTES / 2)) + 32 * ks);
          const uint64_t dxl = desc_sw128(smem_u32(lo + TILE_BYTES) + 32 * ks);
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
    if constexpr (RF_EARLY) {
      // Two buffers: a thread writes this one again two sub-tiles later,
      // past the barrier that every thread reaches after this epilogue.
      rf_buf[t] = rf_t;
      bar_sync(2 + wg, 128);
    }

    // Metric epilogue, count mask, running group minimum.
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 8 * (c / 2) + 2 * (lane % 4) + (c % 2);
      const long long r = row0 + col;
      const bool live = r < count;
      const float rf = RF_EARLY                          ? rf_buf[col]
                       : (ROW_F && aux.rf != nullptr && live) ? aux.rf[r]
                                                              : 0.f;
      const A ds = (dsq != nullptr && live) ? (A)dsq[r] : A(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (c / 2) + 2 * h + (c % 2);
        float v = K1_TRIAL == 1 ? 1.f - (float)acc[i]
                                : bfs::finish<Lane>((typename Lane::acc_t)acc[i], METRIC, qf[h],
                                                    qi[h], rf, (typename Lane::acc_t)ds);
        if (!live) v = inf;
        mn[i] = fminf(mn[i], v);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row_base + 8 * h;
    if (m >= B) continue;
    float* out = gm + (long long)m * T + (long long)tile * G + g0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 8 * (c / 2) + 2 * (lane % 4) + (c % 2);
      if (col < b_rows) out[col] = mn[4 * (c / 2) + 2 * h + (c % 2)];
    }
  }
}

template <class Lane, int METRIC>
int launch_metric(const CUtensorMap& qmap, const CUtensorMap& xmap, bfs::Aux aux, int* dsq,
                  float* gm, int B, int D, int n_tiles, int tile_n, int G, int count,
                  cudaStream_t stream) {
  using E = typename Lane::elem_t;
  const int gblocks = (G + BNC - 1) / BNC;
  const int qblocks = (B + BM - 1) / BM;
  const long long blocks = (long long)n_tiles * gblocks * qblocks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int n_slices = (D * (int)sizeof(E) + SLICE - 1) / SLICE;
  constexpr int bytes = smem_bytes<Lane>();
  cudaError_t err = cudaFuncSetAttribute(gm_tc_kernel<Lane, METRIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  gm_tc_kernel<Lane, METRIC><<<(unsigned)blocks, THREADS_TC, bytes, stream>>>(
      qmap, xmap, aux, dsq, gm, B, tile_n, G, count, (long long)n_tiles * G, n_slices, gblocks,
      qblocks);
  return (int)cudaGetLastError();
}

template <class Lane>
int launch(const void* q, const void* data, bfs::Aux aux, int* dsq, float* gm, int B, int D,
           int n_tiles, int tile_n, int G, int count, int metric, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  if ((D * (int)sizeof(E)) % 16 != 0 || (uintptr_t)q % 16 != 0 || (uintptr_t)data % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, xmap;
  constexpr CUtensorMapDataType type = Tc<Lane>::TYPE;
  if (!make_map(&qmap, type, sizeof(E), q, B, D, BM) ||
      !make_map(&xmap, type, sizeof(E), data, (long long)n_tiles * tile_n, D, BNC))
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
  switch (metric) {
    case bfs::METRIC_L2:
      return launch_metric<Lane, bfs::METRIC_L2>(qmap, xmap, aux, dsq, gm, B, D, n_tiles, tile_n,
                                                 G, count, stream);
    case bfs::METRIC_IP:
      return launch_metric<Lane, bfs::METRIC_IP>(qmap, xmap, aux, dsq, gm, B, D, n_tiles, tile_n,
                                                 G, count, stream);
    default:
      return launch_metric<Lane, bfs::METRIC_COS>(qmap, xmap, aux, dsq, gm, B, D, n_tiles,
                                                  tile_n, G, count, stream);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns a cudaError_t (0 on success).
// Arguments as bf_topk_gm.cu's entry point, plus `dsq`: int32 scratch of at
// least `count` entries for integer L2 (the rows' sums of squares), else
// null. Refuses (cudaErrorInvalidValue) a row stride D * esize that is not a
// multiple of 16 bytes or a base that is not 16-byte aligned.
extern "C" int bf_topk_gm_tc(const void* q, const void* data, const float* qaux_f,
                             const int* qaux_i, const float* raux, int* dsq, float* gm, int lane,
                             int B, int D, int n_tiles, int tile_n, int G, int count, int metric,
                             void* stream) {
  if (B <= 0 || D <= 0 || n_tiles <= 0 || G <= 0 || tile_n % G != 0 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const bfs::Aux aux = {qaux_f, qaux_i, raux};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count = count < 0 ? 0 : count;
  switch (lane) {
    case bfs::LANE_F32:
      return launch<bfs::LaneF32>(q, data, aux, dsq, gm, B, D, n_tiles, tile_n, G, count,
                                metric, s);
    case bfs::LANE_BF16:
      return launch<bfs::LaneBF16>(q, data, aux, dsq, gm, B, D, n_tiles, tile_n, G, count,
                                 metric, s);
    case bfs::LANE_F16:
      return launch<bfs::LaneF16>(q, data, aux, dsq, gm, B, D, n_tiles, tile_n, G, count,
                                metric, s);
    case bfs::LANE_S8:
      return launch<bfs::LaneS8>(q, data, aux, dsq, gm, B, D, n_tiles, tile_n, G, count,
                               metric, s);
    case bfs::LANE_U8:
      return launch<bfs::LaneU8>(q, data, aux, dsq, gm, B, D, n_tiles, tile_n, G, count,
                               metric, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
