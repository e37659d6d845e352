// Fused top-k kernel of the flat index's exact k-NN for 32 < k <= 128 (and,
// chained, any k), all five scoring lanes, L2 / IP / Cosine.
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_kernel` with
// `_pop_merge` (K3), launched by `_one_pass` under `pallas_topk`, with the
// scoring prologue `_tile_scores` (K2) fused in through bf_scores.cuh.
//
// What it computes. The exact m <= 128 smallest (distance, id) pairs per
// query in lexicographic order over the rows < count, optionally only pairs
// lex-greater than a per-query lower bound (lo_d, lo_i): the bound chains
// passes of 128 for k > 128, each pass starting after the last pair of the
// one before. Unfilled slots are (+inf, -1). No score reaches device memory.
//
// The TPU kernel walks all tiles in order on one core with one [B, k] buffer.
// A card needs a few hundred blocks in flight and a block's shared memory
// holds 64 lists, so the store is cut into `n_ranges` ranges of consecutive
// rows: grid (n_ranges, B / 64), a block keeps the running top-m of its range
// (bf_select.cuh) and writes it to part_d, part_i [B, n_ranges, m]. The host
// part (ops/kernels/bf_topk.py `fused_topk`) merges a query's n_ranges sorted
// lists with one exact top-m. Lists are lex-sorted and ranges are in id
// order, so the merge's lower-position rule on ties is the lower-id rule.
//
// What bounds it on an H100. The dot products, as in bf_topk_topc.cu: 2 B N D
// operations on the CUDA cores, about 24 ms at 1M x 768 and B = 1024 in fp32
// at 67 TFLOP/s, against one read of the store. A query inserts about
// m (1 + ln(range_rows / m)) pairs per range.
//
// Since the tensor-core kernel (bf_topk_fused_tc.cu) came, this one serves
// the shapes its gate refuses: rows whose byte length is not a multiple of 16
// (config.gm_tc_ok) or tensors whose bases are not 16-byte aligned. 16-byte
// vector loads could serve none of those, so bf_scores.cuh loads element by
// element; that takes any shape.

#include "bf_select.cuh"

namespace {

using namespace bfs;

template <class Lane>
__global__ void __launch_bounds__(THREADS)
fused_topk_kernel(const typename Lane::elem_t* __restrict__ q,
                  const typename Lane::elem_t* __restrict__ data, Aux aux,
                  const float* __restrict__ lo_d, const int* __restrict__ lo_i,
                  float* __restrict__ part_d, int* __restrict__ part_i, int B, int D, int N,
                  int range_rows, int m, int count, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r_begin = (long long)blockIdx.x * range_rows;
  const long long r_end = r_begin + range_rows < N ? r_begin + range_rows : N;
  range_topm<Lane>(q, data, aux, lo_d, lo_i, part_d, part_i, B, D, r_begin, r_end,
                   (int)blockIdx.y * SEL_BM, (int)blockIdx.x, (int)gridDim.x, m, count, metric,
                   smem);
}

template <class Lane>
int launch(const void* q, const void* data, Aux aux, const float* lo_d, const int* lo_i,
           float* part_d, int* part_i, int B, int D, int N, int range_rows, int n_ranges, int m,
           int count, int metric, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  auto kernel = fused_topk_kernel<Lane>;
  const size_t bytes = select_smem_bytes(m);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_ranges, (unsigned)((B + SEL_BM - 1) / SEL_BM));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const E*>(q), static_cast<const E*>(data),
                                           aux, lo_d, lo_i, part_d, part_i, B, D, N, range_rows,
                                           m, count, metric);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error code (0 on
// success). q [B, D] and data [N, D] in the lane's type; qaux_f [B], qaux_i
// [B], raux [N] as bf_scores.cuh's Aux, null where unused; lo_d, lo_i [B],
// both or neither; part_d, part_i [B, n_ranges, m] with n_ranges * range_rows
// >= N. Contiguous, on the current device.
extern "C" int bf_topk_fused(const void* q, const void* data, const float* qaux_f,
                             const int* qaux_i, const float* raux, const float* lo_d,
                             const int* lo_i, float* part_d, int* part_i, int lane, int B, int D,
                             int N, int range_rows, int n_ranges, int m, int count, int metric,
                             void* stream) {
  if (B <= 0 || D <= 0 || N <= 0 || range_rows <= 0 || n_ranges <= 0 || m <= 0 ||
      m > SEL_MAX_M || metric < 0 || metric > 2 || (lo_d == nullptr) != (lo_i == nullptr) ||
      (long long)n_ranges * range_rows < N)
    return (int)cudaErrorInvalidValue;
  const Aux aux = {qaux_f, qaux_i, raux};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_CALL(Lane)                                                                   \
  return launch<Lane>(q, data, aux, lo_d, lo_i, part_d, part_i, B, D, N, range_rows, n_ranges, \
                      m, count, metric, s)
  switch (lane) {
    case LANE_F32:
      FUSED_CALL(LaneF32);
    case LANE_BF16:
      FUSED_CALL(LaneBF16);
    case LANE_F16:
      FUSED_CALL(LaneF16);
    case LANE_S8:
      FUSED_CALL(LaneS8);
    case LANE_U8:
      FUSED_CALL(LaneU8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CALL
}
