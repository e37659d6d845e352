// Per-tile local top-c kernel of the flat index's exact k-NN for large k
// (128 < k <= 2048), all five scoring lanes, L2 / IP / Cosine.
//
// Replaces: vectorsimilarity_tpu/ops/pallas/bf_topk.py `_make_tile_topc_kernel`
// (K4), launched by `pallas_topk_bigk`, with the scoring prologue
// `_tile_scores` (K2) fused in through bf_scores.cuh.
//
// What it computes. For each tile j of tile_n store rows and each query b,
// the c smallest (distance, id) pairs of that tile in lexicographic order,
// rows >= count at +inf, unfilled slots (+inf, -1). No state crosses tiles.
// The host part (ops/kernels/bf_topk.py `topk_bigk`) takes one exact top-k
// over the n_tiles * c survivors of each query and flags a query as truncated
// when some tile's c-th best lies inside its global top-k.
//
// Output layout: local_d, local_i [B, n_tiles, c]. The TPU kernel writes
// [n_tiles, B, c] because of its compiler's block rule and the host swaps the
// axes; here the block writes the host's layout directly.
//
// What bounds it on an H100. The dot products: 2 B N D operations on the CUDA
// cores (fp32 FMA: 67 TFLOP/s; __dp4a on the integer lanes), about 24 ms at
// 1M x 768 and B = 1024, against one read of the store (1 ms at 3.35 TB/s for
// fp32). Selection adds about c (1 + ln(tile_n / c)) inserts per query and
// tile. The design is bf_select.cuh's: grid (n_tiles, B / 64), a block walks
// its tile in 128-row sub-tiles and keeps 64 sorted lists of c in shared
// memory.
//
// Since the tensor-core K4 (`bf_topk_topc_tc` in bf_topk_fused_tc.cu) came,
// this one serves the shapes its gate refuses: rows whose byte length is not
// a multiple of 16 (config.gm_tc_ok), tensors whose bases are not 16-byte
// aligned, and tiles that are not a multiple of 128 rows (stores whose
// capacity is below 4096). It loads element by element and takes any shape.

#include "bf_select.cuh"

namespace {

using namespace bfs;

template <class Lane>
__global__ void __launch_bounds__(THREADS)
tile_topc_kernel(const typename Lane::elem_t* __restrict__ q,
                 const typename Lane::elem_t* __restrict__ data, Aux aux,
                 float* __restrict__ out_d, int* __restrict__ out_i, int B, int D, int tile_n,
                 int c, int count, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r_begin = (long long)blockIdx.x * tile_n;
  range_topm<Lane>(q, data, aux, nullptr, nullptr, out_d, out_i, B, D, r_begin, r_begin + tile_n,
                   (int)blockIdx.y * SEL_BM, (int)blockIdx.x, (int)gridDim.x, c, count, metric,
                   smem);
}

template <class Lane>
int launch(const void* q, const void* data, Aux aux, float* out_d, int* out_i, int B, int D,
           int n_tiles, int tile_n, int c, int count, int metric, cudaStream_t stream) {
  using E = typename Lane::elem_t;
  auto kernel = tile_topc_kernel<Lane>;
  const size_t bytes = select_smem_bytes(c);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_tiles, (unsigned)((B + SEL_BM - 1) / SEL_BM));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const E*>(q), static_cast<const E*>(data),
                                           aux, out_d, out_i, B, D, tile_n, c, count, metric);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error code (0 on
// success). q [B, D] and data [n_tiles * tile_n, D] in the lane's type; qaux_f
// [B], qaux_i [B], raux [n_tiles * tile_n] as bf_scores.cuh's Aux, null where
// unused; out_d, out_i [B, n_tiles, c]. Contiguous, on the current device.
extern "C" int bf_topk_topc(const void* q, const void* data, const float* qaux_f,
                            const int* qaux_i, const float* raux, float* out_d, int* out_i,
                            int lane, int B, int D, int n_tiles, int tile_n, int c, int count,
                            int metric, void* stream) {
  if (B <= 0 || D <= 0 || n_tiles <= 0 || tile_n <= 0 || c <= 0 || c > SEL_MAX_M ||
      metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const Aux aux = {qaux_f, qaux_i, raux};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOPC_CALL(Lane) \
  return launch<Lane>(q, data, aux, out_d, out_i, B, D, n_tiles, tile_n, c, count, metric, s)
  switch (lane) {
    case LANE_F32:
      TOPC_CALL(LaneF32);
    case LANE_BF16:
      TOPC_CALL(LaneBF16);
    case LANE_F16:
      TOPC_CALL(LaneF16);
    case LANE_S8:
      TOPC_CALL(LaneS8);
    case LANE_U8:
      TOPC_CALL(LaneU8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TOPC_CALL
}
