// Hopper helpers of the tensor-core kernels (the group-min kernel
// bf_topk_gm_tc.cu, the fused top-k and per-tile top-c kernels
// bf_topk_fused_tc.cu): mbarriers, TMA tile loads and the host side of their
// tensor maps, wgmma shared-memory descriptors, one m64n128 and one m64n64
// wgmma per operand type as inline PTX for sm_90a, the fp32 lane's 3xTF32
// split, and the integer rows' sums of squares.
//
// Shared-memory layout the helpers assume. Every operand tile is K-major: a
// row of the tile is SLICE = 128 bytes of depth (32 fp32, 64 bf16/fp16 or
// 128 int8 elements), rows follow each other, and TMA writes the tile with
// the 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)).
// Eight rows form one 1024-byte swizzle atom, so a tile starts on a
// 1024-byte boundary. One wgmma consumes 32 bytes of depth (k8 tf32, k16
// bf16/fp16, k32 int8); step s of a 128-byte slice starts 32 s bytes into
// the tile, which the descriptor expresses by its start address alone.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace bft {

constexpr int SLICE = 128;  // bytes of depth per tile row, stage and TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier
// counts its (never run) phase of parity 1 as completed. A wait that lasts
// 2^35 cycles (~18 s) traps, so that a pipeline fault ends the launch with
// an error instead of holding the card.
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

// --------------------------------------------------------------------- TMA

// Loads the box at element coordinates (col, row) of a 2-D tensor map into
// shared memory at `dst`, completing `bytes` on `bar`. Elements outside the
// tensor arrive as zeros (and still count toward the bytes).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` over `threads` threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Named barrier that also returns whether any of the `threads` threads
// passed `v` true (the barrier orders memory as bar.sync does).
__device__ __forceinline__ bool bar_any(int id, int threads, bool v) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"((uint32_t)v), "r"(id), "r"(threads)
      : "memory");
  return out != 0;
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a K-major, 128-byte-swizzled tile at shared address `addr`
// (1024-byte aligned, or 32 s bytes past such a start for depth step s):
// start address >> 4 in bits 0-13, leading offset 1 (unused by swizzled
// K-major tiles), stride offset 1024 B >> 4 between 8-row atoms in bits
// 32-45, swizzle mode 1 (128 B) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Register rebalancing between warpgroups (all threads of the warpgroup
// execute it).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <class T, int N>
__device__ __forceinline__ void fence_regs(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value) asm volatile("" : "+f"(d[i])::"memory");
    else asm volatile("" : "+r"(d[i])::"memory");
  }
}

#define BFT_REGS                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define BFT_8(C, d, o) \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]), C(d[o + 5]), C(d[o + 6]), C(d[o + 7])
#define BFT_64(C, d)                                                                      \
  BFT_8(C, d, 0), BFT_8(C, d, 8), BFT_8(C, d, 16), BFT_8(C, d, 24), BFT_8(C, d, 32),      \
      BFT_8(C, d, 40), BFT_8(C, d, 48), BFT_8(C, d, 56)
#define BFT_F(x) "+f"(x)
#define BFT_R(x) "+r"(x)

// d[64] (+)= A[64 x 32 B] . B[128 x 32 B]^T, one per operand type. `acc` = 0
// overwrites d (the first step of a sum), 1 adds to it. Accumulator i of
// thread t of the warpgroup is element (row, col) with row = 16 (t / 32) +
// (t % 32) / 4 + 8 ((i / 2) % 2), col = 8 (i / 4) + 2 (t % 4) + i % 2.
#define BFT_WGMMA(NAME, T, CONSTRAINT, INSTR, TAIL)                                         \
  __device__ __forceinline__ void NAME(T(&d)[64], uint64_t da, uint64_t db, uint32_t acc) { \
    asm volatile(                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" INSTR " " BFT_REGS                    \
        ", %64, %65, p" TAIL ";\n}\n"                                                       \
        : BFT_64(CONSTRAINT, d)                                                            \
        : "l"(da), "l"(db), "r"(acc));                                                      \
  }

BFT_WGMMA(wgmma_tf32, float, BFT_F, "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
          ", 1, 1")
BFT_WGMMA(wgmma_bf16, float, BFT_F, "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
          ", 1, 1, 0, 0")
BFT_WGMMA(wgmma_f16, float, BFT_F, "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16",
          ", 1, 1, 0, 0")
BFT_WGMMA(wgmma_s8, int, BFT_R, "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8", "")
BFT_WGMMA(wgmma_u8, int, BFT_R, "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8", "")

#undef BFT_WGMMA

#define BFT_REGS32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define BFT_32(C, d) BFT_8(C, d, 0), BFT_8(C, d, 8), BFT_8(C, d, 16), BFT_8(C, d, 24)

// d[32] (+)= A[64 x 32 B] . B[64 x 32 B]^T: the m64n64 forms, for a B tile
// of 64 rows. Accumulator i of thread t is element (row, col) with the
// m64n128 formula above, i < 32.
#define BFT_WGMMA_N64(NAME, T, CONSTRAINT, INSTR, TAIL)                                     \
  __device__ __forceinline__ void NAME(T(&d)[32], uint64_t da, uint64_t db, uint32_t acc) { \
    asm volatile(                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" INSTR " " BFT_REGS32                  \
        ", %32, %33, p" TAIL ";\n}\n"                                                       \
        : BFT_32(CONSTRAINT, d)                                                            \
        : "l"(da), "l"(db), "r"(acc));                                                      \
  }

BFT_WGMMA_N64(wgmma_tf32_n64, float, BFT_F, "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
              ", 1, 1")
BFT_WGMMA_N64(wgmma_bf16_n64, float, BFT_F,
              "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", ", 1, 1, 0, 0")
BFT_WGMMA_N64(wgmma_f16_n64, float, BFT_F, "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16",
              ", 1, 1, 0, 0")
BFT_WGMMA_N64(wgmma_s8_n64, int, BFT_R, "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8", "")
BFT_WGMMA_N64(wgmma_u8_n64, int, BFT_R, "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8", "")

#undef BFT_WGMMA_N64

// ------------------------------------------------------- fp32 as 3xTF32

// TF32 rounding of an fp32 pattern: nearest, ties away from zero (the
// rounding of cvt.rna.tf32.f32, done with integer ops so that the low 13
// bits come out zero whatever the tensor core does with them). Finite inputs
// only (the stores hold no inf or NaN).
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Splits U * 2 KB of a landed fp32 slice in place into hi = tf32(x), writing
// lo = tf32(x - hi) (x - hi is exact) at the same offsets of `lo`; 128
// threads, thread t takes float4s t + 128 u. The products then run as
// lo_q.hi_x + hi_q.lo_x + hi_q.hi_x. Error per product: |q x - (hq hx + hq
// lx + lq hx)| <= 3.01 * 2^-22 |q x|, so over a dot product at most 2^-20 *
// sum_i |q_i x_i| (9.5e-7 for unit vectors) on top of the fp32
// accumulation; subnormal inputs lose at most 2^-137 absolute each. Both sit
// below the float lanes' 1e-5 tolerance. `split_tf32` in
// ops/kernels/bf_topk.py is the same split in PyTorch, and
// tests/test_torch_bf_gm_tc.py checks these bounds.
template <int U>
__device__ __forceinline__ void split_share(uint8_t* tile, uint8_t* lo, int t) {
  float4* h4 = reinterpret_cast<float4*>(tile);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = t + 128 * u;
    const float4 v = h4[i];
    float4 h, l;
    h.x = tf32_round(v.x);
    h.y = tf32_round(v.y);
    h.z = tf32_round(v.z);
    h.w = tf32_round(v.w);
    l.x = tf32_round(v.x - h.x);
    l.y = tf32_round(v.y - h.y);
    l.z = tf32_round(v.z - h.z);
    l.w = tf32_round(v.w - h.w);
    h4[i] = h;
    l4[i] = l;
  }
}

// ------------------------------------------------- integer L2's row norms

// Sum of squares of each of the first `rows` integer rows, exact in int32
// (the wrappers refuse D with 255^2 D >= 2^31): one warp per row, 8 rows a
// block of 256 threads.
template <class E>
__global__ void row_sumsq(const E* __restrict__ x, int* __restrict__ out, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const E* p = x + (long long)row * D;
  int s = 0;
  for (int e = lane; e < D; e += 32) s += (int)p[e] * (int)p[e];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

// ------------------------------------------------------ TMA maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime
// has already loaded (no link against it).
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Map of a row-major [rows, D] matrix of `esize`-byte elements of TMA type
// `type` in [box_rows x SLICE bytes] boxes with the 128-byte swizzle. Boxes
// reaching past the matrix arrive zero-filled.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                     long long rows, int D, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(SLICE / esize), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  EncodeTiled enc = encoder();
  return enc != nullptr &&
         enc(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace bft
