// Hopper (sm_90a) building blocks of the flash-attention kernels:
// wgmma shared-memory descriptors for the 128-byte swizzle, wgmma
// m64nNk16 bf16 -> f32 with both operands in shared memory or A in
// registers, the warpgroup fences, mbarriers, 3-D TMA loads, register
// reallocation, and the host-side encoding of TMA tensor maps.  The
// encoder is a driver-API function; it is fetched through the runtime's
// driver entry point, so the libraries link no -lcuda.
//
// The layout TMA writes and the descriptors read: a tile of R rows x 64
// bf16 (128 bytes a row) lies row after row, and the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) -- the 128-byte swizzle, in 1024-byte
// atoms of 8 rows.  A head_dim-128 tile is two such 64-column blocks,
// one after the other, a head_dim-256 tile four.  Every tile starts
// 1024-byte aligned, so the swizzle the hardware applies to absolute
// addresses is the tile's own.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

constexpr int kSwizzleCols = 64;     // bf16 columns of a 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;     // 8 swizzled rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a 128B-swizzled operand starting at shared address
// `addr`; lbo and sbo in bytes.  K-major (Q, K: the reduction dimension
// runs along the 128-byte rows): sbo = 1024 steps to the next 8 rows, lbo
// is unused (16).  MN-major (V, read with the transpose bit): lbo steps
// to the next 64-column block, sbo = 1024 to the next 8 rows of the
// reduction dimension.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler that r changes here: reads of a wgmma accumulator
// (or reuse of an A operand's registers) cannot move above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22, subnormal
// results flush to 0), without the range handling of exp2f.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma

// d (m64n128, f32) = A * B + (scale_d ? d : 0), both operands in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n64, f32) = A * B + (scale_d ? d : 0), both operands in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n64, f32) += A (registers, bf16) * B (shared, MN-major: the
// transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// d (m64n128, f32) += A (registers, bf16) * B (shared, MN-major: the
// transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// The accumulator of columns [c0, c0 + 128) of a wider m64n accumulator:
// elements 4j + e with j >= c0 / 8 (see the layout in flash_common.cuh).
using Acc128 = float[64];  // an m64n128 f32 accumulator

template <int C0, int N>
__device__ __forceinline__ Acc128& acc_cols(float (&d)[N]) {
  static_assert(C0 % 128 == 0 && C0 / 2 + 64 <= N, "a 128-column slice");
  return *reinterpret_cast<Acc128*>(&d[C0 / 2]);
}

// d (m64nN, f32) = A * B + (scale_d ? d : 0), both operands in shared
// memory, K-major; N 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "m64nNk16 with N 64 or 128");
  if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}

// d (m64nN, f32) += A (registers) * B (shared, MN-major), N 64, 128 or
// 256.  N 256 runs as two m64n128 products: B's columns 128..255 start two
// 64-column blocks -- twice the descriptor's leading byte offset -- after
// its first column, and feed the upper half of d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 256,
                "m64nNk16 with N 64, 128 or 256");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n128(acc_cols<0>(d), a, desc_b);
    wgmma_rs_n128(acc_cols<128>(d), a,
                  desc_b + 2 * ((desc_b >> 16) & 0x3FFF));
  }
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA

// Copy the box at (c0, c1, c2) of `map` into shared memory at `dst`; the
// bytes count against the transaction count of the mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Issue the TMA loads of the R x D tile at rows [row0, row0 + R) of head
// bh (3-D `map` [bh, s, D], box 64 columns x R rows) into the swizzled
// tile at `dst`: D / 64 blocks of R rows x 128 bytes.  They complete on
// `bar`.
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int blk = 0; blk < D / kSwizzleCols; ++blk)
    tma_load_3d(dst + blk * R * kRowBytes, map, bar, blk * kSwizzleCols, row0,
                bh);
}

// ------------------------------------------------------- named barriers

// Barrier `id` (1..15; 0 is __syncthreads') of `n` threads: wait until
// n threads have come (sync), or count this warp's threads and go on
// (arrive; only where `on`, a predicate rather than a branch, so that no
// wgmma nearby sits in a divergent path).
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n,
                                                 bool on = true) {
  asm volatile(
      "{\n"
      ".reg .pred on;\n"
      "setp.ne.u32 on, %2, 0;\n"
      "@on bar.arrive %0, %1;\n"
      "}\n" ::"r"(id),
      "r"(n), "r"((uint32_t)on)
      : "memory");
}

// ------------------------------------------------- register reallocation

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------ host: tensor maps

// Return codes past the CUDA runtime's own, for the *_error_string
// functions: the driver has no cuTensorMapEncodeTiled, or it refused a
// map (kErrTensorMap + its CUresult).
constexpr int kErrTensorMap = 100000;
constexpr int kErrNoEncoder = 200000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 tensor [bh, s, d] (d innermost) whose
// box is 64 columns x `rows` rows of one bh, 128-byte swizzled; a box that
// runs past s (or past d) reads zeros, never the next head's rows.
// Returns 0 or an error code (see above).
inline int encode_rows_map(CUtensorMap* map, const void* base, int d, int s,
                           int bh, int rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kSwizzleCols, (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)res;
}

// The message of a code a launch function returned: the CUDA runtime's,
// or one of the two above.
inline const char* error_string(int code) {
  static thread_local char msg[96];
  if (code == kErrNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled (CUDA 12.0 or newer "
           "is needed for TMA)";
  if (code > kErrTensorMap && code < kErrNoEncoder) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kErrTensorMap);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
