// Pieces shared by the flash-attention kernels for Hopper (sm_90a):
// tile sizes of the f32 paths and their launch, the visibility rule of
// causal / banded attention, the KV (q) tile range a q (KV) tile needs,
// warp reductions and the re-packing of an f32 wgmma accumulator into
// bf16 A fragments.
//
// Layout of a wgmma m64nN f32 accumulator, warp w of the warpgroup, lane
// = 4 * g + t4: element 4j + e holds row 16 w + g + 8 (e >> 1) and column
// 8j + 2 t4 + (e & 1).  An A fragment (registers, m64k16) of warp w holds
// rows 16 w + g (+ 8) and k columns 2 t4 (+ 1) and 2 t4 + 8 (+ 1): a0 (g,
// 2t4..), a1 (g+8, 2t4..), a2 (g, 2t4+8..), a3 (g+8, 2t4+8..).  The lower
// 16 bits of a packed register hold the lower column.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;          // f32 paths
constexpr int kSimtBlockM = kWarps * kRowsPerWarp;
constexpr int kSimtBlockN = 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Key kv is visible to query q (window <= 0: no window).
__device__ __forceinline__ bool visible(int s, int causal, int window, int q,
                                        int kv) {
  return kv < s && (!causal || kv <= q) && (window <= 0 || q - kv < window);
}

// [first, end) of the KV tiles that can hold a key some row of the q tile
// [q0, q_last] attends to (the kv_first .. num_kv_needed range of the TPU
// kernels).
__device__ __forceinline__ void kv_tile_range(int s, int causal, int window,
                                              int q0, int q_last, int block_n,
                                              int* first, int* end) {
  const int n_tiles = (s + block_n - 1) / block_n;
  *end = causal ? min(n_tiles, q_last / block_n + 1) : n_tiles;
  *first = window > 0 ? max(0, q0 - window + 1) / block_n : 0;
}

// [first, end) of the q tiles holding a query that attends to some key of
// the KV tile [kv0, kv_last] (the overlap test of `_bwd_dkv_kernel`
// turned into a loop range).
__device__ __forceinline__ void q_tile_range(int s, int causal, int window,
                                             int kv0, int kv_last,
                                             int block_m, int* first,
                                             int* end) {
  const int n_tiles = (s + block_m - 1) / block_m;
  *first = causal ? kv0 / block_m : 0;
  *end = window > 0 ? min(n_tiles, (kv_last + window - 1) / block_m + 1)
                    : n_tiles;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k columns 16 kc .. 16 kc + 15 of an accumulator
// (lo: elements 8 kc .. 8 kc + 3, hi: the next four), rounded to bf16: how
// P and dS feed the next product.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Store a thread's part of an m64nD f32 accumulator as bf16: rows row[0]
// and row[1] of `dst` (row stride d, d <= D and a multiple of 8), those at
// or past `s` dropped, and the columns at or past d (the tile's zero fill)
// never written.
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 2],
                                                const int (&row)[2], int t4,
                                                __nv_bfloat16* dst, int s,
                                                int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      if (dn * 8 < d)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row[r] * d + dn * 8 +
                                     t4 * 2) =
            pack_bf16(acc[4 * dn + 2 * r], acc[4 * dn + 2 * r + 1]);
  }
}

// Stage `rows` rows of global `src` (row stride d), starting at `row0`,
// into shared `dst` as rows of D floats; rows at or past `s` and columns
// at or past d are zero.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int row0, int rows, int s,
                                               int d) {
  for (int c = threadIdx.x; c < rows * D; c += kThreads) {
    const int r = c / D, col = c % D;
    dst[c] = row0 + r < s && col < d ? src[(size_t)(row0 + r) * d + col]
                                     : 0.f;
  }
}

// The tile width a kernel is instantiated at for head dim d: the smallest
// of 64, 128 and 256 that holds it (0 past 256).  Columns d .. D - 1 of a
// tile are zeros: they add nothing to a product over the head dim, and
// the columns they produce are never stored.
inline int tile_dim(int d) {
  return d < 1 ? 0 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// Dynamic shared memory of a SIMT (f32) kernel that stages `rows` rows of
// D floats and `extra` floats more.
template <int D>
constexpr int simt_smem_bytes(int rows, int extra = 0) {
  return (rows * D + extra) * 4;
}

// Launch a SIMT (f32) kernel of kThreads threads with `bytes` of dynamic
// shared memory, first raising the kernel's limit where `bytes` passes
// the 48 KB every kernel may use.  Returns the CUDA error code.
template <typename P>
inline int launch_simt(void (*kernel)(P), dim3 grid, int bytes,
                       cudaStream_t st, const P& p) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace flash
