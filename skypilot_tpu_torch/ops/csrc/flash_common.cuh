// Pieces shared by the flash-attention kernels for Hopper (sm_90a):
// tile sizes, the visibility rule of causal / banded attention, the KV
// tile range a q tile needs, warp reductions and the mma.sync m16n8k16
// bf16 -> f32 product with its fragment helpers.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + t4):
//   A (16x16, row-major): a0 (g, 2t4..2t4+1), a1 (g+8, 2t4..), a2 (g,
//     2t4+8..), a3 (g+8, 2t4+8..);
//   B (16x8, column-major): b0 (k 2t4..2t4+1, n g), b1 (k 2t4+8.., n g);
//   C (16x8): c0,c1 (g, 2t4..2t4+1), c2,c3 (g+8, 2t4..2t4+1).
// The lower 16 bits of a packed register hold the lower k (or column).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 64;              // q rows per tile (bf16 backward)
constexpr int kBlockN = 64;              // kv rows per tile (bf16 backward)
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

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring bf16 of one row: a fragment register.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column, `ld` elements apart: a fragment register of the
// transposed matrix (p[0] in the lower half).
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int ld) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) |
         ((uint32_t)__bfloat16_as_ushort(p[ld]) << 16);
}

// The A fragment of the 16x16 block at `p` (row-major, row stride ld).
__device__ __forceinline__ void ld_a(uint32_t a[4], const __nv_bfloat16* p,
                                     int ld, int g, int t4) {
  const __nv_bfloat16* q = p + g * ld + t4 * 2;
  a[0] = ld32(q);
  a[1] = ld32(q + 8 * ld);
  a[2] = ld32(q + 8);
  a[3] = ld32(q + 8 * ld + 8);
}

// The A fragment of a 16x16 block held as two 16x8 C accumulators (n
// tiles lo and hi), rounded to bf16: how P and dS feed the next product.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Stage `rows` rows of D bf16 from global `src` (row stride D), starting
// at row `row0`, into shared `dst` (row stride D + 8); rows at or past
// `s` are zero.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int rows, int s) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(&dst[r * (D + 8) + col]) =
        row0 + r < s ? *reinterpret_cast<const uint4*>(
                           src + (size_t)(row0 + r) * D + col)
                     : zero;
  }
}

// Stage `rows` rows of D floats from global `src`, starting at `row0`,
// into shared `dst` (row stride D); rows at or past `s` are zero.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int row0, int rows, int s) {
  for (int c = threadIdx.x; c < rows * D; c += kThreads) {
    const int r = c / D;
    dst[c] = row0 + r < s ? src[(size_t)(row0 + r) * D + c % D] : 0.f;
  }
}

}  // namespace flash
