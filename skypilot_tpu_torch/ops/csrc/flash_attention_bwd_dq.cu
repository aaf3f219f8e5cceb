// Flash-attention backward, dQ, for Hopper (sm_90a): causal, non-causal
// and banded-causal (sliding-window) GQA attention.  From the forward's
// saved LSE it recomputes P = exp(scale * Q K^T - LSE) tile by tile, forms
// dS = P * (dO V^T - delta) * scale with delta = rowsum(dO * O) (computed
// outside, in f32), and accumulates dQ = dS K in f32, written once in the
// input dtype.
//
// Replaces the TPU kernel `_bwd_dq_kernel`, launched by `_flash_bwd` in
// skypilot_tpu/ops/flash_attention.py (pl.pallas_call at line 302).
//
// What bounds it on an H100: three products per visible (query, key) pair
// -- Q K^T, dO V^T and dS K, 6*D FLOPs -- against Q, dO, dQ, K and V moved
// once, so at the training shape (head_dim 128, S 2048) it is bound by
// tensor-core throughput, not by HBM.  What the bf16 design does about
// that:
//   * every product runs on wgmma: S = Q K^T and dP = dO V^T (m64n64k16)
//     with both operands in 128B-swizzled shared memory, K-major; dQ += dS
//     K (m64nDk16) with dS from registers (the accumulator re-packed as
//     bf16 A fragments) and K read MN-major with the transpose bit;
//   * one CTA per (batch*q_head, 128-row q tile), longest first; Q and dO
//     stay resident in shared memory (TMA, 64 KB at head_dim 128), each
//     consumer thread's LSE and delta in registers;
//   * a producer warpgroup, one thread of which streams 128-row K and V
//     tiles through a two-stage TMA ring (a third 64 KB stage would not
//     fit beside Q and dO); S and dP as m64n128 products read less shared
//     memory per FLOP than with 64-row tiles (measured faster), at
//     64 + 64 + 64 f32 registers for S, dP and dQ; setmaxnreg moves
//     registers from the producer (24) to the two consumer warpgroups of
//     64 q rows (240); their products and dS arithmetic interleave on the
//     SM (taking turns, with dQ of tile i - 1 issued beside S and dP of
//     tile i, measured slower);
//   * P, dP and dS never leave registers (no [S, S] matrix in HBM);
//     P = exp2(S * scale * log2(e) - LSE2) by ex2.approx; only the tiles
//     that hold a key hidden from some row (the ragged edge, the causal
//     diagonal, the window's lower edge) run the per-element mask; KV
//     tiles past the diagonal (and below a window's band) are never
//     loaded; rows past S are never stored.
// head_dim 256 (Gemma): 128-row Q and dO alone take 128 KB there, and the
// 128-row K/V ring 256 KB.  A CTA takes 64 q rows in one consumer
// warpgroup and streams 64-row K/V tiles through the two-stage ring: Q
// and dO 2 x 32 KB, the ring 2 x 2 x 32 KB, 192 KB in all; dQ (64 x 256
// f32) is 128 registers a thread beside S and dP (m64n64, 32 each).  With
// 256 threads a CTA every thread may hold 255 registers, so nothing is
// reallocated.  dS K is m64n256, run as two m64n128 products.
// No atomics: every dQ element is summed by one thread in a fixed order,
// so two calls on the same inputs give bit-identical results.  The Hopper
// primitives live in hopper.cuh.
//
// float32 inputs take a SIMT path (one warp per q row at a time, lanes
// split head_dim) with the same rules; it exists for parity checks.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  int hq, hkv, s, causal, window;  // window <= 0: no window
  float scale;
};

// ---------------------------------------------------------------- bf16

constexpr int kWgRows = 64;            // q rows of a consumer warpgroup
constexpr int kProducerRegs = 24;      // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240;     //   registers fit the SM's 65536
constexpr int kStages = 2;             // K/V tiles in flight

template <int D>
struct Tiles {
  // q rows of a CTA and kv rows of a streamed tile: 128 and 128, or 64
  // and 64 at head_dim 256 (see the header).
  static constexpr int kQRows = D == 256 ? 64 : 128;
  static constexpr int kKvRows = D == 256 ? 64 : 128;
  static constexpr int kConsumers = kQRows / kWgRows;  // warpgroups
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 128;  // + the producer
  static constexpr uint32_t kQBytes = kQRows * D * 2;        // Q or dO
  static constexpr uint32_t kQBlock = kQRows * kRowBytes;    // 64 columns
  static constexpr uint32_t kKvBytes = kKvRows * D * 2;      // a K or V tile
  static constexpr uint32_t kKvBlock = kKvRows * kRowBytes;
  // Q, dO, the ring of K and V tiles, the barriers, and room to align.
  static constexpr int kSmem = 2 * kQBytes + kStages * 2 * kKvBytes +
                               8 * (1 + 2 * kStages) + kAtomBytes;
};

// S = Q K^T (or dP = dO V^T) for one consumer warpgroup: its 64 rows of
// the resident tile at sq against the kv tile at sk, both K-major.
// Accumulator element 4j + e of a thread holds q row qrow[e >> 1] and key
// 8j + 2 t4 + (e & 1) of the tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&d)[Tiles<D>::kKvRows / 2],
                                         uint32_t sq, uint32_t sk) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<T::kKvRows>(
        d, sw128_desc(sq + (kk / 4) * T::kQBlock + col, 16, kAtomBytes),
        sw128_desc(sk + (kk / 4) * T::kKvBlock + col, 16, kAtomBytes), kk);
  }
}

// dQ += dS K: dS as bf16 A fragments, 16 keys per product; K read as it
// lies (MN-major, the transpose bit).
template <int D>
__device__ __forceinline__ void issue_dsk(
    float (&dq)[D / 2], const uint32_t (&dsa)[Tiles<D>::kKvRows / 16][4],
    uint32_t sk) {
#pragma unroll
  for (int kc = 0; kc < Tiles<D>::kKvRows / 16; ++kc)
    wgmma_rs<D>(dq, dsa[kc], sw128_desc(sk + kc * 16 * kRowBytes,
                                        Tiles<D>::kKvBlock, kAtomBytes));
}

// P = exp2(S * scale_log2 - LSE2[row]) in place (sc holds S); where
// kMask (the tiles that hold a key hidden from some row), zero where the
// key at kv0 + column is hidden from the row.
template <bool kMask, int N>
__device__ __forceinline__ void probs(float (&sc)[N / 2],
                                      const float (&lse2)[2], int kv0,
                                      const int (&qrow)[2], int t4,
                                      const Params& p, float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    float pv = exp2_approx(fmaf(sc[j], scale_log2, -lse2[(j >> 1) & 1]));
    if (kMask && !visible(p.s, p.causal, p.window, qrow[(j >> 1) & 1],
                          kv0 + (j >> 2) * 8 + t4 * 2 + (j & 1)))
      pv = 0.f;
    sc[j] = pv;
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const Params p) {
  using T = Tiles<D>;
  constexpr int kQRows = T::kQRows, kKvRows = T::kKvRows;
  constexpr int kConsumerThreads = T::kConsumerThreads;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + kAtomBytes - 1) &
                      ~uint32_t(kAtomBytes - 1);
  const uint32_t sdO = sQ + T::kQBytes;
  const uint32_t sK = sdO + T::kQBytes;            // stage i at + i * kKvBytes
  const uint32_t sV = sK + kStages * T::kKvBytes;
  const uint32_t q_bar = sV + kStages * T::kKvBytes;  // Q and dO landed
  const uint32_t full_bar = q_bar + 8;             // stage i: + 8 * i
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bh = blockIdx.x;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kQRows;
  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0, min(q0 + kQRows, p.s) - 1,
                kKvRows, &kv_first, &kv_end);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: one thread loads Q and dO once and keeps the K/V
    // ring full.  Registers move to two consumer warpgroups; one has
    // enough without.
    if constexpr (T::kConsumers == 2) regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * T::kQBytes);
      tma_load_tile<D, kQRows>(sQ, &tm_q, q_bar, q0, bh);
      tma_load_tile<D, kQRows>(sdO, &tm_do, q_bar, q0, bh);
      int st = 0, phase = 0;
      for (int kv0 = kv_first * kKvRows; kv0 < kv_end * kKvRows;
           kv0 += kKvRows) {
        mbar_wait(empty_bar + 8 * st, phase ^ 1);
        mbar_arrive_expect_tx(full_bar + 8 * st, 2 * T::kKvBytes);
        tma_load_tile<D, kKvRows>(sK + st * T::kKvBytes, &tm_k,
                                  full_bar + 8 * st, kv0, kvh);
        tma_load_tile<D, kKvRows>(sV + st * T::kKvBytes, &tm_v,
                                  full_bar + 8 * st, kv0, kvh);
        if (++st == kStages) st = 0, phase ^= 1;
      }
    }
  } else {
    // One or two consumer warpgroups of 64 q rows each.
    if constexpr (T::kConsumers == 2) regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + wg * kWgRows;  // this warpgroup's first q row
    const int qrow[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const uint32_t sq = sQ + wg * kWgRows * kRowBytes;
    const uint32_t sdo = sdO + wg * kWgRows * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    // This thread's rows: the LSE in log2 units (+inf past S: P = 0
    // there) and delta.
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = qrow[r] < p.s;
      lse2[r] = in ? p.lse[(size_t)bh * p.s + qrow[r]] * kLog2e : INFINITY;
      dlt[r] = in ? p.delta[(size_t)bh * p.s + qrow[r]] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_bar, 0);

    int st = 0, phase = 0;
    for (int kv0 = kv_first * kKvRows; kv0 < kv_end * kKvRows;
         kv0 += kKvRows) {
      const uint32_t sk = sK + st * T::kKvBytes, sv = sV + st * T::kKvBytes;
      // Mask only the tiles that hold a key hidden from some row: the
      // ragged edge, the causal diagonal, the window's lower edge.
      const bool need_mask = kv0 + kKvRows > p.s ||
                             (p.causal && kv0 + kKvRows - 1 > wq0) ||
                             (p.window > 0 &&
                              wq0 + kWgRows - 1 - kv0 >= p.window);
      mbar_wait(full_bar + 8 * st, phase);

      float sc[kKvRows / 2], dp[kKvRows / 2];
      wgmma_fence();
      issue_qk<D>(sc, sq, sk);
      wgmma_commit();
      issue_qk<D>(dp, sdo, sv);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      if (need_mask)
        probs<true, kKvRows>(sc, lse2, kv0, qrow, t4, p, scale_log2);
      else
        probs<false, kKvRows>(sc, lse2, kv0, qrow, t4, p, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kKvRows / 2; ++j)
        sc[j] = sc[j] * (dp[j] - dlt[(j >> 1) & 1]) * p.scale;  // dS
      uint32_t dsa[kKvRows / 16][4];
#pragma unroll
      for (int kc = 0; kc < kKvRows / 16; ++kc)
        c_to_a(dsa[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      wgmma_fence();
      issue_dsk<D>(dq, dsa, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(empty_bar + 8 * st);  // the stage may be refilled
      if (++st == kStages) st = 0, phase ^= 1;
    }

    store_rows_bf16<D>(dq, qrow, t4,
                       static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.s * D,
                       p.s);
  }
}

// Encode the tensor maps of q, k, v and dout (they hold the data
// pointers, so every launch encodes its own) and launch the bf16 kernel.
template <int D>
int launch_bf16(const Params& p, int b, cudaStream_t st) {
  constexpr int kQRows = Tiles<D>::kQRows, kKvRows = Tiles<D>::kKvRows;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map(&tm_q, p.q, D, p.s, b * p.hq, kQRows);
  if (err == 0) err = encode_rows_map(&tm_do, p.dout, D, p.s, b * p.hq, kQRows);
  if (err == 0) err = encode_rows_map(&tm_k, p.k, D, p.s, b * p.hkv, kKvRows);
  if (err == 0) err = encode_rows_map(&tm_v, p.v, D, p.s, b * p.hkv, kKvRows);
  if (err != 0) return err;
  constexpr int bytes = Tiles<D>::kSmem;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(b * p.hq, (p.s + kQRows - 1) / kQRows);
  flash_bwd_dq_bf16_kernel<D><<<grid, Tiles<D>::kThreads, bytes, st>>>(
      tm_q, tm_k, tm_v, tm_do, p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // head_dim elements per lane: d = lane + 32*i
  // The staged K and V tiles (64 KB at head_dim 256: dynamic).
  extern __shared__ float simt_smem[];
  float* sK = simt_smem;              // [kSimtBlockN][D]
  float* sV = sK + kSimtBlockN * D;

  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kSimtBlockM;
  const size_t q_off = (size_t)bh * p.s * D, kv_off = (size_t)kvh * p.s * D;
  const float* qg = static_cast<const float*>(p.q) + q_off;
  const float* dog = static_cast<const float*>(p.dout) + q_off;
  const float* kg = static_cast<const float*>(p.k) + kv_off;
  const float* vg = static_cast<const float*>(p.v) + kv_off;
  float* dqg = static_cast<float*>(p.dq) + q_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRowsPerWarp;

  float q[kRowsPerWarp][E], dout[kRowsPerWarp][E], dq[kRowsPerWarp][E];
  float lse[kRowsPerWarp], dlt[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const bool in = row0 + r < p.s;
    lse[r] = in ? p.lse[(size_t)bh * p.s + row0 + r] : 0.f;
    dlt[r] = in ? p.delta[(size_t)bh * p.s + row0 + r] : 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const size_t at = (size_t)(row0 + r) * D + lane + 32 * i;
      q[r][i] = in ? qg[at] : 0.f;
      dout[r][i] = in ? dog[at] : 0.f;
      dq[r][i] = 0.f;
    }
  }

  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0,
                min(q0 + kSimtBlockM, p.s) - 1, kSimtBlockN, &kv_first,
                &kv_end);
  for (int kt = kv_first; kt < kv_end; ++kt) {
    const int kv0 = kt * kSimtBlockN;
    __syncthreads();
    stage_rows_f32<D>(sK, kg, kv0, kSimtBlockN, p.s);
    stage_rows_f32<D>(sV, vg, kv0, kSimtBlockN, p.s);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s_mine = 0.f, dp_mine = 0.f;  // lane j: key kv0 + j
      for (int j = 0; j < kSimtBlockN; ++j) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          ps += q[r][i] * sK[j * D + lane + 32 * i];
          pd += dout[r][i] * sV[j * D + lane + 32 * i];
        }
        ps = warp_sum(ps);
        pd = warp_sum(pd);
        if (lane == j) {
          s_mine = ps;
          dp_mine = pd;
        }
      }
      const bool vis = row0 + r < p.s &&
                       visible(p.s, p.causal, p.window, row0 + r, kv0 + lane);
      const float pj = vis ? expf(s_mine * p.scale - lse[r]) : 0.f;
      const float dsj = pj * (dp_mine - dlt[r]) * p.scale;
      for (int j = 0; j < kSimtBlockN; ++j) {
        const float db = __shfl_sync(0xffffffffu, dsj, j);
#pragma unroll
        for (int i = 0; i < E; ++i) dq[r][i] += db * sK[j * D + lane + 32 * i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row0 + r >= p.s) continue;
#pragma unroll
    for (int i = 0; i < E; ++i)
      dqg[(size_t)(row0 + r) * D + lane + 32 * i] = dq[r][i];
  }
}

}  // namespace

extern "C" {

// Launches the dQ backward on `stream`.  q, dout, dq: [B, Hq, S, D]; k, v:
// [B, Hkv, S, D]; lse, delta: [B, Hq, S] f32.  All contiguous, bf16
// (is_f32 = 0) or f32 (is_f32 = 1).  window <= 0 means no window.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int b, int hq,
                           int hkv, int s, int d, int causal, int window,
                           float scale, int is_f32, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.hq = hq;
  p.hkv = hkv;
  p.s = s;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    const dim3 grid(b * hq, (s + kSimtBlockM - 1) / kSimtBlockM);
    constexpr int kTiles = 2 * kSimtBlockN;  // sK and sV
    if (d == 64)
      return launch_simt(flash_bwd_dq_f32_kernel<64>, grid,
                         simt_smem_bytes<64>(kTiles), st, p);
    if (d == 128)
      return launch_simt(flash_bwd_dq_f32_kernel<128>, grid,
                         simt_smem_bytes<128>(kTiles), st, p);
    if (d == 256)
      return launch_simt(flash_bwd_dq_f32_kernel<256>, grid,
                         simt_smem_bytes<256>(kTiles), st, p);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64) return launch_bf16<64>(p, b, st);
  if (d == 128) return launch_bf16<128>(p, b, st);
  if (d == 256) return launch_bf16<256>(p, b, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_dq_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
