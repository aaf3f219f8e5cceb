// Flash-attention backward, dK and dV, for Hopper (sm_90a): causal,
// non-causal and banded-causal (sliding-window) GQA attention.  From the
// forward's saved LSE it recomputes P^T = exp(scale * K Q^T - LSE) tile by
// tile, forms dS^T = P^T * (V dO^T - delta) * scale with delta =
// rowsum(dO * O) (computed outside, in f32), and accumulates dV = P^T dO
// and dK = dS^T Q in f32 over every q head of the kv head's group, written
// once in the input dtype.
//
// Replaces the TPU kernel `_bwd_dkv_kernel`, launched by `_flash_bwd` in
// skypilot_tpu/ops/flash_attention.py (pl.pallas_call at line 319), and
// the GQA fold after it (`:347-351`), which this kernel does in registers.
//
// What bounds it on an H100: four products per visible (query, key) pair
// -- K Q^T, V dO^T, P^T dO and dS^T Q, 8*D FLOPs -- against Q, dO, K, V,
// dK and dV moved once, so at the training shape (head_dim 128, S 2048)
// it is bound by tensor-core throughput, not by HBM (989 TFLOP/s bf16 vs
// 3.35 TB/s).  What the bf16 design does about that:
//   * every product runs on wgmma, the only way to the full tensor-core
//     rate: S^T = K Q^T and dP^T = V dO^T (m64n64k16) with both operands
//     in 128B-swizzled shared memory, K-major as they lie in memory;
//     dV += P^T dO and dK += dS^T Q (m64nDk16) with P^T and dS^T from
//     registers (the accumulators re-packed as bf16 A fragments) and dO
//     and Q read MN-major with the transpose bit: nothing is transposed
//     by hand;
//   * one CTA per (batch*kv_head, 128-row KV tile), KV tile 0 (the one
//     that sees the most q tiles, causal) issued first; K and V stay
//     resident in shared memory (TMA, 64 KB at head_dim 128);
//   * a producer warpgroup: one thread streams the 64-row Q and dO tiles
//     of every (q head of the group, overlapping q tile) through a
//     three-stage TMA ring (3-D maps [bh, S, D], so a tile past S reads
//     zeros, not the next head); warp 1 writes each stage's LSE (in log2
//     units, +inf past S) and delta rows with plain loads; mbarriers
//     carry the ring (full: the TMA bytes and the row warp, empty: the
//     256 consumer threads); setmaxnreg moves registers from the producer
//     (40) to the consumers (232);
//   * two consumer warpgroups of 64 kv rows each keep dK and dV in f32
//     registers; the GQA fold happens there, so no f32 [B, Hq, S, D]
//     partials exist; the warpgroups' products and P/dS arithmetic
//     interleave on the SM (taking turns, as the forward does, needs
//     dV/dK of tile i - 1 in flight beside S^T of tile i, which spills);
//   * P^T = exp2(S^T * scale * log2(e) - LSE2) by ex2.approx; only tiles
//     that hold a pair hidden from some query (the ragged edge on either
//     side, the causal diagonal, the window's lower edge) run the
//     per-element mask, the rest a copy compiled without it; q tiles that
//     see none of the KV tile are never loaded; KV rows past S are never
//     stored.
// head_dim 256 (Gemma): K and V of 128 rows take 128 KB there and a
// three-stage Q/dO ring 192 KB, and dK plus dV of 64 rows x 256 are 256
// f32 registers a thread, past the 255 a thread may hold.  A CTA takes 64
// kv rows (K and V 2 x 32 KB resident, a two-stage ring of 64-row Q and
// dO tiles 2 x 2 x 32 KB: 192 KB with the 16 KB below), and its two
// consumer warpgroups split the products rather than the rows: the first
// forms S^T and P^T and accumulates dV (128 registers), the second forms
// dP^T, takes P^T from the first through 16 KB of shared memory (named
// barriers 1 and 2), forms dS^T and accumulates dK (128 registers).  No
// product runs twice, and the grid of an MQA kv head (B * S / 64 CTAs)
// is twice the one 128-row tiles would give.  P^T dO and dS^T Q are
// m64n256, each run as two m64n128 products.
// No atomics: every dK/dV element is summed by one thread in a fixed
// order, so two calls on the same inputs give bit-identical results.
// The Hopper primitives live in hopper.cuh.
//
// float32 inputs take a SIMT path (one warp per KV row at a time, lanes
// split head_dim) with the same rules; it exists for parity checks.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kSimtBlockQ = 32;  // q rows per staged tile, f32 path

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dk;
  void* dv;
  int hq, hkv, s, causal, window;  // window <= 0: no window
  float scale;
};

// ---------------------------------------------------------------- bf16

constexpr int kWgRows = 64;            // kv rows of a consumer warpgroup
constexpr int kQRows = 64;             // q rows of a streamed tile
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kThreadsBf16 = 384;      // and the producer warpgroup
constexpr int kProducerRegs = 40;      // setmaxnreg: 40 * 128 + 232 * 256
constexpr int kConsumerRegs = 232;     //   = the 168 * 384 of the launch
constexpr int kPFullBar = 1;           // head_dim 256: P^T written,
constexpr int kPFreeBar = 2;           //   and read (named barriers)

template <int D>
struct Tiles {
  // head_dim 256 splits the work of one 64-row KV tile between the two
  // consumer warpgroups (see the header); below it each warpgroup has a
  // 64-row half of a 128-row tile.  Q/dO tiles in flight: 3, or 2.
  static constexpr bool kSplit = D == 256;
  static constexpr int kKvRows = kSplit ? kWgRows : 2 * kWgRows;  // a CTA's
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr uint32_t kKvBytes = kKvRows * D * 2;      // K or V
  static constexpr uint32_t kKvBlock = kKvRows * kRowBytes;  // 64 columns
  static constexpr uint32_t kQBytes = kQRows * D * 2;        // a Q or dO tile
  static constexpr uint32_t kQBlock = kQRows * kRowBytes;
  // P^T passed from one warpgroup to the other: an m64n64 f32 accumulator.
  static constexpr uint32_t kPBytes = kSplit ? kWgRows * kQRows * 4 : 0;
  // K, V, the ring of Q and dO tiles, its LSE and delta rows, P^T, the
  // barriers, and room to align.
  static constexpr int kSmem = 2 * kKvBytes + kStages * 2 * kQBytes +
                               kStages * 2 * kQRows * 4 + kPBytes +
                               8 * (1 + 2 * kStages) + kAtomBytes;
};

// S^T = K Q^T (or dP^T = V dO^T) for one consumer warpgroup: 64 rows of
// the resident tile at sk against the 64 rows of the q tile at sq, both
// K-major.  Accumulator element 4j + e of a thread holds kv row
// kvrow[e >> 1] and q column 8j + 2 t4 + (e & 1).
template <int D>
__device__ __forceinline__ void issue_kq(float (&d)[kQRows / 2], uint32_t sk,
                                         uint32_t sq) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(
        d, sw128_desc(sk + (kk / 4) * Tiles<D>::kKvBlock + col, 16, kAtomBytes),
        sw128_desc(sq + (kk / 4) * Tiles<D>::kQBlock + col, 16, kAtomBytes),
        kk);
  }
}

// acc += A X: A (64 kv rows x 64 q) as bf16 fragments, X the q tile at sq
// (dO for dV, Q for dK) read as it lies (MN-major, the transpose bit).
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[kQRows / 16][4],
                                          uint32_t sq) {
#pragma unroll
  for (int kc = 0; kc < kQRows / 16; ++kc)
    wgmma_rs<D>(acc, a[kc], sw128_desc(sq + kc * 16 * kRowBytes,
                                       Tiles<D>::kQBlock, kAtomBytes));
}

// The q tile at q0 against the 64 kv rows from wkv0 holds a pair hidden
// from some query: the ragged edge on either side, the causal diagonal,
// the window's lower edge.  Only such tiles run the per-element mask.
__device__ __forceinline__ bool needs_mask(const Params& p, int q0,
                                           int wkv0) {
  return q0 + kQRows > p.s || wkv0 + kWgRows > p.s ||
         (p.causal && wkv0 + kWgRows - 1 > q0) ||
         (p.window > 0 && q0 + kQRows - 1 - wkv0 >= p.window);
}

// P^T = exp2(S^T * scale_log2 - LSE2[q]) in place (pt holds S^T), the
// LSE2 of the tile's 64 queries at lse2; where kMask (the tiles that hold
// a pair hidden from some query), zero where the key is hidden from the
// query or the query lies past S.
template <bool kMask>
__device__ __forceinline__ void probs_t(float (&pt)[kQRows / 2],
                                        const float* lse2, int q0,
                                        const int (&kvrow)[2], int t4,
                                        const Params& p, float scale_log2) {
#pragma unroll
  for (int j = 0; j < kQRows / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + j * 8 + t4 * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + j * 8 + t4 * 2 + (e & 1);
      float pv = exp2_approx(fmaf(pt[4 * j + e], scale_log2,
                                  -(e & 1 ? l2.y : l2.x)));
      if (kMask && (q >= p.s || !visible(p.s, p.causal, p.window, q,
                                         kvrow[e >> 1])))
        pv = 0.f;
      pt[4 * j + e] = pv;
    }
  }
}

// dS^T = P^T (dP^T - delta[q]) * scale in place (dst holds dP^T), the
// delta of the tile's 64 queries at delta.
__device__ __forceinline__ void grads_t(float (&dst)[kQRows / 2],
                                        const float (&pt)[kQRows / 2],
                                        const float* delta, int t4,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < kQRows / 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + j * 8 + t4 * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[4 * j + e] =
          pt[4 * j + e] * (dst[4 * j + e] - (e & 1 ? dl.y : dl.x)) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const Params p) {
  using T = Tiles<D>;
  constexpr int kKvRows = T::kKvRows, kStages = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + (kAtomBytes - smem_u32(smem_raw) % kAtomBytes) %
                                 kAtomBytes;
  const uint32_t sK = smem_u32(base);
  const uint32_t sV = sK + T::kKvBytes;
  const uint32_t sQ = sV + T::kKvBytes;            // stage i at + i * kQBytes
  const uint32_t sdO = sQ + kStages * T::kQBytes;
  // Stage i's LSE (log2 units, +inf past S) at sRows + 2 i kQRows, its
  // delta kQRows after; then P^T (head_dim 256), then the barriers.
  float* sRows = reinterpret_cast<float*>(
      base + 2 * T::kKvBytes + 2 * kStages * T::kQBytes);
  float* sP = sRows + kStages * 2 * kQRows;
  const uint32_t kv_bar = smem_u32(sP) + T::kPBytes;
  const uint32_t full_bar = kv_bar + 8;            // stage i: + 8 * i
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int kv_tile = blockIdx.y;  // causal: the first tiles see most q
  const int bkv = blockIdx.x;
  const int b = bkv / p.hkv, group = p.hq / p.hkv;
  const int bh0 = b * p.hq + (bkv % p.hkv) * group;  // the group's first
  const int kv0 = kv_tile * kKvRows;
  // The q tiles that overlap the KV tile, for each q head of the group.
  int qt_first, qt_end;
  q_tile_range(p.s, p.causal, p.window, kv0, min(kv0 + kKvRows, p.s) - 1,
               kQRows, &qt_first, &qt_end);
  const int q_first = qt_first * kQRows, q_end = qt_end * kQRows;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1 + 32);  // TMA thread + the row warp
      mbar_init(empty_bar + 8 * st, kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: thread 0 loads K and V once and keeps the Q/dO
    // ring full; warp 1 writes each stage's LSE and delta rows.
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * T::kKvBytes);
      tma_load_tile<D, kKvRows>(sK, &tm_k, kv_bar, kv0, bkv);
      tma_load_tile<D, kKvRows>(sV, &tm_v, kv_bar, kv0, bkv);
      int st = 0, phase = 0;
      for (int bh = bh0; bh < bh0 + group; ++bh)
        for (int q0 = q_first; q0 < q_end; q0 += kQRows) {
          mbar_wait(empty_bar + 8 * st, phase ^ 1);
          mbar_arrive_expect_tx(full_bar + 8 * st, 2 * T::kQBytes);
          tma_load_tile<D, kQRows>(sQ + st * T::kQBytes, &tm_q,
                                   full_bar + 8 * st, q0, bh);
          tma_load_tile<D, kQRows>(sdO + st * T::kQBytes, &tm_do,
                                   full_bar + 8 * st, q0, bh);
          if (++st == kStages) st = 0, phase ^= 1;
        }
    } else if (tid / 32 == 1) {
      const int lane = tid % 32;
      int st = 0, phase = 0;
      for (int bh = bh0; bh < bh0 + group; ++bh)
        for (int q0 = q_first; q0 < q_end; q0 += kQRows) {
          const float* lse = p.lse + (size_t)bh * p.s + q0;
          const float* delta = p.delta + (size_t)bh * p.s + q0;
          mbar_wait(empty_bar + 8 * st, phase ^ 1);
          float* rows = sRows + st * 2 * kQRows;
#pragma unroll
          for (int r = lane; r < kQRows; r += 32) {
            const bool in = q0 + r < p.s;
            rows[r] = in ? lse[r] * kLog2e : INFINITY;
            rows[kQRows + r] = in ? delta[r] : 0.f;
          }
          mbar_arrive(full_bar + 8 * st);
          if (++st == kStages) st = 0, phase ^= 1;
        }
    }
  } else if constexpr (!T::kSplit) {
    // Two consumer warpgroups of 64 kv rows each.
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wkv0 = kv0 + wg * kWgRows;  // this warpgroup's first kv row
    const int kvrow[2] = {wkv0 + warp * 16 + g, wkv0 + warp * 16 + g + 8};
    const uint32_t sk = sK + wg * kWgRows * kRowBytes;
    const uint32_t sv = sV + wg * kWgRows * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_bar, 0);

    int st = 0, phase = 0;
    for (int gi = 0; gi < group; ++gi)
      for (int q0 = q_first; q0 < q_end; q0 += kQRows) {
        const uint32_t sq = sQ + st * T::kQBytes, sdo = sdO + st * T::kQBytes;
        const float* rows = sRows + st * 2 * kQRows;
        const bool need_mask = needs_mask(p, q0, wkv0);
        mbar_wait(full_bar + 8 * st, phase);

        float pt[kQRows / 2], dpt[kQRows / 2];
        wgmma_fence();
        issue_kq<D>(pt, sk, sq);
        wgmma_commit();
        issue_kq<D>(dpt, sv, sdo);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(pt);
        if (need_mask)
          probs_t<true>(pt, rows, q0, kvrow, t4, p, scale_log2);
        else
          probs_t<false>(pt, rows, q0, kvrow, t4, p, scale_log2);
        wgmma_wait<0>();
        fence_regs(dpt);
        grads_t(dpt, pt, rows + kQRows, t4, p.scale);
        uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];
#pragma unroll
        for (int kc = 0; kc < kQRows / 16; ++kc) {
          c_to_a(pa[kc], &pt[8 * kc], &pt[8 * kc + 4]);
          c_to_a(dsa[kc], &dpt[8 * kc], &dpt[8 * kc + 4]);
        }
        wgmma_fence();
        issue_acc<D>(dv, pa, sdo);
        issue_acc<D>(dk, dsa, sq);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(dsa);
        mbar_arrive(empty_bar + 8 * st);  // the stage may be refilled
        if (++st == kStages) st = 0, phase ^= 1;
      }

    const size_t kv_off = (size_t)bkv * p.s * D;
    store_rows_bf16<D>(dk, kvrow, t4,
                       static_cast<__nv_bfloat16*>(p.dk) + kv_off, p.s);
    store_rows_bf16<D>(dv, kvrow, t4,
                       static_cast<__nv_bfloat16*>(p.dv) + kv_off, p.s);
  } else {
    // head_dim 256: both consumer warpgroups take the CTA's 64 kv rows.
    // Warpgroup 0 forms S^T = K Q^T and P^T and accumulates dV += P^T dO;
    // warpgroup 1 forms dP^T = V dO^T, takes P^T through sP, forms dS^T
    // and accumulates dK += dS^T Q.  The code is the same for both (the
    // wgmma in no branch); the operands are chosen by warpgroup.
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, t = tid % 128, warp = t / 32;
    const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
    const int kvrow[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};
    const float scale_log2 = p.scale * kLog2e;
    const int n_tiles = group * (qt_end - qt_first);
    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    named_bar_arrive(kPFreeBar, kConsumerThreads, wg == 1);  // sP is free
    mbar_wait(kv_bar, 0);

    int st = 0, phase = 0, n = 0;
    for (int gi = 0; gi < group; ++gi)
      for (int q0 = q_first; q0 < q_end; q0 += kQRows, ++n) {
        const uint32_t sq = sQ + st * T::kQBytes, sdo = sdO + st * T::kQBytes;
        const float* rows = sRows + st * 2 * kQRows;
        mbar_wait(full_bar + 8 * st, phase);

        float x[kQRows / 2];  // S^T, then P^T (0); dP^T, then dS^T (1)
        wgmma_fence();
        issue_kq<D>(x, wg == 0 ? sK : sV, wg == 0 ? sq : sdo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (wg == 0) {
          if (needs_mask(p, q0, kv0))
            probs_t<true>(x, rows, q0, kvrow, t4, p, scale_log2);
          else
            probs_t<false>(x, rows, q0, kvrow, t4, p, scale_log2);
          // Thread t of either warpgroup holds the same elements: sP is
          // [element][thread], so a warp's stores and loads are
          // consecutive words.
          named_bar_sync(kPFreeBar, kConsumerThreads);
#pragma unroll
          for (int j = 0; j < kQRows / 2; ++j) sP[j * 128 + t] = x[j];
          named_bar_arrive(kPFullBar, kConsumerThreads);
        } else {
          float pt[kQRows / 2];
          named_bar_sync(kPFullBar, kConsumerThreads);
#pragma unroll
          for (int j = 0; j < kQRows / 2; ++j) pt[j] = sP[j * 128 + t];
          named_bar_arrive(kPFreeBar, kConsumerThreads, n + 1 < n_tiles);
          grads_t(x, pt, rows + kQRows, t4, p.scale);
        }
        uint32_t a[kQRows / 16][4];
#pragma unroll
        for (int kc = 0; kc < kQRows / 16; ++kc)
          c_to_a(a[kc], &x[8 * kc], &x[8 * kc + 4]);
        wgmma_fence();
        issue_acc<D>(acc, a, wg == 0 ? sdo : sq);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        mbar_arrive(empty_bar + 8 * st);  // the stage may be refilled
        if (++st == kStages) st = 0, phase ^= 1;
      }

    store_rows_bf16<D>(acc, kvrow, t4,
                       static_cast<__nv_bfloat16*>(wg == 0 ? p.dv : p.dk) +
                           (size_t)bkv * p.s * D,
                       p.s);
  }
}

// Encode the tensor maps of q, k, v and dout (they hold the data
// pointers, so every launch encodes its own) and launch the bf16 kernel.
template <int D>
int launch_bf16(const Params& p, int b, cudaStream_t st) {
  constexpr int kKvRows = Tiles<D>::kKvRows;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map(&tm_q, p.q, D, p.s, b * p.hq, kQRows);
  if (err == 0) err = encode_rows_map(&tm_do, p.dout, D, p.s, b * p.hq, kQRows);
  if (err == 0) err = encode_rows_map(&tm_k, p.k, D, p.s, b * p.hkv, kKvRows);
  if (err == 0) err = encode_rows_map(&tm_v, p.v, D, p.s, b * p.hkv, kKvRows);
  if (err != 0) return err;
  constexpr int bytes = Tiles<D>::kSmem;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(b * p.hkv, (p.s + kKvRows - 1) / kKvRows);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreadsBf16, bytes, st>>>(
      tm_q, tm_k, tm_v, tm_do, p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // head_dim elements per lane: d = lane + 32*i
  // The staged Q and dO tiles and their LSE and delta rows (64 KB at
  // head_dim 256: dynamic).
  extern __shared__ float simt_smem[];
  float* sQ = simt_smem;              // [kSimtBlockQ][D]
  float* sdO = sQ + kSimtBlockQ * D;
  float* sLse = sdO + kSimtBlockQ * D;
  float* sDelta = sLse + kSimtBlockQ;

  const int kv_tile = blockIdx.y;
  const int bkv = blockIdx.x;
  const int b = bkv / p.hkv, group = p.hq / p.hkv;
  const int kv0 = kv_tile * kSimtBlockM;
  const size_t kv_off = (size_t)bkv * p.s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = kv0 + warp * kRowsPerWarp;

  float k[kRowsPerWarp][E], v[kRowsPerWarp][E];
  float dk[kRowsPerWarp][E], dv[kRowsPerWarp][E];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const size_t at = kv_off + (size_t)(row0 + r) * D + lane + 32 * i;
      const bool in = row0 + r < p.s;
      k[r][i] = in ? static_cast<const float*>(p.k)[at] : 0.f;
      v[r][i] = in ? static_cast<const float*>(p.v)[at] : 0.f;
      dk[r][i] = dv[r][i] = 0.f;
    }

  int qt_first, qt_end;
  q_tile_range(p.s, p.causal, p.window, kv0,
               min(kv0 + kSimtBlockM, p.s) - 1, kSimtBlockQ, &qt_first,
               &qt_end);
  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * p.hq + (bkv % p.hkv) * group + gi;
    const size_t q_off = (size_t)bh * p.s * D;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kSimtBlockQ;
      __syncthreads();
      stage_rows_f32<D>(sQ, static_cast<const float*>(p.q) + q_off, q0,
                        kSimtBlockQ, p.s);
      stage_rows_f32<D>(sdO, static_cast<const float*>(p.dout) + q_off, q0,
                        kSimtBlockQ, p.s);
      for (int r = threadIdx.x; r < kSimtBlockQ; r += kThreads) {
        const bool in = q0 + r < p.s;
        sLse[r] = in ? p.lse[(size_t)bh * p.s + q0 + r] : 0.f;
        sDelta[r] = in ? p.delta[(size_t)bh * p.s + q0 + r] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float s_mine = 0.f, dp_mine = 0.f;  // lane j: query q0 + j
        for (int j = 0; j < kSimtBlockQ; ++j) {
          float ps = 0.f, pd = 0.f;
#pragma unroll
          for (int i = 0; i < E; ++i) {
            ps += k[r][i] * sQ[j * D + lane + 32 * i];
            pd += v[r][i] * sdO[j * D + lane + 32 * i];
          }
          ps = warp_sum(ps);
          pd = warp_sum(pd);
          if (lane == j) {
            s_mine = ps;
            dp_mine = pd;
          }
        }
        const bool vis = q0 + lane < p.s &&
                         visible(p.s, p.causal, p.window, q0 + lane,
                                 row0 + r);
        const float pj = vis ? expf(s_mine * p.scale - sLse[lane]) : 0.f;
        const float dsj = pj * (dp_mine - sDelta[lane]) * p.scale;
        for (int j = 0; j < kSimtBlockQ; ++j) {
          const float pb = __shfl_sync(0xffffffffu, pj, j);
          const float db = __shfl_sync(0xffffffffu, dsj, j);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            dv[r][i] += pb * sdO[j * D + lane + 32 * i];
            dk[r][i] += db * sQ[j * D + lane + 32 * i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row0 + r >= p.s) continue;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const size_t at = kv_off + (size_t)(row0 + r) * D + lane + 32 * i;
      static_cast<float*>(p.dk)[at] = dk[r][i];
      static_cast<float*>(p.dv)[at] = dv[r][i];
    }
  }
}

}  // namespace

extern "C" {

// Launches the dK/dV backward on `stream`.  q, dout: [B, Hq, S, D]; k, v,
// dk, dv: [B, Hkv, S, D]; lse, delta: [B, Hq, S] f32.  All contiguous,
// bf16 (is_f32 = 0) or f32 (is_f32 = 1).  window <= 0 means no window.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int b,
                            int hq, int hkv, int s, int d, int causal,
                            int window, float scale, int is_f32,
                            void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  p.hq = hq;
  p.hkv = hkv;
  p.s = s;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    const dim3 grid(b * hkv, (s + kSimtBlockM - 1) / kSimtBlockM);
    // sQ and sdO, then the LSE and delta rows.
    constexpr int kTiles = 2 * kSimtBlockQ, kRows = 2 * kSimtBlockQ;
    if (d == 64)
      return launch_simt(flash_bwd_dkv_f32_kernel<64>, grid,
                         simt_smem_bytes<64>(kTiles, kRows), st, p);
    if (d == 128)
      return launch_simt(flash_bwd_dkv_f32_kernel<128>, grid,
                         simt_smem_bytes<128>(kTiles, kRows), st, p);
    if (d == 256)
      return launch_simt(flash_bwd_dkv_f32_kernel<256>, grid,
                         simt_smem_bytes<256>(kTiles, kRows), st, p);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64) return launch_bf16<64>(p, b, st);
  if (d == 128) return launch_bf16<128>(p, b, st);
  if (d == 256) return launch_bf16<256>(p, b, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_dkv_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
