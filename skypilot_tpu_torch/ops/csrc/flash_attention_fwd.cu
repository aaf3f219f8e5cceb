// Flash-attention forward for Hopper (sm_90a): causal, non-causal and
// banded-causal (sliding-window) GQA attention with an online softmax in
// f32.  Writes O in the input dtype and the per-row log-sum-exp
// LSE = m + log(l) in f32 (natural log), shaped [B, Hq, S]: what both
// backward kernels read.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd` in
// skypilot_tpu/ops/flash_attention.py (pl.pallas_call at line 160).
//
// What bounds it on an H100: at the shapes the Llama forward and train
// step give it (head_dim 128, S >= 1k) attention does ~2*S*D FLOPs per q
// row against ~4*D bytes of Q/O per row, so it is bound by tensor-core
// throughput, not by HBM (989 TFLOP/s bf16 vs 3.35 TB/s).  What the bf16
// design does about that:
//   * both products run on wgmma, the only way to the full tensor-core
//     rate: S = Q K^T (m64n128k16, Q and K read from 128B-swizzled shared
//     memory, K-major as they lie in memory) and O += P V (P from
//     registers -- the S accumulator re-packed as bf16 A fragments -- and
//     V read MN-major with the transpose bit: nothing is transposed by
//     hand);
//   * one CTA per (batch*q_head, 128-row q tile): a producer warpgroup,
//     one thread of which keeps a three-stage ring of 128-row K/V tiles
//     full with TMA (3-D maps [bh, S, D], so a tile past S reads zeros,
//     not the next head), and two consumer warpgroups of 64 q rows each;
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240); mbarriers carry the ring (full: TMA transaction bytes,
//     empty: the 256 consumer threads);
//   * the consumers take turns on the tensor cores (two named barriers):
//     in its turn a warpgroup issues S of tile i and P V of tile i - 1,
//     and then runs the softmax of tile i while the other warpgroup's
//     products run;
//   * scores and P never leave registers (no [S, S] matrix in HBM); only
//     the ragged edge, the causal diagonal and the window's lower edge
//     are masked; KV tiles past the diagonal (and, with a window, below
//     the band) are skipped; causal CTAs are issued longest first;
//   * q head h of batch b reads kv head b*Hkv + h/(Hq/Hkv): no K/V copies;
//     rows past S are never stored.
// Any head dim d up to 256 runs in the tile of the smallest width D of
// 64, 128 and 256 that holds it: the tensor maps span d columns, so the
// 64-column boxes read zeros past d (one that starts past d is all
// zeros), which add nothing to Q K^T; the columns past d of P V are never
// stored.  The bf16 rows must be a multiple of 16 bytes (TMA's row
// stride): the wrapper pads other d.
// head_dim 256 (Gemma) keeps this design with 64-row K/V tiles in a
// two-stage ring: the head_dim-128 tiling would need (1 + 2 * 3) 64 KB
// tiles, twice the 227 KB an SM has, while Q (64 KB) and two stages of
// 64-row K and V (4 x 32 KB) take 192 KB.  S is then m64n64 (32 f32
// registers) beside the 128 of O; P V is m64n256, run as two m64n128
// products (hopper.cuh).
// Registers and layouts are described where they are used; the Hopper
// primitives live in hopper.cuh.
//
// float32 inputs take a SIMT path (one warp per q row at a time, lanes
// split head_dim, 16-row q tiles of four warps, K and V staged in dynamic
// shared memory); it exists for parity checks, not speed.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int hq, hkv, s, d, causal, window;  // window <= 0: no window
  float scale_log2;                   // softmax scale * log2(e)
};

// ---------------------------------------------------------------- bf16

constexpr int kQRows = 128;             // q rows of a CTA
constexpr int kWgRows = 64;             // q rows of a consumer warpgroup
constexpr int kConsumerThreads = 256;   // two consumer warpgroups
constexpr int kThreadsBf16 = 384;       // and the producer warpgroup
constexpr int kProducerRegs = 24;       // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240;      //   registers fit the SM's 65536
constexpr int kTurnBar = 1;             // named barriers 1 and 2

template <int D>
struct Tiles {
  // kv rows of a K/V tile and the tiles in flight: 128 and 3, or 64 and 2
  // at head_dim 256 (see the header).
  static constexpr int kKvRows = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr uint32_t kQBytes = kQRows * D * 2;          // Q
  static constexpr uint32_t kQBlock = kQRows * kRowBytes;      // 64 columns
  static constexpr uint32_t kBytes = kKvRows * D * 2;          // K or V tile
  static constexpr uint32_t kBlockBytes = kKvRows * kRowBytes;
  // Q, the ring of K and V tiles, the barriers, and room to align.
  static constexpr int kSmem = kQBytes + 2 * kStages * kBytes +
                               8 * (1 + 2 * kStages) + kAtomBytes;
};

// S = Q K^T for one consumer warpgroup (wgmma, both from shared memory,
// K-major): sq holds the warpgroup's 64 Q rows, sk the tile's K.
// Accumulator element 4j + e of a thread holds row qrow[e >> 1] and
// column 8j + 2 t4 + (e & 1).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D>::kKvRows / 2],
                                         uint32_t sq, uint32_t sk) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<T::kKvRows>(
        s, sw128_desc(sq + (kk / 4) * T::kQBlock + col, 16, kAtomBytes),
        sw128_desc(sk + (kk / 4) * T::kBlockBytes + col, 16, kAtomBytes), kk);
  }
}

// O += P V: P as bf16 A fragments in registers, 16 keys per product; V
// read as it lies (MN-major, the transpose bit).
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pa)[Tiles<D>::kKvRows / 16][4],
    uint32_t sv) {
#pragma unroll
  for (int kc = 0; kc < Tiles<D>::kKvRows / 16; ++kc)
    wgmma_rs<D>(o, pa[kc], sw128_desc(sv + kc * 16 * kRowBytes,
                                      Tiles<D>::kBlockBytes, kAtomBytes));
}

// The online softmax of one tile, in log2 units: mask S where kMask (the
// tiles that hold a key hidden from some row), raise the running max m
// (of S * scale_log2), turn S into P = exp2(S * scale_log2 - m) in place,
// and return the factor corr = exp2(m_old - m) by which l (here) and O (by
// the caller) are rescaled.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int kv0,
                                             const int (&qrow)[2], int t4,
                                             const Params& p) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask && !visible(p.s, p.causal, p.window, qrow[e >> 1],
                            kv0 + j * 8 + t4 * 2 + (e & 1)))
        s[4 * j + e] = -INFINITY;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
    }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float mn = fmaxf(m[r], tmax[r] * p.scale_log2);
    mb[r] = mn == -INFINITY ? 0.f : mn;  // fully masked so far
    corr[r] = exp2_approx(m[r] - mb[r]);
    m[r] = mn;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float pv = exp2_approx(fmaf(s[i], p.scale_log2, -mb[(i >> 1) & 1]));
    s[i] = pv;
    lsum[(i >> 1) & 1] += pv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
}

// Normalise O, store its d columns as bf16 (row stride d) and write the
// LSE (rows past s are dropped).
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 2],
                                           const float (&m)[2], float (&l)[2],
                                           const int (&qrow)[2], int t4,
                                           __nv_bfloat16* og, float* lseg,
                                           int s, int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= s) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      if (dn * 8 < d)
        *reinterpret_cast<uint32_t*>(og + (size_t)qrow[r] * d + dn * 8 +
                                     t4 * 2) =
            pack_bf16(o[4 * dn + 2 * r] * inv, o[4 * dn + 2 * r + 1] * inv);
    if (t4 == 0)
      lseg[qrow[r]] = m[r] == -INFINITY ? -INFINITY
                                        : (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const Params p) {
  using T = Tiles<D>;
  constexpr uint32_t kBytes = T::kBytes;
  constexpr int kKvRows = T::kKvRows, kStages = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + kAtomBytes - 1) &
                      ~uint32_t(kAtomBytes - 1);
  const uint32_t sK = sQ + T::kQBytes;             // stage i at + i * kBytes
  const uint32_t sV = sK + kStages * kBytes;
  const uint32_t q_bar = sV + kStages * kBytes;    // Q landed
  const uint32_t full_bar = q_bar + 8;             // stage i: + 8 * i
  const uint32_t empty_bar = full_bar + 8 * kStages;

  // (batch, q head) on x, whose limit is 2^31 - 1, the q tiles on y, as
  // both backward kernels lay their grids out.
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bh = blockIdx.x;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kQRows;
  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0, min(q0 + kQRows, p.s) - 1,
                kKvRows, &kv_first, &kv_end);
  const int n_kv = kv_end - kv_first;

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
    // Producer warpgroup: one thread keeps the K/V ring full.
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_bar, T::kQBytes);
      tma_load_tile<D, kQRows>(sQ, &tm_q, q_bar, q0, bh);
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % kStages, kv0 = (kv_first + i) * kKvRows;
        mbar_wait(empty_bar + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full_bar + 8 * st, 2 * kBytes);
        tma_load_tile<D, kKvRows>(sK + st * kBytes, &tm_k,
                                  full_bar + 8 * st, kv0, kvh);
        tma_load_tile<D, kKvRows>(sV + st * kBytes, &tm_v,
                                  full_bar + 8 * st, kv0, kvh);
      }
    }
  } else {
    // Two consumer warpgroups of 64 q rows each.  They take turns on the
    // tensor cores (named barriers kTurnBar + wg): in its turn a warpgroup
    // issues S = Q K^T of tile i and O += P V of tile i - 1, then runs the
    // softmax of tile i while the other warpgroup's products run.
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + wg * kWgRows;  // this warpgroup's first q row
    const int qrow[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const uint32_t sq = sQ + wg * kWgRows * kRowBytes;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial sums (same m per row)
    float s[kKvRows / 2], corr[2];
    uint32_t pa[kKvRows / 16][4];  // P of the previous tile, bf16
    // Mask only the tiles that hold a key hidden from some row: the
    // ragged edge, the causal diagonal, the window's lower edge.
    auto softmax = [&](int kv0) {
      if (kv0 + kKvRows > p.s ||
          (p.causal && kv0 + kKvRows - 1 > wq0) ||
          (p.window > 0 && wq0 + kWgRows - 1 - kv0 >= p.window))
        softmax_tile<true, kKvRows>(s, m, l, corr, kv0, qrow, t4, p);
      else
        softmax_tile<false, kKvRows>(s, m, l, corr, kv0, qrow, t4, p);
    };
    named_bar_arrive(kTurnBar, kConsumerThreads, wg == 0);  // goes first
    mbar_wait(q_bar, 0);

    // Tile 0: S and its softmax; its P V joins the next turn.
    mbar_wait(full_bar, 0);
    named_bar_sync(kTurnBar + wg, kConsumerThreads);
    wgmma_fence();
    issue_qk<D>(s, sq, sK);
    wgmma_commit();
    named_bar_arrive(kTurnBar + 1 - wg, kConsumerThreads);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(kv_first * kKvRows);
#pragma unroll
    for (int kc = 0; kc < kKvRows / 16; ++kc)
      c_to_a(pa[kc], &s[8 * kc], &s[8 * kc + 4]);

    for (int i = 1; i < n_kv; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      const int kv0 = (kv_first + i) * kKvRows;
      mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
      named_bar_sync(kTurnBar + wg, kConsumerThreads);
      wgmma_fence();
      issue_qk<D>(s, sq, sK + st * kBytes);
      wgmma_commit();
      issue_pv<D>(o, pa, sV + prev * kBytes);
      wgmma_commit();
      named_bar_arrive(kTurnBar + 1 - wg, kConsumerThreads);
      wgmma_wait<1>();  // S is in; P V of tile i - 1 may still run
      fence_regs(s);
      softmax(kv0);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty_bar + 8 * prev);  // stage prev may be refilled
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];
#pragma unroll
      for (int kc = 0; kc < kKvRows / 16; ++kc)
        c_to_a(pa[kc], &s[8 * kc], &s[8 * kc + 4]);
    }

    // The last tile's P V; the second warpgroup's turn is the last.
    named_bar_sync(kTurnBar + wg, kConsumerThreads);
    wgmma_fence();
    issue_pv<D>(o, pa, sV + ((n_kv - 1) % kStages) * kBytes);
    wgmma_commit();
    named_bar_arrive(kTurnBar + 1 - wg, kConsumerThreads, wg == 0);
    wgmma_wait<0>();
    fence_regs(o);
    store_rows<D>(o, m, l, qrow, t4,
                  static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.s * p.d,
                  p.lse + (size_t)bh * p.s, p.s, p.d);
  }
}

// Encode the tensor maps of q, k and v (they hold the data pointers, so
// every launch encodes its own) and launch the bf16 kernel.
template <int D>
int launch_bf16(const Params& p, int b, cudaStream_t st) {
  CUtensorMap tm_q, tm_k, tm_v;
  constexpr int kKvRows = Tiles<D>::kKvRows;
  int err = encode_rows_map(&tm_q, p.q, p.d, p.s, b * p.hq, kQRows);
  if (err == 0)
    err = encode_rows_map(&tm_k, p.k, p.d, p.s, b * p.hkv, kKvRows);
  if (err == 0)
    err = encode_rows_map(&tm_v, p.v, p.d, p.s, b * p.hkv, kKvRows);
  if (err != 0) return err;
  constexpr int bytes = Tiles<D>::kSmem;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(b * p.hq, (p.s + kQRows - 1) / kQRows);
  flash_fwd_bf16_kernel<D><<<grid, kThreadsBf16, bytes, st>>>(tm_q, tm_k,
                                                            tm_v, p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // tile columns per lane: lane + 32 * i
  // The staged K and V tiles (simt_smem_bytes<D>: 64 KB at head_dim 256,
  // past the 48 KB of static shared memory).
  extern __shared__ float simt_smem[];
  float* sK = simt_smem;              // [kSimtBlockN][D]
  float* sV = sK + kSimtBlockN * D;

  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kSimtBlockM;
  const int d = p.d;  // row stride; columns d .. D - 1 are zeros
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * p.s * d;
  const float* kg = static_cast<const float*>(p.k) + (size_t)kvh * p.s * d;
  const float* vg = static_cast<const float*>(p.v) + (size_t)kvh * p.s * d;
  float* og = static_cast<float*>(p.o) + (size_t)bh * p.s * d;
  float* lseg = p.lse + (size_t)bh * p.s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * kRowsPerWarp;

  float q[kRowsPerWarp][E], acc[kRowsPerWarp][E];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      q[r][i] = row0 + r < p.s && lane + 32 * i < d
                    ? qg[(size_t)(row0 + r) * d + lane + 32 * i] * p.scale_log2
                    : 0.f;
      acc[r][i] = 0.f;
    }
  }

  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0,
                min(q0 + kSimtBlockM, p.s) - 1, kSimtBlockN, &kv_first,
                &kv_end);
  for (int kt = kv_first; kt < kv_end; ++kt) {
    const int kv0 = kt * kSimtBlockN;
    __syncthreads();
    stage_rows_f32<D>(sK, kg, kv0, kSimtBlockN, p.s, d);
    stage_rows_f32<D>(sV, vg, kv0, kSimtBlockN, p.s, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mine = -INFINITY;  // lane j ends up holding key kv0 + j
      for (int j = 0; j < kSimtBlockN; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i)
          part += q[r][i] * sK[j * D + lane + 32 * i];
        part = warp_sum(part);
        if (lane == j) mine = part;
      }
      const float x =
          visible(p.s, p.causal, p.window, row0 + r, kv0 + lane) ? mine
                                                                  : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(x));
      const float mb = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m[r] - mb);
      const float pj = exp2f(x - mb);
      l[r] = l[r] * corr + warp_sum(pj);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= corr;
      for (int j = 0; j < kSimtBlockN; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
        for (int i = 0; i < E; ++i)
          acc[r][i] += pb * sV[j * D + lane + 32 * i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= p.s) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (lane + 32 * i < d)
        og[(size_t)row * d + lane + 32 * i] = acc[r][i] * inv;
    if (lane == 0)
      lseg[row] = m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  q: [B, Hq, S, d]; k, v: [B, Hkv, S, d];
// o like q; lse: [B, Hq, S] f32.  All contiguous, bf16 (is_f32 = 0; d a
// multiple of 8) or f32 (is_f32 = 1), 1 <= d <= 256.  window <= 0 means no
// window.  Returns the CUDA error code of the launch (0 on success); does
// not synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int hq, int hkv, int s, int d,
                        int causal, int window, float scale, int is_f32,
                        void* stream) {
  // (batch, q head) on gridDim.x; the q tiles (16 rows at the least, the
  // f32 path's) on gridDim.y, whose limit is 65,535; rows indexed in 32
  // bits (the tensor maps' coordinates).
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 ||
      (long long)b * hq * s > 0x7fffffff ||
      (s + kSimtBlockM - 1) / kSimtBlockM > 65535 || tile_dim(d) == 0 ||
      (!is_f32 && d % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.hq = hq;
  p.hkv = hkv;
  p.s = s;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    const dim3 grid(b * hq, (s + kSimtBlockM - 1) / kSimtBlockM);
    constexpr int kTiles = 2 * kSimtBlockN;  // sK and sV
    switch (tile_dim(d)) {
      case 64:
        return launch_simt(flash_fwd_f32_kernel<64>, grid,
                           simt_smem_bytes<64>(kTiles), st, p);
      case 128:
        return launch_simt(flash_fwd_f32_kernel<128>, grid,
                           simt_smem_bytes<128>(kTiles), st, p);
      default:
        return launch_simt(flash_fwd_f32_kernel<256>, grid,
                           simt_smem_bytes<256>(kTiles), st, p);
    }
  }
  switch (tile_dim(d)) {
    case 64: return launch_bf16<64>(p, b, st);
    case 128: return launch_bf16<128>(p, b, st);
    default: return launch_bf16<256>(p, b, st);
  }
}

const char* flash_attention_fwd_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
