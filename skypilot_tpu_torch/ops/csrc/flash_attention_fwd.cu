// Flash-attention forward for Hopper (sm_90a): causal, non-causal and
// banded-causal (sliding-window) GQA attention with an online softmax in
// f32.  Writes O in the input dtype and the per-row log-sum-exp
// LSE = m + log(l) in f32, shaped [B, Hq, S].
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd` in
// skypilot_tpu/ops/flash_attention.py (pl.pallas_call at line 160).
//
// What bounds it on an H100: at the shapes the Llama forward gives it
// (head_dim 128, S >= 1k) attention does ~2*S*D FLOPs per q row against
// ~4*D bytes of Q/O per row, so it is bound by tensor-core throughput,
// not by HBM (989 TFLOP/s bf16 vs 3.35 TB/s).  What the design does about
// that: scores and P never leave registers (no [S, S] matrix in HBM), the
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32), K/V
// tiles are read from global memory once per CTA and reused by all four
// warps through shared memory, KV tiles past the diagonal (and, with a
// window, below the band) are skipped, and causal CTAs are issued longest
// first so the tail of the grid is short.  wgmma, TMA and warp
// specialisation are later work.
//
// Structure (the TPU's sequential grid is not carried over):
//   * one CTA per (batch*q_head, 64-row q tile), 4 warps of 16 q rows;
//   * K/V tiles of 64 rows are staged through shared memory (V
//     transposed, so the B fragments of P*V are 32-bit loads) and a KV
//     loop runs inside the CTA;
//   * q head h of batch b reads kv head b*Hkv + h/(Hq/Hkv): no K/V copies;
//   * the ragged edge (S not a multiple of 64) is masked, rows past S are
//     never stored.
// float32 inputs take a SIMT path (one warp per q row at a time, lanes
// split head_dim) with the same tiling rules; it exists for parity
// checks, not speed.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int hq, hkv, s, causal, window;  // window <= 0: no window
  float scale_log2;                // softmax scale * log2(e)
};

// ---------------------------------------------------------------- bf16

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int LDK = D + 8;        // padded rows: conflict-free fragments
  constexpr int LDV = kBlockN + 8;
  constexpr int CH = D / 8;         // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * LDK];  // also Q
  __shared__ __align__(16) __nv_bfloat16 sVt[D * LDV];       // V^T

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int bh = blockIdx.y;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kBlockM;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.s * D;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + (size_t)kvh * p.s * D;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + (size_t)kvh * p.s * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.s * D;
  float* lseg = p.lse + (size_t)bh * p.s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Stage the Q tile through sK, then keep it in registers as A fragments.
  stage_rows<D>(sK, qg, q0, kBlockM, p.s);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ld_a(qf[kc], &sK[warp * 16 * LDK + kc * 16], LDK, g, t4);

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};  // rows of c0,c1 / c2,c3
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial sums (same m per row)

  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0, min(q0 + kBlockM, p.s) - 1,
                kBlockN, &kv_first, &kv_end);
  for (int kt = kv_first; kt < kv_end; ++kt) {
    const int kv0 = kt * kBlockN;
    __syncthreads();  // previous tile (or the Q staging) fully consumed
    stage_rows<D>(sK, kg, kv0, kBlockN, p.s);
    for (int c = tid; c < kBlockN * CH; c += kThreads) {
      const int r = c % kBlockN, col = (c / kBlockN) * 8;
      uint4 val = kv0 + r < p.s ? *reinterpret_cast<const uint4*>(
                                      vg + (size_t)(kv0 + r) * D + col)
                                : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * LDV + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* bp = &sK[(j * 8 + g) * LDK + kc * 16 + t4 * 2];
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_16816(sc[j], qf[kc], b);
      }
    }

    // Scale into log2 units, mask, online softmax.
    const bool need_mask = kv0 + kBlockN > p.s ||
                           (p.causal && kv0 + kBlockN - 1 > q0) ||
                           (p.window > 0 &&
                            q0 + kBlockM - 1 - kv0 >= p.window);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * p.scale_log2;
        if (need_mask && !visible(p.s, p.causal, p.window, qrow[e >> 1],
                                     kv0 + j * 8 + t4 * 2 + (e & 1)))
          x = -INFINITY;
        sc[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float mb[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mn = fmaxf(m[r], tmax[r]);
      mb[r] = mn == -INFINITY ? 0.f : mn;  // fully masked so far
      corr[r] = exp2f(m[r] - mb[r]);
      m[r] = mn;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(sc[j][e] - mb[e >> 1]);
        sc[j][e] = pv;
        lsum[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];

    // O += P V, P re-packed from the S accumulators as bf16 A fragments.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, sc[2 * kc], sc[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* bp = &sVt[(dn * 8 + g) * LDV + kc * 16 + t4 * 2];
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_16816(o[dn], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= p.s) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(og + (size_t)qrow[r] * D + dn * 8 +
                                   t4 * 2) =
          pack_bf16(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    if (t4 == 0)
      lseg[qrow[r]] = m[r] == -INFINITY ? -INFINITY
                                        : (m[r] + log2f(l[r])) * kLn2;
  }
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // head_dim elements per lane: d = lane + 32*i
  __shared__ float sK[kSimtBlockN][D];
  __shared__ float sV[kSimtBlockN][D];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kSimtBlockM;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * p.s * D;
  const float* kg = static_cast<const float*>(p.k) + (size_t)kvh * p.s * D;
  const float* vg = static_cast<const float*>(p.v) + (size_t)kvh * p.s * D;
  float* og = static_cast<float*>(p.o) + (size_t)bh * p.s * D;
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
      q[r][i] = row0 + r < p.s
                    ? qg[(size_t)(row0 + r) * D + lane + 32 * i] * p.scale_log2
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
    for (int c = tid; c < kSimtBlockN * D; c += kThreads) {
      const int r = c / D, col = c % D;
      const bool in = kv0 + r < p.s;
      sK[r][col] = in ? kg[(size_t)(kv0 + r) * D + col] : 0.f;
      sV[r][col] = in ? vg[(size_t)(kv0 + r) * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mine = -INFINITY;  // lane j ends up holding key kv0 + j
      for (int j = 0; j < kSimtBlockN; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += q[r][i] * sK[j][lane + 32 * i];
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
        for (int i = 0; i < E; ++i) acc[r][i] += pb * sV[j][lane + 32 * i];
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
      og[(size_t)row * D + lane + 32 * i] = acc[r][i] * inv;
    if (lane == 0)
      lseg[row] = m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  q: [B, Hq, S, D]; k, v: [B, Hkv, S, D];
// o like q; lse: [B, Hq, S] f32.  All contiguous, bf16 (is_f32 = 0) or
// f32 (is_f32 = 1).  window <= 0 means no window.  Returns the CUDA error
// code of the launch (0 on success); does not synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int hq, int hkv, int s, int d,
                        int causal, int window, float scale, int is_f32,
                        void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 ||
      b * hq > 65535)
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
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  if (is_f32) {
    const dim3 grid((s + kSimtBlockM - 1) / kSimtBlockM, b * hq);
    if (d == 64)
      flash_fwd_f32_kernel<64><<<grid, block, 0, st>>>(p);
    else if (d == 128)
      flash_fwd_f32_kernel<128><<<grid, block, 0, st>>>(p);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const dim3 grid((s + kBlockM - 1) / kBlockM, b * hq);
    if (d == 64)
      flash_fwd_bf16_kernel<64><<<grid, block, 0, st>>>(p);
    else if (d == 128)
      flash_fwd_bf16_kernel<128><<<grid, block, 0, st>>>(p);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
