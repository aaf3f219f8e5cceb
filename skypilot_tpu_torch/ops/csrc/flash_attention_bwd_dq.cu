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
// tensor-core throughput, not by HBM.  What the design does about that:
// P, dP and dS never leave registers (no [S, S] matrix in HBM), the three
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32, dS
// rounded to bf16 as its A operand), each K/V tile is read from global
// memory once per CTA and shared by its four warps, KV tiles past the
// diagonal (and below a window's band) are skipped, and causal CTAs are
// issued longest first.  wgmma, TMA and warp specialisation are later
// work.
//
// Structure (the TPU's sequential grid is not carried over):
//   * one CTA per (batch*q_head, 64-row q tile), 4 warps of 16 q rows; Q and
//     dO stay in registers as A fragments;
//   * K and V tiles of 64 rows are staged row-major through shared memory;
//     the B fragments of dS K read K down its columns (two 16-bit loads);
//   * the KV loop runs over the forward's range (kv_first ..
//     num_kv_needed), and dS is formed 16 keys at a time, so only one
//     16x16 block of P and dP is live;
//   * the ragged edge (S not a multiple of 64) is masked, rows past S are
//     never stored.
// No atomics: every dQ element is summed by one thread in a fixed order,
// so two calls on the same inputs give bit-identical results.
// float32 inputs take a SIMT path (one warp per q row at a time, lanes
// split head_dim) with the same rules; it exists for parity checks.
#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded rows: conflict-free fragments
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * LD];  // also Q
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * LD];  // also dO

  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bh = blockIdx.x;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int q0 = q_tile * kBlockM;
  const size_t q_off = (size_t)bh * p.s * D, kv_off = (size_t)kvh * p.s * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + q_off;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + q_off;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + q_off;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  // Stage Q through sK and dO through sV; keep both as A fragments.
  stage_rows<D>(sK, qg, q0, kBlockM, p.s);
  stage_rows<D>(sV, dog, q0, kBlockM, p.s);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    ld_a(qf[kc], &sK[warp * 16 * LD + kc * 16], LD, g, t4);
    ld_a(dof[kc], &sV[warp * 16 * LD + kc * 16], LD, g, t4);
  }

  // Rows of c0,c1 / c2,c3, their LSE in log2 units and their delta.
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < p.s;
    lse2[r] = in ? p.lse[(size_t)bh * p.s + qrow[r]] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[(size_t)bh * p.s + qrow[r]] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;

  int kv_first, kv_end;
  kv_tile_range(p.s, p.causal, p.window, q0, min(q0 + kBlockM, p.s) - 1,
                kBlockN, &kv_first, &kv_end);
  for (int kt = kv_first; kt < kv_end; ++kt) {
    const int kv0 = kt * kBlockN;
    __syncthreads();  // previous tile (or the Q/dO staging) fully consumed
    stage_rows<D>(sK, kg, kv0, kBlockN, p.s);
    stage_rows<D>(sV, vg, kv0, kBlockN, p.s);
    __syncthreads();
    const bool need_mask = kv0 + kBlockN > p.s ||
                           (p.causal && kv0 + kBlockN - 1 > q0) ||
                           (p.window > 0 &&
                            q0 + kBlockM - 1 - kv0 >= p.window);

    // 16 keys at a time: S and dP (two 16x8 n tiles each), then dS, then
    // dQ += dS K.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kc + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
        for (int dk = 0; dk < D / 16; ++dk) {
          const __nv_bfloat16* kp = &sK[(j * 8 + g) * LD + dk * 16 + t4 * 2];
          const uint32_t bk[2] = {ld32(kp), ld32(kp + 8)};
          mma_16816(sc[jj], qf[dk], bk);
          const __nv_bfloat16* vp = &sV[(j * 8 + g) * LD + dk * 16 + t4 * 2];
          const uint32_t bv[2] = {ld32(vp), ld32(vp + 8)};
          mma_16816(dp[jj], dof[dk], bv);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pv = exp2f(sc[jj][e] * scale_log2 - lse2[r]);
          if (need_mask && !visible(p.s, p.causal, p.window, qrow[r],
                                    kv0 + j * 8 + t4 * 2 + (e & 1)))
            pv = 0.f;
          sc[jj][e] = pv * (dp[jj][e] - dlt[r]) * p.scale;  // dS
        }
      }
      uint32_t a[4];
      c_to_a(a, sc[0], sc[1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* kp = &sK[(kc * 16 + t4 * 2) * LD + dn * 8 + g];
        const uint32_t b[2] = {ld_col2(kp, LD), ld_col2(kp + 8 * LD, LD)};
        mma_16816(dq[dn], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.s) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)qrow[r] * D + dn * 8 +
                                   t4 * 2) =
          pack_bf16(dq[dn][2 * r], dq[dn][2 * r + 1]);
  }
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // head_dim elements per lane: d = lane + 32*i
  __shared__ float sK[kSimtBlockN * D];
  __shared__ float sV[kSimtBlockN * D];

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
  const dim3 block(kThreads);
  if (is_f32) {
    const dim3 grid(b * hq, (s + kSimtBlockM - 1) / kSimtBlockM);
    if (d == 64)
      flash_bwd_dq_f32_kernel<64><<<grid, block, 0, st>>>(p);
    else if (d == 128)
      flash_bwd_dq_f32_kernel<128><<<grid, block, 0, st>>>(p);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const dim3 grid(b * hq, (s + kBlockM - 1) / kBlockM);
    if (d == 64)
      flash_bwd_dq_bf16_kernel<64><<<grid, block, 0, st>>>(p);
    else if (d == 128)
      flash_bwd_dq_bf16_kernel<128><<<grid, block, 0, st>>>(p);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* flash_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
