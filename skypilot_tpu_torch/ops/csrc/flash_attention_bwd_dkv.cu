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
// it is bound by tensor-core throughput, not by HBM.  What the design does
// about that: P and dS never leave registers, the four products run on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32, P and dS rounded to bf16 as
// A operands), each Q/dO tile is read from global memory once per CTA and
// shared by its four warps, q tiles that see none of the KV tile (causal,
// window) are skipped, and causal CTAs are issued longest first.  wgmma,
// TMA and warp specialisation are later work.
//
// Structure (the TPU keeps dK/dV resident across an "arbitrary" q grid
// axis; nothing carries between CTAs here):
//   * one CTA per (batch*kv_head, 64-row KV tile), 4 warps of 16 KV rows,
//     dK and dV accumulated in registers;
//   * the CTA loops over the Hq/Hkv q heads of its kv head and, for each,
//     over the q tiles that overlap the KV tile (the overlap test of the
//     TPU kernel turned into a loop range) -- the GQA fold happens in the
//     accumulators, so no f32 [B, Hq, S, D] partials exist;
//   * K, V and each q tile's Q and dO are staged row-major in shared memory
//     (dynamic, 70 KB at head_dim 128); the B fragments of P^T dO and
//     dS^T Q read dO and Q down their columns (two 16-bit loads);
//   * the ragged edge (S not a multiple of 64) is masked on both sides,
//     KV rows past S are never stored.
// No atomics: every dK/dV element is summed by one thread in a fixed
// order, so two calls on the same inputs give bit-identical results.
// float32 inputs take a SIMT path (one warp per KV row at a time, lanes
// split head_dim) with the same rules; it exists for parity checks.
#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <int D>
constexpr int bf16_smem_bytes() {
  return (2 * kBlockN + 2 * kBlockM) * (D + 8) * 2 + 2 * kBlockM * 4;
}

// ---------------------------------------------------------------- bf16

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded rows: conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBlockN * LD;
  __nv_bfloat16* sQ = sV + kBlockN * LD;
  __nv_bfloat16* sdO = sQ + kBlockM * LD;
  float* sLse = reinterpret_cast<float*>(sdO + kBlockM * LD);  // log2 units
  float* sDelta = sLse + kBlockM;

  const int kv_tile = blockIdx.y;  // causal: the first tiles see most q
  const int bkv = blockIdx.x;
  const int b = bkv / p.hkv, group = p.hq / p.hkv;
  const int kv0 = kv_tile * kBlockN;
  const size_t kv_off = (size_t)bkv * p.s * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // KV rows of c0,c1 / c2,c3.
  const int kvrow[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;

  stage_rows<D>(sK, kg, kv0, kBlockN, p.s);
  stage_rows<D>(sV, vg, kv0, kBlockN, p.s);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  int qt_first, qt_end;
  q_tile_range(p.s, p.causal, p.window, kv0, min(kv0 + kBlockN, p.s) - 1,
               kBlockM, &qt_first, &qt_end);
  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * p.hq + (bkv % p.hkv) * group + gi;
    const size_t q_off = (size_t)bh * p.s * D;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + q_off;
    const __nv_bfloat16* dog =
        static_cast<const __nv_bfloat16*>(p.dout) + q_off;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // previous q tile fully consumed
      stage_rows<D>(sQ, qg, q0, kBlockM, p.s);
      stage_rows<D>(sdO, dog, q0, kBlockM, p.s);
      for (int r = threadIdx.x; r < kBlockM; r += kThreads) {
        const bool in = q0 + r < p.s;
        sLse[r] = in ? p.lse[(size_t)bh * p.s + q0 + r] * kLog2e : 0.f;
        sDelta[r] = in ? p.delta[(size_t)bh * p.s + q0 + r] : 0.f;
      }
      __syncthreads();
      const bool need_mask = q0 + kBlockM > p.s || kv0 + kBlockN > p.s ||
                             (p.causal && kv0 + kBlockN - 1 > q0) ||
                             (p.window > 0 &&
                              q0 + kBlockM - 1 - kv0 >= p.window);

      // 16 queries at a time: S^T and dP^T (two 16x8 n tiles each), then
      // P^T and dS^T, then dV += P^T dO and dK += dS^T Q.
#pragma unroll
      for (int qc = 0; qc < kBlockM / 16; ++qc) {
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * qc + jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) st[jj][e] = dpt[jj][e] = 0.f;
#pragma unroll
          for (int dk16 = 0; dk16 < D / 16; ++dk16) {
            uint32_t a[4];
            ld_a(a, &sK[warp * 16 * LD + dk16 * 16], LD, g, t4);
            const __nv_bfloat16* qp =
                &sQ[(j * 8 + g) * LD + dk16 * 16 + t4 * 2];
            const uint32_t bq[2] = {ld32(qp), ld32(qp + 8)};
            mma_16816(st[jj], a, bq);
            ld_a(a, &sV[warp * 16 * LD + dk16 * 16], LD, g, t4);
            const __nv_bfloat16* op =
                &sdO[(j * 8 + g) * LD + dk16 * 16 + t4 * 2];
            const uint32_t bo[2] = {ld32(op), ld32(op + 8)};
            mma_16816(dpt[jj], a, bo);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = j * 8 + t4 * 2 + (e & 1);  // q row in the tile
            float pv = exp2f(st[jj][e] * scale_log2 - sLse[qi]);
            if (need_mask && (q0 + qi >= p.s ||
                              !visible(p.s, p.causal, p.window, q0 + qi,
                                       kvrow[e >> 1])))
              pv = 0.f;
            st[jj][e] = pv;                                         // P^T
            dpt[jj][e] = pv * (dpt[jj][e] - sDelta[qi]) * p.scale;  // dS^T
          }
        }
        uint32_t pa[4], dsa[4];
        c_to_a(pa, st[0], st[1]);
        c_to_a(dsa, dpt[0], dpt[1]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int at = (qc * 16 + t4 * 2) * LD + dn * 8 + g;
          const uint32_t bo[2] = {ld_col2(&sdO[at], LD),
                                  ld_col2(&sdO[at + 8 * LD], LD)};
          mma_16816(dv[dn], pa, bo);
          const uint32_t bq[2] = {ld_col2(&sQ[at], LD),
                                  ld_col2(&sQ[at + 8 * LD], LD)};
          mma_16816(dk[dn], dsa, bq);
        }
      }
    }
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + kv_off;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + kv_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kvrow[r] >= p.s) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const size_t at = (size_t)kvrow[r] * D + dn * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(dkg + at) =
          pack_bf16(dk[dn][2 * r], dk[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvg + at) =
          pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int E = D / 32;  // head_dim elements per lane: d = lane + 32*i
  __shared__ float sQ[kSimtBlockQ * D];
  __shared__ float sdO[kSimtBlockQ * D];
  __shared__ float sLse[kSimtBlockQ];
  __shared__ float sDelta[kSimtBlockQ];

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

template <int D>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int bytes = bf16_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
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
    if (d == 64)
      flash_bwd_dkv_f32_kernel<64><<<grid, kThreads, 0, st>>>(p);
    else if (d == 128)
      flash_bwd_dkv_f32_kernel<128><<<grid, kThreads, 0, st>>>(p);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const dim3 grid(b * hkv, (s + kBlockN - 1) / kBlockN);
  if (d == 64) return (int)launch_bf16<64>(p, grid, st);
  if (d == 128) return (int)launch_bf16<128>(p, grid, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
