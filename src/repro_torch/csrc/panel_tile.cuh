// The panel GEMM's CTA schedule for Hopper (sm_90a), shared by the fp32
// kernels (panel_gemm.cu) and the dequant-fused kernels (quant_gemm.cu).
//
// The schedule is one template, parameterised on how a weight element is
// read: a weight type W provides `float operator()(int k, int col)`, the
// fp32 value of packed weight element (k, col).  panel_gemm.cu reads an fp32
// pack; quant_gemm.cu dequantizes int8 or 2-bit ternary codes against their
// per-(column, 128-row group) scales as the element is staged.  Everything
// else (tiles, K order, epilogue, stores) is the same code, so the two
// kernels sum the same products in the same order.
//
// What bounds it on this card.
//   Hopper's tensor cores have no fp32 x fp32 mode (TF32 is a different
//   format), so this lane runs on the FMA units: 67 TFLOP/s fp32 on an H100
//   SXM against 3.35 TB/s of HBM.  At prefill (M = 128) every weight element
//   is used 128 times and the kernel is bound by FMA issue; at decode
//   (M <= 8) it is bound by streaming the weight from HBM once.
//
// What the design does about it.
//   A CTA owns a BM x BN output tile and walks the whole K range (or its
//   split-K slice) through shared memory in BK-deep steps; each thread keeps
//   a TM x TN register micro-tile and issues fmaf from registers.  Prefill
//   uses 64 x 64 tiles with 4 x 4 micro-tiles (256 threads); M <= 16 uses
//   16-row tiles with a 64-deep K step, so fewer rows of zeros are
//   multiplied and more weight bytes are in flight per barrier.  There is no
//   cp.async pipelining, no persistent CTA and no larger register tile yet:
//   this is the simple correct kernel, and its measured times sit beside
//   their bounds in PERF.md.
//
// Numerics.  Each output element is one fp32 accumulator summed with fmaf
// over k = 0, 1, ..., K-1 in ascending order (per slice for split-K).  That
// order depends on K (and the slice map) only: not on M, on the row, on the
// tile shape, on the grid or on the weight type, so results are
// deterministic from run to run, a row's result does not depend on the
// other rows of the batch (the property serve == generate rests on), and a
// quantized pack gives bit for bit what the fp32 kernel gives on its
// dequantized weight.  bf16 activations are widened to fp32 exactly when
// staged; a bf16 output is rounded to nearest even once.  expf/tanhf are
// the accurate library functions (no fast-math intrinsics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace panel {

enum Act : int { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_TANH = 3 };

struct Epilogue {
  const float* bias;      // [N] (the full fused width for glu) or null
  const float* residual;  // [M, n_out] fp32 or null
  int act;                // Act applied to the accumulator (non-glu)
  int glu;                // Act of the gate half; ACT_NONE = no glu
  int softcap;            // apply cap * tanh(v * rcp)
  float cap;
  float rcp;              // fp32(1.0 / cap), rounded once on the host
};

__device__ __forceinline__ float act_apply(int act, float v) {
  switch (act) {
    case ACT_SILU:
      return v / (1.0f + expf(-v));
    case ACT_GELU:  // tanh form, matching repro.kernels.panel_gemm._gelu_tanh
      return 0.5f * v *
             (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
    case ACT_TANH:
      return tanhf(v);
    default:
      return v;
  }
}

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One CTA: a BM x BN tile of output rows [row0, row0 + BM) and columns
// [col0, col0 + BN), accumulated over k in [k_begin, k_begin + k_len).
// GLU carries a second accumulator over the up half (columns + up_off).
// PARTIAL stores the raw fp32 accumulator of slice blockIdx.z into
// out[z][M][n_out]; otherwise the epilogue runs and out is [M][n_out].
template <typename TX, typename W, int BM, int BN, int BK, int TM, int TN,
          bool GLU, bool PARTIAL>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    panel_gemm_kernel(const TX* __restrict__ x, W w, int M, int K,
                      int n_out, int k_len, Epilogue ep,
                      void* __restrict__ out, int out_bf16) {
  constexpr int NTX = BN / TN;
  constexpr int NT = NTX * (BM / TM);
  static_assert(TN == 4, "the micro-tile reads B as float4");
  __shared__ float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ __align__(16) float Bu[GLU ? BK : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_len;
  const int up_off = n_out;  // glu: the up half starts n_out columns on

  float acc[TM][TN];
  float accu[TM][TN];  // the up half's accumulator (glu only)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  if constexpr (GLU) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accu[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_begin + k_len; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r;
      As[c][r] = gr < M ? load_x(x + (size_t)gr * K + k0 + c) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      Bs[r][c] = w(k0 + r, col0 + c);
      if constexpr (GLU) Bu[r][c] = w(k0 + r, col0 + c + up_off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      if constexpr (GLU) {
        const float4 u = *reinterpret_cast<const float4*>(&Bu[kk][tx * TN]);
        const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            accu[i][j] = fmaf(a[i], uv[j], accu[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if constexpr (PARTIAL) {
        float* o = static_cast<float*>(out);
        o[((size_t)blockIdx.z * M + r) * n_out + c] = acc[i][j];
        continue;
      }
      float v;
      if constexpr (GLU) {
        float g = acc[i][j];
        float u = accu[i][j];
        if (ep.bias) {
          g = g + ep.bias[c];
          u = u + ep.bias[c + up_off];
        }
        v = act_apply(ep.glu, g) * u;
      } else {
        v = acc[i][j];
        if (ep.bias) v = v + ep.bias[c];
        v = act_apply(ep.act, v);
      }
      if (ep.softcap) v = ep.cap * tanhf(v * ep.rcp);
      if (ep.residual) v = v + ep.residual[(size_t)r * n_out + c];
      const size_t o = (size_t)r * n_out + c;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

// Tile configurations: prefill (M > 16) and skinny (M <= 16).
struct Prefill { static constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4; };
struct Skinny  { static constexpr int BM = 16, BN = 64, BK = 64, TM = 1, TN = 4; };

template <typename Cfg, typename TX, typename W, bool GLU, bool PARTIAL>
cudaError_t launch(const void* x, const W& w, int M, int K, int n_out,
                   int split_k, const Epilogue& ep, void* out, int out_bf16,
                   cudaStream_t stream) {
  constexpr int NT = (Cfg::BM / Cfg::TM) * (Cfg::BN / Cfg::TN);
  dim3 grid(n_out / Cfg::BN, (M + Cfg::BM - 1) / Cfg::BM, split_k);
  panel_gemm_kernel<TX, W, Cfg::BM, Cfg::BN, Cfg::BK, Cfg::TM, Cfg::TN, GLU,
                    PARTIAL><<<grid, NT, 0, stream>>>(
      static_cast<const TX*>(x), w, M, K, n_out, K / split_k, ep, out,
      out_bf16);
  return cudaGetLastError();
}

template <typename Cfg, typename W, bool GLU, bool PARTIAL>
cudaError_t dispatch_x(const void* x, int x_bf16, const W& w, int M, int K,
                       int n_out, int split_k, const Epilogue& ep, void* out,
                       int out_bf16, cudaStream_t stream) {
  if (x_bf16)
    return launch<Cfg, __nv_bfloat16, W, GLU, PARTIAL>(
        x, w, M, K, n_out, split_k, ep, out, out_bf16, stream);
  return launch<Cfg, float, W, GLU, PARTIAL>(x, w, M, K, n_out, split_k, ep,
                                             out, out_bf16, stream);
}

// The launch for one weight type: the skinny tile at M <= 16, else the
// prefill tile.  split_k > 1 with PARTIAL stores per-slice partials.
template <typename W, bool GLU, bool PARTIAL>
cudaError_t dispatch(const void* x, int x_bf16, const W& w, int M, int K,
                     int n_out, int split_k, const Epilogue& ep, void* out,
                     int out_bf16, cudaStream_t stream) {
  if (M <= Skinny::BM)
    return dispatch_x<Skinny, W, GLU, PARTIAL>(x, x_bf16, w, M, K, n_out,
                                               split_k, ep, out, out_bf16,
                                               stream);
  return dispatch_x<Prefill, W, GLU, PARTIAL>(x, x_bf16, w, M, K, n_out,
                                              split_k, ep, out, out_bf16,
                                              stream);
}

// The store step's launch: glu or not, the epilogue applied, one store.
template <typename W>
cudaError_t dispatch_store(const void* x, int x_bf16, const W& w, int M,
                           int K, int n_out, const Epilogue& ep, void* out,
                           int out_bf16, cudaStream_t stream) {
  if (ep.glu)
    return dispatch<W, true, false>(x, x_bf16, w, M, K, n_out, 1, ep, out,
                                    out_bf16, stream);
  return dispatch<W, false, false>(x, x_bf16, w, M, K, n_out, 1, ep, out,
                                   out_bf16, stream);
}

// The split-K partials pass: out is fp32 [split_k, M, N].
template <typename W>
cudaError_t dispatch_partials(const void* x, int x_bf16, const W& w, int M,
                              int K, int N, int split_k, float* partials,
                              cudaStream_t stream) {
  const Epilogue none{nullptr, nullptr, ACT_NONE, ACT_NONE, 0, 0.0f, 0.0f};
  return dispatch<W, false, true>(x, x_bf16, w, M, K, N, split_k, none,
                                  partials, 0, stream);
}

// Shape contract shared by every entry point (the Python wrappers check the
// same before they call): K and every column count are multiples of the
// kernel's BK and BN, which the pack's 128-multiple padding guarantees.
inline bool shapes_ok(int M, int K, int n_out, int split_k) {
  if (M < 1 || split_k < 1 || K % split_k || n_out % Prefill::BN) return false;
  const int k_len = K / split_k;
  return k_len % Prefill::BK == 0 && k_len % Skinny::BK == 0;
}

}  // namespace panel
