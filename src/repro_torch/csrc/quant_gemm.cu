// Dequant-fused panel GEMM for Hopper (sm_90a): the quantized formats'
// prefill kernel and split-K decode kernel, with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/cuda_lib.py builds this file with
// nvcc).
//
// What it replaces.
//   repro_quant_panel_gemm        <- src/repro/quant/kernels.py::quant_panel_gemm
//                                    (bodies _quant_gemm_kernel, _quant_glu_kernel)
//   repro_quant_panel_gemm_splitk <- src/repro/quant/kernels.py::quant_panel_gemm_splitk
//                                    (body _quant_splitk_kernel)
//   C = epilogue(x @ dequant(codes, scales)).  The weight arrives as int8
//   codes [K, N], or as ternary bytes [K/4, N] holding four 2-bit codes
//   (code + 1) along K, row 4r + i in bits [2i, 2i + 2); beside them one
//   fp32 scale per (column, 128-row K group), [K/128, N].  Padding codes
//   carry scale 0 and dequantize to exact zeros.
//
// What bounds it on this card.
//   The products still run on the FMA units in fp32 (67 TFLOP/s on an H100
//   SXM): at prefill (M = 128) the kernel is bound by operations exactly as
//   the fp32 kernel is.  At decode the weight stream shrinks 4x (int8) or
//   16x (ternary), so its byte bound falls by as much and the bound moves
//   toward operations.
//
// What the design does about it.
//   It runs panel_tile.cuh's CTA schedule unchanged and dequantizes each
//   weight element as it is staged into shared memory: float(code) * scale,
//   one IEEE multiply rounded once (__fmul_rn keeps the compiler from fusing
//   it into the FMA that consumes it), exactly the value
//   formats.dequantize_padded computes.  Each CTA reads only the code bytes
//   of its tile, so the HBM stream is the codes', and the fp32 weight never
//   exists in device memory.  Because the dequantized values are the same
//   and the K order is the fp32 kernel's, a launch here is bit for bit the
//   fp32 kernel's launch on the dequantized pack (the port's quant_gate).
//   Ternary bytes are read once per K row from L1, not unpacked in
//   registers four rows at a time: simple first, faster later.
#include "panel_tile.cuh"

namespace quant_lane {

constexpr int kGroupK = 128;  // K rows per scale group (formats.GROUP_K)

// Int8 codes [K, ldw] and scales [K / kGroupK, ldw].
struct Int8Weight {
  const int8_t* codes;
  const float* scales;
  int ldw;
  __device__ __forceinline__ float operator()(int k, int col) const {
    const float c = (float)codes[(size_t)k * ldw + col];
    return __fmul_rn(c, scales[(size_t)(k / kGroupK) * ldw + col]);
  }
};

// Ternary bytes [K / 4, ldw] (code + 1 in two bits per K row) and scales
// [K / kGroupK, ldw].
struct TernaryWeight {
  const uint8_t* codes;
  const float* scales;
  int ldw;
  __device__ __forceinline__ float operator()(int k, int col) const {
    const unsigned b = codes[(size_t)(k >> 2) * ldw + col];
    const float c = (float)((b >> (2 * (k & 3))) & 3u) - 1.0f;
    return __fmul_rn(c, scales[(size_t)(k / kGroupK) * ldw + col]);
  }
};

bool quant_shapes_ok(int M, int K, int n_out, int split_k) {
  return panel::shapes_ok(M, K, n_out, split_k) && K % kGroupK == 0;
}

}  // namespace quant_lane

using quant_lane::Int8Weight;
using quant_lane::TernaryWeight;
using quant_lane::quant_shapes_ok;

extern "C" {

// out[M, n_out] = epilogue(x[M, K] @ dequant(codes, scales)[K, ldw]).
// ternary != 0 selects the 2-bit format.  Without glu n_out == ldw; with
// glu (glu_act != 0) ldw == 2 * n_out and the up half starts at column
// n_out.  Returns the cudaError_t of the launch (0 = launched).
int repro_quant_panel_gemm(const void* x, int x_bf16, const void* codes,
                           const float* scales, int ternary,
                           const float* bias, const float* residual,
                           void* out, int out_bf16, int M, int K, int ldw,
                           int n_out, int act, int glu_act, int softcap,
                           float cap, float rcp, void* stream) {
  if (!quant_shapes_ok(M, K, n_out, 1) ||
      ldw != (glu_act ? 2 * n_out : n_out))
    return (int)cudaErrorInvalidValue;
  const panel::Epilogue ep{bias, residual, act, glu_act, softcap, cap, rcp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ternary) {
    const TernaryWeight w{static_cast<const uint8_t*>(codes), scales, ldw};
    return (int)panel::dispatch_store(x, x_bf16, w, M, K, n_out, ep, out,
                                      out_bf16, s);
  }
  const Int8Weight w{static_cast<const int8_t*>(codes), scales, ldw};
  return (int)panel::dispatch_store(x, x_bf16, w, M, K, n_out, ep, out,
                                    out_bf16, s);
}

// partials[split_k, M, N] = per-slice x[:, slice] @ dequant(codes,
// scales)[slice, :], fp32.
int repro_quant_panel_gemm_splitk(const void* x, int x_bf16,
                                  const void* codes, const float* scales,
                                  int ternary, float* partials, int M, int K,
                                  int N, int split_k, void* stream) {
  if (!quant_shapes_ok(M, K, N, split_k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ternary) {
    const TernaryWeight w{static_cast<const uint8_t*>(codes), scales, N};
    return (int)panel::dispatch_partials(x, x_bf16, w, M, K, N, split_k,
                                         partials, s);
  }
  const Int8Weight w{static_cast<const int8_t*>(codes), scales, N};
  return (int)panel::dispatch_partials(x, x_bf16, w, M, K, N, split_k,
                                       partials, s);
}

}  // extern "C"
