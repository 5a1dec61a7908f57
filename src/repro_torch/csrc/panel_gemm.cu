// Panel GEMM for Hopper (sm_90a): the prefill kernel and the split-K decode
// kernel of the fp32 lane, with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/cuda_lib.py builds this file with nvcc).
//
// What it replaces.
//   repro_panel_gemm        <- src/repro/kernels/panel_gemm.py::panel_gemm
//                              (bodies _gemm_kernel, _gemm_glu_kernel)
//   repro_panel_gemm_splitk <- src/repro/kernels/panel_gemm.py::panel_gemm_splitk
//                              (body _splitk_kernel)
//   C = epilogue(x @ w): x is [M, K] fp32 or bf16, w is the packed weight
//   [K, N] fp32 (K and N padded to multiples of 128 at load), the epilogue
//   runs on the fp32 accumulator in the reference's order
//   bias -> silu/gelu/tanh (or the glu combine act(g) * u) -> tanh softcap ->
//   residual, then one cast and one store.  The split-K kernel writes each
//   K slice's fp32 partial uncast to [split_k, M, N]; the fixed pairwise
//   combine tree and the epilogue run after it, outside, as in the reference.
//
// The CTA schedule, what bounds it on this card, what its design does about
// that, and its numerics are in panel_tile.cuh, which quant_gemm.cu shares.
#include "panel_tile.cuh"

namespace fp32_lane {

// The fp32 pack: element (k, col) of the row-major [K, ldw] weight.
struct F32Weight {
  const float* w;
  int ldw;
  __device__ __forceinline__ float operator()(int k, int col) const {
    return w[(size_t)k * ldw + col];
  }
};

}  // namespace fp32_lane

using fp32_lane::F32Weight;

extern "C" {

// out[M, n_out] = epilogue(x[M, K] @ w[K, ldw]).  Without glu n_out == ldw;
// with glu (glu_act != 0) ldw == 2 * n_out and the up half starts at column
// n_out.  Returns the cudaError_t of the launch (0 = launched).
int repro_panel_gemm(const void* x, int x_bf16, const float* w,
                     const float* bias, const float* residual, void* out,
                     int out_bf16, int M, int K, int ldw, int n_out, int act,
                     int glu_act, int softcap, float cap, float rcp,
                     void* stream) {
  if (!panel::shapes_ok(M, K, n_out, 1) ||
      ldw != (glu_act ? 2 * n_out : n_out))
    return (int)cudaErrorInvalidValue;
  const panel::Epilogue ep{bias, residual, act, glu_act, softcap, cap, rcp};
  return (int)panel::dispatch_store(x, x_bf16, F32Weight{w, ldw}, M, K,
                                    n_out, ep, out, out_bf16,
                                    static_cast<cudaStream_t>(stream));
}

// partials[split_k, M, N] = per-slice x[:, slice] @ w[slice, :], fp32.
int repro_panel_gemm_splitk(const void* x, int x_bf16, const float* w,
                            float* partials, int M, int K, int N, int split_k,
                            void* stream) {
  if (!panel::shapes_ok(M, K, N, split_k)) return (int)cudaErrorInvalidValue;
  return (int)panel::dispatch_partials(x, x_bf16, F32Weight{w, N}, M, K, N,
                                       split_k, partials,
                                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
