// MLP-block forward for Hopper (sm_90a):
//
//   out = x + GELU(LN(x) @ W1 + b1) @ W2 + b2
//
// Replaces the TPU kernel sky_embeddings_tpu/ops/kernels/mlp_block.py:
// _pallas_fwd (_fwd_kernel / _fwd_kernel_pipe), the primal of
// fused_mlp_block.
//
// Three launches behind one C entry point:
//   0. LayerNorm                         -> y (M, D) bf16, staged in `out`
//   1. fc1 GEMM + b1 + exact erf GELU    -> h (M, F) bf16
//   2. fc2 GEMM + b2 + fp32 residual     -> out (M, D) bf16
// y and h go through device memory in bf16, the points where the TPU kernel
// rounds them (mlp_block.py:235, :240). The TPU kernel approximates erf
// (Abramowitz-Stegun 7.1.26, error <= 1.5e-7); this one uses erff.
//
// Bound on the H100: both GEMMs are compute-bound at the serving shapes
// (F = 3072). The h round trip costs 2 * M * F * 2 bytes; keeping h on chip
// and moving the GEMMs to wgmma are the first speed changes.
#include "gemm.cuh"

extern "C" int sky_mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* h, void* out, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS_GELU>(gemm_args(out, w1, b1, nullptr, h, M, F, D), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS_RESIDUAL>(gemm_args(h, w2, b2, x, out, M, D, F), s);
  return static_cast<int>(err);
}
