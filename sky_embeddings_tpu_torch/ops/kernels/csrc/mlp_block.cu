// MLP-block forward for Hopper (sm_90a):
//
//   out = x + GELU(LN(x) @ W1 + b1) @ W2 + b2
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/mlp_block.py:
// _pallas_fwd (_fwd_kernel / _fwd_kernel_pipe), the primal of
// fused_mlp_block (entry sky_mlp_block_fwd); and _pallas_fwd_stash
// (_fwd_stash_kernel, mlp_block.py:357-375), the training forward of
// stash_mlp (entry sky_mlp_block_fwd_stash), which also hands back the fc1
// pre-activation a (M, F) rounded to bf16 for the stash backward
// (mlp_block_bwd.cu, sky_mlp_block_bwd_stash). The two differ only in the
// fc1 epilogue, which in the stash entry also stores bf16(a); GELU still
// reads the fp32 a, so `out` is K1's bit for bit.
//
// Three launches behind each C entry point:
//   0. LayerNorm                         -> y (M, D) bf16, staged in `out`
//   1. fc1 GEMM + b1 + exact erf GELU    -> h (M, F) bf16 (+ a (M, F) bf16)
//   2. fc2 GEMM + b2 + fp32 residual     -> out (M, D) bf16
// y and h go through device memory in bf16, the points where the TPU kernel
// rounds them (mlp_block.py:235, :240). The TPU kernel approximates erf
// (Abramowitz-Stegun 7.1.26, error <= 1.5e-7); this one uses erff.
//
// Bound on the H100: both GEMMs are compute-bound at the serving shapes
// (F = 3072). The h round trip costs 2 * M * F * 2 bytes and the stash
// another M * F * 2; keeping h on chip and moving the GEMMs to wgmma are
// the first speed changes.
#include "gemm.cuh"

// Returns 0, or the first CUDA error a launch reported. With `a` (M, F)
// bf16 the fc1 epilogue also stores the pre-activation stash.
static int mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* h, void* a,
                         void* out, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GemmArgs fc1 = gemm_args(out, w1, b1, nullptr, h, M, F, D, nullptr, a);
  err = a ? launch_gemm<EPI_BIAS_GELU_STASH>(fc1, s) : launch_gemm<EPI_BIAS_GELU>(fc1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS_RESIDUAL>(gemm_args(h, w2, b2, x, out, M, D, F), s);
  return static_cast<int>(err);
}

extern "C" int sky_mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* h, void* out, int M, int D, int F, void* stream) {
  return mlp_block_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, h, nullptr, out, M, D, F, stream);
}

extern "C" int sky_mlp_block_fwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* h, void* a, void* out, int M, int D,
                                       int F, void* stream) {
  return mlp_block_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, h, a, out, M, D, F, stream);
}
