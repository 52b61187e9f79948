// MLP-block backward for Hopper (sm_90a), recomputing the forward.
//
// Replaces the TPU kernel sky_embeddings_tpu/ops/kernels/mlp_block.py:
// _pallas_bwd (_bwd_kernel, mlp_block.py:309-354): the gradients of
// out = x + GELU(LN(x) @ W1 + b1) @ W2 + b2 from x and the output gradient
// g alone (the ViT-B training default, stash_mlp = False), with LN, fc1
// and GELU recomputed.
//
// Launches behind one C entry point, at the TPU kernel's rounding points:
//   1. LayerNorm of x                        -> y bf16                (:320-321)
//   2. a = y @ W1 + b1, fp32                 -> a (M, F) fp32         (:322)
//   3. dh = g @ W2^T; its epilogue reads a:  da = dh * gelu'(a) fp32 (kept
//      over a, for db1), da_c = bf16(da), h_c = bf16(gelu(a))        (:323-329)
//   4. dy = da_c @ W1^T, fp32                                         (:330)
//   5. LN backward -> dx, dscale / dbias partials                     (:333-337)
//   6. dW1 = y^T @ da_c, dW2 = h_c^T @ g: bf16 (the weight dtype,
//      mlp_block.py:954-956), GEMMs over K = B*N split into slices that
//      are added in order (launch_weight_grad, gemm.cuh)                (:351, :353)
//   7. db1 = column sums of da, db2 of g; the partial sums added in order.
// GELU and its derivative use erff (the TPU kernel's A-S erf differs by at
// most 1.5e-7). Parameter gradient sums are two-pass (bwd_common.cuh), so
// runs give the same bits.
//
// Bound on the H100: five GEMMs of 2 M D F FLOP each (98 GFLOP at B = 64):
// operation-bound. The first version runs on the wmma GEMM of gemm.cuh and
// moves a / da (M * F * 4 bytes, twice) and da_c, h_c through device
// memory; fusing them into the GEMMs is the first byte cost to remove.
#include "bwd_common.cuh"

// Returns 0, or the first CUDA error a launch reported. The caller allocates
// the scratch (y: (M, D) bf16; a: (M, F) fp32; da_c, h_c: (M, F) bf16; dy:
// (M, D) fp32; part: (F + 3D) * ceil(M / 32) fp32; ws: 8 * D * F fp32) and
// the outputs (dx (M, D) bf16; dscale, dbias, db2 (D,) and db1 (F,) fp32;
// dw1 (D, F) and dw2 (F, D) bf16).
extern "C" int sky_mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* g,
                                 void* y, void* a, void* da_c, void* h_c, void* dy, void* part,
                                 void* ws, void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                                 void* dw2, void* db2, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);          // parts x F
  float* part_b2 = part_b1 + (size_t)parts * F;        // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;   // parts x D
  float* af = static_cast<float*>(a);
  float* dyf = static_cast<float*>(dy);

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  SKY_TRY((launch_gemm<EPI_BIAS_F32>(gemm_args(y, w1, b1, nullptr, nullptr, M, F, D, af), s)));
  SKY_TRY((launch_gemm<EPI_GELU_BWD, false, true>(
      gemm_args(g, w2, nullptr, nullptr, da_c, M, F, D, af, h_c), s)));
  SKY_TRY((launch_gemm<EPI_STORE_F32, false, true>(
      gemm_args(da_c, w1, nullptr, nullptr, nullptr, M, D, F, dyf), s)));
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  float* wsf = static_cast<float*>(ws);
  SKY_TRY(launch_weight_grad(y, da_c, dw1, D, F, M, wsf, s));
  SKY_TRY(launch_weight_grad(h_c, g, dw2, F, D, M, wsf, s));
  SKY_TRY(launch_colsum_partial<float>(af, M, F, part_b1, nullptr, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_b2, nullptr, s));

  SKY_TRY(launch_colsum_final(part_b1, parts, F, db1, s));
  SKY_TRY(launch_colsum_final(part_b2, parts, D, db2, s));
  SKY_TRY(launch_colsum_final(part_scale, parts, D, dscale, s));
  SKY_TRY(launch_colsum_final(part_bias, parts, D, dbias, s));
  return 0;
}
