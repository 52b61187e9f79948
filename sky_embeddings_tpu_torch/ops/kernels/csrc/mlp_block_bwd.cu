// MLP-block backward for Hopper (sm_90a): recompute (kernel 8), stash
// (kernel 7) and weight-streaming (kernel 9, at the end of this file)
// variants.
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/mlp_block.py:
// - _pallas_bwd (_bwd_kernel, mlp_block.py:309-354), entry
//   sky_mlp_block_bwd: the gradients of
//   out = x + GELU(LN(x) @ W1 + b1) @ W2 + b2 from x and the output gradient
//   g alone (the ViT-B training default, stash_mlp = False), with LN, fc1
//   and GELU recomputed;
// - _pallas_bwd_stash (_bwd_stash_kernel, mlp_block.py:378-423), entry
//   sky_mlp_block_bwd_stash: the same gradients from x, g and the bf16 fc1
//   pre-activation a that the stash forward (mlp_block.cu,
//   sky_mlp_block_fwd_stash) kept (the ViT-L default, stash_mlp = True). No
//   fc1 GEMM: GELU and GELU' are taken from the ROUNDED a, so h_c (for dW2)
//   is recomputed from bf16 a and is not the forward's h.
//
// Launches behind each C entry point, at the TPU kernel's rounding points:
//   1. LayerNorm of x                        -> y bf16                (:320-321)
//   2. recompute only: a = y @ W1 + b1, fp32 -> a (M, F) fp32         (:322)
//   3. dh = g @ W2^T; its epilogue reads a (fp32 recomputed, or the bf16
//      stash): da = dh * gelu'(a) fp32 (for db1), da_c = bf16(da),
//      h_c = bf16(gelu(a))                                            (:323-329, :393-399)
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
// Bound on the H100: five GEMMs of 2 M D F FLOP each for kernel 8 (98 GFLOP
// at ViT-B B = 64), four for kernel 7 (79 GFLOP at ViT-L D = 768, B = 64):
// operation-bound. The first version runs on the wmma GEMM of gemm.cuh and
// moves a / da (M * F * 4 bytes) and da_c, h_c through device memory;
// fusing them into the GEMMs is the first byte cost to remove.
#include "bwd_common.cuh"

// Returns 0, or the first CUDA error a launch reported. With `a_stash`
// (M, F) bf16 the fc1 recompute is skipped and `b1` is not read; `af`
// (M, F) fp32 then receives da only.
static int mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                         const void* b1, const void* w2, const void* a_stash, const void* g,
                         void* y, void* a, void* da_c, void* h_c, void* dy, void* part, void* ws,
                         void* dx, void* dscale, void* dbias, void* dw1, void* db1, void* dw2,
                         void* db2, int M, int D, int F, void* stream) {
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
  GemmArgs dh = gemm_args(g, w2, nullptr, a_stash, da_c, M, F, D, af, h_c);
  if (a_stash) {
    SKY_TRY((launch_gemm<EPI_GELU_BWD_STASH, false, true>(dh, s)));
  } else {
    SKY_TRY((launch_gemm<EPI_BIAS_F32>(gemm_args(y, w1, b1, nullptr, nullptr, M, F, D, af), s)));
    SKY_TRY((launch_gemm<EPI_GELU_BWD, false, true>(dh, s)));
  }
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

// Kernel 8. The caller allocates the scratch (y: (M, D) bf16; a: (M, F)
// fp32; da_c, h_c: (M, F) bf16; dy: (M, D) fp32; part: (F + 3D) *
// ceil(M / 32) fp32; ws: 8 * D * F fp32) and the outputs (dx (M, D) bf16;
// dscale, dbias, db2 (D,) and db1 (F,) fp32; dw1 (D, F) and dw2 (F, D) bf16).
extern "C" int sky_mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* g,
                                 void* y, void* a, void* da_c, void* h_c, void* dy, void* part,
                                 void* ws, void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                                 void* dw2, void* db2, int M, int D, int F, void* stream) {
  return mlp_block_bwd(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, a, da_c, h_c, dy, part, ws,
                       dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, stream);
}

// Kernel 7: as kernel 8, with the bf16 stash a (M, F) in place of b1 and
// `da` (M, F) fp32 scratch in place of a.
extern "C" int sky_mlp_block_bwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* w1, const void* w2, const void* a, const void* g,
                                       void* y, void* da, void* da_c, void* h_c, void* dy,
                                       void* part, void* ws, void* dx, void* dscale, void* dbias,
                                       void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                       int F, void* stream) {
  return mlp_block_bwd(x, ln_scale, ln_bias, w1, nullptr, w2, a, g, y, da, da_c, h_c, dy, part, ws,
                       dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, stream);
}

// Kernel 9: the weight-streaming backward. Replaces _pallas_bwd_stream
// (_bwd_stream_slab_kernel, mlp_block.py:459-631), the backward of
// fused_mlp_block(stash="stream") that wide blocks (D * F > 1024 * 4096,
// ViT-H) take. It computes kernel 8's gradients slab by slab over nj = F / fs
// column slabs of W1 (rows of W2), in order, as the TPU kernel's nj calls do:
//   1. LayerNorm of x                             -> y bf16, once    (:489-490)
//   per slab j (columns j*fs .. (j+1)*fs of F):
//   2. a_j = y @ W1[:, j] + b1_j, fp32            -> a (M, fs)       (:491)
//   3. dh_j = g @ W2[j, :]^T; epilogue da_j = dh_j * gelu'(a_j) fp32 (for
//      db1), da_c = bf16(da_j), h_c = bf16(gelu(a_j))                 (:492-498)
//   4. dy = da_c @ W1[:, j]^T in fp32: slab 0 stores it, later slabs add
//      their product to it (dy + dyin)                                 (:499-501)
//   5. dW1[:, j] = y^T @ da_c and dW2[j, :] = h_c^T @ g, rounded to bf16,
//      straight into their columns / rows of dw1 and dw2           (:514, :516)
//   6. db1_j = column sums of da_j                                     (:515)
//   7. after the last slab: LN backward from the summed dy -> dx, dscale,
//      dbias; db2 = column sums of g                         (:518, :520-527)
// No slab is copied: the fc1 and dy products read W1's column slab in place
// (GemmArgs::ldb = F) and dW1's slab is written in place (ldc = F); W2's
// row slab and dW2's are contiguous already. The slabs' fp32 dy partials
// are added in JAX's order. Against kernel 8, a, da, da_c, h_c, db1 and db2
// are the same bits; dy (and so dx, dscale, dbias) sums in another order,
// and the weight gradients may split their K = M sums into other slices
// (launch_weight_grad sizes the split from the output's tile count).
//
// What the slabs bound here: not a resident weight term (the TPU's
// 12 * D * fs bytes of VMEM) but the (M, fs) scratch in device memory, fp32
// a / da and bf16 da_c, h_c: 8 * M * fs bytes instead of kernel 8's
// 8 * M * F (173 MB instead of 692 MB at ViT-H, B = 256), and the split-K
// workspace, 8 * D * fs * 4 bytes. Bound: the same five GEMMs of 2 M D F
// FLOP as kernel 8, operation-bound.
//
// The caller allocates the scratch (y: (M, D) bf16; a: (M, fs) fp32; da_c,
// h_c: (M, fs) bf16; dy: (M, D) fp32; part: (fs + 3D) * ceil(M / 32) fp32;
// ws: 8 * D * fs fp32) and the outputs as for kernel 8. fs divides F and is
// a multiple of 8.
extern "C" int sky_mlp_block_bwd_stream(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* y, void* a, void* da_c, void* h_c,
                                        void* dy, void* part, void* ws, void* dx, void* dscale,
                                        void* dbias, void* dw1, void* db1, void* dw2, void* db2,
                                        int M, int D, int F, int fs, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);          // parts x fs, one slab at a time
  float* part_b2 = part_b1 + (size_t)parts * fs;       // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;   // parts x D
  float* af = static_cast<float*>(a);
  float* dyf = static_cast<float*>(dy);
  float* wsf = static_cast<float*>(ws);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  bf16* dw1b = static_cast<bf16*>(dw1);
  bf16* dw2b = static_cast<bf16*>(dw2);
  float* db1f = static_cast<float*>(db1);

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  for (int j = 0; j * fs < F; ++j) {
    const size_t c0 = (size_t)j * fs;
    GemmArgs fc1 = gemm_args(y, w1b + c0, b1f + c0, nullptr, nullptr, M, fs, D, af);
    fc1.ldb = F;
    SKY_TRY((launch_gemm<EPI_BIAS_F32>(fc1, s)));
    SKY_TRY((launch_gemm<EPI_GELU_BWD, false, true>(
        gemm_args(g, w2b + c0 * D, nullptr, nullptr, da_c, M, fs, D, af, h_c), s)));
    GemmArgs dyj = gemm_args(da_c, w1b + c0, nullptr, nullptr, nullptr, M, D, fs, dyf);
    dyj.ldb = F;  // W1[:, j] read as the (D, fs) transposed operand
    if (j == 0) {
      SKY_TRY((launch_gemm<EPI_STORE_F32, false, true>(dyj, s)));
    } else {
      SKY_TRY((launch_gemm<EPI_ADD_F32, false, true>(dyj, s)));
    }
    SKY_TRY(launch_weight_grad(y, da_c, dw1b + c0, D, fs, M, wsf, s, F));
    SKY_TRY(launch_weight_grad(h_c, g, dw2b + c0 * D, fs, D, M, wsf, s));
    SKY_TRY(launch_colsum_partial<float>(af, M, fs, part_b1, nullptr, s));
    SKY_TRY(launch_colsum_final(part_b1, parts, fs, db1f + c0, s));
  }
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_b2, nullptr, s));
  SKY_TRY(launch_colsum_final(part_b2, parts, D, db2, s));
  SKY_TRY(launch_colsum_final(part_scale, parts, D, dscale, s));
  SKY_TRY(launch_colsum_final(part_bias, parts, D, dbias, s));
  return 0;
}
