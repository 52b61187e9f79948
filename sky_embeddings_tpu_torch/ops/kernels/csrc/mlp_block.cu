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
//   0. LayerNorm (gemm.cuh)              -> y (M, D) bf16, staged in `out`
//   1. fc1 GEMM + b1 + exact erf GELU    -> h (M, F) bf16 (+ a (M, F) bf16)
//   2. fc2 GEMM + b2 + fp32 residual     -> out (M, D) bf16
// Both products run on the persistent wgmma + TMA GEMM of gemm_sm90.cuh.
// y and h go through device memory in bf16, the points where the TPU kernel
// rounds them (mlp_block.py:235, :240). The TPU kernel approximates erf
// (Abramowitz-Stegun 7.1.26, error <= 1.5e-7); this one uses erff.
//
// Bound on the H100: both GEMMs are compute-bound at the serving shapes
// (F = 3072); on the wgmma mainloop fc2 runs at about seven tenths of the
// tensor cores' peak and fc1 at half (PERF.md). What is left: fc1's
// erf-GELU epilogue, which no mainloop overlaps (both consumer warpgroups
// share one tile), and the h round trip (2 * M * F * 2 bytes, the stash
// another M * F * 2).
//
// This file also carries the new GEMM's entries for the card tests and
// chip_smoke.py: one product with a chosen epilogue (sky_gemm_sm90), its
// tile rule (sky_gemm_sm90_plan) and the host cost of its TMA maps.
#include <chrono>

#include "gemm_sm90.cuh"

// Returns 0, or the first CUDA error a launch reported. With `a` (M, F)
// bf16 the fc1 epilogue also stores the pre-activation stash.
static int mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* h, void* a,
                         void* out, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = a ? sm90::launch_gemm_sm90<EPI_BIAS_GELU_STASH>(out, w1, b1, nullptr, h, a, M, F, D, s)
          : sm90::launch_gemm_sm90<EPI_BIAS_GELU>(out, w1, b1, nullptr, h, nullptr, M, F, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::launch_gemm_sm90<EPI_BIAS_RESIDUAL>(h, w2, b2, x, out, nullptr, M, D, F, s);
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

// out = epilogue(a @ b + bias) on the new GEMM alone, for the card tests and
// chip_smoke.py: a (M, K), b (K, N), bias (N,) fp32; epi is EPI_BIAS (0),
// EPI_BIAS_GELU (1), EPI_BIAS_RESIDUAL (2, resid (M, N)) or
// EPI_BIAS_GELU_STASH (7, out2 (M, N) the pre-activation).
extern "C" int sky_gemm_sm90(const void* a, const void* b, const void* bias, const void* resid,
                             void* out, void* out2, int M, int N, int K, int epi, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (epi == EPI_BIAS)
    err = sm90::launch_gemm_sm90<EPI_BIAS>(a, b, bias, nullptr, out, nullptr, M, N, K, s);
  else if (epi == EPI_BIAS_GELU)
    err = sm90::launch_gemm_sm90<EPI_BIAS_GELU>(a, b, bias, nullptr, out, nullptr, M, N, K, s);
  else if (epi == EPI_BIAS_RESIDUAL)
    err = sm90::launch_gemm_sm90<EPI_BIAS_RESIDUAL>(a, b, bias, resid, out, nullptr, M, N, K, s);
  else if (epi == EPI_BIAS_GELU_STASH)
    err = sm90::launch_gemm_sm90<EPI_BIAS_GELU_STASH>(a, b, bias, nullptr, out, out2, M, N, K, s);
  return static_cast<int>(err);
}

// The tile rule at (M, N) over `sms` resident CTAs: plan[0..3] = BN,
// ring stages, output tiles, dynamic shared-memory bytes.
extern "C" void sky_gemm_sm90_plan(int M, int N, int sms, int* plan) {
  const sky::sm90::Plan p = sky::sm90::gemm_sm90_plan(M, N, sms);
  plan[0] = p.bn;
  plan[1] = p.stages;
  plan[2] = p.tiles;
  plan[3] = p.smem;
}

// Host microseconds to encode one launch's TMA maps (a (M, K), b (K, N),
// out (M, N)), the mean of `reps`; -1 if an encode fails.
extern "C" double sky_gemm_sm90_encode_us(const void* a, const void* b, void* out, int M, int N,
                                          int K, int reps) {
  using namespace sky::sm90;
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_2d(&maps[0], a, M, K, BM) || !encode_2d(&maps[1], b, K, N, BK) ||
        !encode_2d(&maps[2], out, M, N, 64))
      return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}
