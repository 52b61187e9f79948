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
//   0. LayerNorm (common.cuh)            -> y (M, D) bf16, staged in `out`
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
// fp32 forms (entries sky_mlp_block_fwd_f32 and sky_mlp_block_fwd_stash_f32,
// the bf16 entries' arguments; the fp32 configs, where JAX runs
// xla_mlp_block, models/layers.py:253): the same three launches with fp32
// x, weights, y, h and out, both products on the 3xTF32 GEMM of
// gemm_f32.cuh, exact-erf GELU in fc1's epilogue. Kernel 6's stores the
// pre-activation a (M, F) in fp32, the operand dtype, as JAX's fp32
// autodiff keeps it; GELU reads the same fp32 value, so its `out` is K1's
// fp32 form's bit for bit.
//
// This file also carries the GEMMs' entries for the card tests and
// chip_smoke.py: one product with a chosen epilogue (sky_gemm_sm90), its
// tile rule (sky_gemm_sm90_plan) and the host cost of its TMA maps; one fp32
// product in any form and epilogue (sky_gemm_f32, sky_gemm_f32_ld with row
// pitches), its workspace and its plan (sky_gemm_f32_plan).
#include <chrono>

#include "gemm_f32.cuh"
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

// The fp32 forms of K1 and (with `a` (M, F)) kernel 6: x, w1, w2, h (M, F)
// and out fp32; the LN output is staged in `out`, which the last launch
// overwrites once it is dead.
static int mlp_block_fwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* h, void* a, void* out, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layernorm<float>(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = a ? f32::launch_gemm_f32<f32::FWD, f32::BIAS_GELU_STASH>(out, w1, b1, nullptr, h, a, M, F,
                                                                 D, nullptr, s)
          : f32::launch_gemm_f32<f32::FWD, f32::BIAS_GELU>(out, w1, b1, nullptr, h, nullptr, M, F,
                                                           D, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = f32::launch_gemm_f32<f32::FWD, f32::BIAS_RESIDUAL>(h, w2, b2, x, out, nullptr, M, D, F,
                                                           nullptr, s);
  return static_cast<int>(err);
}

extern "C" int sky_mlp_block_fwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* h, void* out, int M, int D, int F,
                                     void* stream) {
  return mlp_block_fwd_f32(x, ln_scale, ln_bias, w1, b1, w2, b2, h, nullptr, out, M, D, F, stream);
}

extern "C" int sky_mlp_block_fwd_stash_f32(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* w1, const void* b1,
                                           const void* w2, const void* b2, void* h, void* a,
                                           void* out, int M, int D, int F, void* stream) {
  return mlp_block_fwd_f32(x, ln_scale, ln_bias, w1, b1, w2, b2, h, a, out, M, D, F, stream);
}

// One fp32 product on gemm_f32.cuh alone, for the card tests and
// chip_smoke.py: form 0 (FWD: a (M, K), b (K, N)), 1 (NT: b (N, K)) or 2
// (TN: a (K, M)); epi 0 BIAS, 1 BIAS_GELU, 2 BIAS_RESIDUAL (resid (M, N)),
// 3 STORE, 4 DGELU (NT; aux (M, N) the pre-activation in, its GELU out), 5
// BIAS_GELU_STASH (FWD; aux (M, N) the pre-activation out), 6 ADD (NT; c
// (M, N) in and out). A TN STORE product with ws (sky_gemm_f32_ws floats)
// may split along K. sky_gemm_f32_ld takes row pitches (floats; 0: dense)
// of a, b and c (resid and aux share c's), as the blocks pass them, and a
// forced tile width and split count (0: the plan's; a sweep's).
static int gemm_f32_entry(const void* a, const void* b, const void* bias, const void* resid,
                          void* c, void* aux, void* ws, int form, int epi, int M, int N, int K,
                          sky::f32::Ld ld, int bn, int splits, void* stream) {
  using namespace sky::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (form == FWD && epi == BIAS)
    err = launch_gemm_f32<FWD, BIAS>(a, b, bias, nullptr, c, nullptr, M, N, K, nullptr, s, ld,
                                     bn, splits);
  else if (form == FWD && epi == BIAS_GELU)
    err = launch_gemm_f32<FWD, BIAS_GELU>(a, b, bias, nullptr, c, nullptr, M, N, K, nullptr, s,
                                          ld, bn, splits);
  else if (form == FWD && epi == BIAS_RESIDUAL)
    err = launch_gemm_f32<FWD, BIAS_RESIDUAL>(a, b, bias, resid, c, nullptr, M, N, K, nullptr, s,
                                              ld, bn, splits);
  else if (form == NT && epi == STORE)
    err = launch_gemm_f32<NT, STORE>(a, b, nullptr, nullptr, c, nullptr, M, N, K, nullptr, s, ld,
                                     bn, splits);
  else if (form == FWD && epi == BIAS_GELU_STASH)
    err = launch_gemm_f32<FWD, BIAS_GELU_STASH>(a, b, bias, nullptr, c, aux, M, N, K, nullptr, s,
                                                ld, bn, splits);
  else if (form == NT && epi == DGELU)
    err = launch_gemm_f32<NT, DGELU>(a, b, nullptr, aux, c, aux, M, N, K, nullptr, s, ld, bn,
                                     splits);
  else if (form == NT && epi == ADD)
    err = launch_gemm_f32<NT, ADD>(a, b, nullptr, nullptr, c, nullptr, M, N, K, nullptr, s, ld, bn,
                                   splits);
  else if (form == TN && epi == STORE)
    err = launch_gemm_f32<TN, STORE>(a, b, nullptr, nullptr, c, nullptr, M, N, K, ws, s, ld, bn,
                                     splits);
  return static_cast<int>(err);
}

extern "C" int sky_gemm_f32(const void* a, const void* b, const void* bias, const void* resid,
                            void* c, void* aux, void* ws, int form, int epi, int M, int N, int K,
                            void* stream) {
  return gemm_f32_entry(a, b, bias, resid, c, aux, ws, form, epi, M, N, K, {}, 0, 0, stream);
}

extern "C" int sky_gemm_f32_ld(const void* a, const void* b, const void* bias, const void* resid,
                               void* c, void* aux, void* ws, int form, int epi, int M, int N,
                               int K, int lda, int ldb, int ldc, int bn, int splits,
                               void* stream) {
  sky::f32::Ld ld;
  ld.a = lda;
  ld.b = ldb;
  ld.c = ldc;
  return gemm_f32_entry(a, b, bias, resid, c, aux, ws, form, epi, M, N, K, ld, bn, splits, stream);
}

// The fp32 GEMM's plan of an (M, N, K) product over `sms` CTAs (f32_plan):
// {BN, splits, slabs a slice, units, ring slots, shared-memory bytes}.
extern "C" void sky_gemm_f32_plan(int M, int N, int K, int may_split, int sms, int* plan) {
  const sky::f32::Plan p = sky::f32::f32_plan(M, N, K, may_split != 0, sms);
  plan[0] = p.bn;
  plan[1] = p.splits;
  plan[2] = p.kslabs;
  plan[3] = p.units;
  plan[4] = sky::f32::stages_of(p.bn);
  plan[5] = sky::f32::smem_of(p.bn);
}

extern "C" long long sky_gemm_f32_ws(int M, int N, int K) {
  return static_cast<long long>(sky::f32::workspace(M, N, K));
}

// ---- the tensor-parallel form of K1 -----------------------------------------
//
// K1 split at the all-reduce (parallel/sharding.py): a rank holds the
// contiguous column block F_r = F / tp of W1 (w1_r (D, F_r), b1_r) and the
// same rows of W2 (w2_r (F_r, D)). Entry sky_mlp_block_tp_fwd runs the
// rank's half: LN of the replicated x (staged in `part`; in bf16 the row
// held in registers, common.cuh launch_layernorm_held, D <= 1 280), h_r =
// bf16(GELU(y @ w1_r + b1_r)) (M, F_r), then part = h_r @ w2_r in fp32
// (EPI_STORE_F32). The caller all-reduces `part` over the model group, and
// sky_mlp_block_tp_finish adds b2 and the residual and rounds: out = bf16(x
// + (sum + b2)), K1's EPI_BIAS_RESIDUAL order. A rank's bound: its 4 M D
// F_r FLOP of products; the all-reduce moves 4 M D bytes. The fp32 forms
// (_f32 entries) take the fp32 GEMM and the multi-pass LN. One launch that
// keeps y and h on chip at the ViT-S shard was built and read slower than
// these three (PERF.md section 6, "Tried and dropped").
static int mlp_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* w1, const void* b1, const void* w2, void* h, void* part,
                            int M, int D, int F, bool fp32, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fp32) {
    err = launch_layernorm<float>(x, ln_scale, ln_bias, part, M, D, s);
    if (err == cudaSuccess)
      err = f32::launch_gemm_f32<f32::FWD, f32::BIAS_GELU>(part, w1, b1, nullptr, h, nullptr, M, F,
                                                           D, nullptr, s);
    if (err == cudaSuccess)
      err = f32::launch_gemm_f32<f32::FWD, f32::STORE>(h, w2, nullptr, nullptr, part, nullptr, M, D,
                                                       F, nullptr, s);
    return static_cast<int>(err);
  }
  err = launch_layernorm_held(x, ln_scale, ln_bias, part, M, D, s);
  if (err == cudaSuccess)
    err = sm90::launch_gemm_sm90<EPI_BIAS_GELU>(part, w1, b1, nullptr, h, nullptr, M, F, D, s);
  if (err == cudaSuccess)
    err = sm90::launch_gemm_sm90<EPI_STORE_F32>(h, w2, nullptr, nullptr, part, nullptr, M, D, F, s);
  return static_cast<int>(err);
}

// The rank's half: h (M, F_r) scratch, part (M, D) fp32 out; F = F_r.
extern "C" int sky_mlp_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                    const void* w1, const void* b1, const void* w2, void* h,
                                    void* part, int M, int D, int F, void* stream) {
  return mlp_block_tp_fwd(x, ln_scale, ln_bias, w1, b1, w2, h, part, M, D, F, false, stream);
}

extern "C" int sky_mlp_block_tp_fwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2, void* h,
                                        void* part, int M, int D, int F, void* stream) {
  return mlp_block_tp_fwd(x, ln_scale, ln_bias, w1, b1, w2, h, part, M, D, F, true, stream);
}

// One LN launch over bf16 rows (M, K): the row held in registers (held != 0,
// the TP forms' LN) or read once a pass (the whole blocks'), for the check
// that compares their bits.
extern "C" int sky_layernorm_bf16(const void* x, const void* scale, const void* bias, void* y,
                                  int M, int K, int held, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(held ? sky::launch_layernorm_held(x, scale, bias, y, M, K, s)
                               : sky::launch_layernorm(x, scale, bias, y, M, K, s));
}

// After the all-reduce: out = x + (part + b2), rounded to x's type.
extern "C" int sky_mlp_block_tp_finish(const void* x, const void* part, const void* b2, void* out,
                                       int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<sky::bf16>(
      x, part, b2, out, M, D, static_cast<cudaStream_t>(stream)));
}

extern "C" int sky_mlp_block_tp_finish_f32(const void* x, const void* part, const void* b2,
                                           void* out, int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<float>(x, part, b2, out, M, D,
                                                           static_cast<cudaStream_t>(stream)));
}
