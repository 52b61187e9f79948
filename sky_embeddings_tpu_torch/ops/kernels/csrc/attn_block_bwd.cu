// Attention-block backward for Hopper (sm_90a): from the stash (kernel 3)
// and with the forward recomputed (kernel 4).
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/attn_block.py:
// - _pallas_bwd_stash (_bwd_stash_kernel / _bwd_stash_kernel_loop), entry
//   sky_attn_block_bwd_stash: the gradients of
//   out = x + MHA(LN(x) @ Wqkv + bqkv) @ Wproj + bproj from x, the output
//   gradient g, and the qkv and probabilities that the stash forward
//   (attn_block.cu, sky_attn_block_fwd_stash) kept. Nothing of the qkv GEMM,
//   the logits or the softmax is recomputed: only the LN and ctx = P V (for
//   dWproj).
// - _pallas_bwd (_bwd_kernel, attn_block.py:156-235, and _bwd_kernel_loop,
//   :768-821, with _loop_heads_bwd(probs_ref=None)), entry
//   sky_attn_block_bwd: the same gradients from x and g alone (stash =
//   False, remat). LN, qkv (rounded to bf16 after its bias), the logits and
//   the fp32 softmax are recomputed. Not kernel 3 with recomputed
//   probabilities: ctx and dV take the bf16 P, but the softmax backward
//   takes the fp32 P (attn_block.py:192-201). With packed segments
//   (seg_len > 0, MAE sequence packing) the recomputed softmax runs over
//   each row's own segment, as the forward core does (attn_block.cu), and
//   P is exactly 0 elsewhere.
// Neither needs the mask past the softmax: where P = 0, ds = (dp * p -
// p * rowsum(dp * p)) * scale is 0 too, so dq, dk and dv take nothing from
// another segment's rows or keys. Kernel 3 takes no seg_len at all: its
// stashed probabilities already carry the zeros (JAX _fab_bwd).
//
// Launches behind each C entry point, at the TPU kernel's rounding points
// (attn_block.py:282-356 and :156-235), every product on the persistent
// wgmma + TMA GEMM of gemm_sm90.cuh:
//   1. LayerNorm of x                         -> y = bf16 LN output   (:298-299)
//   1b. kernel 4 only: qkv = bf16(y @ Wqkv + bqkv), the forward form
//       (EPI_BIAS, as K2 computes it)                                 (:174-175)
//   2. dctx = g @ Wproj^T, rounded -> dc bf16: FORM_NT, Wproj in its
//      (in, out) layout read as (N, K), staged TMA store (EPI_STORE)
//                                                        (:302-303, :320)
//   3. backward core (attn_core.cuh), one CTA per (sample, head), query
//      blocks of QB rows (the whole head at N <= 128):
//        kernel 4: S = Q K^T (fp32), P = softmax(S * hd^-0.5) in fp32, in
//        registers beside its bf16 copy (K2's arithmetic)           (:191-193)
//        ctx = bf16(P_bf16 V)                                         (:318)
//        dp = dc V^T;  ds = bf16((dp * P - P * rowsum(dp * P)) * hd^-0.5)
//        with P fp32 (kernel 4) or the stashed bf16 P (kernel 3)
//        dq = ds K;  dk = ds^T Q;  dv = P_bf16^T dc, summed in fp32 and
//        written as bf16 dqkv_c, beside the fp32 column sums of each
//        sample's rows (dbqkv from the fp32 dqkv, :354)         (:321-328)
//      P^T and ds^T are read from the block's bf16 tiles in shared memory
//      through ldmatrix.trans. dk and dv sum over the query blocks in
//      registers and shared memory, each key row by one warp in block
//      order, without atomics and never in device memory.
//   4. dy = dqkv_c @ Wqkv^T in fp32: FORM_NT (EPI_STORE_F32)          (:334)
//   5. LN backward -> dx, dscale / dbias partials                     (:336-340)
//   6. dWqkv = y^T @ dqkv_c and dWproj = ctx^T @ g: one FORM_TN group
//      launch, bf16 (the weight dtype, attn_block.py:1176-1178), K = B*N
//      split into slices added in order where the group plan says
//   7. dbproj's partials (column sums of g); then dbqkv (the B per-sample
//      partials), dbproj, dscale and dbias, each added in order, in one
//      launch.
// Parameter gradient sums are two-pass (bwd_common.cuh, the core's
// per-sample partials), so runs give the same bits.
//
// Bound on the H100: ~8 M D^2 FLOP in the four GEMMs (kernel 4: 6 M D^2 more
// for the qkv recompute) plus 8 B H N^2 hd in the core (kernel 4: 10):
// operation-bound. What moves besides the products: y, dc, ctx and dqkv_c
// in bf16 (written once, read by the products), dy in fp32, qkv (kernel 4
// writes and reads it), the stash (kernel 3) and the split weight
// gradients' fp32 partials; no fp32 (M, 3D) dqkv reaches device memory.
//
// Shared memory (AttnBwdPlan, attn_core.cuh, with the column sums): 75 520
// bytes at N = 65, hd = 64 (three CTAs per SM); kernels 3 and 4 share the
// plan.
//
// The backward core (attn_bwd_core_kernel) lives in attn_core.cuh, shared with
// kernel 13 (attention.cu), which runs the recompute core alone.
//
// The fp32 forms of kernels 3 and 4 (entries sky_attn_block_bwd_stash_f32
// and sky_attn_block_bwd_f32, the bf16 entries' arguments; the fp32
// configs, where JAX takes jax.vjp of xla_attn_block): steps 1-7 in fp32 at
// the plain version's points, every product on the 3xTF32 GEMM of
// gemm_f32.cuh (kernel 4's qkv recompute on its forward form, as K2's fp32
// form computes qkv), the core kernel 13's fp32 one (attn_f32.cuh) writing
// ctx = P V beside the fp32 dqkv (M, 3D), which goes through device memory;
// dbqkv from its column sums in two passes. Kernel 3's core reads the
// stashed fp32 probabilities; kernel 4's recomputes them (masked to packed
// segments with seg_len > 0) exactly as the forward core does, so its ctx
// is the forward's bit for bit without a second launch of the forward core.
#include "attn_core.cuh"
#include "attn_f32.cuh"
#include "bwd_common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

// The weight-gradient group (FORM_TN, bf16): spec[0] dWqkv = y^T @ dqkv_c
// (D, 3D), spec[1] dWproj = ctx^T @ g (D, D), both over K = M token rows.
static void weight_group(sky::sm90::BwdSpec* spec, const void* y, const void* dqkv_c,
                         const void* ctx, const void* g, void* dwqkv, void* dwproj, int M, int D) {
  using namespace sky::sm90;
  spec[0] = BwdSpec{FORM_TN, sky::EPI_STORE, y, dqkv_c, 0, dwqkv, nullptr, 0, D, 3 * D, M};
  spec[1] = BwdSpec{FORM_TN, sky::EPI_STORE, ctx, g, 0, dwproj, nullptr, 0, D, D, M};
}

// fp32 floats of split-K workspace the weight-gradient group of (M, D) needs.
extern "C" long long sky_attn_block_bwd_ws(int M, int D) {
  using namespace sky::sm90;
  int sms = 0;
  if (sky::sm_count(&sms) != cudaSuccess) return -1;
  BwdSpec spec[2];
  weight_group(spec, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M, D);
  int shapes[2][4];
  bwd_shapes(spec, 2, shapes);
  return (long long)bwd_workspace(shapes, 2, bwd_plan(shapes, 2, sms));
}

// Returns 0, or the first CUDA error a launch reported. The caller allocates
// the scratch (y, dc, ctx: (M, D) bf16; dqkv_c: (M, 3D) bf16; dy: (M, D)
// fp32; part: B * 3D + 3D * ceil(M / 32) fp32; ws: sky_attn_block_bwd_ws(M,
// D) fp32) and the outputs (dx (B, N, D) bf16; dscale, dbias, dbproj (D,)
// and dbqkv (3D,) fp32; dwqkv (D, 3D) and dwproj (D, D) bf16). Kernel 3
// reads the stashed `qkv` and `probs`; kernel 4 (`recompute`) writes `qkv`
// (scratch, (M, 3D) bf16) from `bqkv` and reads no probabilities.
static int attn_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                          const void* probs, const void* g, void* y, void* dc, void* ctx,
                          void* dqkv_c, void* dy, void* part, void* ws, void* dx, void* dscale,
                          void* dbias, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, int B,
                          int N, int D, int H, int seg_len, bool recompute, void* stream) {
  using namespace sky;
  using sm90::BwdSpec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const int parts = n_partials(M);
  float* part_qkv = static_cast<float*>(part);            // B x 3D, one row per sample
  float* part_proj = part_qkv + (size_t)B * 3 * D;        // parts x D
  float* part_scale = part_proj + (size_t)parts * D;      // parts x D
  float* part_bias = part_scale + (size_t)parts * D;      // parts x D
  float* dyf = static_cast<float*>(dy);

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  if (recompute)
    SKY_TRY(sm90::launch_gemm_sm90<EPI_BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * D, D, s));
  const BwdSpec dctx{sm90::FORM_NT, EPI_STORE, g, wproj, 0, dc, nullptr, 0, M, D, D};
  SKY_TRY(sm90::launch_bwd_group(&dctx, 1, nullptr, s));

  if (recompute)
    SKY_TRY((launch_attn_bwd_core<true, true>(qkv, nullptr, dc, ctx, dqkv_c, B, N, D, H, seg_len,
                                              s, part_qkv)));
  else
    SKY_TRY((launch_attn_bwd_core<false, true>(qkv, probs, dc, ctx, dqkv_c, B, N, D, H, 0, s,
                                               part_qkv)));

  const BwdSpec dy_spec{sm90::FORM_NT, EPI_STORE_F32, dqkv_c, wqkv, 0, nullptr, dyf, 0, M, D, 3 * D};
  SKY_TRY(sm90::launch_bwd_group(&dy_spec, 1, nullptr, s));
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  BwdSpec dw[2];
  weight_group(dw, y, dqkv_c, ctx, g, dwqkv, dwproj, M, D);
  SKY_TRY(sm90::launch_bwd_group(dw, 2, static_cast<float*>(ws), s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_proj, s));

  const ColsumJob jobs[4] = {{part_qkv, static_cast<float*>(dbqkv), B, 3 * D},
                             {part_proj, static_cast<float*>(dbproj), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 4, s));
  return 0;
}

// Shared-memory bytes of the backward core's plan at (N, hd) with the
// column sums, kernel 3's and kernel 4's alike; the wrappers refuse what
// exceeds the block's limit.
extern "C" long long sky_attn_bwd_plan_bytes(int N, int hd) {
  return static_cast<long long>(sky::AttnBwdPlan(N, hd, true).bytes());
}

// Kernel 3: the gradients from the stashed qkv (B, N, 3D) and probs (B, H, N, N).
extern "C" int sky_attn_block_bwd_stash(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* wproj,
    const void* qkv, const void* probs, const void* g, void* y, void* dc, void* ctx, void* dqkv_c,
    void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, int B, int N, int D, int H, void* stream) {
  return attn_block_bwd(x, ln_scale, ln_bias, wqkv, nullptr, wproj, const_cast<void*>(qkv), probs,
                        g, y, dc, ctx, dqkv_c, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv,
                        dwproj, dbproj, B, N, D, H, 0, false, stream);
}

// Kernel 4: the gradients from x and g alone; qkv is (B, N, 3D) bf16 scratch;
// seg_len > 0 masks attention to packed segments of seg_len tokens.
extern "C" int sky_attn_block_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv_c,
    void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, int B, int N, int D, int H, int seg_len, void* stream) {
  return attn_block_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, nullptr, g, y, dc, ctx,
                        dqkv_c, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj, B,
                        N, D, H, seg_len, true, stream);
}

// The weight-gradient group alone, as both entries launch it: dWqkv = y^T @
// dqkv_c and dWproj = ctx^T @ g in one launch; bn, splits, schedule > 0
// force the plan (gemm_sm90.cuh bwd_plan_forced); ws holds the workspace
// sky_gemm_sm90_bwd_plan gives under them.
extern "C" int sky_attn_bwd_weight_grads(const void* y, const void* dqkv_c, const void* ctx,
                                         const void* g, void* dwqkv, void* dwproj, void* ws, int M,
                                         int D, int bn, int splits, int schedule, void* stream) {
  using namespace sky::sm90;
  BwdSpec spec[2];
  weight_group(spec, y, dqkv_c, ctx, g, dwqkv, dwproj, M, D);
  return static_cast<int>(launch_bwd_group(spec, 2, static_cast<float*>(ws),
                                           static_cast<cudaStream_t>(stream), bn, splits,
                                           schedule));
}

// ---- the fp32 forms of kernels 3 and 4 --------------------------------------

// fp32 floats of split-K workspace the fp32 forms of (M, D) need: the larger
// of their two weight gradients' (one after the other).
extern "C" long long sky_attn_block_bwd_f32_ws(int M, int D) {
  const size_t a = sky::f32::workspace(D, 3 * D, M), b = sky::f32::workspace(D, D, M);
  return static_cast<long long>(a > b ? a : b);
}

// All fp32. The caller allocates the scratch (y, dc, ctx, dy: (M, D); dqkv:
// (M, 3D); part: 6D * ceil(M / 32); ws: sky_attn_block_bwd_f32_ws(M, D);
// kernel 4 also qkv (M, 3D)) and the outputs (dx (B, N, D); dscale, dbias,
// dbproj (D,); dbqkv (3D,); dwqkv (D, 3D); dwproj (D, D)). Kernel 3 reads
// the stashed `qkv` and `probs`; kernel 4 (`recompute`) writes `qkv` from
// `bqkv` and reads no probabilities.
static int attn_block_bwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                              const void* probs, const void* g, void* y, void* dc, void* ctx,
                              void* dqkv, void* dy, void* part, void* ws, void* dx, void* dscale,
                              void* dbias, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                              int B, int N, int D, int H, int seg_len, bool recompute,
                              void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const int parts = n_partials(M);
  float* part_qkv = static_cast<float*>(part);           // parts x 3D
  float* part_proj = part_qkv + (size_t)parts * 3 * D;   // parts x D
  float* part_scale = part_proj + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;     // parts x D
  float* dyf = static_cast<float*>(dy);
  SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, y, M, D, s));
  if (recompute)
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M,
                                                       3 * D, D, nullptr, s)));
  SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(g, wproj, nullptr, nullptr, dc, nullptr, M, D,
                                                     D, nullptr, s)));
  void* stash = recompute ? nullptr : const_cast<void*>(probs);  // kernel 3 reads the stash
  SKY_TRY(launch_f32(true, qkv, dc, dqkv, B, N, D, H, s, stash, ctx, recompute ? seg_len : 0));
  SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(dqkv, wqkv, nullptr, nullptr, dyf, nullptr, M,
                                                     D, 3 * D, nullptr, s)));
  SKY_TRY(launch_ln_bwd<float>(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(y, dqkv, nullptr, nullptr, dwqkv, nullptr, D,
                                                     3 * D, M, ws, s)));
  SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(ctx, g, nullptr, nullptr, dwproj, nullptr, D,
                                                     D, M, ws, s)));
  SKY_TRY(launch_colsum_partial<float>(dqkv, M, 3 * D, part_qkv, s));
  SKY_TRY(launch_colsum_partial<float>(g, M, D, part_proj, s));
  const ColsumJob jobs[4] = {{part_qkv, static_cast<float*>(dbqkv), parts, 3 * D},
                             {part_proj, static_cast<float*>(dbproj), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 4, s));
  return 0;
}

// Kernel 3's fp32 form: from the stashed fp32 qkv and probs.
extern "C" int sky_attn_block_bwd_stash_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* wproj,
    const void* qkv, const void* probs, const void* g, void* y, void* dc, void* ctx, void* dqkv,
    void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, int B, int N, int D, int H, void* stream) {
  return attn_block_bwd_f32(x, ln_scale, ln_bias, wqkv, nullptr, wproj, const_cast<void*>(qkv),
                            probs, g, y, dc, ctx, dqkv, dy, part, ws, dx, dscale, dbias, dwqkv,
                            dbqkv, dwproj, dbproj, B, N, D, H, 0, false, stream);
}

// Kernel 4's fp32 form: from x and g alone; qkv is (B, N, 3D) fp32 scratch;
// seg_len > 0 masks attention to packed segments of seg_len tokens.
extern "C" int sky_attn_block_bwd_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, int B, int N, int D, int H, int seg_len, void* stream) {
  return attn_block_bwd_f32(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, nullptr, g, y, dc, ctx,
                            dqkv, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj, B,
                            N, D, H, seg_len, true, stream);
}
