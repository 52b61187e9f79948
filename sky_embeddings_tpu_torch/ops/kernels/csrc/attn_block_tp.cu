// The attention block's tensor-parallel forms for Hopper (sm_90a): K2 and
// kernel 4 split at the all-reduce over the model group
// (parallel/sharding.py, ops/kernels/attn_block.py). Each is two C
// entries, the rank's half and the finish after the all-reduce, with their
// fp32 forms; their launches are K2's (attn_block.cu) and kernel 4's
// (attn_block_bwd.cu) at the rank's widths, on the same cores and GEMM
// forms. They live in a library of their own, beside the sources of the
// whole blocks' kernels.
#include "attn_core.cuh"
#include "attn_f32.cuh"
#include "bwd_common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

// ---- the tensor-parallel form of K2 -----------------------------------------
//
// K2 split at the all-reduce (parallel/sharding.py): a rank holds the qkv
// columns of its H / tp heads, [q_r | k_r | v_r], each Dl = D / tp wide,
// wqkv_r (D, 3 Dl) and bqkv_r (3 Dl,), and wproj's rows of the same heads,
// wproj_r (Dl, D). Entry sky_attn_block_tp_fwd runs the rank's half:
//   0. LayerNorm of the replicated x            -> y (M, D), staged in `part`
//   1. qkv_r = y @ wqkv_r + bqkv_r               -> (M, 3 Dl) bf16
//   2. the attention core over the rank's Hl heads (attn_core.cuh reads q,
//      k and v at columns 0, Dl and 2 Dl of each row: the head-group
//      layout above)                             -> ctx_r (M, Dl) bf16
//   3. part = ctx_r @ wproj_r, fp32 (EPI_STORE_F32: no bias, no residual)
// The caller all-reduces `part` over the model group (torch.distributed),
// then sky_attn_block_tp_finish adds bproj and the residual and rounds:
// out = bf16(x + (sum + bproj)), K2's EPI_BIAS_RESIDUAL order. What a rank
// bounds on the H100: its qkv and proj products, 8 M D Dl FLOP, and its
// heads' core; the all-reduce moves M D fp32 (4 M D bytes) over the link.
// The fp32 forms (_f32 entries, the same arguments) take the fp32 GEMM and
// core of sky_attn_block_fwd_f32.
static int attn_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                             void* ctx, void* part, int B, int N, int D, int Dl, int Hl,
                             int seg_len, bool fp32, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  if (fp32) {
    SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, part, M, D, s));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(part, wqkv, bqkv, nullptr, qkv, nullptr, M,
                                                       3 * Dl, D, nullptr, s)));
    SKY_TRY(launch_f32(false, qkv, nullptr, ctx, B, N, Dl, Hl, s, nullptr, nullptr, seg_len));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::STORE>(ctx, wproj, nullptr, nullptr, part,
                                                        nullptr, M, D, Dl, nullptr, s)));
    return 0;
  }
  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, part, M, D, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_BIAS>(part, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * Dl, D,
                                           s));
  SKY_TRY(launch_attn_core(qkv, ctx, nullptr, B, N, Dl, Hl, seg_len, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_STORE_F32>(ctx, wproj, nullptr, nullptr, part, nullptr, M, D,
                                                Dl, s));
  return 0;
}

// The rank's half: qkv (M, 3 Dl) and ctx (M, Dl) scratch, part (M, D) fp32
// out; seg_len > 0 masks attention to packed segments of seg_len tokens.
extern "C" int sky_attn_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* wqkv, const void* bqkv, const void* wproj,
                                     void* qkv, void* ctx, void* part, int B, int N, int D, int Dl,
                                     int Hl, int seg_len, void* stream) {
  return attn_block_tp_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl,
                           Hl, seg_len, false, stream);
}

extern "C" int sky_attn_block_tp_fwd_f32(const void* x, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv, const void* bqkv,
                                         const void* wproj, void* qkv, void* ctx, void* part,
                                         int B, int N, int D, int Dl, int Hl, int seg_len,
                                         void* stream) {
  return attn_block_tp_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl,
                           Hl, seg_len, true, stream);
}

// After the all-reduce: out = x + (part + bproj), rounded to x's type.
extern "C" int sky_attn_block_tp_finish(const void* x, const void* part, const void* bproj,
                                        void* out, int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<sky::bf16>(
      x, part, bproj, out, M, D, static_cast<cudaStream_t>(stream)));
}

extern "C" int sky_attn_block_tp_finish_f32(const void* x, const void* part, const void* bproj,
                                            void* out, int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<float>(x, part, bproj, out, M, D,
                                                           static_cast<cudaStream_t>(stream)));
}

// ---- the tensor-parallel form of kernel 4 -------------------------------------
//
// Kernel 4 split at the all-reduce, on a rank's shard (attn_block.cu: the
// qkv columns of its Hl = H / tp heads, [q_r | k_r | v_r] each Dl = D / tp
// wide, and wproj's rows of the same heads). Entry sky_attn_block_tp_bwd
// runs the rank's half from the replicated x and output gradient g:
//   1. y = LN(x) (M, D); 1b. qkv_r = bf16(y @ wqkv_r + bqkv_r) (M, 3 Dl)
//   2. dc_r = bf16(g @ wproj_r^T) (M, Dl): FORM_NT, wproj_r (Dl, D) read as
//      (N, K)
//   3. the recompute core over the rank's heads -> dqkv_c (M, 3 Dl) bf16,
//      ctx_r, and dbqkv_r's per-sample partials
//   4. dy_r = dqkv_c @ wqkv_r^T in fp32 (M, D): the rank's partial of dy
//   5. dWqkv_r = y^T @ dqkv_c and dWproj_r = ctx_r^T @ g, one FORM_TN group
//   6. dbqkv_r, the partials added in order
// The caller all-reduces dy over the model group; sky_attn_block_tp_bwd_finish
// then runs what needs the whole dy: the LN backward (dx = g + ..., the
// partials of dscale and dbias) and dbproj's column sums of g, each added
// in order. Those gradients are of replicated parameters, computed alike on
// every rank from replicated inputs: nothing of them is all-reduced. Each
// step is kernel 4's launch at the rank's widths; the bound is a rank's 14
// M D Dl FLOP of products (with the qkv recompute) and its heads' core.
// The fp32 forms (_f32 entries) take the products and core of
// sky_attn_block_bwd_f32.

// fp32 floats of split-K workspace the rank's weight-gradient group needs.
extern "C" long long sky_attn_block_tp_bwd_ws(int M, int D, int Dl) {
  using namespace sky::sm90;
  int sms = 0;
  if (sky::sm_count(&sms) != cudaSuccess) return -1;
  BwdSpec spec[2];
  spec[0] = BwdSpec{FORM_TN, sky::EPI_STORE, nullptr, nullptr, 0, nullptr, nullptr, 0, D, 3 * Dl, M};
  spec[1] = BwdSpec{FORM_TN, sky::EPI_STORE, nullptr, nullptr, 0, nullptr, nullptr, 0, Dl, D, M};
  int shapes[2][4];
  bwd_shapes(spec, 2, shapes);
  return (long long)bwd_workspace(shapes, 2, bwd_plan(shapes, 2, sms));
}

extern "C" long long sky_attn_block_tp_bwd_f32_ws(int M, int D, int Dl) {
  const size_t a = sky::f32::workspace(D, 3 * Dl, M), b = sky::f32::workspace(Dl, D, M);
  return static_cast<long long>(a > b ? a : b);
}

// The caller allocates the scratch (y (M, D); qkv, dqkv (M, 3 Dl); dc, ctx
// (M, Dl), in the operand dtype; part: bf16 B * 3 Dl, fp32 3 Dl *
// ceil(M / 32) floats; ws: the _ws entry's floats) and the outputs (dy (M,
// D) fp32; dwqkv (D, 3 Dl), dwproj (Dl, D) in the operand dtype; dbqkv
// (3 Dl,) fp32).
static int attn_block_tp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* wqkv, const void* bqkv, const void* wproj, const void* g,
                             void* y, void* qkv, void* dc, void* ctx, void* dqkv, void* part,
                             void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B,
                             int N, int D, int Dl, int Hl, int seg_len, bool fp32, void* stream) {
  using namespace sky;
  using sm90::BwdSpec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  float* partf = static_cast<float*>(part);
  float* dyf = static_cast<float*>(dy);
  if (fp32) {
    SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, y, M, D, s));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M,
                                                       3 * Dl, D, nullptr, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(g, wproj, nullptr, nullptr, dc, nullptr, M,
                                                       Dl, D, nullptr, s)));
    SKY_TRY(launch_f32(true, qkv, dc, dqkv, B, N, Dl, Hl, s, nullptr, ctx, seg_len));
    SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(dqkv, wqkv, nullptr, nullptr, dyf, nullptr,
                                                       M, D, 3 * Dl, nullptr, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(y, dqkv, nullptr, nullptr, dwqkv, nullptr, D,
                                                       3 * Dl, M, ws, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(ctx, g, nullptr, nullptr, dwproj, nullptr,
                                                       Dl, D, M, ws, s)));
    SKY_TRY(launch_colsum_partial<float>(dqkv, M, 3 * Dl, partf, s));
    SKY_TRY(launch_colsum_final(partf, n_partials(M), 3 * Dl, dbqkv, s));
    return 0;
  }
  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * Dl, D, s));
  const BwdSpec dctx{sm90::FORM_NT, EPI_STORE, g, wproj, 0, dc, nullptr, 0, M, Dl, D};
  SKY_TRY(sm90::launch_bwd_group(&dctx, 1, nullptr, s));
  SKY_TRY((launch_attn_bwd_core<true, true>(qkv, nullptr, dc, ctx, dqkv, B, N, Dl, Hl, seg_len, s,
                                            partf)));
  const BwdSpec dy_spec{sm90::FORM_NT, EPI_STORE_F32, dqkv, wqkv, 0, nullptr, dyf, 0, M, D, 3 * Dl};
  SKY_TRY(sm90::launch_bwd_group(&dy_spec, 1, nullptr, s));
  BwdSpec dw[2];
  dw[0] = BwdSpec{sm90::FORM_TN, EPI_STORE, y, dqkv, 0, dwqkv, nullptr, 0, D, 3 * Dl, M};
  dw[1] = BwdSpec{sm90::FORM_TN, EPI_STORE, ctx, g, 0, dwproj, nullptr, 0, Dl, D, M};
  SKY_TRY(sm90::launch_bwd_group(dw, 2, static_cast<float*>(ws), s));
  SKY_TRY(launch_colsum_final(partf, B, 3 * Dl, dbqkv, s));
  return 0;
}

extern "C" int sky_attn_block_tp_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* part, void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B, int N, int D,
    int Dl, int Hl, int seg_len, void* stream) {
  return attn_block_tp_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, g, y, qkv, dc, ctx, dqkv, part,
                           ws, dy, dwqkv, dbqkv, dwproj, B, N, D, Dl, Hl, seg_len, false, stream);
}

extern "C" int sky_attn_block_tp_bwd_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* part, void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B, int N, int D,
    int Dl, int Hl, int seg_len, void* stream) {
  return attn_block_tp_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, g, y, qkv, dc, ctx, dqkv, part,
                           ws, dy, dwqkv, dbqkv, dwproj, B, N, D, Dl, Hl, seg_len, true, stream);
}

// After the all-reduce of dy (M, D) fp32: dx (the operand dtype), dscale,
// dbias and dbproj (D,) fp32; part holds 3 D * ceil(M / 32) floats.
extern "C" int sky_attn_block_tp_bwd_finish(const void* x, const void* ln_scale, const void* g,
                                            const void* dy, void* part, void* dx, void* dscale,
                                            void* dbias, void* dbproj, int M, int D, void* stream) {
  return sky::tp_bwd_finish<sky::bf16>(x, ln_scale, g, dy, part, dx, dscale, dbias, dbproj, M, D,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int sky_attn_block_tp_bwd_finish_f32(const void* x, const void* ln_scale,
                                                const void* g, const void* dy, void* part,
                                                void* dx, void* dscale, void* dbias, void* dbproj,
                                                int M, int D, void* stream) {
  return sky::tp_bwd_finish<float>(x, ln_scale, g, dy, part, dx, dscale, dbias, dbproj, M, D,
                                   static_cast<cudaStream_t>(stream));
}
