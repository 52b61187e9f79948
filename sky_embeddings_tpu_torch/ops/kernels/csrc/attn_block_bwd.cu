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
// (attn_block.py:282-356 and :156-235):
//   1. LayerNorm of x                         -> y = bf16 LN output   (:298-299)
//   1b. kernel 4 only: qkv = bf16(y @ Wqkv + bqkv)                     (:174-175)
//   2. dctx = g @ Wproj^T, rounded            -> dc bf16              (:302-303, :320)
//   3. backward core (attn_core.cuh), one CTA per (sample, head), query
//      blocks of QB rows (the whole head at N <= 128):
//        kernel 4: S = Q K^T (fp32), P = softmax(S * hd^-0.5) in fp32, in
//        registers beside its bf16 copy (K2's arithmetic)           (:191-193)
//        ctx = bf16(P_bf16 V)                                         (:318)
//        dp = dc V^T;  ds = bf16((dp * P - P * rowsum(dp * P)) * hd^-0.5)
//        with P fp32 (kernel 4) or the stashed bf16 P (kernel 3)
//        dq = ds K;  dk = ds^T Q;  dv = P_bf16^T dc, all fp32 -> dqkv fp32 (:321-328)
//      P^T and ds^T are read from the block's bf16 tiles in shared memory
//      through ldmatrix.trans. dk and dv sum over the query blocks in
//      registers and shared memory, each key row by one warp in block
//      order, without atomics and never in device memory.
//   4. dqkv -> bf16 dqkv_c, and its column sums   (dbqkv from fp32, :354)
//   5. dy = dqkv_c @ Wqkv^T, fp32                                     (:334)
//   6. LN backward -> dx, dscale / dbias partials                     (:336-340)
//   7. dWqkv = y^T @ dqkv_c, dWproj = ctx^T @ g: bf16 (the weight dtype,
//      attn_block.py:1176-1178), GEMMs over K = B*N split into slices that
//      are added in order (launch_weight_grad, gemm.cuh)
//   8. dbproj = column sums of g; the partial sums added in order.
// Parameter gradient sums are two-pass (bwd_common.cuh), so runs give the
// same bits.
//
// Bound on the H100: ~8 M D^2 FLOP in the four GEMMs (kernel 4: 6 M D^2 more
// for the qkv recompute) plus 8 B H N^2 hd in the core (kernel 4: 10):
// operation-bound; the GEMMs run on the wmma GEMM of gemm.cuh, and dqkv's
// fp32 round trip (M * 3D * 4 bytes written and read twice) is the largest
// byte cost left.
//
// Shared memory (AttnBwdPlan, attn_core.cuh): 74 240 bytes at N = 65,
// hd = 64 (three CTAs per SM); kernels 3 and 4 share the plan.
//
// The backward core (attn_bwd_core_kernel) lives in attn_core.cuh, shared with
// kernel 13 (attention.cu), which runs the recompute core alone.
#include "attn_core.cuh"
#include "bwd_common.cuh"

// Returns 0, or the first CUDA error a launch reported. The caller allocates
// the scratch (y, dc, ctx: (M, D) bf16; dqkv: (M, 3D) fp32; dqkv_c: (M, 3D)
// bf16; dy: (M, D) fp32; part: (4D + 2D) * ceil(M / 32) fp32; ws: 8 * 3D^2
// fp32) and the outputs (dx (B, N, D) bf16; dscale, dbias, dbproj (D,) and
// dbqkv (3D,) fp32; dwqkv (D, 3D) and dwproj (D, D) bf16). Kernel 3 reads
// the stashed `qkv` and `probs`; kernel 4 (`recompute`) writes `qkv` (scratch,
// (M, 3D) bf16) from `bqkv` and reads no probabilities.
static int attn_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                          const void* probs, const void* g, void* y, void* dc, void* ctx,
                          void* dqkv, void* dqkv_c, void* dy, void* part, void* ws, void* dx,
                          void* dscale, void* dbias, void* dwqkv, void* dbqkv, void* dwproj,
                          void* dbproj, int B, int N, int D, int H, int seg_len, bool recompute,
                          void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const int parts = n_partials(M);
  float* part_qkv = static_cast<float*>(part);            // parts x 3D
  float* part_proj = part_qkv + (size_t)parts * 3 * D;    // parts x D
  float* part_scale = part_proj + (size_t)parts * D;      // parts x D
  float* part_bias = part_scale + (size_t)parts * D;      // parts x D
  float* dyf = static_cast<float*>(dy);

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  if (recompute)
    SKY_TRY(launch_gemm<EPI_BIAS>(gemm_args(y, wqkv, bqkv, nullptr, qkv, M, 3 * D, D), s));
  SKY_TRY((launch_gemm<EPI_STORE, false, true>(gemm_args(g, wproj, nullptr, nullptr, dc, M, D, D), s)));

  if (recompute)
    SKY_TRY(launch_attn_bwd_core<true>(qkv, nullptr, dc, ctx, dqkv, B, N, D, H, seg_len, s));
  else
    SKY_TRY(launch_attn_bwd_core<false>(qkv, probs, dc, ctx, dqkv, B, N, D, H, 0, s));

  SKY_TRY(launch_colsum_partial<float>(dqkv, M, 3 * D, part_qkv, dqkv_c, s));
  SKY_TRY((launch_gemm<EPI_STORE_F32, false, true>(
      gemm_args(dqkv_c, wqkv, nullptr, nullptr, nullptr, M, D, 3 * D, dyf), s)));
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  float* wsf = static_cast<float*>(ws);
  SKY_TRY(launch_weight_grad(y, dqkv_c, dwqkv, D, 3 * D, M, wsf, s));
  SKY_TRY(launch_weight_grad(ctx, g, dwproj, D, D, M, wsf, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_proj, nullptr, s));

  SKY_TRY(launch_colsum_final(part_qkv, parts, 3 * D, dbqkv, s));
  SKY_TRY(launch_colsum_final(part_proj, parts, D, dbproj, s));
  SKY_TRY(launch_colsum_final(part_scale, parts, D, dscale, s));
  SKY_TRY(launch_colsum_final(part_bias, parts, D, dbias, s));
  return 0;
}

// Shared-memory bytes of the backward core's plan at (N, hd), kernel 3's
// and kernel 4's alike; the wrappers refuse what exceeds the block's limit.
extern "C" long long sky_attn_bwd_plan_bytes(int N, int hd) {
  return static_cast<long long>(sky::AttnBwdPlan(N, hd).bytes());
}

// Kernel 3: the gradients from the stashed qkv (B, N, 3D) and probs (B, H, N, N).
extern "C" int sky_attn_block_bwd_stash(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* wproj,
    const void* qkv, const void* probs, const void* g, void* y, void* dc, void* ctx, void* dqkv,
    void* dqkv_c, void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int H, void* stream) {
  return attn_block_bwd(x, ln_scale, ln_bias, wqkv, nullptr, wproj, const_cast<void*>(qkv), probs,
                        g, y, dc, ctx, dqkv, dqkv_c, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv,
                        dwproj, dbproj, B, N, D, H, 0, false, stream);
}

// Kernel 4: the gradients from x and g alone; qkv is (B, N, 3D) bf16 scratch;
// seg_len > 0 masks attention to packed segments of seg_len tokens.
extern "C" int sky_attn_block_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* dqkv_c, void* dy, void* part, void* ws, void* dx, void* dscale, void* dbias, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int H, int seg_len, void* stream) {
  return attn_block_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, nullptr, g, y, dc, ctx, dqkv,
                        dqkv_c, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj, B, N,
                        D, H, seg_len, true, stream);
}
