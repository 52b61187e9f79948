// Attention-block forward for Hopper (sm_90a):
//
//   out = x + (MHA(LN(x) @ Wqkv + bqkv)) @ Wproj + bproj
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/attn_block.py:
// _pallas_fwd (_fwd_kernel / _fwd_kernel_loop), the primal of
// fused_attn_block (entry sky_attn_block_fwd); and _pallas_fwd_stash
// (_fwd_stash_kernel / _fwd_stash_kernel_loop), the training forward (entry
// sky_attn_block_fwd_stash), which also hands back qkv (B, N, 3D) and the
// softmax probabilities (B, H, N, N), both bf16, for the stash backward
// (attn_block_bwd.cu). The two differ only there: the stash forward's qkv
// buffer is an output instead of scratch, and the attention core also
// stores each probability row it rounds to bf16.
//
// Packed segments (seg_len > 0, MAE sequence packing): the N tokens are
// N / seg_len samples, and token i attends to key j only when i / seg_len ==
// j / seg_len. JAX adds -1e9 to every other logit (attn_block.py _seg_bias),
// so their exp underflows to exactly 0; here each softmax row runs over its
// own segment's keys [s * seg_len, (s + 1) * seg_len) and writes exact zeros
// elsewhere, the stashed rows included, which is the same function. The QK^T
// and PV products stay whole-tile: the zero probabilities contribute nothing
// to ctx, and a 16-row tile that straddles two segments stays exact.
// seg_len = 0 or >= N means no mask.
//
// Four launches behind one C entry point:
//   0. LayerNorm (gemm.cuh)               -> y (B, N, D) bf16
//   1. qkv GEMM + bias                    -> qkv (B, N, 3D) bf16
//   2. attention core (attn_core.cuh): CTAs walk (sample, head) pairs
//      through a two-stage cp.async ring of k, v and q; each warp owns 16
//      query rows, QK^T and PV on the tensor cores (mma.sync, fp32
//      accumulate), S and P in registers, fp32 softmax, probs rounded to
//      bf16 before the PV product, ctx rounded to bf16 -> ctx (B, N, D)
//   3. proj GEMM + bias + fp32 residual  -> out (B, N, D) bf16
// Both products run on the persistent wgmma + TMA GEMM of gemm_sm90.cuh.
// y, qkv and ctx go through device memory exactly where the TPU kernel
// rounds them to bf16 (attn_block.py:141, :145, :126, :130), so the numerics
// match.
//
// Bound on the H100: the two GEMMs carry ~96% of the FLOPs and are
// compute-bound at the serving shapes; the attention core is small
// (N = 65: 4*N*N*hd FLOP per head) and bound by its loads and softmax.
// With the GEMMs on wgmma (PERF.md), what is left is the qkv and ctx round
// trips through device memory and the core's own time. The stash adds
// B*H*N*N*2 bytes of probability writes (6.5 MB at B = 64, N = 65), which
// the backward then need not recompute.
//
// The attention core (attn_core_kernel) lives in attn_core.cuh, shared with
// kernel 12 (attention.cu), which launches it alone on a given qkv.
#include "attn_core.cuh"
#include "gemm_sm90.cuh"

// Returns 0, or the first CUDA error a launch reported. qkv (B, N, 3D) and
// ctx (B, N, D) are allocated by the caller; the LN output is staged in
// `out`, which the last launch overwrites once it is dead. With `probs`
// (B, H, N, N) the core also stores the bf16 probabilities. seg_len > 0
// masks attention to packed segments of seg_len tokens.
static int attn_block_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
                          void* qkv, void* ctx, void* probs, void* out, int B, int N, int D, int H,
                          int seg_len, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::launch_gemm_sm90<EPI_BIAS>(out, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * D, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_core(qkv, ctx, probs, B, N, D, H, seg_len, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::launch_gemm_sm90<EPI_BIAS_RESIDUAL>(ctx, wproj, bproj, x, out, nullptr, M, D, D, s);
  return static_cast<int>(err);
}

// Shared-memory bytes of the core's plan at (N, hd); the wrappers refuse
// what exceeds the block's limit.
extern "C" long long sky_attn_fwd_plan_bytes(int N, int hd) {
  return static_cast<long long>(sky::AttnPlan(N, hd).bytes());
}

extern "C" int sky_attn_block_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, void* qkv, void* ctx, void* out, int B, int N,
                                  int D, int H, int seg_len, void* stream) {
  return attn_block_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, qkv, ctx, nullptr, out, B,
                        N, D, H, seg_len, stream);
}

extern "C" int sky_attn_block_fwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* wqkv, const void* bqkv, const void* wproj,
                                        const void* bproj, void* qkv, void* ctx, void* probs,
                                        void* out, int B, int N, int D, int H, int seg_len,
                                        void* stream) {
  return attn_block_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, qkv, ctx, probs, out, B,
                        N, D, H, seg_len, stream);
}
