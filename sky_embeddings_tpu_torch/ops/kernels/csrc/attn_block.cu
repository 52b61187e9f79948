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
//   0. LayerNorm                          -> y (B, N, D) bf16
//   1. qkv GEMM + bias                    -> qkv (B, N, 3D) bf16
//   2. attention core, one CTA per (sample, head): q, k, v of N x hd in
//      shared memory, QK^T and PV on the tensor cores (wmma, fp32
//      accumulate), fp32 softmax, probs rounded to bf16 before the PV
//      product, ctx rounded to bf16          -> ctx (B, N, D)
//   3. proj GEMM + bias + fp32 residual  -> out (B, N, D) bf16
// y, qkv and ctx go through device memory exactly where the TPU kernel
// rounds them to bf16 (attn_block.py:141, :145, :126, :130), so the numerics
// match.
//
// Bound on the H100: the two GEMMs carry ~96% of the FLOPs and are
// compute-bound at the serving shapes; the attention core is small
// (N = 65: 4*N*N*hd FLOP per head) and bound by its loads and softmax.
// Keeping qkv and ctx on chip and moving the GEMMs to wgmma are the first
// speed changes. The stash adds B*H*N*N*2 bytes of probability writes (6.5 MB
// at B = 64, N = 65), which the backward then need not recompute.
#include <math_constants.h>

#include "gemm.cuh"

namespace sky {

constexpr int ATTN_THREADS = 128;

// Shared-memory plan of one (sample, head) CTA. N is padded to NP (a
// multiple of 16); queries go in blocks of QB rows (all of them at N <= 128,
// else 64; fewer, down to 16, where a wide head would not fit the block's
// 227 KB otherwise: 32 at hd = 128, N = 256).
//   Ks, Vs  NP x (hd + 8) bf16     keys and values, zero past N
//   Qs      QB x (hd + 8) bf16     one query block, zero past N
//   Ps      QB x (NP + 8) bf16     probabilities, rounded to bf16
//   Ss      QB x SL fp32           logits, then the fp32 context
// Every row pitch is a multiple of 8 bf16 (hd % 16 == 0), so each wmma tile
// of 16 rows starts 32-byte aligned: hd = 80 gives HL = 88, five 16-wide
// tiles and ten 16-byte vectors per head row.
struct AttnPlan {
  int NP, QB, HL, PL, SL;
  __host__ __device__ AttnPlan(int N, int hd) {
    NP = (N + 15) & ~15;
    QB = NP <= 128 ? NP : 64;
    HL = hd + 8;
    PL = NP + 8;
    SL = (NP > hd ? NP : hd) + 4;
    while (bytes() > SMEM_OPTIN_MAX && QB > 16) QB = QB > 64 ? 64 : QB / 2;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(2 * NP * HL + QB * HL + QB * PL) * sizeof(bf16) + (size_t)QB * SL * sizeof(float);
  }
};

__global__ void __launch_bounds__(ATTN_THREADS)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, bf16* __restrict__ probs,
                 int N, int D, int H, int hd, int seg_len, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const AttnPlan pl(N, hd);
  const int NP = pl.NP, QB = pl.QB, HL = pl.HL, PL = pl.PL, SL = pl.SL;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + NP * HL;
  bf16* Qs = Vs + NP * HL;
  bf16* Ps = Qs + QB * HL;
  float* Ss = reinterpret_cast<float*>(Ps + QB * PL);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int NW = ATTN_THREADS / 32;
  const int vpr = hd / 8;  // 16-byte vectors per head row
  const bf16* src = qkv + (size_t)b * N * 3 * D + (size_t)h * hd;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = threadIdx.x; idx < NP * vpr; idx += ATTN_THREADS) {
    const int n = idx / vpr;
    const int c = (idx % vpr) * 8;
    const bf16* row = src + (size_t)n * 3 * D + c;
    *reinterpret_cast<uint4*>(Ks + n * HL + c) = n < N ? *reinterpret_cast<const uint4*>(row + D) : zero;
    *reinterpret_cast<uint4*>(Vs + n * HL + c) = n < N ? *reinterpret_cast<const uint4*>(row + 2 * D) : zero;
  }

  for (int q0 = 0; q0 < N; q0 += QB) {
    for (int idx = threadIdx.x; idx < QB * vpr; idx += ATTN_THREADS) {
      const int r = idx / vpr;
      const int c = (idx % vpr) * 8;
      const int n = q0 + r;
      *reinterpret_cast<uint4*>(Qs + r * HL + c) =
          n < N ? *reinterpret_cast<const uint4*>(src + (size_t)n * 3 * D + c) : zero;
    }
    __syncthreads();

    // logits S = Q K^T on the tensor cores, fp32
    const int tm = QB / 16, tn = NP / 16, tv = hd / 16;
    for (int t = warp; t < tm * tn; t += NW) {
      const int i = t / tn, j = t % tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < hd; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;  // K^T
        wmma::load_matrix_sync(fa, Qs + 16 * i * HL + k, HL);
        wmma::load_matrix_sync(fb, Ks + 16 * j * HL + k, HL);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + 16 * i * SL + 16 * j, acc, SL, wmma::mem_row_major);
    }
    __syncthreads();

    // fp32 softmax of scale * S over the row's keys [lo, hi) (all N of them,
    // or its segment's), one warp per row; probabilities rounded to bf16,
    // zero elsewhere; with `probs` (the stash forward) each real row is also
    // stored at probs[b, h, q0 + r, :]
    for (int r = warp; r < QB; r += NW) {
      float* srow = Ss + r * SL;
      bf16* prow = Ps + r * PL;
      int lo, hi;
      seg_keys(q0 + r, N, seg_len, lo, hi);
      float mx = -CUDART_INF_F;
      for (int j = lo + lane; j < hi; j += 32) {
        const float z = srow[j] * scale;
        srow[j] = z;
        mx = fmaxf(mx, z);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lo + lane; j < hi; j += 32) {
        const float e = expf(srow[j] - mx);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      bf16* grow = probs && q0 + r < N ? probs + (((size_t)b * H + h) * N + q0 + r) * N : nullptr;
      for (int j = lane; j < NP; j += 32) {
        const bf16 pv = __float2bfloat16_rn(j >= lo && j < hi ? srow[j] / sum : 0.f);
        prow[j] = pv;
        if (grow && j < N) grow[j] = pv;
      }
    }
    __syncthreads();

    // context = P V, fp32, staged in Ss (the logits are dead)
    for (int t = warp; t < tm * tv; t += NW) {
      const int i = t / tv, j = t % tv;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < NP; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + 16 * i * PL + k, PL);
        wmma::load_matrix_sync(fb, Vs + k * HL + 16 * j, HL);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + 16 * i * SL + 16 * j, acc, SL, wmma::mem_row_major);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < QB * vpr; idx += ATTN_THREADS) {
      const int r = idx / vpr;
      const int c = (idx % vpr) * 8;
      const int n = q0 + r;
      if (n < N) {
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16_rn(Ss[r * SL + c + e]);
        *reinterpret_cast<uint4*>(ctx + ((size_t)b * N + n) * D + (size_t)h * hd + c) = o;
      }
    }
    __syncthreads();  // Qs and Ss are rewritten by the next query block
  }
}

}  // namespace sky

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
  const int hd = D / H;
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, out, M, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS>(gemm_args(out, wqkv, bqkv, nullptr, qkv, M, 3 * D, D), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = AttnPlan(N, hd).bytes();
  if (smem > SMEM_OPTIN_MAX) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(attn_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_core_kernel<<<B * H, ATTN_THREADS, smem, s>>>(static_cast<const bf16*>(qkv),
                                                     static_cast<bf16*>(ctx),
                                                     static_cast<bf16*>(probs), N, D, H, hd,
                                                     seg_len, 1.0f / sqrtf(static_cast<float>(hd)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_gemm<EPI_BIAS_RESIDUAL>(gemm_args(ctx, wproj, bproj, x, out, M, D, D), s);
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
