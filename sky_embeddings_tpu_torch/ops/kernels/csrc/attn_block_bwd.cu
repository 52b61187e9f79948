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
//   3. backward core, one CTA per (sample, head), query blocks of QB rows:
//        kernel 4: S = Q K^T (fp32), P = softmax(S * hd^-0.5) in fp32, kept
//        in shared memory beside its bf16 copy (K2's arithmetic)    (:191-193)
//        ctx = bf16(P_bf16 V)                                         (:318)
//        dp = dc V^T;  ds = bf16((dp * P - P * rowsum(dp * P)) * hd^-0.5)
//        with P fp32 (kernel 4) or the stashed bf16 P (kernel 3)
//        dq = ds K;  dk = ds^T Q;  dv = P_bf16^T dc, all fp32 -> dqkv fp32 (:321-328)
//      P^T and ds^T are read from the row-major tiles as col_major wmma
//      fragments. dk and dv sum over every query block: the CTA owns its
//      (sample, head) slice of dqkv, so it adds each block's products into
//      it in order, without atomics.
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
// operation-bound; the first version runs on the wmma GEMM of gemm.cuh, and
// dqkv's fp32 round trip (M * 3D * 4 bytes written and read twice) is the
// first byte cost to remove.
//
// Shared memory: kernel 3's core needs 226 KB of the 227 KB a CTA may use at
// N = 256, hd = 64; kernel 4 keeps an fp32 P tile beside the bf16 one, so it
// takes smaller query blocks (64 rows past N = 64, 32 past N = 128): 183 KB
// at N = 256, 107 KB at N = 66 (two CTAs per SM).
#include <math_constants.h>

#include "bwd_common.cuh"

namespace sky {

constexpr int ATTN_BWD_THREADS = 256;

// Shared-memory plan of one (sample, head) CTA. N is padded to NP (a
// multiple of 16); queries go in blocks of QB rows.
//   Ks, Vs    NP x (hd + 8) bf16     keys and values, zero past N
//   Qs, dCs   QB x (hd + 8) bf16     one query block of q and dc, zero past N
//   Ps, dSs   QB x (NP + 8) bf16     probabilities (stashed or recomputed), then ds
//   Ss        fp32: dp (QB x (NP + 4)), then per-warp 16 x 16 staging tiles
//   Pf        RECOMPUTE only: fp32 logits, then fp32 P (QB x (NP + 4))
// Kernel 3 at N = 256, hd = 64: 226,304 bytes, inside the 232,448 a CTA may
// use. Where a wide head would not fit, QB shrinks (to 64, 32, then 16):
// kernel 3 at hd = 80, N = 256 takes QB = 32 (168,448 bytes), at hd = 128
// too (223,744); kernel 4 at hd = 80 needs 116,224 bytes at N = 66 and
// 201,728 at N = 256, at hd = 128, N = 256 QB = 16 (198,144). At hd = 192,
// N = 256 no plan fits, and the wrappers refuse it. dk and dv then sum over more query blocks, in
// order. Row pitches stay multiples of 8 bf16, so wmma tiles start 32-byte
// aligned at any hd % 16 == 0 (hd = 80: pitch 88, five 16-wide tiles).
template <bool RECOMPUTE>
struct AttnBwdPlan {
  int NP, QB, HL, PL, SL;
  __host__ __device__ AttnBwdPlan(int N, int hd) {
    NP = (N + 15) & ~15;
    if (RECOMPUTE)
      QB = NP <= 64 ? NP : (NP <= 128 ? 64 : 32);
    else
      QB = NP <= 128 ? NP : 64;
    HL = hd + 8;
    PL = NP + 8;
    SL = NP + 4;
    while (bytes() > SMEM_OPTIN_MAX && QB > 16) QB = QB > 64 ? 64 : QB / 2;
  }
  // fp32 elements of Ss: dp, or the warps' 16 x 16 staging tiles
  __host__ __device__ int ss() const {
    const int staging = (ATTN_BWD_THREADS / 32) * 256;
    return QB * SL > staging ? QB * SL : staging;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(2 * NP * HL + 2 * QB * HL + 2 * QB * PL) * sizeof(bf16) +
           (size_t)(ss() + (RECOMPUTE ? QB * SL : 0)) * sizeof(float);
  }
};

template <bool RECOMPUTE>
__global__ void __launch_bounds__(ATTN_BWD_THREADS)
attn_bwd_core_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                     const bf16* __restrict__ dc, bf16* __restrict__ ctx, float* __restrict__ dqkv,
                     int N, int D, int H, int hd, int seg_len, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const AttnBwdPlan<RECOMPUTE> pl(N, hd);
  const int NP = pl.NP, QB = pl.QB, HL = pl.HL, PL = pl.PL, SL = pl.SL;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + NP * HL;
  bf16* Qs = Vs + NP * HL;
  bf16* dCs = Qs + QB * HL;
  bf16* Ps = dCs + QB * HL;
  bf16* dSs = Ps + QB * PL;
  float* Ss = reinterpret_cast<float*>(dSs + QB * PL);
  float* Pf = Ss + pl.ss();  // RECOMPUTE only

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int NW = ATTN_BWD_THREADS / 32;
  const int vpr = hd / 8;  // 16-byte vectors per head row
  const size_t D3 = 3 * (size_t)D;
  const bf16* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  const bf16* psrc = RECOMPUTE ? nullptr : probs + ((size_t)b * H + h) * N * N;
  const bf16* dcsrc = dc + (size_t)b * N * D + (size_t)h * hd;
  float* dst = dqkv + (size_t)b * N * D3 + (size_t)h * hd;  // + 0 / D / 2D: dq / dk / dv
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = threadIdx.x; idx < NP * vpr; idx += ATTN_BWD_THREADS) {
    const int n = idx / vpr;
    const int c = (idx % vpr) * 8;
    const bf16* row = src + (size_t)n * D3 + c;
    *reinterpret_cast<uint4*>(Ks + n * HL + c) = n < N ? *reinterpret_cast<const uint4*>(row + D) : zero;
    *reinterpret_cast<uint4*>(Vs + n * HL + c) = n < N ? *reinterpret_cast<const uint4*>(row + 2 * D) : zero;
  }

  const int tm = QB / 16, tn = NP / 16, tv = hd / 16;
  float* st = Ss + warp * 256;  // this warp's 16 x 16 staging tile (after the ds pass)
  const int sr = lane >> 1, sc = (lane & 1) * 8;

  for (int q0 = 0; q0 < N; q0 += QB) {
    for (int idx = threadIdx.x; idx < QB * vpr; idx += ATTN_BWD_THREADS) {
      const int r = idx / vpr;
      const int c = (idx % vpr) * 8;
      const int n = q0 + r;
      *reinterpret_cast<uint4*>(Qs + r * HL + c) =
          n < N ? *reinterpret_cast<const uint4*>(src + (size_t)n * D3 + c) : zero;
      *reinterpret_cast<uint4*>(dCs + r * HL + c) =
          n < N ? *reinterpret_cast<const uint4*>(dcsrc + (size_t)n * D + c) : zero;
    }
    // probability rows are N long, not 16-byte aligned in general: bf16 loads
    if (!RECOMPUTE) {
      for (int idx = threadIdx.x; idx < QB * NP; idx += ATTN_BWD_THREADS) {
        const int r = idx / NP;
        const int j = idx % NP;
        const int n = q0 + r;
        Ps[r * PL + j] = n < N && j < N ? psrc[(size_t)n * N + j] : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();

    if (RECOMPUTE) {
      // logits S = Q K^T, fp32 (QB x NP), into Pf
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
        wmma::store_matrix_sync(Pf + 16 * i * SL + 16 * j, acc, SL, wmma::mem_row_major);
      }
      __syncthreads();
      // fp32 softmax of scale * S over the row's keys [lo, hi), one warp per
      // row, as the forward core computes it; P stays fp32 in Pf (for ds)
      // and bf16 in Ps (for ctx and dv), zero outside [lo, hi) and on query
      // rows past N
      for (int r = warp; r < QB; r += NW) {
        float* srow = Pf + r * SL;
        bf16* prow = Ps + r * PL;
        if (q0 + r >= N) {  // warp-uniform
          for (int j = lane; j < NP; j += 32) {
            srow[j] = 0.f;
            prow[j] = __float2bfloat16_rn(0.f);
          }
          continue;
        }
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
        for (int j = lane; j < NP; j += 32) {
          const float p = j >= lo && j < hi ? srow[j] / sum : 0.f;
          srow[j] = p;
          prow[j] = __float2bfloat16_rn(p);
        }
      }
      // the dp pass below reads neither Pf nor Ps; the barrier after it
      // orders both for the ds pass
    }

    // dp = dC V^T, fp32 (QB x NP)
    for (int t = warp; t < tm * tn; t += NW) {
      const int i = t / tn, j = t % tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < hd; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;  // V^T
        wmma::load_matrix_sync(fa, dCs + 16 * i * HL + k, HL);
        wmma::load_matrix_sync(fb, Vs + 16 * j * HL + k, HL);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + 16 * i * SL + 16 * j, acc, SL, wmma::mem_row_major);
    }
    __syncthreads();

    // softmax backward, one warp per row, over the N real keys:
    // ds = (dp * p - p * sum(dp * p)) * scale, rounded to bf16, zero past N;
    // p is the recomputed fp32 P (kernel 4) or the stashed bf16 P (kernel 3),
    // 0 outside a packed row's segment, where ds is then 0 as well
    for (int r = warp; r < QB; r += NW) {
      float* srow = Ss + r * SL;
      const bf16* prow = Ps + r * PL;
      const float* pfrow = Pf + r * SL;
      float s = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float t = srow[j] * (RECOMPUTE ? pfrow[j] : __bfloat162float(prow[j]));
        srow[j] = t;
        s += t;
      }
      s = warp_sum(s);
      for (int j = lane; j < NP; j += 32) {
        const float p = j < N ? (RECOMPUTE ? pfrow[j] : __bfloat162float(prow[j])) : 0.f;
        const float v = j < N ? (srow[j] - p * s) * scale : 0.f;
        dSs[r * PL + j] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();

    // Four products per query block, their 16 x 16 tiles dealt round-robin
    // to the warps: ctx = P V and dq = dS K (this block's rows), and
    // dv += P^T dC, dk += dS^T Q (all NP key rows).
    const int n_row = tm * tv, n_key = tn * tv;
    for (int t = warp; t < 2 * n_row + 2 * n_key; t += NW) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      int task, i, j;
      if (t < 2 * n_row) {
        task = t / n_row;  // 0: ctx, 1: dq
        i = (t % n_row) / tv;
        j = (t % n_row) % tv;
        const bf16* A = task == 0 ? Ps : dSs;
        const bf16* Bm = task == 0 ? Vs : Ks;
        for (int k = 0; k < NP; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + 16 * i * PL + k, PL);
          wmma::load_matrix_sync(fb, Bm + k * HL + 16 * j, HL);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      } else {
        const int u = t - 2 * n_row;
        task = 2 + u / n_key;  // 2: dv, 3: dk
        i = (u % n_key) / tv;
        j = (u % n_key) % tv;
        const bf16* A = task == 2 ? Ps : dSs;    // read transposed: (key, query)
        const bf16* Bm = task == 2 ? dCs : Qs;
        for (int k = 0; k < QB; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + k * PL + 16 * i, PL);
          wmma::load_matrix_sync(fb, Bm + k * HL + 16 * j, HL);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int n = (task < 2 ? q0 : 0) + 16 * i + sr;
      const int col = 16 * j + sc;
      if (n < N) {
        const float* v = st + sr * 16 + sc;
        if (task == 0) {
          uint4 o;
          bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
          for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16_rn(v[e]);
          *reinterpret_cast<uint4*>(ctx + ((size_t)b * N + n) * D + (size_t)h * hd + col) = o;
        } else {
          float4* out = reinterpret_cast<float4*>(dst + (size_t)n * D3 + (size_t)(task == 1 ? 0 : task == 3 ? D : 2 * D) + col);
          float4 v0 = make_float4(v[0], v[1], v[2], v[3]);
          float4 v1 = make_float4(v[4], v[5], v[6], v[7]);
          if (task >= 2 && q0 > 0) {  // dk, dv: add this query block's share
            const float4 o0 = out[0], o1 = out[1];
            v0 = make_float4(o0.x + v0.x, o0.y + v0.y, o0.z + v0.z, o0.w + v0.w);
            v1 = make_float4(o1.x + v1.x, o1.y + v1.y, o1.z + v1.z, o1.w + v1.w);
          }
          out[0] = v0;
          out[1] = v1;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every shared tile is rewritten by the next query block
  }
}

}  // namespace sky

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
  const int hd = D / H;
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

  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  if (recompute) {
    const size_t smem = AttnBwdPlan<true>(N, hd).bytes();
    if (smem > SMEM_OPTIN_MAX) return static_cast<int>(cudaErrorInvalidValue);
    SKY_TRY(cudaFuncSetAttribute(attn_bwd_core_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    attn_bwd_core_kernel<true><<<B * H, ATTN_BWD_THREADS, smem, s>>>(
        static_cast<const bf16*>(qkv), nullptr, static_cast<const bf16*>(dc),
        static_cast<bf16*>(ctx), static_cast<float*>(dqkv), N, D, H, hd, seg_len, scale);
  } else {
    const size_t smem = AttnBwdPlan<false>(N, hd).bytes();
    if (smem > SMEM_OPTIN_MAX) return static_cast<int>(cudaErrorInvalidValue);
    SKY_TRY(cudaFuncSetAttribute(attn_bwd_core_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    attn_bwd_core_kernel<false><<<B * H, ATTN_BWD_THREADS, smem, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs),
        static_cast<const bf16*>(dc), static_cast<bf16*>(ctx), static_cast<float*>(dqkv), N, D, H,
        hd, 0, scale);
  }
  SKY_TRY(cudaGetLastError());

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

// Shared-memory bytes of kernel 3's (recompute = 0) or kernel 4's core plan
// at (N, hd); the wrappers refuse what exceeds the block's limit.
extern "C" long long sky_attn_bwd_plan_bytes(int N, int hd, int recompute) {
  return static_cast<long long>(recompute ? sky::AttnBwdPlan<true>(N, hd).bytes()
                                          : sky::AttnBwdPlan<false>(N, hd).bytes());
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
