// Shared bf16 GEMM (wmma) and LayerNorm for the attention-block and
// MLP-block kernels.
//
//   out[M, N] = epilogue(op(A)[M, K] @ op(B)[K, N])
//
// A and B are bf16 and row-major in memory. op(A) is A as stored (M, K), or,
// with TA, the transpose of a stored (K, M) matrix; op(B) is B as stored
// (K, N) -- the JAX (in, out) kernel layout -- or, with TB, the transpose of
// a stored (N, K) matrix. Its last caller is kernel 7 (the MLP stash
// backward): it reads a weight as (out, in) with TB (g @ W2^T: dh; da_c @
// W1^T: dy) and reduces over the token rows with TA (y^T @ da_c, h_c^T @
// g: the weight gradients, where K = B*N rows is ragged and zero-fills).
// No operand is copied to transpose it: the slab loads read along the
// contiguous axis and wmma takes the tile as a col_major fragment. The
// product runs on the tensor cores through nvcuda::wmma (16x16x16 bf16
// fragments, fp32 accumulators). One CTA of 8 warps owns a 128x128 output
// tile; each warp owns 64x32 of it (4x2 fragments, so 6 fragment loads feed
// 8 MMAs). K is walked in 32-wide slabs through a ring of STAGES
// shared-memory buffers filled by cp.async, so STAGES - 1 slabs of loads
// are in flight while one is multiplied, with one barrier per slab.
// Ragged edges are masked: rows past M and columns past K load as zero
// (cp.async zero-fill), and the epilogue stores only in-range rows and
// columns. The contiguous axis of each stored operand (K or M for A, N or
// K for B) and N must be multiples of 8 (16-byte vectors), which the
// Python wrappers check. Every output element is one thread's fp32 sum in
// a fixed order, so a product is bit-reproducible run to run.
//
// Split-K (launch_weight_grad): the weight-gradient products have a small
// (in, out) output -- 36 to 144 tiles of 128 x 128 at ViT-B, fewer than the
// 264 CTAs two per SM would hold -- and a long K = B*N. They split K into
// slices over blockIdx.z; each slice writes its fp32 partial tile to a
// workspace, and splitk_reduce adds the slices in order and rounds to bf16,
// so the result stays bit-reproducible. (gemm_sm90.cuh's weight gradients
// use the same reduce.)
//
// Epilogues of this GEMM (fp32 until the final store, which rounds to
// bf16), applied per 16x16 fragment through a per-warp staging tile. The
// enum also names the epilogues of gemm_sm90.cuh, which runs every forward
// product and the backward products of kernels 3, 4, 8 and 9.
//   EPI_STORE          acc                           (weight gradients cast to bf16:
//                                                     mlp_block.py:954)
//   EPI_STORE_F32      acc, fp32 out                 (dy, kept fp32 for the LN backward;
//                                                     the split-K partials)
//   EPI_GELU_BWD_STASH da = acc * gelu'(a) with a the bf16 stash in `stash`;
//                      out_f32 = da (fp32, for db1), out = bf16(da),
//                      out2 = bf16(gelu(a))          (kernel 7, mlp_block.py:393-399)
//
// layernorm_bf16 computes the LN that opens both blocks: fp32 two-pass
// statistics per row (eps 1e-6), output rounded to bf16 -- the rounding
// point of the TPU kernels (attn_block.py:141, mlp_block.py:235).
//
// What bounds it on the H100: at the training shapes (M = B*65 rows, K and
// N 768..3072) these products are compute-bound (about 200 bf16 FLOP per
// byte moved). wmma (mma.sync) reaches the tensor cores but not their full
// rate (90-180 TFLOP/s here). gemm_sm90.cuh (wgmma fed by TMA) has the
// forward form and the two backward forms (B K-major, A MN-major); kernel
// 7 moves to it next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace sky {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int GEMM_THREADS = 256;
constexpr int WARPS_N = 4;    // 2 x 4 warps, each a 64x32 warp tile
constexpr int FM = 4;         // 16-row fragments per warp tile
constexpr int FN = 2;         // 16-col fragments per warp tile
// dynamic shared memory one block may use on sm_90 (the opt-in limit);
// mirrored by SMEM_PER_BLOCK in the Python attention wrappers
constexpr size_t SMEM_OPTIN_MAX = 232448;

// Shared-memory tiles of one ring slot, as stored: A (BM x BK), or with TA
// its transpose (BK x BM); B (BK x BN), or with TB (BN x BK). Rows are
// padded by 8 bf16: wmma pointers stay 32-byte aligned and smem reads
// conflict-free.
template <bool TA, bool TB>
struct GemmLayout {
  static constexpr int A_LD = TA ? BM + 8 : BK + 8;
  static constexpr int B_LD = TB ? BK + 8 : BN + 8;
  static constexpr int A_STAGE = TA ? BK * A_LD : BM * A_LD;  // bf16 elements per ring slot
  static constexpr int B_STAGE = TB ? BN * B_LD : BK * B_LD;
  static constexpr size_t SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * sizeof(__nv_bfloat16) +
                                 (size_t)(GEMM_THREADS / 32) * 16 * 16 * sizeof(float);
};

enum Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_STORE = 3,
  EPI_STORE_F32 = 4,
  EPI_BIAS_GELU_STASH = 7,
  EPI_GELU_BWD_STASH = 8,
  EPI_ADD_F32 = 9,
};

struct GemmArgs {
  const bf16* a;      // (M, K), or (K, M) with TA
  const bf16* b;      // (K, N), or (N, K) with TB
  const bf16* stash;  // (M, N): the stashed a of EPI_GELU_BWD_STASH
  bf16* out;          // (M, N) bf16 (not for EPI_STORE_F32)
  float* out_f32;     // (M, N) fp32: EPI_STORE_F32, EPI_GELU_BWD_STASH
  bf16* out2;         // (M, N) bf16: EPI_GELU_BWD_STASH
  int M, N, K;
  int k_split;        // with TA: K per blockIdx.z slice, a multiple of BK (K when
                      // unsplit); slice z writes its fp32 partial at out_f32 + z * M * N
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The keys [lo, hi) that query row n of an N-token sequence attends to: all
// N, or with packed segments (0 < seg_len < N) the seg_len-token segment that
// holds n, cut at N. A padding row past N takes the last real row's segment,
// so its softmax never runs over no keys.
__device__ __forceinline__ void seg_keys(int n, int N, int seg_len, int& lo, int& hi) {
  lo = 0;
  hi = N;
  if (seg_len > 0 && seg_len < N) {
    lo = (min(n, N - 1) / seg_len) * seg_len;
    hi = min(lo + seg_len, N);
  }
}

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// d gelu_erf / da (mlp_block.py:218-219, with erff for the A-S erf)
__device__ __forceinline__ float gelu_erf_grad(float a) {
  return 0.5f * (1.0f + erff(a * 0.70710678118654752f)) +
         a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

// gelu_erf(a) and gelu_erf_grad(a), the same bits, with one erff
__device__ __forceinline__ void gelu_erf_and_grad(float a, float& gelu, float& grad) {
  const float e = erff(a * 0.70710678118654752f);
  gelu = 0.5f * a * (1.0f + e);
  grad = 0.5f * (1.0f + e) + a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

// 16-byte global -> shared copy; when !pred it reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K slab into ring slot (As, Bs): 512 + 512 16-byte vectors, 2 + 2 per
// thread, each read along its operand's contiguous axis.
template <bool TA, bool TB>
__device__ __forceinline__ void load_slab(const GemmArgs& p, int m0, int n0, int k0, int k_end,
                                          bf16* As, bf16* Bs) {
  using L = GemmLayout<TA, TB>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    if (!TA) {
      const int r = v >> 2, c = (v & 3) * 8;  // A: 128 rows (m) x 4 vectors (k)
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < p.M && k < k_end;
      cp_async16(As + r * L::A_LD + c, ok ? p.a + (size_t)m * p.K + k : p.a, ok);
    } else {
      const int r = v >> 4, c = (v & 15) * 8;  // A^T: 32 rows (k) x 16 vectors (m)
      const int k = k0 + r, m = m0 + c;
      const bool ok = k < k_end && m < p.M;
      cp_async16(As + r * L::A_LD + c, ok ? p.a + (size_t)k * p.M + m : p.a, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    if (!TB) {
      const int r = v >> 4, c = (v & 15) * 8;  // B: 32 rows (k) x 16 vectors (n)
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < k_end && n < p.N;
      cp_async16(Bs + r * L::B_LD + c, ok ? p.b + (size_t)k * p.N + n : p.b, ok);
    } else {
      const int r = v >> 2, c = (v & 3) * 8;  // B^T: 128 rows (n) x 4 vectors (k)
      const int n = n0 + r, k = k0 + c;
      const bool ok = n < p.N && k < k_end;
      cp_async16(Bs + r * L::B_LD + c, ok ? p.b + (size_t)n * p.K + k : p.b, ok);
    }
  }
}

template <int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_bf16_kernel(GemmArgs p) {
  using namespace nvcuda;
  using L = GemmLayout<TA, TB>;
  using ALayout = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + STAGES * L::A_STAGE;
  float* stage = reinterpret_cast<float*>(Bs + STAGES * L::B_STAGE);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * (FM * 16);  // this warp's 64x32 sub-tile
  const int wn = (warp % WARPS_N) * (FN * 16);
  // this slice's K range [kb, ke): split-K runs only the transposed-A
  // (weight-gradient) products, so the others compile without it
  const int kb = TA ? blockIdx.z * p.k_split : 0;
  const int ke = TA ? min(p.K, kb + p.k_split) : p.K;
  const int nk = (ke - kb + BK - 1) / BK;
  float* out_f32 = TA ? p.out_f32 + (size_t)blockIdx.z * p.M * p.N : p.out_f32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slab<TA, TB>(p, m0, n0, kb + s * BK, ke, As + s * L::A_STAGE, Bs + s * L::B_STAGE);
    cp_async_commit();  // one group per slot, empty past the end
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed (for this thread)
    __syncthreads();              // ... for every thread; slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int slot = nxt % STAGES;
      load_slab<TA, TB>(p, m0, n0, kb + nxt * BK, ke, As + slot * L::A_STAGE,
                        Bs + slot * L::B_STAGE);
    }
    cp_async_commit();
    const bf16* a_s = As + (kt % STAGES) * L::A_STAGE;
    const bf16* b_s = Bs + (kt % STAGES) * L::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], TA ? a_s + (wm + 16 * i) + kk * L::A_LD
                                         : a_s + (wm + 16 * i) * L::A_LD + kk, L::A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], TB ? b_s + kk + (wn + 16 * j) * L::B_LD
                                         : b_s + kk * L::B_LD + wn + 16 * j, L::B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue, one 16x16 fragment at a time through this warp's staging
  // tile: lane -> row lane / 2, columns (lane % 2) * 8 .. + 8, 16-byte I/O.
  float* st = stage + warp * 16 * 16;
  const int r = lane >> 1;
  const int c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm + 16 * i + r;
      const int n = n0 + wn + 16 * j + c;
      if (m < p.M && n < p.N) {  // N % 8 == 0: the 8 columns are all in range
        const size_t at = (size_t)m * p.N + n;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c + e];
        if (EPI == EPI_GELU_BWD_STASH) {
          const uint4 sv = *reinterpret_cast<const uint4*>(p.stash + at);
          const bf16* se = reinterpret_cast<const bf16*>(&sv);
          uint4 hv;
          bf16* he = reinterpret_cast<bf16*>(&hv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float a = __bfloat162float(se[e]);
            v[e] *= gelu_erf_grad(a);
            he[e] = __float2bfloat16_rn(gelu_erf(a));
          }
          *reinterpret_cast<uint4*>(p.out2 + at) = hv;
        }
        if (EPI == EPI_STORE_F32 || EPI == EPI_GELU_BWD_STASH) {
          float4* op = reinterpret_cast<float4*>(out_f32 + at);
          op[0] = make_float4(v[0], v[1], v[2], v[3]);
          op[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        if (EPI != EPI_STORE_F32) {
          uint4 ov;
          bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16_rn(v[e]);
          *reinterpret_cast<uint4*>(p.out + at) = ov;
        }
      }
      __syncwarp();
    }
  }
}

inline GemmArgs gemm_args(const void* a, const void* b, const void* stash, void* out, int M, int N,
                          int K, void* out_f32 = nullptr, void* out2 = nullptr) {
  GemmArgs p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.stash = static_cast<const bf16*>(stash);
  p.out = static_cast<bf16*>(out);
  p.out_f32 = static_cast<float*>(out_f32);
  p.out2 = static_cast<bf16*>(out2);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_split = K;
  return p;
}

template <int EPI, bool TA = false, bool TB = false>
cudaError_t launch_gemm(GemmArgs p, cudaStream_t stream) {
  constexpr size_t smem = GemmLayout<TA, TB>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI, TA, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, (p.K + p.k_split - 1) / p.k_split);
  gemm_bf16_kernel<EPI, TA, TB><<<grid, GEMM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int MAX_SPLITS = 8;  // mirrored by MAX_SPLITS in the Python wrappers

// out[r, c] = bf16(sum over the slices z of ws[z * MN + r * N + c]), in
// order; out's rows ldc apart; 4 per thread (N % 4 == 0, ldc % 4 == 0).
__global__ void splitk_reduce_kernel(const float4* __restrict__ ws, int splits, size_t n4, int N,
                                     int ldc, bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const size_t r = 4 * i / N, c = 4 * i % N;
  float4 s = ws[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = ws[(size_t)z * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  uint2 o;
  bf16* oe = reinterpret_cast<bf16*>(&o);
  oe[0] = __float2bfloat16_rn(s.x);
  oe[1] = __float2bfloat16_rn(s.y);
  oe[2] = __float2bfloat16_rn(s.z);
  oe[3] = __float2bfloat16_rn(s.w);
  *reinterpret_cast<uint2*>(out + r * ldc + c) = o;
}

// out[M, N] = bf16(A^T @ B) for A stored (K, M) and B (K, N): a weight
// gradient summed over K = B*N token rows. The slices fill about two CTAs
// per SM, each at least 8 slabs long; ws holds MAX_SPLITS * M * N floats.
inline cudaError_t launch_weight_grad(const void* a, const void* b, void* out, int M, int N, int K,
                                      float* ws, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int nk = (K + BK - 1) / BK;
  int splits = (2 * sms + tiles - 1) / tiles;
  splits = min(splits, min(MAX_SPLITS, max(1, nk / 8)));
  const int k_split = ((nk + splits - 1) / splits) * BK;
  splits = (K + k_split - 1) / k_split;
  GemmArgs p = gemm_args(a, b, nullptr, out, M, N, K);
  if (splits == 1) return launch_gemm<EPI_STORE, true, false>(p, stream);
  p.out_f32 = ws;  // the slices' partials stay contiguous
  p.k_split = k_split;
  cudaError_t err = launch_gemm<EPI_STORE_F32, true, false>(p, stream);
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)M * N / 4;
  splitk_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), splits, n4, N, N, static_cast<bf16*>(out));
  return cudaGetLastError();
}

constexpr int LN_THREADS = 256;  // one warp per row

// y = bf16(LN(x) * scale + bias) over rows of K (K % 8 == 0), fp32 stats.
__global__ void __launch_bounds__(LN_THREADS)
layernorm_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ y, int M, int K) {
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const bf16* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + 1e-6f);
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = (__bfloat162float(e[j]) - mu) * rstd;
      oe[j] = __float2bfloat16_rn(xhat * scale[k + j] + bias[k + j]);
    }
    *reinterpret_cast<uint4*>(y + (size_t)row * K + k) = o;
  }
}

inline cudaError_t launch_layernorm(const void* x, const void* scale, const void* bias, void* y,
                                    int M, int K, cudaStream_t stream) {
  const int rows_per_cta = LN_THREADS / 32;
  layernorm_bf16_kernel<<<(M + rows_per_cta - 1) / rows_per_cta, LN_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(y), M, K);
  return cudaGetLastError();
}


}  // namespace sky
