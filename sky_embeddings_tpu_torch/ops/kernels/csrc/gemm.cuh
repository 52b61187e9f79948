// Shared bf16 GEMM and LayerNorm for the attention-block and MLP-block kernels.
//
//   out[M, N] = epilogue(A[M, K] @ B[K, N] + bias[N])
//
// A and B are bf16 row-major; B is the JAX (in, out) kernel layout. The
// product runs on the tensor cores through nvcuda::wmma (16x16x16 bf16
// fragments, fp32 accumulators). One CTA of 8 warps owns a 128x128 output
// tile; each warp owns 64x32 of it (4x2 fragments, so 6 fragment loads feed
// 8 MMAs). K is walked in 32-wide slabs through a ring of STAGES
// shared-memory buffers filled by cp.async, so STAGES - 1 slabs of loads
// are in flight while one is multiplied, with one barrier per slab.
// Ragged edges are masked: rows past M and columns past K load as zero
// (cp.async zero-fill), and the epilogue stores only in-range rows and
// columns. K and N must be multiples of 8 (16-byte vectors), which the
// Python wrappers check.
//
// Epilogues (fp32 until the final store, which rounds to bf16), applied per
// 16x16 fragment through a per-warp staging tile:
//   EPI_BIAS           acc + bias                    (qkv, attn_block.py:143-145)
//   EPI_BIAS_GELU      erf-GELU(acc + bias)          (fc1 -> h, mlp_block.py:234-240)
//   EPI_BIAS_RESIDUAL  resid + (acc + bias)          (proj / fc2 + residual,
//                                                     attn_block.py:153, mlp_block.py:243)
//
// layernorm_bf16 computes the LN that opens both blocks: fp32 two-pass
// statistics per row (eps 1e-6), output rounded to bf16 -- the rounding
// point of the TPU kernels (attn_block.py:141, mlp_block.py:235).
//
// What bounds it on the H100: at the serving shapes (M = B*65 rows, K and N
// 768..3072) these products are compute-bound (about 200 bf16 FLOP per byte
// moved). wmma (mma.sync) reaches the tensor cores but not their full rate,
// which only wgmma with TMA-fed shared memory gives; that is the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
constexpr int A_LD = BK + 8;  // padded bf16 row strides: keep wmma pointers
constexpr int B_LD = BN + 8;  // 32-byte aligned and smem reads conflict-free
constexpr int A_STAGE = BM * A_LD;  // bf16 elements per ring slot
constexpr int B_STAGE = BK * B_LD;
constexpr size_t GEMM_SMEM =
    (size_t)STAGES * (A_STAGE + B_STAGE) * sizeof(__nv_bfloat16) +
    (size_t)(GEMM_THREADS / 32) * 16 * 16 * sizeof(float);

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

struct GemmArgs {
  const bf16* a;      // (M, K)
  const bf16* b;      // (K, N)
  const float* bias;  // (N,)
  const bf16* resid;  // (M, N), EPI_BIAS_RESIDUAL only
  bf16* out;          // (M, N)
  int M, N, K;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
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

// One K slab into ring slot (As, Bs): 512 + 512 16-byte vectors, 4 per thread.
__device__ __forceinline__ void load_slab(const GemmArgs& p, int m0, int n0, int k0, bf16* As,
                                          bf16* Bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    const int r = v >> 2, c = (v & 3) * 8;  // A: 128 rows x 4 vectors
    const int m = m0 + r, k = k0 + c;
    const bool ok = m < p.M && k < p.K;
    cp_async16(As + r * A_LD + c, ok ? p.a + (size_t)m * p.K + k : p.a, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    const int r = v >> 4, c = (v & 15) * 8;  // B: 32 rows x 16 vectors
    const int k = k0 + r, n = n0 + c;
    const bool ok = k < p.K && n < p.N;
    cp_async16(Bs + r * B_LD + c, ok ? p.b + (size_t)k * p.N + n : p.b, ok);
  }
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_bf16_kernel(GemmArgs p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* stage = reinterpret_cast<float*>(Bs + STAGES * B_STAGE);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * (FM * 16);  // this warp's 64x32 sub-tile
  const int wn = (warp % WARPS_N) * (FN * 16);
  const int nk = (p.K + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slab(p, m0, n0, s * BK, As + s * A_STAGE, Bs + s * B_STAGE);
    cp_async_commit();  // one group per slot, empty past the end
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed (for this thread)
    __syncthreads();              // ... for every thread; slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int slot = nxt % STAGES;
      load_slab(p, m0, n0, nxt * BK, As + slot * A_STAGE, Bs + slot * B_STAGE);
    }
    cp_async_commit();
    const bf16* a_s = As + (kt % STAGES) * A_STAGE;
    const bf16* b_s = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], a_s + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + wn + 16 * j, B_LD);
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
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c + e] + p.bias[n + e];
        if (EPI == EPI_BIAS_GELU) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
        }
        if (EPI == EPI_BIAS_RESIDUAL) {
          const uint4 rv = *reinterpret_cast<const uint4*>(p.resid + (size_t)m * p.N + n);
          const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(re[e]) + v[e];
        }
        uint4 ov;
        bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16_rn(v[e]);
        *reinterpret_cast<uint4*>(p.out + (size_t)m * p.N + n) = ov;
      }
      __syncwarp();
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(GEMM_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_bf16_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(p);
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

inline GemmArgs gemm_args(const void* a, const void* b, const void* bias, const void* resid,
                          void* out, int M, int N, int K) {
  GemmArgs p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.bias = static_cast<const float*>(bias);
  p.resid = static_cast<const bf16*>(resid);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  return p;
}

}  // namespace sky
