// What the port's CUDA sources share: the bf16 type, the shared-memory
// limit, the epilogue names of the GEMM (gemm_sm90.cuh), warp reductions,
// the packed-segment key range of the attention cores (attn_core.cuh),
// erf-GELU and its derivative for the epilogues, the mma.sync and ldmatrix
// fragments, the resident grid of a persistent kernel, wgmma's descriptor,
// fences and groups, cp.async, the ordered
// split-K reduce of the backward group launch and the LayerNorm that opens
// every block.
//
// layernorm_kernel computes that LN: fp32 two-pass statistics per row (eps
// 1e-6), output rounded to bf16 -- the rounding point of the TPU kernels
// (attn_block.py:141, mlp_block.py:235) -- or, in the blocks' fp32 forms,
// kept in fp32. One warp a row, 16-byte loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sky {

using bf16 = __nv_bfloat16;

// dynamic shared memory one block may use on sm_90 (the opt-in limit);
// mirrored by SMEM_PER_BLOCK in the Python attention wrappers
constexpr size_t SMEM_OPTIN_MAX = 232448;

// The epilogues of gemm_sm90.cuh's products (described there), by the numbers
// the C entries and ops/kernels/gemm.py pass.
enum Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_STORE = 3,
  EPI_STORE_F32 = 4,
  EPI_BIAS_GELU_STASH = 7,
  EPI_ADD_F32 = 9,
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

// gelu_erf(a) and its derivative d gelu_erf / da (mlp_block.py:218-219,
// with erff for the A-S erf), with one erff
__device__ __forceinline__ void gelu_erf_and_grad(float a, float& gelu, float& grad) {
  const float e = erff(a * 0.70710678118654752f);
  gelu = 0.5f * a * (1.0f + e);
  grad = 0.5f * (1.0f + e) + a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

// gelu(a) and d gelu / da with the TPU kernels' own erf (Abramowitz-Stegun
// 7.1.26, mlp_block.py:201-219), whose exp(-x^2) at x = a / sqrt(2) is the
// derivative's exp(-a^2 / 2): one fast reciprocal and one fast exp serve
// both (the stash dh product's epilogue).
__device__ __forceinline__ void gelu_as_and_grad(float a, float& gelu, float& grad) {
  const float t = __fdividef(1.0f, fmaf(0.3275911f * 0.70710678118654752f, fabsf(a), 1.0f));
  float poly = fmaf(t, 1.061405429f, -1.453152027f);
  poly = fmaf(t, poly, 1.421413741f);
  poly = fmaf(t, poly, -0.284496736f);
  poly = fmaf(t, poly, 0.254829592f);
  const float e = __expf(-0.5f * a * a);
  const float half_erf1 = 0.5f + copysignf(fmaf(-poly * t, e, 1.0f), a) * 0.5f;  // (1 + erf) / 2
  gelu = a * half_erf1;
  grad = fmaf(a * e, 0.39894228040143268f, half_erf1);
}

// mma.sync m16n8k16 and ldmatrix, as the attention cores (attn_core.cuh) and
// the multi-query bank scorer (simscore_multi.cu) use them
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8m..8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 fp32
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the card's SM count (the GEMMs' tile and split plans), read once
inline cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// as many CTAs as are resident on the card at once, at most `work`
template <typename K>
inline int resident_grid(K kernel, int threads, size_t smem, int work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  return static_cast<int>(cap < work ? cap : work);
}

// wgmma (gemm_sm90.cuh, simscore_multi.cu). Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma: each register is an operand of an empty asm.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory writes of this thread made visible to the async proxy (TMA
// stores, wgmma operands read through descriptors).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// The split-K reduce of gemm_sm90.cuh's weight gradients: out[r, c] =
// bf16(sum over the slices z of ws[z * MN + r * N + c]), in order; out's
// rows ldc apart; 4 per thread (N % 4 == 0, ldc % 4 == 0).
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

// 8 consecutive elements as fp32, and back (16-byte loads and stores: one
// vector of bf16, two of fp32): the LayerNorm's rows
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 o;
  bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = o;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

constexpr int LN_THREADS = 256;  // one warp per row
// The bf16 tensor-parallel backward forms (attn_block_tp.cu, mlp_block_bwd.cu)
// hold a row of up to LN_REG_CHUNKS * 256 elements (ViT-H's 1 280) in
// registers, CH = ceil(K / 256) chunks of eight elements a lane (one
// instantiation for each CH, so a narrow row holds no more registers than
// it fills); every other launch reads the row once a pass (CH = 0).
constexpr int LN_REG_CHUNKS = 5;

inline int ln_chunks(int K) {
  const int ch = (K + 255) / 256;
  return ch <= LN_REG_CHUNKS ? ch : 0;
}

// The held-row LN of one row of K, one warp: e[c] holds the row's
// elements lane * 8 + 256 c .. + 7 (those below K) on entry and their
// LN(x) * scale + bias on return, in fp32. The sums run over the lane's
// chunks in order, then the warp. The bf16 TP forms' LN launch and K2 TP's
// fused forward half (attn_block_tp.cu) share it.
template <int CH>
__device__ __forceinline__ void ln_row_held(float (&e)[CH][8], const float* __restrict__ scale,
                                            const float* __restrict__ bias, int lane, int K) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (lane * 8 + 256 * c < K) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s += e[c][j];
    }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (lane * 8 + 256 * c < K) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = e[c][j] - mu;
        q += d * d;
      }
    }
  const float rstd = rsqrtf(warp_sum(q) / K + 1e-6f);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = lane * 8 + 256 * c;
    if (k >= K) continue;
    float sc[8], bi[8];
    load8(scale + k, sc);
    load8(bias + k, bi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = (e[c][j] - mu) * rstd;
      e[c][j] = xhat * sc[j] + bi[j];
    }
  }
}

// y = LN(x) * scale + bias over rows of K (K % 8 == 0), fp32 stats; x and y
// bf16 (y rounded) or fp32. The sums run over a lane's chunks in order,
// then the warp, whether the row is held in registers (CH > 0) or read
// again for each pass (CH = 0).
template <typename T, int CH>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, int M, int K) {
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const T* xr = x + (size_t)row * K;
  T* yr = y + (size_t)row * K;
  if constexpr (CH > 0) {
    float e[CH][8];
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (lane * 8 + 256 * c < K) load8(xr + lane * 8 + 256 * c, e[c]);
    ln_row_held<CH>(e, scale, bias, lane, K);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (lane * 8 + 256 * c < K) store8(yr + lane * 8 + 256 * c, e[c]);
  } else {
    float s = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      float e[8];
      load8(xr + k, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += e[j];
    }
    const float mu = warp_sum(s) / K;
    float q = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      float e[8];
      load8(xr + k, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = e[j] - mu;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / K + 1e-6f);
    for (int k = lane * 8; k < K; k += 256) {
      float e[8], o[8];
      load8(xr + k, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = (e[j] - mu) * rstd;
        o[j] = xhat * scale[k + j] + bias[k + j];
      }
      store8(yr + k, o);
    }
  }
}

// The tensor-parallel blocks' finish (attn_block.cu, mlp_block.cu), after
// the all-reduce of the ranks' fp32 partial products of proj or fc2:
// out = T(x + (part + bias)) over (M, D), the order of EPI_BIAS_RESIDUAL's
// epilogue, which the whole blocks fuse into that product. Eight elements a
// thread (D % 8 == 0, 16-byte loads): a pass at memory rate.
template <typename T>
__global__ void __launch_bounds__(256)
bias_residual_kernel(const T* __restrict__ x, const float* __restrict__ part,
                     const float* __restrict__ bias, T* __restrict__ out, size_t n8, int D) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const size_t e0 = 8 * i;
  const int c = static_cast<int>(e0 % D);
  float xv[8], pv[8], bv[8], o[8];
  load8(x + e0, xv);
  load8(part + e0, pv);
  load8(bias + c, bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = xv[j] + (pv[j] + bv[j]);
  store8(out + e0, o);
}

template <typename T>
inline cudaError_t launch_bias_residual(const void* x, const void* part, const void* bias,
                                        void* out, int M, int D, cudaStream_t stream) {
  if (M <= 0 || D <= 0 || D % 8) return cudaErrorInvalidValue;
  const size_t n8 = (size_t)M * D / 8;
  bias_residual_kernel<T><<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(part), static_cast<const float*>(bias),
      static_cast<T*>(out), n8, D);
  return cudaGetLastError();
}

template <typename T = bf16>
inline cudaError_t launch_layernorm(const void* x, const void* scale, const void* bias, void* y,
                                    int M, int K, cudaStream_t stream) {
  const int rows_per_cta = LN_THREADS / 32;
  layernorm_kernel<T, 0><<<(M + rows_per_cta - 1) / rows_per_cta, LN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), M, K);
  return cudaGetLastError();
}

// The LN of the bf16 tensor-parallel halves' chains: the row held in
// registers; K > LN_REG_CHUNKS * 256 refused.
inline cudaError_t launch_layernorm_held(const void* x, const void* scale, const void* bias,
                                         void* y, int M, int K, cudaStream_t stream) {
  const dim3 grid((M + LN_THREADS / 32 - 1) / (LN_THREADS / 32));
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  bf16* yp = static_cast<bf16*>(y);
  switch (ln_chunks(K)) {
    case 1: layernorm_kernel<bf16, 1><<<grid, LN_THREADS, 0, stream>>>(xp, sp, bp, yp, M, K); break;
    case 2: layernorm_kernel<bf16, 2><<<grid, LN_THREADS, 0, stream>>>(xp, sp, bp, yp, M, K); break;
    case 3: layernorm_kernel<bf16, 3><<<grid, LN_THREADS, 0, stream>>>(xp, sp, bp, yp, M, K); break;
    case 4: layernorm_kernel<bf16, 4><<<grid, LN_THREADS, 0, stream>>>(xp, sp, bp, yp, M, K); break;
    case 5: layernorm_kernel<bf16, 5><<<grid, LN_THREADS, 0, stream>>>(xp, sp, bp, yp, M, K); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace sky
