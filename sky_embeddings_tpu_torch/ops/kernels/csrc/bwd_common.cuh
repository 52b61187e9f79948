// Pieces shared by the attention-block and MLP-block backward kernels: the
// LayerNorm backward and deterministic column sums.
//
// The TPU kernels add each grid step's parameter gradients into outputs
// that stay resident across the sequential grid (attn_block.py:342-356,
// mlp_block.py:340-354). Hopper blocks run in parallel and in no order, so
// the sums over the B*N token rows go in two passes instead of atomics:
// each block writes the column sums of its ROWS_PER_PARTIAL rows to a
// partial row, and one thread per column adds the partials in order. Runs
// give the same bits, and the kernel-vs-plain bars stay stable.
#pragma once

#include "gemm.cuh"

namespace sky {

constexpr int ROWS_PER_PARTIAL = 32;  // mirrored by ROWS_PER_PARTIAL in the Python wrappers
constexpr int LNB_THREADS = 256;
constexpr int CS_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// LayerNorm backward over ROWS_PER_PARTIAL rows per block
// (attn_block.py:336-340, mlp_block.py:333-337):
//   xhat, rstd recomputed from x (fp32 two-pass statistics, eps 1e-6)
//   dxhat = dy * scale;  m1 = mean(dxhat);  m2 = mean(dxhat * xhat)
//   dx = bf16(g + rstd * (dxhat - m1 - xhat * m2))      (residual grad g added)
//   part_scale[blk, c] = sum_rows dy * xhat;  part_bias[blk, c] = sum_rows dy
// Row statistics: one warp per row; then one thread per column walks the
// block's rows (coalesced across the warp).
__global__ void __launch_bounds__(LNB_THREADS)
ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, const float* __restrict__ dy,
              const float* __restrict__ scale, bf16* __restrict__ dx, float* __restrict__ part_scale,
              float* __restrict__ part_bias, int M, int D) {
  __shared__ float s_mu[ROWS_PER_PARTIAL], s_rstd[ROWS_PER_PARTIAL], s_m1[ROWS_PER_PARTIAL],
      s_m2[ROWS_PER_PARTIAL];
  const int row0 = blockIdx.x * ROWS_PER_PARTIAL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(ROWS_PER_PARTIAL, M - row0);
  for (int rr = warp; rr < rows; rr += LNB_THREADS / 32) {
    const bf16* xr = x + (size_t)(row0 + rr) * D;
    const float* dyr = dy + (size_t)(row0 + rr) * D;
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += __bfloat162float(xr[k]);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float d = __bfloat162float(xr[k]) - mu;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-6f);
    float a1 = 0.f, a2 = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float dxh = dyr[k] * scale[k];
      a1 += dxh;
      a2 += dxh * (__bfloat162float(xr[k]) - mu) * rstd;
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s_mu[rr] = mu;
      s_rstd[rr] = rstd;
      s_m1[rr] = a1 / D;
      s_m2[rr] = a2 / D;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += LNB_THREADS) {
    const float sc = scale[c];
    float ps = 0.f, pb = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const size_t at = (size_t)(row0 + rr) * D + c;
      const float xhat = (__bfloat162float(x[at]) - s_mu[rr]) * s_rstd[rr];
      const float d = dy[at];
      const float dxhat = d * sc;
      dx[at] = __float2bfloat16_rn(__bfloat162float(g[at]) +
                                   s_rstd[rr] * (dxhat - s_m1[rr] - xhat * s_m2[rr]));
      ps += d * xhat;
      pb += d;
    }
    part_scale[(size_t)blockIdx.x * D + c] = ps;
    part_bias[(size_t)blockIdx.x * D + c] = pb;
  }
}

// part[blk, c] = sum of in[r, c] over the block's ROWS_PER_PARTIAL rows, in
// fp32; with cast_out, also cast_out[r, c] = bf16(in[r, c]) (dqkv -> dqkv_c).
template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
colsum_partial_kernel(const T* __restrict__ in, int M, int C, float* __restrict__ part,
                      bf16* __restrict__ cast_out) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= C) return;
  const int row0 = blockIdx.y * ROWS_PER_PARTIAL;
  const int row1 = min(M, row0 + ROWS_PER_PARTIAL);
  float s = 0.f;
  for (int r = row0; r < row1; ++r) {
    const float v = to_f32(in[(size_t)r * C + c]);
    s += v;
    if (cast_out) cast_out[(size_t)r * C + c] = __float2bfloat16_rn(v);
  }
  part[(size_t)blockIdx.y * C + c] = s;
}

// out[c] = sum over the partial rows, in order.
__global__ void __launch_bounds__(CS_THREADS)
colsum_final_kernel(const float* __restrict__ part, int parts, int C, float* __restrict__ out) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += part[(size_t)k * C + c];
  out[c] = s;
}

inline int n_partials(int M) { return (M + ROWS_PER_PARTIAL - 1) / ROWS_PER_PARTIAL; }

template <typename T>
cudaError_t launch_colsum_partial(const void* in, int M, int C, float* part, void* cast_out,
                                  cudaStream_t s) {
  const dim3 grid((C + CS_THREADS - 1) / CS_THREADS, n_partials(M));
  colsum_partial_kernel<T><<<grid, CS_THREADS, 0, s>>>(static_cast<const T*>(in), M, C, part,
                                                       static_cast<bf16*>(cast_out));
  return cudaGetLastError();
}

inline cudaError_t launch_colsum_final(const float* part, int parts, int C, void* out,
                                       cudaStream_t s) {
  colsum_final_kernel<<<(C + CS_THREADS - 1) / CS_THREADS, CS_THREADS, 0, s>>>(
      part, parts, C, static_cast<float*>(out));
  return cudaGetLastError();
}

inline cudaError_t launch_ln_bwd(const void* x, const void* g, const float* dy, const void* scale,
                                 void* dx, float* part_scale, float* part_bias, int M, int D,
                                 cudaStream_t s) {
  ln_bwd_kernel<<<n_partials(M), LNB_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), dy,
      static_cast<const float*>(scale), static_cast<bf16*>(dx), part_scale, part_bias, M, D);
  return cudaGetLastError();
}

}  // namespace sky

// Evaluate a launch; return its error code from the enclosing C entry point.
#define SKY_TRY(call)                                   \
  do {                                                  \
    const cudaError_t sky_err_ = (call);                \
    if (sky_err_ != cudaSuccess) return static_cast<int>(sky_err_); \
  } while (0)
