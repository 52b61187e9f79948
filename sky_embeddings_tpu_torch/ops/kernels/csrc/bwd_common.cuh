// Pieces shared by the attention-block and MLP-block backward kernels: the
// LayerNorm backward and deterministic column sums.
//
// The TPU kernels add each grid step's parameter gradients into outputs
// that stay resident across the sequential grid (attn_block.py:342-356,
// mlp_block.py:340-354). Hopper blocks run in parallel and in no order, so
// the sums over the B*N token rows go in two passes instead of atomics:
// each block writes the column sums of its ROWS_PER_PARTIAL rows to a
// partial row, and a second launch adds the partials in a fixed order. Runs
// give the same bits, and the kernel-vs-plain bars stay stable.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sky {

constexpr int ROWS_PER_PARTIAL = 32;  // mirrored by ROWS_PER_PARTIAL in the Python wrappers
constexpr int CS_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// LayerNorm backward over ROWS_PER_PARTIAL rows per block
// (attn_block.py:336-340, mlp_block.py:333-337), on bf16 x, g and dx (the
// blocks' bf16 forms) or fp32 ones (their fp32 forms):
//   xhat, rstd recomputed from x (fp32 two-pass statistics, eps 1e-6)
//   dxhat = dy * scale;  m1 = mean(dxhat);  m2 = mean(dxhat * xhat)
//   dx = T(g + rstd * (dxhat - m1 - xhat * m2))         (residual grad g added)
//   part_scale[blk, c] = sum_rows dy * xhat;  part_bias[blk, c] = sum_rows dy
//   part_g[blk, c] = sum_rows g, where the row is held in registers (CH > 0:
//   the bf16 tensor-parallel finish's output-bias gradient, the sums of
//   colsum_partial_kernel without a pass of its own over g)
// Row statistics: one warp per row, read in 16-byte vectors (8 bf16 or two
// float4 of x, two float4 of dy and scale per lane and step; the wrappers
// require D % 8 == 0), once a pass (CH = 0) or, for the bf16 tensor-parallel
// finish, once into registers (CH chunks, as layernorm_kernel), the sums
// taken in the passes' order. Then each thread walks the block's rows for two
// columns (bf16x2 / float2), adding each column's rows in row order. 16
// warps a block keep more bytes in flight than scalar 2-byte loads did
// (PERF.md PR 10).
constexpr int LNB_THREADS = 512;

// eight elements of a row of x, read in one 16-byte vector (bf16) or two
// (fp32) and widened to fp32 where each is used
template <typename T>
struct Row8;
template <>
struct Row8<bf16> {
  uint4 u;
  __device__ __forceinline__ explicit Row8(const bf16* p) : u(*reinterpret_cast<const uint4*>(p)) {}
  __device__ __forceinline__ float operator[](int j) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&u)[j]);
  }
};
template <>
struct Row8<float> {
  float e[8];
  __device__ __forceinline__ explicit Row8(const float* p) { load8(p, e); }
  __device__ __forceinline__ float operator[](int j) const { return e[j]; }
};

// two elements (columns c, c + 1) of a row, as the column pass reads and
// writes them
__device__ __forceinline__ float2 ln_load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ln_load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void ln_store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void ln_store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int CH>
__global__ void __launch_bounds__(LNB_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ dy,
              const float* __restrict__ scale, T* __restrict__ dx, float* __restrict__ part_scale,
              float* __restrict__ part_bias, float* __restrict__ part_g, int M, int D) {
  __shared__ float s_mu[ROWS_PER_PARTIAL], s_rstd[ROWS_PER_PARTIAL], s_m1[ROWS_PER_PARTIAL],
      s_m2[ROWS_PER_PARTIAL];
  const int row0 = blockIdx.x * ROWS_PER_PARTIAL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(ROWS_PER_PARTIAL, M - row0);
  for (int rr = warp; rr < rows; rr += LNB_THREADS / 32) {
    const T* xr = x + (size_t)(row0 + rr) * D;
    const float* dyr = dy + (size_t)(row0 + rr) * D;
    float mu, rstd, a1 = 0.f, a2 = 0.f;
    if constexpr (CH > 0) {
      // the row held in registers, its sums in the order of the passes below
      float e[CH][8];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (lane * 8 + 256 * c < D) load8(xr + lane * 8 + 256 * c, e[c]);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (lane * 8 + 256 * c < D) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s += e[c][j];
        }
      mu = warp_sum(s) / D;
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (lane * 8 + 256 * c < D) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = e[c][j] - mu;
            q += d * d;
          }
        }
      rstd = rsqrtf(warp_sum(q) / D + 1e-6f);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int k = lane * 8 + 256 * c;
        if (k >= D) continue;
        float dv[8], cv[8];
        load8(dyr + k, dv);
        load8(scale + k, cv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dxh = dv[j] * cv[j];
          a1 += dxh;
          a2 += dxh * (e[c][j] - mu) * rstd;
        }
      }
    } else {
      float s = 0.f;
      for (int k = lane * 8; k < D; k += 256) {
        const Row8<T> e(xr + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += e[j];
      }
      mu = warp_sum(s) / D;
      float q = 0.f;
      for (int k = lane * 8; k < D; k += 256) {
        const Row8<T> e(xr + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = e[j] - mu;
          q += d * d;
        }
      }
      rstd = rsqrtf(warp_sum(q) / D + 1e-6f);
      for (int k = lane * 8; k < D; k += 256) {
        const Row8<T> e(xr + k);
        float dv[8], cv[8];
        load8(dyr + k, dv);
        load8(scale + k, cv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dxh = dv[j] * cv[j];
          a1 += dxh;
          a2 += dxh * (e[j] - mu) * rstd;
        }
      }
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
  for (int c = 2 * threadIdx.x; c < D; c += 2 * LNB_THREADS) {
    const float2 sc = *reinterpret_cast<const float2*>(scale + c);
    float ps0 = 0.f, ps1 = 0.f, pb0 = 0.f, pb1 = 0.f, pg0 = 0.f, pg1 = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < rows; ++rr) {
      const size_t at = (size_t)(row0 + rr) * D + c;
      const float2 xv = ln_load2(x + at);
      const float2 gv = ln_load2(g + at);
      const float2 d = *reinterpret_cast<const float2*>(dy + at);
      const float xh0 = (xv.x - s_mu[rr]) * s_rstd[rr], xh1 = (xv.y - s_mu[rr]) * s_rstd[rr];
      const float o0 = gv.x + s_rstd[rr] * (d.x * sc.x - s_m1[rr] - xh0 * s_m2[rr]);
      const float o1 = gv.y + s_rstd[rr] * (d.y * sc.y - s_m1[rr] - xh1 * s_m2[rr]);
      ln_store2(dx + at, o0, o1);
      ps0 += d.x * xh0;
      ps1 += d.y * xh1;
      pb0 += d.x;
      pb1 += d.y;
      if constexpr (CH > 0) {
        pg0 += gv.x;
        pg1 += gv.y;
      }
    }
    *reinterpret_cast<float2*>(part_scale + (size_t)blockIdx.x * D + c) = make_float2(ps0, ps1);
    *reinterpret_cast<float2*>(part_bias + (size_t)blockIdx.x * D + c) = make_float2(pb0, pb1);
    if constexpr (CH > 0)
      *reinterpret_cast<float2*>(part_g + (size_t)blockIdx.x * D + c) = make_float2(pg0, pg1);
  }
}

// part[blk, c] = sum of in[r, c] over the block's ROWS_PER_PARTIAL rows, in
// fp32.
template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
colsum_partial_kernel(const T* __restrict__ in, int M, int C, float* __restrict__ part) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= C) return;
  const int row0 = blockIdx.y * ROWS_PER_PARTIAL;
  const int row1 = min(M, row0 + ROWS_PER_PARTIAL);
  float s = 0.f;
  for (int r = row0; r < row1; ++r) s += to_f32(in[(size_t)r * C + c]);
  part[(size_t)blockIdx.y * C + c] = s;
}

inline int n_partials(int M) { return (M + ROWS_PER_PARTIAL - 1) / ROWS_PER_PARTIAL; }

// out[c] = sum of part[k, c] over the partial rows, for up to four (part,
// out) jobs in one launch: job blockIdx.y, 32 columns a block, its 8 warps
// each adding every 8th partial row in order, then the 8 warp sums added in
// warp order. A fixed order, so runs give the same bits.
struct ColsumJob {
  const float* part;  // (parts, C)
  float* out;         // (C,)
  int parts, C;
};
struct ColsumJobs {
  ColsumJob j[4];
};

__global__ void __launch_bounds__(CS_THREADS) colsum_final_kernel(const ColsumJobs jobs) {
  __shared__ float red[CS_THREADS / 32][32];
  const ColsumJob& job = jobs.j[blockIdx.y];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  if (blockIdx.x * 32 >= job.C) return;  // block-uniform
  float s = 0.f;
  if (c < job.C)
    for (int k = grp; k < job.parts; k += CS_THREADS / 32) s += job.part[(size_t)k * job.C + c];
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && c < job.C) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < CS_THREADS / 32; ++w) t += red[w][lane];
    job.out[c] = t;
  }
}

inline cudaError_t launch_colsum_finals(const ColsumJob* jobs, int count, cudaStream_t s) {
  if (count < 1 || count > 4) return cudaErrorInvalidValue;
  ColsumJobs p;
  int c_max = 0;
  for (int i = 0; i < count; ++i) {
    p.j[i] = jobs[i];
    c_max = max(c_max, jobs[i].C);
  }
  colsum_final_kernel<<<dim3((c_max + 31) / 32, count), CS_THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_colsum_partial(const void* in, int M, int C, float* part, cudaStream_t s) {
  const dim3 grid((C + CS_THREADS - 1) / CS_THREADS, n_partials(M));
  colsum_partial_kernel<T><<<grid, CS_THREADS, 0, s>>>(static_cast<const T*>(in), M, C, part);
  return cudaGetLastError();
}

inline cudaError_t launch_colsum_final(const float* part, int parts, int C, void* out,
                                       cudaStream_t s) {
  const ColsumJob job{part, static_cast<float*>(out), parts, C};
  return launch_colsum_finals(&job, 1, s);
}

template <typename T = bf16>
inline cudaError_t launch_ln_bwd(const void* x, const void* g, const float* dy, const void* scale,
                                 void* dx, float* part_scale, float* part_bias, int M, int D,
                                 cudaStream_t s) {
  ln_bwd_kernel<T, 0><<<n_partials(M), LNB_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dy, static_cast<const float*>(scale),
      static_cast<T*>(dx), part_scale, part_bias, nullptr, M, D);
  return cudaGetLastError();
}

// The LN backward of the bf16 tensor-parallel finish: the row held in
// registers, and g's column partials into part_g; D > LN_REG_CHUNKS * 256
// refused.
inline cudaError_t launch_ln_bwd_held(const void* x, const void* g, const float* dy,
                                      const void* scale, void* dx, float* part_scale,
                                      float* part_bias, float* part_g, int M, int D,
                                      cudaStream_t s) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(g);
  const float* sp = static_cast<const float*>(scale);
  bf16* dxp = static_cast<bf16*>(dx);
  const int blocks = n_partials(M);
  switch (ln_chunks(D)) {  // common.cuh: the row's registers, by its chunks
    case 1:
      ln_bwd_kernel<bf16, 1><<<blocks, LNB_THREADS, 0, s>>>(xp, gp, dy, sp, dxp, part_scale,
                                                             part_bias, part_g, M, D);
      break;
    case 2:
      ln_bwd_kernel<bf16, 2><<<blocks, LNB_THREADS, 0, s>>>(xp, gp, dy, sp, dxp, part_scale,
                                                             part_bias, part_g, M, D);
      break;
    case 3:
      ln_bwd_kernel<bf16, 3><<<blocks, LNB_THREADS, 0, s>>>(xp, gp, dy, sp, dxp, part_scale,
                                                             part_bias, part_g, M, D);
      break;
    case 4:
      ln_bwd_kernel<bf16, 4><<<blocks, LNB_THREADS, 0, s>>>(xp, gp, dy, sp, dxp, part_scale,
                                                             part_bias, part_g, M, D);
      break;
    case 5:
      ln_bwd_kernel<bf16, 5><<<blocks, LNB_THREADS, 0, s>>>(xp, gp, dy, sp, dxp, part_scale,
                                                             part_bias, part_g, M, D);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace sky

// Evaluate a launch; return its error code from the enclosing C entry point.
#define SKY_TRY(call)                                   \
  do {                                                  \
    const cudaError_t sky_err_ = (call);                \
    if (sky_err_ != cudaSuccess) return static_cast<int>(sky_err_); \
  } while (0)

namespace sky {

// The tensor-parallel blocks' backward finish (attn_block_bwd.cu,
// mlp_block_bwd.cu), after the all-reduce of the ranks' fp32 partials of
// dy, the gradient of the LN output: the LN backward (dx = g + ..., the
// partials of dscale and dbias) and the output bias's gradient (bproj or
// b2: the column sums of g; in bf16 summed by the LN backward's column pass
// as it reads g, its row held in registers), the three added in order in
// one launch, as the whole blocks' last launches do. part: 3 D * ceil(M /
// 32) floats.
template <typename T>
inline int tp_bwd_finish(const void* x, const void* ln_scale, const void* g, const void* dy,
                         void* part, void* dx, void* dscale, void* dbias, void* dbout, int M,
                         int D, cudaStream_t s) {
  const int parts = n_partials(M);
  float* part_out = static_cast<float*>(part);          // parts x D
  float* part_scale = part_out + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;    // parts x D
  const float* dyf = static_cast<const float*>(dy);
  if constexpr (std::is_same<T, bf16>::value) {
    SKY_TRY(launch_ln_bwd_held(x, g, dyf, ln_scale, dx, part_scale, part_bias, part_out, M, D, s));
  } else {
    SKY_TRY(launch_ln_bwd<T>(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
    SKY_TRY(launch_colsum_partial<T>(g, M, D, part_out, s));
  }
  const ColsumJob jobs[3] = {{part_out, static_cast<float*>(dbout), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 3, s));
  return 0;
}

}  // namespace sky
