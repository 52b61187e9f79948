// Standalone multi-head attention for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/attention.py:
// - kernel 12, fused_attention (_attn_kernel, attention.py:29-53): the
//   (B, N, 3D) fused qkv projection -> the (B, N, D) context, in qkv's dtype;
//   per (sample, head) S = Q K^T with fp32 accumulation, P = softmax(S *
//   hd^-0.5) in fp32, P cast to v's dtype, ctx = P V with fp32 accumulation.
//   Entries sky_attention_fwd (bf16) and sky_attention_fwd_f32.
// - kernel 13, _fused_attention_bwd_call (_attn_bwd_kernel, :104-138): qkv
//   and dctx -> dqkv (B, N, 3D) in qkv's dtype. P is recomputed in fp32; dV =
//   P_c^T dC, dP = dC V^T, dS = (P * dP - P * rowsum(P * dP)) * hd^-0.5
//   rounded to qkv's dtype, dQ = dS K, dK = dS^T Q. Entries
//   sky_attention_bwd (bf16) and sky_attention_bwd_f32.
//
// bf16: kernel 12 is K2's attention core (attn_core.cuh, attn_core_kernel)
// launched alone, without the stash and the mask; kernel 13 is kernel 4's
// recompute core (attn_bwd_core_kernel<true>) without its ctx product,
// writing dq, dk and dv straight to bf16, each rounded once from its fp32
// accumulator, as the TPU kernel rounds each of them once (:136-138). Both
// keep S, P and dS in registers (the backward also P and dS of a query
// block in shared memory for dK = dS^T Q and dV = P^T dC) and sum nothing
// in device memory.
//
// fp32: the TPU kernel takes fp32 qkv too (Attention's default dtype,
// models/layers.py:125). Here one CTA per (sample, head) holds K and V of
// N x hd in shared memory (rows padded by one float, so a warp reading 32
// keys' element d hits 32 banks) and computes on the CUDA cores with fp32
// FMAs, one warp per query row; P is never rounded. The backward runs in two
// passes over the same shared memory: by query rows (P, dP, the row sum
// delta_i = sum_j P_ij dP_ij, dS, dQ; it keeps each row's max, sum and
// delta), then, with Q and dC in place of K and V, by key rows (dK_j =
// sum_i dS_ij Q_i and dV_j = sum_i P_ij dC_i, recomputing P_ij and dS_ij
// from the kept row statistics with the same operations in the same order).
// No float atomics: every output element is one thread's sum in a fixed
// order.
//
// Bound on the H100: bytes. Kernel 12 reads 3 B N D and writes B N D
// elements against 4 B H N^2 hd FLOP: at ViT-B (N = 65, D = 768, hd = 64)
// about 33 FLOP per bf16 byte, under the ~295 where the tensor cores become
// the limit. Kernel 13 moves 7 B N D elements for 10 B H N^2 hd FLOP. The
// bf16 cores keep loads in flight (kernel 12 walks several heads per CTA
// through a two-stage cp.async ring) and move each byte once. The fp32
// kernels run on the CUDA cores (67 TFLOP/s): correct first, fast later.
#include "attn_core.cuh"

namespace sky {

constexpr int F32_THREADS = 256;
constexpr int F32_WARPS = F32_THREADS / 32;

// Shared-memory plan of one fp32 (sample, head) CTA:
//   Ks, Vs  N x (hd + 1) fp32          keys and values (backward pass 2: Q, dC)
//   per warp: two rows of hd and two of N fp32 (a query's q and dc, its P
//             and dP / dS rows; pass 2: a key's k and v, its P and dS columns)
//   backward only: the rows' max, sum and delta, 3 x N fp32
struct AttnF32Plan {
  int KL;
  size_t total;
  __host__ __device__ AttnF32Plan(int N, int hd, bool backward) {
    KL = hd + 1;
    total = ((size_t)2 * N * KL + (size_t)F32_WARPS * (2 * hd + 2 * N) + (backward ? 3 * N : 0)) *
            sizeof(float);
  }
  __host__ __device__ size_t bytes() const { return total; }
};

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// K and V (or Q and dC) of one (sample, head) into shared memory; `src` is
// the head's first element, rows `pitch` apart
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int N, int hd, int KL,
                                              size_t pitch) {
  for (int idx = threadIdx.x; idx < N * hd; idx += F32_THREADS) {
    const int n = idx / hd, c = idx % hd;
    dst[n * KL + c] = src[(size_t)n * pitch + c];
  }
}

__global__ void __launch_bounds__(F32_THREADS)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, int N, int D, int H,
                    int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KL = hd + 1;
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + N * KL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qrow = Vs + N * KL + warp * (2 * hd + 2 * N);
  float* prow = qrow + 2 * hd;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t D3 = 3 * (size_t)D;
  const float* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  load_rows_f32(Ks, src + D, N, hd, KL, D3);
  load_rows_f32(Vs, src + 2 * D, N, hd, KL, D3);
  __syncthreads();

  for (int r = warp; r < N; r += F32_WARPS) {
    for (int c = lane; c < hd; c += 32) qrow[c] = src[(size_t)r * D3 + c];
    __syncwarp();
    float mx = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) {
      const float z = dot_f32(qrow, Ks + j * KL, hd) * scale;
      prow[j] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) prow[j] = prow[j] / sum;
    __syncwarp();
    float* out = ctx + ((size_t)b * N + r) * D + (size_t)h * hd;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(prow[j], Vs[j * KL + c], acc);
      out[c] = acc;
    }
    __syncwarp();  // qrow and prow are rewritten by the warp's next row
  }
}

__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                    float* __restrict__ dqkv, int N, int D, int H, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KL = hd + 1;
  float* As = reinterpret_cast<float*>(smem_raw);  // pass 1: K; pass 2: Q
  float* Bs = As + N * KL;                         // pass 1: V; pass 2: dC
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wbuf = Bs + N * KL + warp * (2 * hd + 2 * N);
  float* row_a = wbuf;             // pass 1: q_i;  pass 2: k_j
  float* row_b = wbuf + hd;        // pass 1: dc_i; pass 2: v_j
  float* pbuf = wbuf + 2 * hd;     // P_i. (pass 1) or P_.j (pass 2)
  float* sbuf = pbuf + N;          // dP then dS
  float* stats = Bs + N * KL + F32_WARPS * (2 * hd + 2 * N);
  float* rmax = stats;
  float* rsum = stats + N;
  float* rdelta = stats + 2 * N;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t D3 = 3 * (size_t)D;
  const float* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  const float* dcs = dctx + (size_t)b * N * D + (size_t)h * hd;
  float* dst = dqkv + (size_t)b * N * D3 + (size_t)h * hd;  // + 0 / D / 2D: dq / dk / dv

  // pass 1, one warp per query row i: P_i., dP_i., delta_i, dS_i., dq_i
  load_rows_f32(As, src + D, N, hd, KL, D3);
  load_rows_f32(Bs, src + 2 * D, N, hd, KL, D3);
  __syncthreads();
  for (int i = warp; i < N; i += F32_WARPS) {
    for (int c = lane; c < hd; c += 32) {
      row_a[c] = src[(size_t)i * D3 + c];
      row_b[c] = dcs[(size_t)i * D + c];
    }
    __syncwarp();
    float mx = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) {
      const float z = dot_f32(row_a, As + j * KL, hd) * scale;
      pbuf[j] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pbuf[j] - mx);
      pbuf[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = pbuf[j] / sum;
      const float dp = dot_f32(row_b, Bs + j * KL, hd);
      pbuf[j] = p;
      sbuf[j] = dp;
      delta += dp * p;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < N; j += 32) sbuf[j] = (sbuf[j] * pbuf[j] - pbuf[j] * delta) * scale;
    if (lane == 0) {
      rmax[i] = mx;
      rsum[i] = sum;
      rdelta[i] = delta;
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(sbuf[j], As[j * KL + c], acc);
      dst[(size_t)i * D3 + c] = acc;
    }
    __syncwarp();
  }
  __syncthreads();  // K and V are dead; the row statistics are complete

  // pass 2, one warp per key row j: P_.j and dS_.j from the row statistics,
  // dk_j = sum_i dS_ij q_i, dv_j = sum_i P_ij dc_i
  load_rows_f32(As, src, N, hd, KL, D3);
  load_rows_f32(Bs, dcs, N, hd, KL, D);
  __syncthreads();
  for (int j = warp; j < N; j += F32_WARPS) {
    for (int c = lane; c < hd; c += 32) {
      row_a[c] = src[(size_t)j * D3 + D + c];
      row_b[c] = src[(size_t)j * D3 + 2 * D + c];
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float z = dot_f32(As + i * KL, row_a, hd) * scale;
      const float p = expf(z - rmax[i]) / rsum[i];
      const float dp = dot_f32(Bs + i * KL, row_b, hd);
      pbuf[i] = p;
      sbuf[i] = (dp * p - p * rdelta[i]) * scale;
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < N; ++i) {
        dk = fmaf(sbuf[i], As[i * KL + c], dk);
        dv = fmaf(pbuf[i], Bs[i * KL + c], dv);
      }
      dst[(size_t)j * D3 + D + c] = dk;
      dst[(size_t)j * D3 + 2 * D + c] = dv;
    }
    __syncwarp();
  }
}

inline cudaError_t launch_f32(bool backward, const void* qkv, const void* dctx, void* out, int B,
                              int N, int D, int H, cudaStream_t s) {
  const int hd = D / H;
  const size_t smem = AttnF32Plan(N, hd, backward).bytes();
  if (smem > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaError_t err;
  if (backward) {
    err = cudaFuncSetAttribute(attn_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attn_bwd_f32_kernel<<<B * H, F32_THREADS, smem, s>>>(static_cast<const float*>(qkv),
                                                         static_cast<const float*>(dctx),
                                                         static_cast<float*>(out), N, D, H, hd,
                                                         scale);
  } else {
    err = cudaFuncSetAttribute(attn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attn_fwd_f32_kernel<<<B * H, F32_THREADS, smem, s>>>(static_cast<const float*>(qkv),
                                                         static_cast<float*>(out), N, D, H, hd,
                                                         scale);
  }
  return cudaGetLastError();
}

}  // namespace sky

// Shared-memory bytes of a kernel's plan at (N, hd): bf16 (f32 = 0) or fp32,
// forward (bwd = 0) or backward. The wrappers refuse what exceeds the
// block's limit.
extern "C" long long sky_attention_plan_bytes(int N, int hd, int f32, int bwd) {
  using namespace sky;
  if (f32) return static_cast<long long>(AttnF32Plan(N, hd, bwd != 0).bytes());
  return static_cast<long long>(bwd ? AttnBwdPlan(N, hd).bytes() : AttnPlan(N, hd).bytes());
}

// Kernel 12, bf16: ctx (B, N, D) from qkv (B, N, 3D). Returns 0 or the
// launch's CUDA error.
extern "C" int sky_attention_fwd(const void* qkv, void* ctx, int B, int N, int D, int H,
                                 void* stream) {
  return static_cast<int>(sky::launch_attn_core(qkv, ctx, nullptr, B, N, D, H, 0,
                                                static_cast<cudaStream_t>(stream)));
}

// Kernel 13, bf16: dqkv (B, N, 3D) bf16 from qkv (B, N, 3D) and dctx
// (B, N, D).
extern "C" int sky_attention_bwd(const void* qkv, const void* dctx, void* dqkv, int B, int N, int D,
                                 int H, void* stream) {
  return static_cast<int>(sky::launch_attn_bwd_core<true, sky::bf16>(
      qkv, nullptr, dctx, nullptr, dqkv, B, N, D, H, 0, static_cast<cudaStream_t>(stream)));
}

// Kernel 12, fp32.
extern "C" int sky_attention_fwd_f32(const void* qkv, void* ctx, int B, int N, int D, int H,
                                     void* stream) {
  return static_cast<int>(sky::launch_f32(false, qkv, nullptr, ctx, B, N, D, H,
                                          static_cast<cudaStream_t>(stream)));
}

// Kernel 13, fp32: dqkv (B, N, 3D) from qkv and dctx, all fp32.
extern "C" int sky_attention_bwd_f32(const void* qkv, const void* dctx, void* dqkv, int B, int N,
                                     int D, int H, void* stream) {
  return static_cast<int>(sky::launch_f32(true, qkv, dctx, dqkv, B, N, D, H,
                                          static_cast<cudaStream_t>(stream)));
}
