// The attention cores shared by the attention-block kernels and the
// standalone attention kernels 12 and 13, one CTA per (sample, head), on the
// tensor cores through wmma (16x16x16 bf16 fragments, fp32 accumulate):
//
// - attn_core_kernel: ctx = bf16(bf16(softmax(Q K^T * hd^-0.5)) V) from a
//   bf16 qkv (B, N, 3D), optionally storing the bf16 probabilities (the
//   stash) and masked to packed segments (seg_len). K2 and kernel 2
//   (attn_block.cu) launch it between their GEMMs; kernel 12 (attention.cu)
//   launches it alone.
// - attn_bwd_core_kernel: dqkv (fp32, (B, N, 3D)) from qkv and dctx, with
//   the probabilities stashed (RECOMPUTE = false, kernel 3) or recomputed in
//   fp32 (RECOMPUTE = true, kernel 4; kernel 13 without the ctx product).
//
// launch_attn_core and launch_attn_bwd_core size the dynamic shared memory
// from the plans, refuse (cudaErrorInvalidValue) a plan past the opt-in
// limit, launch B * H CTAs and return the launch's error.
#pragma once

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
    // Without `ctx` (kernel 13) the ctx tiles are skipped altogether.
    const int n_row = tm * tv, n_key = tn * tv;
    for (int t = (ctx ? 0 : n_row) + warp; t < 2 * n_row + 2 * n_key; t += NW) {
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

// ctx (B, N, D) from qkv (B, N, 3D), both bf16; with `probs` (B, H, N, N)
// the bf16 probabilities too. seg_len > 0 masks to packed segments.
inline cudaError_t launch_attn_core(const void* qkv, void* ctx, void* probs, int B, int N, int D,
                                    int H, int seg_len, cudaStream_t s) {
  const int hd = D / H;
  const size_t smem = AttnPlan(N, hd).bytes();
  if (smem > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_core_kernel<<<B * H, ATTN_THREADS, smem, s>>>(static_cast<const bf16*>(qkv),
                                                     static_cast<bf16*>(ctx),
                                                     static_cast<bf16*>(probs), N, D, H, hd,
                                                     seg_len, 1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

// fp32 dqkv (B, N, 3D) from qkv (B, N, 3D) and dc (B, N, D), both bf16;
// kernel 3 reads the stashed `probs`, the recompute core none. With `ctx`
// (B, N, D) the core also stores bf16(P_bf16 V).
template <bool RECOMPUTE>
inline cudaError_t launch_attn_bwd_core(const void* qkv, const void* probs, const void* dc, void* ctx,
                                        void* dqkv, int B, int N, int D, int H, int seg_len,
                                        cudaStream_t s) {
  const int hd = D / H;
  const size_t smem = AttnBwdPlan<RECOMPUTE>(N, hd).bytes();
  if (smem > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_kernel<RECOMPUTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_bwd_core_kernel<RECOMPUTE><<<B * H, ATTN_BWD_THREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs), static_cast<const bf16*>(dc),
      static_cast<bf16*>(ctx), static_cast<float*>(dqkv), N, D, H, hd, seg_len,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

}  // namespace sky
