// The attention cores shared by the attention-block kernels and the
// standalone attention kernels 12 and 13, on the tensor cores through
// mma.sync m16n8k16 (bf16 operands from ldmatrix, fp32 accumulators in
// registers):
//
// - attn_core_kernel: ctx = bf16(bf16(softmax(Q K^T * hd^-0.5)) V) from a
//   bf16 qkv (B, N, 3D), optionally storing the bf16 probabilities (the
//   stash) and masked to packed segments (seg_len). K2 and kernel 2
//   (attn_block.cu) launch it between their GEMMs; kernel 12 (attention.cu)
//   launches it alone.
// - attn_bwd_core_kernel: dq, dk, dv from qkv and dctx, with the
//   probabilities stashed (RECOMPUTE = false, kernel 3) or recomputed in
//   fp32 (RECOMPUTE = true, kernel 4; kernel 13 without the ctx product),
//   written straight to bf16, each element rounded once; kernels 3 and 4
//   also write the fp32 column sums of each sample's dq, dk, dv (dbqkv's
//   partials), so no fp32 dqkv reaches device memory.
//
// What bounds them on the H100: bytes. A head moves 3 N hd bf16 in and
// N hd out for 4 N^2 hd FLOP (ViT-B: ~33 FLOP per byte, under the ~295 at
// which the tensor cores become the limit). So the design keeps loads in
// flight and keeps S, P and dS out of shared memory where it can:
//
// Forward. Each warp owns 16 query rows of a head. S (16 x NP, N padded to
// NP, a multiple of 16) is built in the accumulators of mma.sync; the
// fp32 row max and sum come from quad shuffles; P is normalised in fp32,
// rounded to bf16 and repacked in registers as the A operand of P V (the
// m16n8 accumulator layout of two neighbouring key tiles is the m16k16 A
// layout), V read through ldmatrix.trans. ctx is rounded from the
// accumulators, staged in the warp's own (dead) Q rows and stored with
// 16-byte writes; heads wider than 64 loop over 64-column chunks of V with
// the same P fragments. A CTA of min(NP / 16, 8) warps walks several
// (sample, head) pairs, pair blockIdx.x + k gridDim.x, through a two-stage
// cp.async ring of K, V and Q, so the next head's loads fly while this one
// computes; the grid is as many CTAs as fit the card at once. Where two
// stages do not fit (wide heads) one does, and where even Q does not, Q's
// fragments are read from device memory.
//
// Backward. One CTA per (sample, head, column chunk), min(NP / 16, 8)
// warps. K and V stay in shared memory; queries go in blocks of QB rows
// (the whole head at N <= 128). Per block, phase 1 (warps own 16 query
// rows): S and the softmax (or the stashed P), dP = dC V^T, the row sum
// delta = sum_j P dP and dS = bf16((dP P - P delta) * hd^-0.5) in
// registers; P (bf16) and dS go to shared memory; dQ = dS K and ctx =
// P V are stored from the accumulators. Phase 2 (warps own 16 key rows):
// dV = P^T dC and dK = dS^T Q over the block's rows, P^T and dS^T through
// ldmatrix.trans; with one block they are stored at once, with several
// they are summed across blocks in fp32 shared memory, each key row by the
// same warp in block order. No float atomics and nothing summed in device
// memory: every output element is one thread's sum in a fixed order, so
// two launches give the same bits. A head whose dK and dV do not fit
// beside K and V (hd = 512; N > 128) is split over CTAs by output columns
// (HC): each recomputes S and dP for the whole head and writes its
// columns of dq, dk, dv (and ctx). Column sums (kernels 3, 4): each warp
// adds its tiles' 16-row sums (a reduce-scatter of xor shuffles) into its
// own row of shared memory; the rows are added in warp order (dk, dv of
// several blocks: the fp32 accumulators in row order) into the sample's
// partial row, so the sums too are the same bits run to run.
//
// launch_attn_core and launch_attn_bwd_core size the dynamic shared memory
// from the plans, refuse (cudaErrorInvalidValue) a plan past the opt-in
// limit, pick the register footprint (KT, the most 16-key tiles a head may
// have: 2, 5, 8 or 16) from N and return the launch's error.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace sky {

constexpr int ATTN_MAX_WARPS = 8;
constexpr int ATTN_MAX_THREADS = 32 * ATTN_MAX_WARPS;
constexpr int ATTN_CHUNK = 64;  // head columns per accumulator chunk

// Fragment addresses, per lane. A 16 x 16 tile at (r0, c0) of a row-major
// matrix (pitch ld), as the A operand:
__device__ __forceinline__ const bf16* a_addr(const bf16* m, int ld, int r0, int c0, int lane) {
  return m + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// ... as the A operand transposed (A = M^T, rows of A are columns c0.. of M):
__device__ __forceinline__ const bf16* at_addr(const bf16* m, int ld, int r0, int c0, int lane) {
  return m + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8;
}
// B operands of two neighbouring 8-wide n-tiles (regs 0, 1: n0; 2, 3: n0 + 8)
// from a matrix stored (n, k) row-major (K for Q K^T), ldsm4:
__device__ __forceinline__ const bf16* bn_addr(const bf16* m, int ld, int n0, int k0, int lane) {
  return m + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// ... from a matrix stored (k, n) row-major (V for P V), ldsm4_t:
__device__ __forceinline__ const bf16* bk_addr(const bf16* m, int ld, int k0, int n0, int lane) {
  return m + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8;
}

// The two rows (g, g + 8) and column pairs (2t, 2t + 1) a lane holds of a
// 16 x 8 accumulator tile.
struct Frag {
  int g, t;
  __device__ __forceinline__ explicit Frag(int lane) : g(lane >> 2), t(lane & 3) {}
};

// Walks the 16-byte vectors (row n, vector c) of a rows x vpr tile from
// vector `start` in steps of `step` vectors, without a division per step.
struct VecWalk {
  int n, c, dn, dc, vpr;
  __device__ __forceinline__ VecWalk(int start, int step, int vpr_)
      : n(start / vpr_), c(start % vpr_), dn(step / vpr_), dc(step % vpr_), vpr(vpr_) {}
  __device__ __forceinline__ void next() {
    n += dn;
    c += dc;
    if (c >= vpr) {
      c -= vpr;
      ++n;
    }
  }
};

// quad (4-lane) reductions: the lanes that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// fp32 softmax of scale * S over each row's keys [lo, hi) (all N, or its
// packed segment), in place: s holds a warp's 16 x 16 KT logits as 2 KT
// accumulator tiles; afterwards the probabilities, exactly 0 outside
// [lo, hi). Query rows r0 (regs 0, 1) and r0 + 8 (regs 2, 3). The max is
// taken on the raw logits (scale > 0), exp(scale (s - max)) as exp2 of one
// FMA, and the row's sum divided once (p = e * (1 / sum)): within a few
// fp32 ulps of softmax(scale * S), far under the bf16 rounding of P.
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[2 * KT][4], int nk, int r0, int N,
                                             int seg_len, float scale, const Frag& f) {
  int lo[2], hi[2];
  seg_keys(r0, N, seg_len, lo[0], hi[0]);
  seg_keys(r0 + 8, N, seg_len, lo[1], hi[1]);
  // an 8-key tile inside both rows' keys needs no test per element
  const int lo_all = max(lo[0], lo[1]), hi_all = min(hi[0], hi[1]);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < 2 * nk) {
      const bool whole = 8 * j >= lo_all && 8 * j + 8 <= hi_all;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * f.t + (e & 1), r = e >> 1;
        if (whole || (c >= lo[r] && c < hi[r])) mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
  }
  const float sl = scale * 1.4426950408889634f;  // scale * log2(e)
  const float off[2] = {quad_max(mx[0]) * sl, quad_max(mx[1]) * sl};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < 2 * nk) {
      const bool whole = 8 * j >= lo_all && 8 * j + 8 <= hi_all;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * f.t + (e & 1), r = e >> 1;
        const float v = whole || (c >= lo[r] && c < hi[r]) ? exp2f(fmaf(s[j][e], sl, -off[r])) : 0.f;
        s[j][e] = v;
        sum[r] += v;
      }
    }
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < 2 * nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
    }
  }
}

// ---------------------------------------------------------------- forward

// Shared-memory plan of the forward: a ring of `stages` (sample, head)
// slots, each K, V (and Q where it fits) of NP x (hd + 8) bf16, zero past
// N. Row pitches are odd multiples of 16 bytes, so ldmatrix's eight row
// reads hit distinct banks. ViT-B (N = 65, hd = 64): two stages of 34 560
// bytes, three CTAs of five warps per SM; hd = 512 at N = 65: one stage,
// Q from device memory (166 400 bytes).
struct AttnPlan {
  int NP, HL, NW, stages, q_smem;
  __host__ __device__ AttnPlan(int N, int hd) {
    NP = (N + 15) & ~15;
    HL = hd + 8;
    NW = NP / 16 < ATTN_MAX_WARPS ? NP / 16 : ATTN_MAX_WARPS;
    stages = 2;
    q_smem = 1;
    if (bytes() > SMEM_OPTIN_MAX) stages = 1;
    if (bytes() > SMEM_OPTIN_MAX) q_smem = 0;
  }
  __host__ __device__ size_t stage_elems() const { return (size_t)(2 + q_smem) * NP * HL; }
  __host__ __device__ size_t bytes() const { return stages * stage_elems() * sizeof(bf16); }
};

// K, V (and Q) of one (sample, head) into a ring slot, 16-byte cp.async,
// zero-filled past N
__device__ __forceinline__ void attn_fwd_issue(const bf16* __restrict__ qkv, bf16* slot,
                                               const AttnPlan& pl, int pair, int N, int D, int H,
                                               int hd) {
  const size_t D3 = 3 * (size_t)D;
  const bf16* src = qkv + (size_t)(pair / H) * N * D3 + (size_t)(pair % H) * hd;
  for (int part = 0; part < 2 + pl.q_smem; ++part) {  // K, V, Q
    const int off = part == 2 ? 0 : (part + 1) * D;
    bf16* dst = slot + (size_t)part * pl.NP * pl.HL;
    for (VecWalk w(threadIdx.x, blockDim.x, hd / 8); w.n < pl.NP; w.next()) {
      const bool ok = w.n < N;
      cp_async16(dst + w.n * pl.HL + 8 * w.c, ok ? src + (size_t)w.n * D3 + off + 8 * w.c : src, ok);
    }
  }
}

// A warp's 16 query rows q0.. of one head: S = Q K^T (Q from shared memory,
// or, where Qs is null, from device memory at qg, rows D3 apart), the
// softmax, and P rounded to bf16 and repacked as the A operand of P V (the
// m16n8 accumulator layout of two neighbouring key tiles is the m16k16 A
// layout). attn_core_kernel and the fused TP forward half
// (attn_block_tp.cu) share it, and so their bits.
template <int KT>
__device__ __forceinline__ void attn_fwd_probs(const bf16* Qs, const bf16* qg, size_t D3,
                                               const bf16* Ks, int HL, int nk, int q0, int N,
                                               int hd, int seg_len, float scale, const Frag& f,
                                               int lane, unsigned (&pa)[KT][4]) {
  const int r0 = q0 + f.g;  // this lane's rows: r0, r0 + 8
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 16) {
    unsigned a[4];
    if (Qs) {
      ldsm4(a, a_addr(Qs, HL, q0, k0, lane));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e & 1), c = k0 + 2 * f.t + 8 * (e >> 1);
        a[e] = r < N ? *reinterpret_cast<const unsigned*>(qg + (size_t)r * D3 + c) : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nk) {
        unsigned kb[4];
        ldsm4(kb, bn_addr(Ks, HL, 16 * j, k0, lane));
        mma16816(s[2 * j], a, kb[0], kb[1]);
        mma16816(s[2 * j + 1], a, kb[2], kb[3]);
      }
    }
  }
  softmax_rows<KT>(s, nk, r0, N, seg_len, scale, f);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// o = P V over the head's columns c0 .. c0 + ATTN_CHUNK (V read through
// ldmatrix.trans), in fp32
template <int KT>
__device__ __forceinline__ void attn_fwd_pv(const unsigned (&pa)[KT][4], const bf16* Vs, int HL,
                                            int nk, int c0, int hd, int lane,
                                            float (&o)[ATTN_CHUNK / 8][4]) {
#pragma unroll
  for (int j = 0; j < ATTN_CHUNK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    if (kc < nk) {
#pragma unroll
      for (int jj = 0; jj < ATTN_CHUNK / 16; ++jj) {
        if (c0 + 16 * jj < hd) {
          unsigned vb[4];
          ldsm4_t(vb, bk_addr(Vs, HL, 16 * kc, c0 + 16 * jj, lane));
          mma16816(o[2 * jj], pa[kc], vb[0], vb[1]);
          mma16816(o[2 * jj + 1], pa[kc], vb[2], vb[3]);
        }
      }
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(ATTN_MAX_THREADS)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, bf16* __restrict__ probs,
                 int B, int N, int D, int H, int hd, int seg_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const AttnPlan pl(N, hd);
  const int NP = pl.NP, HL = pl.HL, nk = NP / 16;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Frag f(lane);
  const size_t D3 = 3 * (size_t)D;
  const int pairs = B * H;

  int pair = blockIdx.x;
  if (pair >= pairs) return;
  attn_fwd_issue(qkv, ring, pl, pair, N, D, H, hd);
  cp_async_commit();
  for (int it = 0; pair < pairs; ++it, pair += gridDim.x) {
    const int nxt = pair + gridDim.x;
    const int slot = pl.stages == 2 ? (it & 1) : 0;
    if (pl.stages == 2) {
      if (nxt < pairs) attn_fwd_issue(qkv, ring + (slot ^ 1) * pl.stage_elems(), pl, nxt, N, D, H, hd);
      cp_async_commit();  // possibly empty, so the wait below counts groups right
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    bf16* Ks = ring + slot * pl.stage_elems();
    const bf16* Vs = Ks + (size_t)NP * HL;
    bf16* Qs = pl.q_smem ? Ks + (size_t)2 * NP * HL : nullptr;
    const int b = pair / H, h = pair % H;
    const bf16* qg = qkv + (size_t)b * N * D3 + (size_t)h * hd;  // Q rows in device memory
    bf16* out = ctx + (size_t)b * N * D + (size_t)h * hd;
    bf16* prow = probs ? probs + (size_t)pair * N * N : nullptr;

    for (int tile = warp; tile < nk; tile += pl.NW) {
      const int q0 = 16 * tile;
      const int r0 = q0 + f.g;  // this lane's rows: r0, r0 + 8
      unsigned pa[KT][4];
      attn_fwd_probs<KT>(Qs, qg, D3, Ks, HL, nk, q0, N, hd, seg_len, scale, f, lane, pa);
      if (prow) {  // the stash: the same bf16 values, real rows and keys only
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (j < nk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + 8 * (e & 1), c = 16 * j + 8 * (e >> 1) + 2 * f.t;
              if (r >= N || c >= N) continue;
              const size_t at = (size_t)r * N + c;
              const unsigned v = pa[j][e];
              if (c + 1 < N && ((reinterpret_cast<size_t>(prow + at) & 3) == 0)) {
                *reinterpret_cast<unsigned*>(prow + at) = v;
              } else {
                prow[at] = __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xffffu));
                if (c + 1 < N) prow[at + 1] = __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
              }
            }
          }
        }
      }

      // ctx = P V in 64-column chunks of the head
      for (int c0 = 0; c0 < hd; c0 += ATTN_CHUNK) {
        float o[ATTN_CHUNK / 8][4];
        attn_fwd_pv<KT>(pa, Vs, HL, nk, c0, hd, lane, o);
#pragma unroll
        for (int j = 0; j < ATTN_CHUNK / 8; ++j) {
          const int c = c0 + 8 * j + 2 * f.t;
          if (c >= hd) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const unsigned v = pack_bf16(o[j][2 * half], o[j][2 * half + 1]);
            const int rl = f.g + 8 * half;
            if (Qs) {  // the warp's own Q rows are dead: stage there
              *reinterpret_cast<unsigned*>(Qs + (q0 + rl) * HL + c) = v;
            } else if (q0 + rl < N) {
              *reinterpret_cast<unsigned*>(out + (size_t)(q0 + rl) * D + c) = v;
            }
          }
        }
      }
      if (Qs) {  // 16-byte stores of the staged rows
        __syncwarp();
        for (VecWalk w(lane, 32, hd / 8); w.n < 16 && q0 + w.n < N; w.next())
          *reinterpret_cast<uint4*>(out + (size_t)(q0 + w.n) * D + 8 * w.c) =
              *reinterpret_cast<const uint4*>(Qs + (q0 + w.n) * HL + 8 * w.c);
      }
    }
    __syncthreads();  // the slot is refilled by the next issue
    if (pl.stages == 1 && nxt < pairs) {
      attn_fwd_issue(qkv, ring, pl, nxt, N, D, H, hd);
      cp_async_commit();
    }
  }
}

// the 16-key tiles a register footprint must cover at N tokens
inline int attn_kt(int N) {
  const int nk = (N + 15) / 16;
  return nk <= 2 ? 2 : nk <= 5 ? 5 : nk <= 8 ? 8 : 16;
}

template <int KT>
inline cudaError_t launch_attn_core_kt(const void* qkv, void* ctx, void* probs, int B, int N, int D,
                                       int H, int seg_len, cudaStream_t s) {
  const int hd = D / H;
  const AttnPlan pl(N, hd);
  const size_t smem = pl.bytes();
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = 32 * pl.NW;
  const int grid = resident_grid(attn_core_kernel<KT>, threads, smem, B * H);
  attn_core_kernel<KT><<<grid, threads, smem, s>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx),
                                                   static_cast<bf16*>(probs), B, N, D, H, hd, seg_len,
                                                   1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

// ctx (B, N, D) from qkv (B, N, 3D), both bf16; with `probs` (B, H, N, N)
// the bf16 probabilities too. seg_len > 0 masks to packed segments.
inline cudaError_t launch_attn_core(const void* qkv, void* ctx, void* probs, int B, int N, int D,
                                    int H, int seg_len, cudaStream_t s) {
  if (AttnPlan(N, D / H).bytes() > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  switch (attn_kt(N)) {
    case 2: return launch_attn_core_kt<2>(qkv, ctx, probs, B, N, D, H, seg_len, s);
    case 5: return launch_attn_core_kt<5>(qkv, ctx, probs, B, N, D, H, seg_len, s);
    case 8: return launch_attn_core_kt<8>(qkv, ctx, probs, B, N, D, H, seg_len, s);
    default: return launch_attn_core_kt<16>(qkv, ctx, probs, B, N, D, H, seg_len, s);
  }
}

// --------------------------------------------------------------- backward

// Shared-memory plan of one backward CTA:
//   Ks, Vs    NP x (hd + 8) bf16     keys and values, zero past N
//   Qs, dCs   QB x (hd + 8) bf16     one query block of q and dc, zero past N
//   Ps, dSs   QB x (NP + 8) bf16     the block's probabilities and dS
//   dKa, dVa  NP x (HC + 4) fp32     several blocks only: dk and dv of the
//                                    CTA's HC columns, summed over blocks
//   red       NW x HC fp32           one block and column sums only
//                                    (kernels 3, 4): each warp's sums of its
//                                    tiles' rows; with several blocks these
//                                    rows (QB / 16 of them at most) live in
//                                    dKa's 4 padding floats a row, free
// The first plan that fits, widest columns first, then largest blocks:
// ViT-B (N = 65, hd = 64) one block of 80 rows, 74 240 bytes (75 520 with
// the sums: three CTAs still share an SM); hd = 80 84 480; hd = 512 at
// N = 65 16-row blocks and 32-column chunks (228 352); N = 256 at hd = 64
// 32-row blocks of 32 columns (190 464), at hd = 128 of 16 columns
// (231 424). Past hd = 144 at N = 256 no backward plan fits (hd = 160
// needs 240 640 bytes at the smallest) and the wrappers refuse.
struct AttnBwdPlan {
  int NP, HL, PL, QB, HC, NW;
  bool sums;
  __host__ __device__ AttnBwdPlan(int N, int hd, bool sums_ = false) : sums(sums_) {
    NP = (N + 15) & ~15;
    HL = hd + 8;
    PL = NP + 8;
    NW = NP / 16 < ATTN_MAX_WARPS ? NP / 16 : ATTN_MAX_WARPS;
    const int hcs[5] = {hd, 128, 64, 32, 16};
    for (int i = 0; i < 5; ++i) {
      if (i > 0 && hcs[i] >= hd) continue;
      HC = hcs[i];
      for (QB = NP <= 128 ? NP : 64; QB >= 16; QB = QB > 64 ? 64 : QB / 2)
        if (bytes() <= SMEM_OPTIN_MAX) return;
    }
    HC = 16;
    QB = 16;
  }
  __host__ __device__ bool multi() const { return QB < NP; }
  __host__ __device__ int chunks(int hd) const { return (hd + HC - 1) / HC; }
  __host__ __device__ size_t acc_elems() const { return multi() ? (size_t)NP * (HC + 4) : 0; }
  __host__ __device__ size_t sum_elems() const { return sums && !multi() ? (size_t)NW * HC : 0; }
  __host__ __device__ size_t bytes() const {
    return (size_t)(2 * NP * HL + 2 * QB * HL + 2 * QB * PL) * sizeof(bf16) +
           (2 * acc_elems() + sum_elems()) * sizeof(float);
  }
};

// two bf16 output elements (columns c, c + 1) of one row
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// The warps' rows of column sums (AttnBwdPlan's red): element (w, c) of an
// HC-wide row at base[(e / 4) * stride + e % 4], e = w HC + c; stride 4
// packs them (one block), stride HC + 4 puts them in dKa's padding
// (several blocks). Columns c, c + 1 (c even) share a group of four.
struct SumRows {
  float* base;
  int stride, hc;
  __device__ __forceinline__ float& at(int w, int c) const {
    const int e = w * hc + c;
    return base[(e >> 2) * stride + (e & 3)];
  }
};

// One step of colsum16's reduce-scatter: lanes whose g has bit HALF / 2
// keep the upper HALF values and send the lower ones to their partner
// (lane ^ 2 HALF), the others the reverse; each adds what it receives.
template <int HALF>
__device__ __forceinline__ void fold_half(float (&v)[16], int g) {
  const bool up = g & (HALF / 2);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[HALF + i];
    const float keep = up ? v[HALF + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The column sums of a 16-row tile of eight 8-column accumulator groups
// (o[j]: lane (g, t) holds rows g and g + 8 of columns 8 j + 2 t, + 1),
// rows from `rows` on left out: the two rows added in each lane, then a
// reduce-scatter over the 8 lanes of one t (8 + 4 + 2 shuffles, where a
// butterfly per group would take 48), after which lane (g, t) holds group
// j = g's sums, columns 8 g + 2 t and + 1, in s0, s1. A fixed order.
__device__ __forceinline__ void colsum16(const float (&o)[ATTN_CHUNK / 8][4], int rows,
                                         const Frag& f, float& s0, float& s1) {
  const bool lo = f.g < rows, hi = f.g + 8 < rows;
  float v[16];
#pragma unroll
  for (int j = 0; j < ATTN_CHUNK / 8; ++j) {
    v[2 * j] = (lo ? o[j][0] : 0.f) + (hi ? o[j][2] : 0.f);
    v[2 * j + 1] = (lo ? o[j][1] : 0.f) + (hi ? o[j][3] : 0.f);
  }
  fold_half<8>(v, f.g);
  fold_half<4>(v, f.g);
  fold_half<2>(v, f.g);
  s0 = v[0];
  s1 = v[1];
}

// out[r, c0 + ...] = (A B) over rows 16 tile.., an [ATTN_CHUNK] column chunk
// of width <= cw: A a 16 x (16 nka) bf16 tile of `a` (pitch lda) at row
// arow; B = bm[k, bcol + ...] stored (k, n) (pitch HL). Accumulated in
// registers, stored per element pair through `emit(row_in_tile, col, v0, v1)`.
// With `sums`, the tile's first `rows` rows are also added into row `w`
// of the column sums, in fp32 before any rounding (colsum16), to what the
// warp's earlier tiles left there.
template <typename Emit>
__device__ __forceinline__ void tile_product(const bf16* a, int lda, int arow, bool a_trans, int acol,
                                             int nka, const bf16* bm, int ldb, int bcol, int cw,
                                             int lane, const Frag& f, Emit emit,
                                             const SumRows* sums = nullptr, int w = 0, int rows = 0) {
  for (int cc = 0; cc < cw; cc += ATTN_CHUNK) {
    float o[ATTN_CHUNK / 8][4];
#pragma unroll
    for (int j = 0; j < ATTN_CHUNK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kc = 0; kc < nka; ++kc) {
      unsigned fa[4];
      if (a_trans)
        ldsm4_t(fa, at_addr(a, lda, 16 * kc, acol, lane));
      else
        ldsm4(fa, a_addr(a, lda, arow, 16 * kc, lane));
#pragma unroll
      for (int jj = 0; jj < ATTN_CHUNK / 16; ++jj) {
        if (cc + 16 * jj < cw) {
          unsigned fb[4];
          ldsm4_t(fb, bk_addr(bm, ldb, 16 * kc, bcol + cc + 16 * jj, lane));
          mma16816(o[2 * jj], fa, fb[0], fb[1]);
          mma16816(o[2 * jj + 1], fa, fb[2], fb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ATTN_CHUNK / 8; ++j) {
      const int c = cc + 8 * j + 2 * f.t;
      if (c < cw) {
        emit(f.g, c, o[j][0], o[j][1]);
        emit(f.g + 8, c, o[j][2], o[j][3]);
      }
    }
    if (sums) {  // warp-uniform; the groups past cw hold zeros
      float s0, s1;
      colsum16(o, rows, f, s0, s1);
      const int c = cc + 8 * f.g + 2 * f.t;
      if (c < cw) {
        sums->at(w, c) += s0;
        sums->at(w, c + 1) += s1;
      }
    }
  }
}

// dp tiles (two 8-key n-tiles of 16-key tile j) = dC V^T over the head dims
__device__ __forceinline__ void dp_tile(float (&d)[2][4], const bf16* dCs, const bf16* Vs, int HL,
                                        int q0, int j, int hd, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 16) {
    unsigned a[4], vb[4];
    ldsm4(a, a_addr(dCs, HL, q0, k0, lane));
    ldsm4(vb, bn_addr(Vs, HL, 16 * j, k0, lane));
    mma16816(d[0], a, vb[0], vb[1]);
    mma16816(d[1], a, vb[2], vb[3]);
  }
}

// KT <= 5 (N <= 80, the training paths) is held to 128 registers, so
// three CTAs of five warps share an SM. With SUMS the CTA also writes the
// fp32 column sums of its dq, dk and dv columns over the sample's N rows
// into `psum` (B, 3D) (kernels 3 and 4: dbqkv's per-sample partials); a
// template parameter, so that kernel 13's core compiles without them.
template <bool RECOMPUTE, int KT, bool SUMS>
__global__ void __launch_bounds__(ATTN_MAX_THREADS, KT <= 5 ? 2 : 1)
attn_bwd_core_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                     const bf16* __restrict__ dc, bf16* __restrict__ ctx, bf16* __restrict__ dqkv,
                     float* __restrict__ psum, int N, int D, int H, int hd, int seg_len,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const AttnBwdPlan pl(N, hd, SUMS);
  const int NP = pl.NP, HL = pl.HL, PL = pl.PL, QB = pl.QB, nk = NP / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + NP * HL;
  bf16* Qs = Vs + NP * HL;
  bf16* dCs = Qs + QB * HL;
  bf16* Ps = dCs + QB * HL;
  bf16* dSs = Ps + QB * PL;
  float* dKa = reinterpret_cast<float*>(dSs + QB * PL);  // several blocks only
  float* dVa = dKa + pl.acc_elems();
  const int AL = pl.HC + 4;
  // column sums only: a row of HC per warp (one block), or per phase-1 warp
  // in dKa's padding (several blocks: at most 4 HC floats, under its 4 NP)
  const SumRows red = pl.multi() ? SumRows{dKa + pl.HC, AL, pl.HC}
                                 : SumRows{dVa + pl.acc_elems(), 4, pl.HC};
  const int red_rows = pl.multi() ? min(pl.NW, QB / 16) : pl.NW;

  const int nch = pl.chunks(hd);
  const int pair = blockIdx.x / nch;
  const int c0 = (blockIdx.x % nch) * pl.HC;  // this CTA's output columns [c0, c0 + cw)
  const int cw = min(pl.HC, hd - c0);
  const int b = pair / H, h = pair % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Frag f(lane);
  const size_t D3 = 3 * (size_t)D;
  const int vpr = hd / 8;
  const bf16* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  const bf16* dcsrc = dc + (size_t)b * N * D + (size_t)h * hd;
  const bf16* psrc = RECOMPUTE ? nullptr : probs + (size_t)pair * N * N;
  bf16* dst = dqkv + (size_t)b * N * D3 + (size_t)h * hd;  // + 0 / D / 2D: dq / dk / dv
  bf16* cdst = ctx ? ctx + (size_t)b * N * D + (size_t)h * hd : nullptr;
  float* sdst = SUMS ? psum + (size_t)b * D3 + (size_t)h * hd + c0 : nullptr;  // + 0 / D / 2D
  const SumRows* sums = SUMS ? &red : nullptr;

  // the warps' column sums added in warp order into sdst[off + c], then cleared
  auto flush = [&](size_t off) {
    __syncthreads();
    for (int c = threadIdx.x; c < cw; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < red_rows; ++w) {
        s += red.at(w, c);
        red.at(w, c) = 0.f;
      }
      sdst[off + c] = s;
    }
    __syncthreads();
  };

  for (int part = 0; part < 2; ++part)  // K, V
    for (VecWalk w(threadIdx.x, blockDim.x, vpr); w.n < NP; w.next()) {
      const bool ok = w.n < N;
      cp_async16(Ks + (size_t)part * NP * HL + w.n * HL + 8 * w.c,
                 ok ? src + (size_t)w.n * D3 + (part + 1) * D + 8 * w.c : src, ok);
    }
  for (size_t idx = threadIdx.x; idx < 2 * pl.acc_elems() + pl.sum_elems(); idx += blockDim.x)
    dKa[idx] = 0.f;

  for (int q0 = 0; q0 < N; q0 += QB) {
    for (int part = 0; part < 2; ++part)  // Q, dC
      for (VecWalk w(threadIdx.x, blockDim.x, vpr); w.n < QB; w.next()) {
        const int n = q0 + w.n, c = 8 * w.c;
        const bool ok = n < N;
        const bf16* g = part == 0 ? src + (size_t)n * D3 + c : dcsrc + (size_t)n * D + c;
        cp_async16(Qs + (size_t)part * QB * HL + w.n * HL + c, ok ? g : src, ok);
      }
    cp_async_commit();
    if (!RECOMPUTE) {  // the stashed rows: N long, not 4-byte aligned in general;
                       // four loads in flight per thread
      constexpr int U = 4;
      for (int base = threadIdx.x; base < QB * NP; base += U * blockDim.x) {
        bf16 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = base + u * blockDim.x;
          const int r = idx / NP, j = idx % NP, n = q0 + r;
          v[u] = idx < QB * NP && n < N && j < N ? psrc[(size_t)n * N + j] : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = base + u * blockDim.x;
          if (idx < QB * NP) Ps[(idx / NP) * PL + idx % NP] = v[u];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // phase 1: warps own 16 query rows of the block
    for (int tile = warp; tile < QB / 16; tile += pl.NW) {
      const int l0 = 16 * tile;      // local rows l0 + g, l0 + g + 8
      const int r0 = q0 + l0 + f.g;  // their sequence rows
      float p[2 * KT][4];
      if (RECOMPUTE) {
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
        for (int k0 = 0; k0 < hd; k0 += 16) {
          unsigned a[4];
          ldsm4(a, a_addr(Qs, HL, l0, k0, lane));
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j < nk) {
              unsigned kb[4];
              ldsm4(kb, bn_addr(Ks, HL, 16 * j, k0, lane));
              mma16816(p[2 * j], a, kb[0], kb[1]);
              mma16816(p[2 * j + 1], a, kb[2], kb[3]);
            }
          }
        }
        softmax_rows<KT>(p, nk, r0, N, seg_len, scale, f);
      }
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        if (j < 2 * nk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int lr = l0 + f.g + 8 * half, c = 8 * j + 2 * f.t;
            unsigned* pp = reinterpret_cast<unsigned*>(Ps + lr * PL + c);
            if (RECOMPUTE) {
              if (q0 + lr >= N) p[j][2 * half] = p[j][2 * half + 1] = 0.f;  // padding rows
              *pp = pack_bf16(p[j][2 * half], p[j][2 * half + 1]);
            } else {
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(pp);
              p[j][2 * half] = __low2float(v);
              p[j][2 * half + 1] = __high2float(v);
            }
          }
        }
      }
      // delta = sum_j P dP per row; dS = bf16((dP P - P delta) * scale)
      float delta[2] = {0.f, 0.f};
      constexpr bool HOLD = KT <= 8;  // dP held in registers; else recomputed
      float dp[HOLD ? 2 * KT : 2][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          float d[2][4];
          dp_tile(d, dCs, Vs, HL, l0, j, hd, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              d[n][e] *= p[2 * j + n][e];
              delta[e >> 1] += d[n][e];
              if (HOLD) dp[HOLD ? 2 * j + n : 0][e] = d[n][e];
            }
        }
      }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          float d[2][4];
          if (HOLD) {
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[n][e] = dp[HOLD ? 2 * j + n : 0][e];
          } else {
            dp_tile(d, dCs, Vs, HL, l0, j, hd, lane);
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[n][e] *= p[2 * j + n][e];
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int lr = l0 + f.g + 8 * half, c = 16 * j + 8 * n + 2 * f.t;
              const float v0 = (d[n][2 * half] - p[2 * j + n][2 * half] * delta[half]) * scale;
              const float v1 = (d[n][2 * half + 1] - p[2 * j + n][2 * half + 1] * delta[half]) * scale;
              *reinterpret_cast<unsigned*>(dSs + lr * PL + c) = pack_bf16(v0, v1);
            }
        }
      }
      __syncwarp();
      // dq = dS K and ctx = P V for the block's rows, this CTA's columns
      tile_product(dSs, PL, l0, false, 0, nk, Ks, HL, c0, cw, lane, f,
                   [&](int rl, int c, float v0, float v1) {
                     const int n = q0 + l0 + rl;
                     if (n < N) store2(dst + (size_t)n * D3 + c0 + c, v0, v1);
                   },
                   sums, warp, N - q0 - l0);
      if (cdst)
        tile_product(Ps, PL, l0, false, 0, nk, Vs, HL, c0, cw, lane, f,
                     [&](int rl, int c, float v0, float v1) {
                       const int n = q0 + l0 + rl;
                       if (n < N) store2(cdst + (size_t)n * D + c0 + c, v0, v1);
                     });
    }
    __syncthreads();
    if (SUMS && !pl.multi()) flush(0);  // dq's sums: one block holds every row

    // phase 2: warps own 16 key rows; dv = P^T dC, then dk = dS^T Q, over the block
    for (int which = 0; which < 2; ++which) {  // 0: dv, 1: dk
      const bf16* A = which == 0 ? Ps : dSs;
      const bf16* Bm = which == 0 ? dCs : Qs;
      float* acc = which == 0 ? dVa : dKa;
      bf16* out = dst + (which == 0 ? 2 * D : D);
      for (int kt = warp; kt < nk; kt += pl.NW)
        tile_product(A, PL, 0, true, 16 * kt, QB / 16, Bm, HL, c0, cw, lane, f,
                     [&](int rl, int c, float v0, float v1) {
                       const int n = 16 * kt + rl;
                       if (pl.multi()) {
                         float* a = acc + (size_t)n * AL + c;
                         a[0] += v0;
                         a[1] += v1;
                       } else if (n < N) {
                         store2(out + (size_t)n * D3 + c0 + c, v0, v1);
                       }
                     },
                     pl.multi() ? nullptr : sums, warp, N - 16 * kt);
      if (SUMS && !pl.multi()) flush(which == 0 ? 2 * D : D);
    }
    __syncthreads();  // the block's tiles are rewritten by the next one
  }

  if (pl.multi()) {
    for (int idx = threadIdx.x; idx < N * (cw / 2); idx += blockDim.x) {
      const int n = idx / (cw / 2), c = 2 * (idx % (cw / 2));
      const float* k = dKa + (size_t)n * AL + c;
      const float* v = dVa + (size_t)n * AL + c;
      store2(dst + (size_t)n * D3 + D + c0 + c, k[0], k[1]);
      store2(dst + (size_t)n * D3 + 2 * D + c0 + c, v[0], v[1]);
    }
    if (SUMS) {  // dk's and dv's sums in row order, then dq's over the warps
      for (int c = threadIdx.x; c < cw; c += blockDim.x) {
        float sk = 0.f, sv = 0.f;
        for (int n = 0; n < N; ++n) {
          sk += dKa[(size_t)n * AL + c];
          sv += dVa[(size_t)n * AL + c];
        }
        sdst[D + c] = sk;
        sdst[2 * D + c] = sv;
      }
      flush(0);
    }
  }
}

template <bool RECOMPUTE, int KT, bool SUMS>
inline cudaError_t launch_attn_bwd_kt(const void* qkv, const void* probs, const void* dc, void* ctx,
                                      void* dqkv, float* psum, int B, int N, int D, int H,
                                      int seg_len, cudaStream_t s) {
  const int hd = D / H;
  const AttnBwdPlan pl(N, hd, SUMS);
  const size_t smem = pl.bytes();
  auto kernel = attn_bwd_core_kernel<RECOMPUTE, KT, SUMS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * H * pl.chunks(hd), 32 * pl.NW, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs), static_cast<const bf16*>(dc),
      static_cast<bf16*>(ctx), static_cast<bf16*>(dqkv), psum, N, D, H, hd, seg_len,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

// dqkv (B, N, 3D) bf16, each element rounded once, from qkv (B, N, 3D) and
// dc (B, N, D), both bf16; kernel 3 reads the stashed `probs`, the
// recompute core none. With `ctx` (B, N, D) the core also stores
// bf16(P_bf16 V); with SUMS, into `psum` (B, 3D) fp32, the column sums of
// the fp32 dqkv over each sample's rows (kernels 3 and 4; kernel 13 takes
// neither).
template <bool RECOMPUTE, bool SUMS = false>
inline cudaError_t launch_attn_bwd_core(const void* qkv, const void* probs, const void* dc, void* ctx,
                                        void* dqkv, int B, int N, int D, int H, int seg_len,
                                        cudaStream_t s, float* psum = nullptr) {
  if (AttnBwdPlan(N, D / H, SUMS).bytes() > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  switch (attn_kt(N)) {
    case 2: return launch_attn_bwd_kt<RECOMPUTE, 2, SUMS>(qkv, probs, dc, ctx, dqkv, psum, B, N, D, H, seg_len, s);
    case 5: return launch_attn_bwd_kt<RECOMPUTE, 5, SUMS>(qkv, probs, dc, ctx, dqkv, psum, B, N, D, H, seg_len, s);
    case 8: return launch_attn_bwd_kt<RECOMPUTE, 8, SUMS>(qkv, probs, dc, ctx, dqkv, psum, B, N, D, H, seg_len, s);
    default: return launch_attn_bwd_kt<RECOMPUTE, 16, SUMS>(qkv, probs, dc, ctx, dqkv, psum, B, N, D, H, seg_len, s);
  }
}

}  // namespace sky
