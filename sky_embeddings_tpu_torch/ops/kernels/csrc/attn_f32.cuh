// The fp32 attention kernels: kernels 12 and 13 in fp32 (attention.cu
// launches them alone; their design is noted there) and the fp32 attention
// cores of the attention-block kernels' fp32 forms (attn_block.cu,
// attn_block_bwd.cu):
//
// - attn_fwd_f32_kernel: ctx = softmax(Q K^T * hd^-0.5) V from an fp32 qkv
//   (B, N, 3D); with `probs` it also stores the fp32 probabilities (B, H,
//   N, N), the stash of kernel 2's fp32 form (K2's form passes none);
// - attn_bwd_f32_kernel<STAGED, STASH = false, CTX = false>: kernel 13,
//   dqkv from qkv and dctx with P recomputed;
// - attn_bwd_f32_kernel<STAGED, STASH = false, CTX = true>: the core of
//   kernel 4's fp32 form: kernel 13's, which also writes ctx = P V beside
//   dqkv for dWproj. The recomputed P is the forward core's bit for bit
//   (the same FMA chains and softmax), and so is this ctx, so the block's
//   backward needs no second run of the forward core;
// - attn_bwd_f32_kernel<STAGED, STASH = true, CTX = true>: the core of
//   kernel 3's fp32 form: P read from the stashed fp32 probabilities
//   instead of recomputed (f32_softmax_bwd_rows takes only the softmax's
//   backward), and ctx = P V written beside dqkv, as attn_bwd_core_plain
//   computes it.
// With CTX, P keeps a buffer of its own, so V stays staged for ctx = P V.
//
// Packed segments (seg_len > 0, MAE sequence packing; the forward and the
// recompute backward): JAX's _seg_bias (attn_block.py:84-100) adds -1e9 to
// the scaled logit of every key outside the query's segment (token i is in
// segment i / seg_len), before the softmax; exp of it underflows to exactly
// 0 in fp32, so those probabilities, and the dS they give, are exact zeros.
// f32_softmax_rows adds the same bias to the same logits. Padded rows and
// columns (N..NP-1) are never in a softmax row, so the mask cannot turn
// them into NaN; every real row's segment holds at least its own key. The
// stash backward needs no mask: the stashed probabilities carry the zeros.
#pragma once

#include "attn_core.cuh"

namespace sky {

constexpr int F32_MAX_THREADS = 512;

// Shared-memory plan of the fp32 kernels at (N, hd). Tokens pad to NP (a
// multiple of 4), head dims to HD4; staged rows are HP = HD4 + 4 floats
// apart. Staged (one CTA per (sample, head), the whole head):
//   forward   Q, K, V   NP x HP each; S  NP x NP
//   backward  Q, K, V, dC  NP x HP each; dP  NP x NP; S  NP x NP in V's
//             place once dP is done (a buffer of its own if NP > HP, or
//             with `keep_v`: the backwards that write ctx = P V, which
//             reads V after dP)
// ViT-B (N = 65, hd = 64): 73 984 and 92 480 bytes, three and two CTAs an
// SM; ViT-H (N = 66, hd = 80): 87 040 and 109 888, two CTAs. Otherwise from
// device memory: the forward one CTA per (sample, head, block of QB query
// rows) with S QB x NP; the backward one CTA per (sample, head, HC columns)
// with S and dP QB x NP and, with several blocks, dK and dV NP x HC in fp32:
// the widest HC (a multiple of 8), then the largest QB, that fits (N = 256
// at hd = 64: QB = 32, HC = 64, 196 608 bytes). This plan fits every N <=
// 256 at any head width. threads: one per 4 x 4 tile of the largest
// product, in warps, 128 to 512.
struct AttnF32Plan {
  int NP, HD4, HP, staged, QB, HC, threads;
  size_t total;
  __host__ __device__ AttnF32Plan(int N, int hd, bool backward, bool keep_v = false) {
    NP = (N + 3) & ~3;
    HD4 = (hd + 3) & ~3;
    HP = HD4 + 4;
    const size_t cap = SMEM_OPTIN_MAX / sizeof(float);
    const size_t sq = (size_t)NP * NP, rows = (size_t)NP * HP;
    total = backward ? 4 * rows + sq + (NP > HP || keep_v ? sq : 0) : 3 * rows + sq;
    staged = total <= cap;
    QB = NP;
    HC = (hd + 7) & ~7;
    if (!staged && !backward) {
      while (QB > 4 && (size_t)QB * NP > cap) QB = QB > 128 ? 128 : (QB / 2) & ~3;
      total = (size_t)QB * NP;
    } else if (!staged) {
      const int hcs[5] = {HC, 64, 32, 16, 8};
      for (int i = 0; i < 5 && !fits(cap); ++i) {
        if (i > 0 && hcs[i] >= hcs[0]) continue;
        HC = hcs[i];
        for (QB = NP; QB >= 4; QB = QB > 64 ? 64 : (QB / 2) & ~3)
          if (fits(cap)) break;
      }
      total = 2 * (size_t)QB * NP + (QB < NP ? 2 * (size_t)NP * HC : 0);
    }
    total *= sizeof(float);
    const int rg = QB / 4, kg = NP / 4, cg = HC / 4;
    int tiles = rg * kg;
    tiles = tiles > rg * cg ? tiles : rg * cg;
    if (backward) tiles = tiles > kg * cg ? tiles : kg * cg;
    threads = (tiles + 31) & ~31;
    threads = threads < 128 ? 128 : threads > F32_MAX_THREADS ? F32_MAX_THREADS : threads;
  }
  // the general backward's bytes (floats) at this QB and HC fit `cap`
  __host__ __device__ bool fits(size_t cap) const {
    return QB >= 4 && 2 * (size_t)QB * NP + (QB < NP ? 2 * (size_t)NP * HC : 0) <= cap;
  }
  __host__ __device__ int blocks(int N) const { return (N + QB - 1) / QB; }
  __host__ __device__ int chunks(int hd) const { return (hd + HC - 1) / HC; }
  __host__ __device__ size_t bytes() const { return total; }
};

// 4-byte global -> shared copy; when !pred it reads nothing and zero-fills.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 4 : 0));
}

// A row-major fp32 matrix, read 4 columns at a time: staged (shared memory,
// zero past its rows and up to HD4 columns; one float4 load) or in device
// memory (`rows` x `cols`, element by element, zero outside).
template <bool STAGED>
struct F32Mat {
  const float* p;
  size_t ld;
  int rows, cols;
  __device__ __forceinline__ float4 row4(int r, int c) const {
    const float* q = p + (size_t)r * ld + c;
    if (STAGED) return *reinterpret_cast<const float4*>(q);
    const bool ok = r < rows;
    float4 v;
    v.x = ok && c < cols ? __ldg(q) : 0.f;
    v.y = ok && c + 1 < cols ? __ldg(q + 1) : 0.f;
    v.z = ok && c + 2 < cols ? __ldg(q + 2) : 0.f;
    v.w = ok && c + 3 < cols ? __ldg(q + 3) : 0.f;
    return v;
  }
};

// rows [0, N) of an N x hd matrix (rows `pitch` floats apart) into dst
// (NP x HP), zero in rows N..NP-1 and columns hd..HD4-1; 16-byte copies
// where `vec` (hd % 4 == 0 and a 16-byte aligned source), else 4-byte ones
__device__ __forceinline__ void f32_stage(float* dst, const float* src, size_t pitch, int N,
                                          const AttnF32Plan& pl, int hd, bool vec) {
  if (vec) {
    for (VecWalk w(threadIdx.x, blockDim.x, pl.HD4 / 4); w.n < pl.NP; w.next()) {
      const bool ok = w.n < N;
      cp_async16(dst + w.n * pl.HP + 4 * w.c, ok ? src + (size_t)w.n * pitch + 4 * w.c : src, ok);
    }
  } else {
    for (VecWalk w(threadIdx.x, blockDim.x, pl.HD4); w.n < pl.NP; w.next()) {
      const bool ok = w.n < N && w.c < hd;
      cp_async4(dst + w.n * pl.HP + w.c, ok ? src + (size_t)w.n * pitch + w.c : src, ok);
    }
  }
}

// up to 4 output elements of one row from v[0..3]: a float4 store where
// `vec` and all 4 are in range, else the first `left` one by one
__device__ __forceinline__ void f32_store4(float* p, const float (&v)[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) p[e] = v[e];
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// The products, each cut into 4 x 4 register tiles of fp32 FMAs, one tile
// per thread: a tile's rows (keys, in dK and dV) are ri + RG r, r < 4, for
// RG = rows / 4, so a warp's threads read neighbouring rows, which hit
// distinct banks (rows HP = 4 x odd floats apart); its columns are one
// float4, 4 ci..4 ci + 3.

// S[i * ldo + j] = scale * sum_d A[i][d] B[j][d] for i < na rows of A, j < nb
// rows of B (both multiples of 4), over d < d4 (zero past the head), each
// one fmaf chain in order of d.
template <bool STAGED>
__device__ __forceinline__ void f32_nt(const F32Mat<STAGED>& A, const F32Mat<STAGED>& B, int na, int nb,
                                       int d4, float scale, float* out, int ldo) {
  const int RG = na / 4, KG = nb / 4;
  for (int tile = threadIdx.x; tile < RG * KG; tile += blockDim.x) {
    const int ri = tile / KG, kj = tile % KG;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < d4; d += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A.row4(ri + RG * r, d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 b = B.row4(kj + KG * c, d);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = acc[r][c];
          v = fmaf(a[r].x, b.x, v);
          v = fmaf(a[r].y, b.y, v);
          v = fmaf(a[r].z, b.z, v);
          acc[r][c] = fmaf(a[r].w, b.w, v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(ri + RG * r) * ldo + kj + KG * c] = acc[r][c] * scale;
  }
}

// C[i][c] = sum_{j < nk} P[i * ldp + j] B[j][c0 + c] for i < na (a multiple
// of 4) and c < cw, each one fmaf chain in order of j, handed to emit(i, c,
// v[4]) by 4 columns. P is read 4 keys at a time (float4s; nk, ldp and P's
// columns past the real keys, which must hold zeros, to a multiple of 4):
// a padded key adds fmaf(0, 0, acc) = acc to each chain.
template <bool STAGED, typename Emit>
__device__ __forceinline__ void f32_nn(const float* P, int ldp, int na, const F32Mat<STAGED>& B, int nk,
                                       int c0, int cw, Emit emit) {
  const int RG = na / 4, CG = (cw + 3) / 4;
  for (int tile = threadIdx.x; tile < RG * CG; tile += blockDim.x) {
    const int ri = tile / CG, ci = tile % CG;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    const float* prow = P + ri * ldp;
    for (int j = 0; j < nk; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = *reinterpret_cast<const float4*>(prow + RG * r * ldp + j);
      const float4 b0 = B.row4(j, c0 + 4 * ci), b1 = B.row4(j + 1, c0 + 4 * ci);
      const float4 b2 = B.row4(j + 2, c0 + 4 * ci), b3 = B.row4(j + 3, c0 + 4 * ci);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fma4(acc[r], p[r].x, b0);
        fma4(acc[r], p[r].y, b1);
        fma4(acc[r], p[r].z, b2);
        fma4(acc[r], p[r].w, b3);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) emit(ri + RG * r, 4 * ci, acc[r]);
  }
}

// dK[k][c] = sum_i dS[i][k] Q[i][c0 + c] and dV[k][c] = sum_i P[i][k] dC[i][c0 +
// c] over the block's ni query rows (dS, P at pitch ldp), for k < nk (a
// multiple of 4) and c < cw, each one fmaf chain in order of i. With `accK`
// (several query blocks; fp32, pitch lda) the chains start from and end in
// accK and accV; otherwise from zero, handed to emit(k, c, dk[4], dv[4]).
template <bool STAGED, typename Emit>
__device__ __forceinline__ void f32_tn2(const float* dS, const float* P, int ldp, int nk,
                                        const F32Mat<STAGED>& Qm, const F32Mat<STAGED>& dCm, int ni,
                                        int c0, int cw, float* accK, float* accV, int lda, Emit emit) {
  const int KG = nk / 4, CG = (cw + 3) / 4;
  for (int tile = threadIdx.x; tile < KG * CG; tile += blockDim.x) {
    const int kj = tile / CG, ci = tile % CG;
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (kj + KG * r) * lda + 4 * ci + e;
        dk[r][e] = accK ? accK[at] : 0.f;
        dv[r][e] = accK ? accV[at] : 0.f;
      }
    for (int i = 0; i < ni; ++i) {
      const float4 q = Qm.row4(i, c0 + 4 * ci), g = dCm.row4(i, c0 + 4 * ci);
      const float* ds = dS + i * ldp + kj;
      const float* p = P + i * ldp + kj;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fma4(dk[r], ds[KG * r], q);
        fma4(dv[r], p[KG * r], g);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (accK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (kj + KG * r) * lda + 4 * ci + e;
          accK[at] = dk[r][e];
          accV[at] = dv[r][e];
        }
      } else {
        emit(kj + KG * r, 4 * ci, dk[r], dv[r]);
      }
    }
  }
}

// The softmax of rows [0, nrows) of S (pitch lds, logits already scaled) over
// their first N keys, in place, with the arithmetic of a warp per row (the
// order of the plain version's softmax on the card): lane l adds the exps of
// keys l, l + 32, ..., the lanes' sums meet in an xor butterfly (16, 8, 4,
// 2, 1), and each P is e / sum. Here four neighbouring threads take a row,
// thread q the warp's lanes q, q + 4, ..., q + 28: levels 16, 8 and 4 of the
// butterfly add its own lanes in registers, levels 2 and 1 go by shuffle,
// so every sum is the warp's, bit for bit, with no lane idle past N. With
// dP (the backward) also delta_i = sum_j dP_ij P_ij (the same way) and dS =
// (dP P - P delta) * scale into dP. Row r is query q0 + r; with seg > 0 its
// logits outside the query's segment take JAX's -1e9 bias first (above).
__device__ __forceinline__ float f32_quad_tree(float (&v)[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] += v[m + 4];  // xor 16
#pragma unroll
  for (int m = 0; m < 2; ++m) v[m] += v[m + 2];  // xor 8
  float t = v[0] + v[1];                          // xor 4
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  return t + __shfl_xor_sync(0xffffffffu, t, 1);
}

__device__ __forceinline__ void f32_softmax_rows(float* S, float* dP, int lds, int nrows, int N,
                                                 float scale, int q0 = 0, int seg = 0) {
  const int q = threadIdx.x & 3;
  const int rounds = (nrows + blockDim.x / 4 - 1) / (blockDim.x / 4);
  for (int k = 0; k < rounds; ++k) {  // every thread runs every round: the shuffles
    const int r = k * (blockDim.x / 4) + (threadIdx.x >> 2);
    const bool ok = r < nrows;
    float* row = S + (ok ? r : 0) * lds;
    float mx = -CUDART_INF_F;
    const int sid = seg > 0 ? (q0 + r) / seg : 0;
    for (int j = q; ok && j < N; j += 4) {  // the exp loop below gives j to this thread too
      if (seg > 0 && j / seg != sid) row[j] += -1e9f;
      mx = fmaxf(mx, row[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      v[m] = 0.f;
      for (int j = q + 4 * m; ok && j < N; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        v[m] += e;
      }
    }
    const float sum = f32_quad_tree(v);
    if (!dP) {
      for (int j = q; ok && j < N; j += 4) row[j] = row[j] / sum;
      continue;
    }
    float* drow = dP + (ok ? r : 0) * lds;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      v[m] = 0.f;
      for (int j = q + 4 * m; ok && j < N; j += 32) {
        const float p = row[j] / sum;
        const float dp = drow[j];
        row[j] = p;
        v[m] += dp * p;
      }
    }
    const float delta = f32_quad_tree(v);
    for (int j = q; ok && j < N; j += 4) drow[j] = (drow[j] * row[j] - row[j] * delta) * scale;
  }
}

// The softmax backward alone, for probabilities P already in rows [0,
// nrows) of P (pitch lds): delta_i = sum_j dP_ij P_ij in the order of
// f32_softmax_rows (a warp's lanes, four threads a row) and dS = (dP P - P
// delta) * scale into dP.
__device__ __forceinline__ void f32_softmax_bwd_rows(const float* P, float* dP, int lds, int nrows,
                                                     int N, float scale) {
  const int q = threadIdx.x & 3;
  const int rounds = (nrows + blockDim.x / 4 - 1) / (blockDim.x / 4);
  for (int k = 0; k < rounds; ++k) {  // every thread runs every round: the shuffles
    const int r = k * (blockDim.x / 4) + (threadIdx.x >> 2);
    const bool ok = r < nrows;
    const float* row = P + (ok ? r : 0) * lds;
    float* drow = dP + (ok ? r : 0) * lds;
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      v[m] = 0.f;
      for (int j = q + 4 * m; ok && j < N; j += 32) v[m] += drow[j] * row[j];
    }
    const float delta = f32_quad_tree(v);
    for (int j = q; ok && j < N; j += 4) drow[j] = (drow[j] * row[j] - row[j] * delta) * scale;
  }
}

// Kernel 12, fp32. Staged: one CTA per (sample, head), Q and K in one
// cp.async group and V in a second, which lands while S is computed.
// Otherwise one CTA per (sample, head, block of QB query rows), operands
// from device memory. With `probs` (B, H, N, N) each block's probabilities
// are stored too (kernel 2's fp32 form); seg > 0 masks to packed segments.
template <bool STAGED>
__global__ void __launch_bounds__(F32_MAX_THREADS, 2)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ ctx,
                    float* __restrict__ probs, AttnF32Plan pl, int N, int D, int H, int hd,
                    float scale, int vec, int seg) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int NP = pl.NP, HP = pl.HP, nb = pl.blocks(N);
  const int pair = blockIdx.x / nb, q0 = (blockIdx.x % nb) * pl.QB;
  const int b = pair / H, h = pair % H;
  const size_t D3 = 3 * (size_t)D;
  const float* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  float* out = ctx + ((size_t)b * N + q0) * D + (size_t)h * hd;
  const int rows = min(pl.QB, N - q0);

  F32Mat<STAGED> Q{src + q0 * D3, D3, N - q0, hd}, K{src + D, D3, N, hd}, V{src + 2 * D, D3, N, hd};
  float* S = sm;
  if (STAGED) {
    float* Qs = sm;
    float* Ks = Qs + NP * HP;
    float* Vs = Ks + NP * HP;
    S = Vs + NP * HP;
    f32_stage(Qs, src, D3, N, pl, hd, vec);
    f32_stage(Ks, src + D, D3, N, pl, hd, vec);
    cp_async_commit();
    f32_stage(Vs, src + 2 * D, D3, N, pl, hd, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    Q = {Qs, (size_t)HP, 0, 0};
    K = {Ks, (size_t)HP, 0, 0};
    V = {Vs, (size_t)HP, 0, 0};
  }
  f32_nt<STAGED>(Q, K, pl.QB, NP, pl.HD4, scale, S, NP);
  __syncthreads();
  f32_softmax_rows(S, nullptr, NP, rows, N, scale, q0, seg);
  if (STAGED) cp_async_wait<0>();
  __syncthreads();
  if (probs) {
    float* pr = probs + ((size_t)pair * N + q0) * N;
    for (int i = threadIdx.x; i < rows * N; i += blockDim.x) pr[i] = S[(i / N) * NP + i % N];
  }
  f32_nn<STAGED>(S, NP, pl.QB, V, NP, 0, hd, [&](int r, int c, const float(&v)[4]) {
    if (r < rows) f32_store4(out + (size_t)r * D + c, v, hd - c, vec);
  });
}

// Kernel 13, fp32. Staged: one CTA per (sample, head), dC and V in one
// cp.async group and Q and K in a second, which lands while dP is
// computed; dP in a buffer, S in V's place once dP is done (where it fits).
// Otherwise one CTA per (sample, head, HC columns) walks the head's blocks
// of QB query rows with operands from device memory, dK and dV carried
// across blocks in fp32 accumulators. STASH (kernel 3's fp32 form): P is
// the block's rows of the stashed `probs` (B, H, N, N), read into S, in
// place of Q K^T and the softmax. CTX (kernels 3 and 4's fp32 forms): ctx
// = P V (this CTA's columns) is written to `ctx` (B, N, D), S in a buffer
// of its own (the plan's keep_v). seg > 0 masks the recomputed softmax to
// packed segments.
template <bool STAGED, bool STASH, bool CTX>
__global__ void __launch_bounds__(F32_MAX_THREADS, 2)
attn_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                    float* __restrict__ dqkv, const float* __restrict__ probs,
                    float* __restrict__ ctx, AttnF32Plan pl, int N, int D, int H, int hd,
                    float scale, int vec, int seg) {
  static_assert(CTX || !STASH, "the stash backward writes ctx");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int NP = pl.NP, HP = pl.HP, QB = pl.QB, nch = pl.chunks(hd);
  const int pair = blockIdx.x / nch, c0 = (blockIdx.x % nch) * pl.HC;
  const int cw = min(pl.HC, hd - c0);
  const int b = pair / H, h = pair % H;
  const size_t D3 = 3 * (size_t)D;
  const float* src = qkv + (size_t)b * N * D3 + (size_t)h * hd;
  const float* dcs = dctx + (size_t)b * N * D + (size_t)h * hd;
  float* dst = dqkv + (size_t)b * N * D3 + (size_t)h * hd + c0;  // + 0 / D / 2D: dq / dk / dv
  const bool multi = QB < N;

  F32Mat<STAGED> Qm, dCm, Km{src + D, D3, N, hd}, Vm{src + 2 * D, D3, N, hd};
  float *S, *dP, *accK = nullptr, *accV = nullptr;
  if (STAGED) {
    float* Qs = sm;
    float* Ks = Qs + NP * HP;
    float* Vs = Ks + NP * HP;
    float* dCs = Vs + NP * HP;
    dP = dCs + NP * HP;
    S = NP <= HP && !CTX ? Vs : dP + NP * NP;  // S overwrites V once dP = dC V^T is done
    f32_stage(dCs, dcs, D, N, pl, hd, vec);
    f32_stage(Vs, src + 2 * D, D3, N, pl, hd, vec);
    cp_async_commit();
    f32_stage(Qs, src, D3, N, pl, hd, vec);
    f32_stage(Ks, src + D, D3, N, pl, hd, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    Qm = {Qs, (size_t)HP, 0, 0};
    Km = {Ks, (size_t)HP, 0, 0};
    Vm = {Vs, (size_t)HP, 0, 0};
    dCm = {dCs, (size_t)HP, 0, 0};
  } else {
    dP = sm;
    S = dP + QB * NP;
    if (multi) {
      accK = S + QB * NP;
      accV = accK + NP * pl.HC;
      for (int i = threadIdx.x; i < 2 * NP * pl.HC; i += blockDim.x) accK[i] = 0.f;
    }
  }

  for (int q0 = 0; q0 < N; q0 += QB) {
    const int rows = min(QB, N - q0);
    if (!STAGED) {
      Qm = {src + q0 * D3, D3, N - q0, hd};
      dCm = {dcs + (size_t)q0 * D, (size_t)D, N - q0, hd};
    }
    f32_nt<STAGED>(dCm, Vm, QB, NP, pl.HD4, 1.f, dP, NP);
    if (STAGED) cp_async_wait<0>();
    __syncthreads();  // staged: V is dead (but with CTX), Q and K have landed
    if (STASH) {
      const float* pr = probs + ((size_t)(b * H + h) * N + q0) * N;
      for (int i = threadIdx.x; i < QB * NP; i += blockDim.x) {
        const int r = i / NP, j = i % NP;
        S[i] = r < rows && j < N ? pr[(size_t)r * N + j] : 0.f;
      }
    } else {
      f32_nt<STAGED>(Qm, Km, QB, NP, pl.HD4, scale, S, NP);
    }
    __syncthreads();
    if (STASH)
      f32_softmax_bwd_rows(S, dP, NP, rows, N, scale);
    else
      f32_softmax_rows(S, dP, NP, rows, N, scale, q0, seg);
    __syncthreads();
    // dq = dS K for the block's rows, this CTA's columns
    f32_nn<STAGED>(dP, NP, QB, Km, NP, c0, cw, [&](int r, int c, const float(&v)[4]) {
      if (r < rows) f32_store4(dst + (size_t)(q0 + r) * D3 + c, v, cw - c, vec);
    });
    if (CTX) {  // ctx = P V, this CTA's columns
      float* co = ctx + ((size_t)b * N + q0) * D + (size_t)h * hd + c0;
      f32_nn<STAGED>(S, NP, QB, Vm, NP, c0, cw, [&](int r, int c, const float(&v)[4]) {
        if (r < rows) f32_store4(co + (size_t)r * D + c, v, cw - c, vec);
      });
    }
    // dk = dS^T Q and dv = P^T dC over the block's rows
    f32_tn2<STAGED>(dP, S, NP, NP, Qm, dCm, rows, c0, cw, accK, accV, pl.HC,
                    [&](int k, int c, const float(&gk)[4], const float(&gv)[4]) {
                      if (k >= N) return;
                      f32_store4(dst + (size_t)k * D3 + D + c, gk, cw - c, vec);
                      f32_store4(dst + (size_t)k * D3 + 2 * D + c, gv, cw - c, vec);
                    });
    __syncthreads();  // S and dP are rewritten by the next block
  }
  if (multi) {
    for (int idx = threadIdx.x; idx < N * cw; idx += blockDim.x) {
      const int n = idx / cw, c = idx % cw;
      dst[(size_t)n * D3 + D + c] = accK[n * pl.HC + c];
      dst[(size_t)n * D3 + 2 * D + c] = accV[n * pl.HC + c];
    }
  }
}

// the grid fits one launch and the kernel may take the plan's shared memory
template <typename K>
inline cudaError_t prepare_f32(K kernel, const AttnF32Plan& pl, long long grid) {
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(pl.bytes()));
}

// The forward (ctx into `out`; with `probs` also the probabilities) or the
// backward (dqkv into `out`; with `probs` the stash backward, which reads
// them and writes `ctx`; without, the recompute backward, which writes
// `ctx` too where one is given). seg_len > 0 masks the forward and the
// recompute backward to packed segments (>= N: no mask).
inline cudaError_t launch_f32(bool backward, const void* qkv, const void* dctx, void* out, int B,
                              int N, int D, int H, cudaStream_t s, void* probs = nullptr,
                              void* ctx = nullptr, int seg_len = 0) {
  const int hd = D / H;
  const bool stash = backward && probs != nullptr, with_ctx = backward && ctx != nullptr;
  if ((stash && !with_ctx) || seg_len < 0 || (stash && seg_len > 0)) return cudaErrorInvalidValue;
  const int seg = seg_len < N ? seg_len : 0;
  const AttnF32Plan pl(N, hd, backward, with_ctx);
  if (pl.bytes() > SMEM_OPTIN_MAX) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  const int vec = hd % 4 == 0 && aligned(qkv) && aligned(out) && (!dctx || aligned(dctx)) &&
                  (!ctx || aligned(ctx));
  const long long grid = (long long)B * H * (backward ? pl.chunks(hd) : pl.blocks(N));
  const size_t smem = pl.bytes();
  const float* q = static_cast<const float*>(qkv);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (backward) {
    const float* g = static_cast<const float*>(dctx);
    const float* pr = static_cast<const float*>(probs);
    float* c = static_cast<float*>(ctx);
    auto kernel = stash      ? (pl.staged ? attn_bwd_f32_kernel<true, true, true>
                                          : attn_bwd_f32_kernel<false, true, true>)
                  : with_ctx ? (pl.staged ? attn_bwd_f32_kernel<true, false, true>
                                          : attn_bwd_f32_kernel<false, false, true>)
                             : (pl.staged ? attn_bwd_f32_kernel<true, false, false>
                                          : attn_bwd_f32_kernel<false, false, false>);
    if ((err = prepare_f32(kernel, pl, grid)) != cudaSuccess) return err;
    kernel<<<static_cast<int>(grid), pl.threads, smem, s>>>(q, g, o, pr, c, pl, N, D, H, hd, scale,
                                                            vec, seg);
  } else {
    auto kernel = pl.staged ? attn_fwd_f32_kernel<true> : attn_fwd_f32_kernel<false>;
    if ((err = prepare_f32(kernel, pl, grid)) != cudaSuccess) return err;
    kernel<<<static_cast<int>(grid), pl.threads, smem, s>>>(q, o, static_cast<float*>(probs), pl, N,
                                                            D, H, hd, scale, vec, seg);
  }
  return cudaGetLastError();
}

}  // namespace sky
