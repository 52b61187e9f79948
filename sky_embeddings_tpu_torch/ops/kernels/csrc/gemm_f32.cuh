// The fp32 GEMM of the block kernels' fp32 forms, for Hopper (sm_90a):
// every fp32 product as three TF32 products on the tensor cores (3xTF32),
// through mma.sync.m16n8k8.
//
// It replaces no TPU kernel by itself: JAX sends fp32 blocks to XLA's fp32
// einsums (models/layers.py:253, :356), never to its Pallas kernels, and
// the port's North star forbids the plain path on the card. So the fp32
// forms of K1 and kernels 6-9 (mlp_block.cu, mlp_block_bwd.cu) and of K2
// and kernels 2-4 (attn_block.cu, attn_block_bwd.cu) run every product
// here, in the three forms of gemm_sm90.cuh, all operands fp32 and
// row-major:
//   FWD  C (M, N) = A (M, K) @ B (K, N): qkv, proj, fc1, fc2 and the
//        backwards' fc1 and qkv recomputes (B, the (in, out) weight, read
//        N-major);
//   NT   C = A (M, K) @ B^T, B stored (N, K): dctx, dh, dy;
//   TN   C = A^T @ B, A stored (K, M), B (K, N): the weight gradients over
//        the K = B*N token rows; where the tiles would leave SMs idle in
//        their last wave, split along K into slices (split_slice), each
//        stored to its own fp32 workspace plane, then added in slice order
//        by a second launch.
// Epilogues: BIAS (acc + bias), BIAS_GELU (gelu_erf(acc + bias), exact erf),
// BIAS_RESIDUAL (resid + (acc + bias)), STORE, DGELU (NT, the MLP backward's
// dh = g @ W2^T: reads the fc1 pre-activation a from `resid`, stores da =
// dh * gelu'(a) and gelu(a) into `aux`, which may be `resid` itself),
// BIAS_GELU_STASH (FWD, kernel 6's fc1: BIAS_GELU that also stores the
// pre-activation acc + bias into `aux`) and ADD (acc + c, kernel 9's dy
// summed over the slabs), the plain versions' formulas and orders
// (ops/kernels/mlp_block.py, attn_block.py). Each operand and C may have a
// row pitch of its own (Ld; kernel 9 reads W1's column slabs and writes
// dW1's in place).
//
// Numerics: each operand x is split into big = tf32(x) and small = tf32(x -
// big), both rounded to nearest, and a product adds small * big, big *
// small and big * big with fp32 accumulation (CUTLASS's "fast fp32"): about
// 21 bits of each operand, against the 24 of the plain version's fp32
// products (cuBLAS with TF32 off). The tensor cores' accumulator does not
// round to nearest, and over a long K its error grows with K (1.3e-4 of
// the largest output at K = 16 896 on the H100, over this GEMM's 1e-4
// bar); so each 16-deep slab is summed on the tensor cores from zero and
// added to the running sum by an fp32 add, which rounds to nearest.
// Kernels 12 and 13 needed 5e-7 and kept fp32 FMAs; here the bar is 1e-4
// per output, and 3xTF32 does a third of the work of a bf16 split with 5-6
// products (kernel 11).
//
// Design (a first one, right before fast): a CTA computes a 128 x 128 tile
// with 8 warps of 64 x 32 (16 m16n8 accumulator tiles a warp); K goes in
// 16-deep slabs through a 4-stage cp.async ring of 16-byte copies,
// zero-filled past the edges. The ring keeps each operand in its global
// layout (K-major rows padded to 20 floats, N-major rows to 136), and the
// fragments come from plain 32-bit shared loads, which take either layout
// without conflicts (the 32 lanes of a load hit 32 banks): one template
// serves all three forms. wgmma's tf32 form takes both shared operands
// K-major only, so the forward's weight and TN's A would need a transpose
// first; a wgmma + TMA fp32 GEMM is a later redesign. Every output element
// is one thread's sum in a fixed order and split slices are added in
// order, with no atomics: two launches give the same bits.
//
// Bound on the H100: operations, 2 M N K FLOP of fp32 products at the
// faster of 3xTF32 (495 / 3 = 165 TFLOP/s) and the CUDA cores' FMAs (67);
// mma.sync reaches a part of the tensor cores' rate (PERF.md).
#pragma once

#include "common.cuh"

namespace sky {
namespace f32 {

enum Form { FWD = 0, NT = 1, TN = 2 };
enum Epi { BIAS = 0, BIAS_GELU = 1, BIAS_RESIDUAL = 2, STORE = 3, DGELU = 4, BIAS_GELU_STASH = 5,
           ADD = 6 };

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 4, THREADS = 256;
constexpr int KP = BK + 4;  // pitch of a K-major tile row: 128 rows x 16 k
constexpr int MP = BM + 8;  // pitch of an N-major tile row: 16 k x 128
constexpr int TILE = BM * KP;  // floats of one operand's slot (>= BK * MP)
constexpr size_t SMEM = (size_t)STAGES * 2 * TILE * sizeof(float);  // 81 920 bytes
constexpr int MAX_SPLITS = 8;
constexpr int MIN_SLICE = 1024;  // token rows of a split slice at least

struct Args {
  const float* a;
  const float* b;
  const float* bias;
  const float* resid;
  float* c;
  float* aux;
  int M, N, K;
  int lda, ldb, ldc;  // row pitches (floats) of A, B and C (resid and aux share C's)
  int kslice;  // K rows per split slice, a multiple of BK (>= K: unsplit)
};

// Row pitches in floats, 0 for a dense operand: A's row is K long (M for
// TN), B's N (K for NT), C's N.
struct Ld {
  int a = 0, b = 0, c = 0;
};

// rows r0..r0+127, columns k0..k0+15 of a row-major (rows, K) matrix with
// rows `ld` floats apart into s[128][KP] (K % 4 == 0, so a 16-byte vector
// is wholly in or out)
__device__ __forceinline__ void load_kmajor(float* s, const float* g, int rows, int K, int ld,
                                            int r0, int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
    const int r = i >> 2, kc = (i & 3) * 4;
    const bool ok = r0 + r < rows && k0 + kc < K;
    cp_async16(s + r * KP + kc, ok ? g + (size_t)(r0 + r) * ld + k0 + kc : g, ok);
  }
}

// rows k0..k0+15, columns c0..c0+127 of a row-major (K, cols) matrix with
// rows `ld` floats apart into s[BK][MP] (cols % 4 == 0)
__device__ __forceinline__ void load_nmajor(float* s, const float* g, int cols, int K, int ld,
                                            int c0, int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < BK * BM / 4; i += THREADS) {
    const int k = i >> 5, cc = (i & 31) * 4;
    const bool ok = k0 + k < K && c0 + cc < cols;
    cp_async16(s + k * MP + cc, ok ? g + (size_t)(k0 + k) * ld + c0 + cc : g, ok);
  }
}

// element (row r, depth k) of a slot, K-major or N-major
template <bool KMAJOR>
__device__ __forceinline__ float ld_op(const float* s, int r, int k) {
  return KMAJOR ? s[r * KP + k] : s[k * MP + r];
}

// x = big + small, both TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32; d 16 x 8 fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring outputs (m, n), (m, n + 1) through the epilogue (N even)
template <int EPI>
__device__ __forceinline__ void epi_store(const Args& p, float* c, int m, int n, float v0,
                                          float v1) {
  if (m >= p.M || n >= p.N) return;
  const size_t at = (size_t)m * p.ldc + n;
  if (EPI == BIAS || EPI == BIAS_GELU || EPI == BIAS_RESIDUAL || EPI == BIAS_GELU_STASH) {
    v0 += p.bias[n];
    v1 += p.bias[n + 1];
  }
  if (EPI == BIAS_GELU_STASH) *reinterpret_cast<float2*>(p.aux + at) = make_float2(v0, v1);
  if (EPI == BIAS_GELU || EPI == BIAS_GELU_STASH) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (EPI == BIAS_RESIDUAL) {
    const float2 r = *reinterpret_cast<const float2*>(p.resid + at);
    v0 = r.x + v0;
    v1 = r.y + v1;
  }
  if (EPI == ADD) {
    const float2 r = *reinterpret_cast<const float2*>(c + at);
    v0 += r.x;
    v1 += r.y;
  }
  if (EPI == DGELU) {
    const float2 a = *reinterpret_cast<const float2*>(p.resid + at);
    float h0, d0, h1, d1;
    gelu_erf_and_grad(a.x, h0, d0);
    gelu_erf_and_grad(a.y, h1, d1);
    v0 *= d0;
    v1 *= d1;
    *reinterpret_cast<float2*>(p.aux + at) = make_float2(h0, h1);
  }
  *reinterpret_cast<float2*>(c + at) = make_float2(v0, v1);
}

// One 128 x 128 output tile (blockIdx.x: N, blockIdx.y: M) over the K slice
// blockIdx.z; a split product stores slice z at c + z * M * N.
template <int FORM, int EPI>
__global__ void __launch_bounds__(THREADS, 1) gemm_f32_kernel(const Args p) {
  constexpr bool A_KMAJOR = FORM != TN, B_KMAJOR = FORM == NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + STAGES * TILE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * p.kslice;
  const int ke = min(p.K, kb + p.kslice);
  const int tiles = (ke - kb + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    float* a = sa + stage * TILE;
    float* b = sb + stage * TILE;
    if (A_KMAJOR)
      load_kmajor(a, p.a, p.M, p.K, p.lda, m0, k0);
    else
      load_nmajor(a, p.a, p.M, p.K, p.lda, m0, k0);
    if (B_KMAJOR)
      load_kmajor(b, p.b, p.N, p.K, p.ldb, n0, k0);
    else
      load_nmajor(b, p.b, p.N, p.K, p.ldb, n0, k0);
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) load(st, kb + st * BK);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // slab i has landed
    __syncthreads();              // and every warp is done with slab i - 1's slot
    const int nx = i + STAGES - 1;
    if (nx < tiles) load(nx % STAGES, kb + nx * BK);
    cp_async_commit();
    const float* a = sa + (i % STAGES) * TILE;
    const float* b = sb + (i % STAGES) * TILE;
    unsigned bhi[2][4][2], blo[2][4][2];  // B's fragments of the slab's two k8 steps
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g, k = 8 * ks + t;
        split_tf32(ld_op<B_KMAJOR>(b, n, k), bhi[ks][nt][0], blo[ks][nt][0]);
        split_tf32(ld_op<B_KMAJOR>(b, n, k + 4), bhi[ks][nt][1], blo[ks][nt][1]);
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m = wm + mt * 16 + g;
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k = 8 * ks + t;
        split_tf32(ld_op<A_KMAJOR>(a, m, k), ahi[ks][0], alo[ks][0]);
        split_tf32(ld_op<A_KMAJOR>(a, m + 8, k), ahi[ks][1], alo[ks][1]);
        split_tf32(ld_op<A_KMAJOR>(a, m, k + 4), ahi[ks][2], alo[ks][2]);
        split_tf32(ld_op<A_KMAJOR>(a, m + 8, k + 4), ahi[ks][3], alo[ks][3]);
      }
      // the slab's 16-deep sum on the tensor cores, from zero, then added
      // to the running sum on the CUDA cores (round to nearest)
      float part[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[nt], alo[ks], bhi[ks][nt]);
          mma_tf32(part[nt], ahi[ks], blo[ks][nt]);
          mma_tf32(part[nt], ahi[ks], bhi[ks][nt]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
    }
  }
  cp_async_wait<0>();

  float* c = p.c + (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm + mt * 16 + g, n = n0 + wn + nt * 8 + 2 * t;
      epi_store<EPI>(p, c, m, n, acc[mt][nt][0], acc[mt][nt][1]);
      epi_store<EPI>(p, c, m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// out = the sum over the slices z of the dense (M, N) planes of ws, in slice
// order, into rows `ldc` floats apart; a float4 a thread (n4r of a row)
__global__ void splitk_reduce_f32_kernel(const float4* __restrict__ ws, int splits, size_t n4,
                                         int n4r, int ldc, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = ws[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = ws[(size_t)z * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(out + (i / n4r) * ldc + (i % n4r) * 4) = s;
}

// K rows a slice of a TN product of (M, N, K) takes. Of the split counts s
// up to MAX_SPLITS that leave each slice MIN_SLICE rows or more, the one
// whose (tile, slice) units fill the card's waves best: the fewest waves
// per unit of work, ceil(tiles * s / SMs) / s, the smaller s on a tie. Then
// rounded up to whole slabs (K or more: unsplit). A slice's partial sums
// cost 8 * M * N bytes of traffic (its store and the reduce's load), under
// a hundredth of its products' time at the weight gradients' shapes.
inline int split_slice(int M, int N, int K) {
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int n_sm = 1;
  sm_count(&n_sm);  // no card: 1, and launches fail anyway
  const long long sms = n_sm;
  long long best = 1, best_waves = (tiles + sms - 1) / sms;
  for (long long s = 2; s <= MAX_SPLITS && s * MIN_SLICE <= K; ++s) {
    const long long waves = (tiles * s + sms - 1) / sms;
    if (waves * best < best_waves * s) {  // waves / s < best_waves / best
      best = s;
      best_waves = waves;
    }
  }
  if (best < 2) return K;
  const int per = (int)((K + best - 1) / best);
  return (per + BK - 1) / BK * BK;
}

// fp32 floats of workspace a TN product of (M, N, K) stores its slices in
// (0: unsplit)
inline size_t workspace(int M, int N, int K) {
  const int slice = split_slice(M, N, K);
  const int splits = (K + slice - 1) / slice;
  return splits > 1 ? (size_t)splits * M * N : 0;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// C = the form's product of A and B through the epilogue. `ws` (TN with
// STORE only; workspace(M, N, K) floats) lets the product split along K;
// nullptr keeps it whole. The contiguous axes and the row pitches `ld`
// must be multiples of 4, and the pointers 16-byte aligned.
template <int FORM, int EPI>
cudaError_t launch_gemm_f32(const void* a, const void* b, const void* bias, const void* resid,
                            void* c, void* aux, int M, int N, int K, void* ws, cudaStream_t s,
                            Ld ld = {}) {
  static_assert(EPI != DGELU || FORM == NT, "the GELU' epilogue is the dh product's");
  static_assert(EPI != BIAS_GELU_STASH || FORM == FWD, "the stash epilogue is fc1's");
  const int a_row = FORM == TN ? M : K, b_row = FORM == NT ? K : N;
  const int lda = ld.a ? ld.a : a_row, ldb = ld.b ? ld.b : b_row, ldc = ld.c ? ld.c : N;
  if (M <= 0 || N <= 0 || K <= 0 || a_row % 4 || b_row % 4 || N % 4 || lda % 4 || ldb % 4 ||
      ldc % 4 || lda < a_row || ldb < b_row || ldc < N || !aligned16(a) || !aligned16(b) ||
      !aligned16(c) || (resid && !aligned16(resid)) || (aux && !aligned16(aux)))
    return cudaErrorInvalidValue;
  if ((EPI == DGELU && (!resid || !aux)) || (EPI == BIAS_GELU_STASH && !aux))
    return cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  int slice = K;
  if (FORM == TN && EPI == STORE && ws != nullptr) slice = split_slice(M, N, K);
  const int splits = (K + slice - 1) / slice;
  cudaError_t err = cudaFuncSetAttribute(gemm_f32_kernel<FORM, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(bias), static_cast<const float*>(resid),
               static_cast<float*>(splits > 1 ? ws : c), static_cast<float*>(aux), M, N, K,
               lda, ldb, splits > 1 ? N : ldc, slice};  // the split slices' planes are dense
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_f32_kernel<FORM, EPI><<<grid, THREADS, SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits < 2) return err;
  const size_t n4 = (size_t)M * N / 4;
  splitk_reduce_f32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(ws), splits, n4, N / 4, ldc, static_cast<float*>(c));
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace sky
