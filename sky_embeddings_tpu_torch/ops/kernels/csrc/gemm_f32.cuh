// The fp32 GEMM of the block kernels' fp32 forms, for Hopper (sm_90a):
// every fp32 product as three TF32 products (3xTF32) on wgmma, fed by TMA.
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
//        the K = B*N token rows, split along K into slices where the plan
//        says so, each stored to its own fp32 workspace plane, then added
//        in slice order by a second launch.
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
// round to nearest, and over a long K its error grows with K; so each
// SLAB_K-deep slab is summed on the tensor cores from zero (scale-d = 0 on
// its first wgmma) and added to the running sum by an fp32 add, which
// rounds to nearest. SLAB_K = 16, k in order: each 8-deep step sums the
// same eight products, in the same three wgmmas, into the same 16-deep
// slab sums as the mma.sync GEMM this one replaced, and on the H100 every
// product that both split alike (all but some TN ones, whose slices the
// new plan cuts elsewhere) came out bit-equal to it. That matters beyond
// the largest error (1.3e-6 to 2.0e-6 of the largest output at the K =
// 16 896 weight gradient, unsplit, for any depth from 8 to 128; 1.3e-4
// summed whole): the fp32 predictor paths' kernel-vs-plain bars hold
// near-cancelling pool gradients that amplify the error pattern. Eight
// steps permuted across a 32-deep slot and 32-deep slabs (the shrink
// toward zero of the truncating accumulator then -1.8e-7 of the mean
// output, against -8.7e-8) took lp_1's worst leaf to 3.5e-3 (bar 1.5e-3);
// 8-deep slabs cut the shrink to -3.8e-8 and moved cls_ft_1k_large's to
// 3.1e-4 (bar 2.5e-4). With the parent's order and depth the forward
// tokens are the parent's, lp_1's, z_ft_2's and z_tiny's gaps equal its,
// and every route stays inside its bar (tools/gemm_f32_variants.py slab,
// tools/f32_path_gaps.py, PERF.md).
//
// Bound on the H100: operations, 2 M N K FLOP of fp32 products at 3xTF32's
// 495 / 3 = 165 TFLOP/s. The design keeps the tensor cores fed:
// - One CTA per SM (persistent) walks units of (128 x BN output tile, K
//   slice) in a fixed order: slice slowest, then rows, columns fastest, so
//   the CTAs in flight share A's rows and one slice's operands in L2.
// - Warp specialisation. Warpgroup 0 gives back registers (setmaxnreg 56):
//   one thread of its warp 0 keeps TMA loads of the fp32 A and B tiles (one
//   32-deep slab, 128 bytes a row: the 128-byte swizzle) in flight through
//   a ring of STAGES slots with full and empty mbarriers; its warps 1-3
//   split each landed B tile into big and small planes in the same slot
//   and arrive on the slot's split barrier. Warpgroups 1 and 2 are the
//   consumers (setmaxnreg 224): each owns 64 rows x BN of the tile. While
//   they run a unit's epilogue, the ring already fills with the next one's
//   slabs.
// - wgmma's .tf32 form reads shared-memory operands K-major only (the
//   transpose flags are for 16-bit types), and A may come from registers.
//   So A comes from registers: each consumer thread loads its fragments
//   from the landed fp32 tile in whatever layout the form gives (FWD and
//   NT: K-major rows; TN: the (K, M) tile) and splits them there. B is split once per CTA per slab by
//   the producer's warps into two K-major planes in wgmma's 128-byte
//   swizzle, transposed on the way where it arrives N-major (FWD's weight,
//   TN's B). k stays in order in both, as the sums above need: FWD and NT
//   fragments come in 4-byte loads that no two lanes of a warp take from
//   one bank; TN's permute the rows of A instead (8-byte loads of two
//   rows; an output's sum does not see where its row sits), and the
//   epilogue reads them back (row_of).
// - Each 8-deep step issues wgmma m64nBNk8 three times (small x big, big x
//   small, big x big) into the slab sum; at a slab's end (twice a slot)
//   the consumer waits for its group and adds the slab sum to the running
//   sum, and at a slot's end frees it. The other consumer's wgmmas fill the
//   tensor cores meanwhile.
// - The output leaves from the registers, float2 pairs through the
//   epilogue (a warp's store fills 32-byte sectors).
// - Tile width and K split by wave count (f32_plan, mirrored in Python by
//   ops/kernels/gemm.py f32_plan): of BN = 128, 64 and, for a TN product
//   that may split, 1 to MAX_SPLITS slices of at least MIN_SLICE rows, the
//   least modelled time: waves x slabs a slice x (BN + a tile's fixed
//   cost), plus the split's partials' traffic; a later candidate wins only
//   by more than a sixteenth. The ring takes what shared memory there is:
//   3 slots at BN = 128, 5 at 64.
//
// Deterministic: an output is one consumer thread's sum over its K slice
// in a fixed order, and split slices are added in slice order with no
// atomics: two launches give the same bits. Ragged edges: TMA zero-fills
// past M, N and K (boxes wholly past M or N are not loaded; what the slot
// holds there reaches only outputs that are not stored), and the stores
// skip rows past M and columns past N. The contiguous axes and row pitches
// must be multiples of 4 and the pointers 16-byte aligned (TMA's strides).
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace sky {
namespace f32 {

enum Form { FWD = 0, NT = 1, TN = 2 };
enum Epi { BIAS = 0, BIAS_GELU = 1, BIAS_RESIDUAL = 2, STORE = 3, DGELU = 4, BIAS_GELU_STASH = 5,
           ADD = 6 };

constexpr int BM = 128;         // two consumer warpgroups of 64 rows
constexpr int BK = 32;          // k of a ring slot: one 128-byte swizzle row of fp32
constexpr int BOX = 32;         // fp32 columns of a 128-byte TMA box
constexpr int BOX_BYTES = BOX * BK * 4;  // a 32 x 32 box
constexpr int THREADS = 384;    // the producer warpgroup + two consumers
constexpr int SPLITTERS = 96;   // the producer's warps 1-3
constexpr int SLAB_K = 16;      // k summed on the tensor cores from zero before an fp32 add
constexpr int A_BYTES = BM * BK * 4;
constexpr int SMEM_EXTRA = 1024 + 256;  // 1024-byte alignment slack, barriers
constexpr int N_BNS = 2;
constexpr int BNS[N_BNS] = {128, 64};  // tile widths, widest first
constexpr int MAX_SPLITS = 8;
constexpr int MIN_SLICE = 1024;  // token rows of a split slice at least
constexpr long long REDUCE_BYTES_PER_COST = 1 << 15;
constexpr int TILE_COST = 32;  // a tile's cost per slab beyond its columns (A's loads and splits)

// A ring slot: A's fp32 tile, B's, and B's big and small planes (BN rows of
// 128 bytes each).
template <int BN>
struct Cfg {
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 3 * B_BYTES;
  static constexpr int STAGES = (int)((SMEM_OPTIN_MAX - SMEM_EXTRA) / STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + SMEM_EXTRA;
  static_assert(STAGES >= 3, "ring too shallow");
};

inline int stages_of(int bn) { return bn == 128 ? Cfg<128>::STAGES : Cfg<64>::STAGES; }
inline int smem_of(int bn) { return bn == 128 ? Cfg<128>::SMEM : Cfg<64>::SMEM; }

struct Plan {
  int bn, splits, kslabs, units;  // kslabs: BK-deep slabs of a K slice
};

// The tile width and K split of an (M, N, K) product over `sms` resident
// CTAs: of BN = 128, 64 and split counts 1 to MAX_SPLITS (1 unless
// may_split; each slice MIN_SLICE rows or more), the least modelled time,
// waves x slabs a slice x (BN + TILE_COST) (in 128 x 1 x 32 products on
// one SM), plus the split partials' stores and the reduce's reads and
// writes at REDUCE_BYTES_PER_COST bytes a unit; a later candidate wins only
// by more than a sixteenth. TILE_COST fits the card's sweep of every width
// and split count (tools/gemm_f32_variants.py sweep, PERF.md): a 64-wide
// tile took 1.18-1.31x a 128-wide one's time per FLOP. Mirrored by
// ops/kernels/gemm.py f32_plan.
inline Plan f32_plan(int M, int N, int K, bool may_split, int sms) {
  const long long nk = (K + BK - 1) / BK;
  Plan best{0, 0, 0, 0};
  long long best_cost = 0;
  for (int i = 0; i < N_BNS; ++i) {
    const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BNS[i] - 1) / BNS[i]);
    for (long long s = 1; s <= (may_split ? MAX_SPLITS : 1); ++s) {
      if (s > 1 && s * MIN_SLICE > K) break;
      const long long per = (nk + s - 1) / s;
      if ((nk + per - 1) / per != s) continue;  // the same slices as a smaller s
      const long long units = tiles * s;
      long long cost = (units + sms - 1) / sms * per * (BNS[i] + TILE_COST);
      if (s > 1) cost += (2 * s + 1) * (long long)M * N * 4 / REDUCE_BYTES_PER_COST;
      if (best.bn == 0 || cost * 16 < best_cost * 15) {
        best = Plan{BNS[i], (int)s, (int)per, (int)units};
        best_cost = cost;
      }
    }
  }
  return best;
}

struct Args {
  const float* bias;
  const float* resid;
  float* c;
  float* aux;
  int M, N, K;
  int ldc;     // row pitch (floats) of C, resid and aux; N for split partials
  int kslabs;  // BK-deep slabs of a K slice
  int splits;  // K slices; slice z stores at c + z * M * N
};

// Row pitches in floats, 0 for a dense operand: A's row is K long (M for
// TN), B's N (K for NT), C's N.
struct Ld {
  int a = 0, b = 0, c = 0;
};

// x = big + small, both TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Byte offset of 16-byte chunk c of row r in a box of 128-byte rows, as
// TMA's 128-byte swizzle and wgmma's K-major descriptor place it (the box
// 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ float lds32(uint32_t at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(at));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t at) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at));
  return v;
}

__device__ __forceinline__ float2 lds64(uint32_t at) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(at));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t at, unsigned a, unsigned b, unsigned c,
                                       unsigned d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// B's tile of one slot (raw) into its big and small planes: BN rows (n) of
// 32 k, K-major, 128-byte swizzle. 2 BN units of 16 values. NT: raw is one
// box of BN rows (n) x 32 k, in the planes' order; unit (n, half) splits
// chunks 4 half .. 4 half + 3 of row n. FWD, TN: raw is BN / 32 boxes of
// 32 rows (k) x 32 n; unit (4 n's, chunk c) reads rows 4c .. 4c + 3 in
// 16-byte loads and writes chunk c of four plane rows, transposed. The
// eight units of a quarter-warp take four n's and two c's, so that its
// loads hit distinct banks and its stores two to a bank.
template <int FORM, int BN>
__device__ __forceinline__ void split_stage(uint32_t raw, uint32_t big, uint32_t small, int tid) {
#pragma unroll 1
  for (int u = tid; u < 2 * BN; u += SPLITTERS) {
    float4 v[4];
    int n, c, dn, dc;
    if (FORM == NT) {
      n = u % BN, c = 4 * (u / BN), dn = 0, dc = 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = lds128(raw + swz(n, c + i));
    } else {
      c = ((u >> 2) & 1) | (((u >> 3) & 3) << 1);
      const int n4 = (u & 3) | ((u >> 5) << 2);
      const uint32_t box = raw + (n4 >> 3) * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = lds128(box + swz(4 * c + i, n4 & 7));
      n = 4 * n4, dn = 1, dc = 0;
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // NT: chunk c + w of row n is v[w]; FWD, TN: chunk c of row n + w
      // gathers element w of the four rows
      float x[4];
      if (FORM == NT) {
        x[0] = v[w].x, x[1] = v[w].y, x[2] = v[w].z, x[3] = v[w].w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = w == 0 ? v[i].x : w == 1 ? v[i].y : w == 2 ? v[i].z : v[i].w;
      }
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
      const uint32_t at = swz(n + w * dn, c + w * dc);
      sts128(big + at, hi[0], hi[1], hi[2], hi[3]);
      sts128(small + at, lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// One consumer thread's A fragments of a slab: [8-deep step][register],
// registers as wgmma's tf32 A layout (row g, k t; row g + 8, k t; row g,
// k t + 4; row g + 8, k t + 4 of the warp's 16 rows), split.
struct AFrags {
  unsigned hi[4][4], lo[4][4];
};

// Rows (of the warpgroup's 64) that fragment row g (h = 0) and g + 8 (h =
// 1) of warp w stand for: TN reads two neighbouring rows in one load.
template <int FORM>
__device__ __forceinline__ int row_of(int w, int g, int h) {
  return FORM == TN ? 16 * w + 2 * g + h : 16 * w + g + 8 * h;
}

template <int FORM>
__device__ __forceinline__ void load_frags(AFrags& f, uint32_t sa, int wg, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (FORM != TN) {
    // A K-major: one 128-row box; k 8s + t and 8s + t + 4 of rows g and g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + row_of<FORM>(w, g, h);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        split_tf32(lds32(sa + swz(r, 2 * s) + 4 * t), f.hi[s][h], f.lo[s][h]);
        split_tf32(lds32(sa + swz(r, 2 * s + 1) + 4 * t), f.hi[s][2 + h], f.lo[s][2 + h]);
      }
    }
  } else {
    // A (K, M): boxes of 32 rows (k) x 32 m; rows m and m + 1 of row k
    const int m = 64 * wg + row_of<FORM>(w, g, 0);
    const uint32_t box = sa + (m >> 5) * BOX_BYTES;
    const int cm = m & 31;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + t + 4 * h;
        const float2 x = lds64(box + swz(k, cm >> 2) + (cm & 3) * 4);
        split_tf32(x.x, f.hi[s][2 * h], f.lo[s][2 * h]);
        split_tf32(x.y, f.hi[s][2 * h + 1], f.lo[s][2 * h + 1]);
      }
  }
}

// D[64 x BN] (+)= A[64 x 8] (registers, tf32) @ B[8 x BN] (shared memory,
// K-major, 128-byte swizzle, through its descriptor); scale_d = 0
// overwrites D.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, const unsigned (&a)[4], uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const unsigned (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const unsigned (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// two neighbouring outputs (m, n), (m, n + 1) through the epilogue (N % 4 == 0)
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

// Unit u of the CTAs' walk: K slice z (slowest), then the 128 x BN output
// tile at (m0, n0), columns fastest; slabs kb0 .. kb1 - 1.
struct Unit {
  int m0, n0, z, kb0, kb1;
};

template <int BN>
__device__ __forceinline__ Unit unit_of(const Args& p, int u) {
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (p.K + BK - 1) / BK;
  const int z = u / tiles, tile = u - z * tiles;
  const int kb0 = z * p.kslabs;
  return Unit{(tile / n_tiles) * BM, (tile % n_tiles) * BN, z, kb0, min(nk, kb0 + p.kslabs)};
}

template <int FORM, int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_f32_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b, const Args p) {
  using C = Cfg<BN>;
  using namespace sm90;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // slot s: A (16 KB) at base + s * STAGE_BYTES, then B's tile, its big
  // plane and its small plane (B_BYTES each); every box 1024-byte aligned,
  // as the swizzle needs. Then the full, split and empty barriers.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + C::STAGES * C::STAGE_BYTES;
  const uint32_t split0 = full0 + 8 * C::STAGES;
  const uint32_t empty0 = split0 + 8 * C::STAGES;
  const int units = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN) * p.splits;
  // a slab is whole ring slots or a whole number of 8-deep steps in one
  constexpr int SLAB_STAGES = SLAB_K >= BK ? SLAB_K / BK : 1;
  constexpr int SLAB_STEPS = SLAB_K >= BK ? BK / 8 : SLAB_K / 8;
  static_assert(SLAB_K % BK == 0 || (BK % SLAB_K == 0 && SLAB_K % 8 == 0), "slab depth");

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the loader's expect_tx; TMA completes it
      mbar_init(split0 + 8 * s, SPLITTERS);  // every splitter thread
      mbar_init(empty0 + 8 * s, 2);          // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    int stage = 0;
    uint32_t phase = 0;
    if (threadIdx.x == 0) {
      // the loader: A's and B's tiles of every slab of every unit
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<BN>(p, u);
        // boxes of 32 columns wholly past M (TN's A) or N (FWD's and TN's B) stay unloaded
        const int na = FORM == TN ? min(BM / BOX, (p.M - w.m0 + BOX - 1) / BOX) : 1;
        const int nb = FORM == NT ? 1 : min(BN / BOX, (p.N - w.n0 + BOX - 1) / BOX);
        const uint32_t bytes = (FORM == TN ? na * BOX_BYTES : A_BYTES) +
                               (FORM == NT ? C::B_BYTES : nb * BOX_BYTES);
        for (int kb = w.kb0; kb < w.kb1; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = base + stage * C::STAGE_BYTES, sb = sa + A_BYTES;
          mbar_expect_tx(full, bytes);
          if (FORM == TN) {
            for (int i = 0; i < na; ++i)
              tma_load_2d(sa + i * BOX_BYTES, &tma_a, full, w.m0 + i * BOX, kb * BK);
          } else {
            tma_load_2d(sa, &tma_a, full, kb * BK, w.m0);
          }
          if (FORM == NT) {
            tma_load_2d(sb, &tma_b, full, kb * BK, w.n0);
          } else {
            for (int i = 0; i < nb; ++i)
              tma_load_2d(sb + i * BOX_BYTES, &tma_b, full, w.n0 + i * BOX, kb * BK);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      // the splitters: B's big and small planes of every landed slab
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<BN>(p, u);
        for (int kb = w.kb0; kb < w.kb1; ++kb) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t sb = base + stage * C::STAGE_BYTES + A_BYTES;
          split_stage<FORM, BN>(sb, sb + C::B_BYTES, sb + 2 * C::B_BYTES, threadIdx.x - 32);
          fence_proxy_async();  // the planes, visible to wgmma
          mbar_arrive(split0 + 8 * stage);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 1 and 2: rows 64 * wg .. + 64 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const bool leader = (threadIdx.x & 127) == 0;
    float r[BN / 2], s[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of<BN>(p, u);
      const int mw = w.m0 + 64 * wg;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) r[i] = 0.f;
      int pending = -1;  // a slot whose products may still run
      for (int kb = w.kb0; kb < w.kb1; ++kb) {
        // where the slab sum restarts from zero and where it joins the running sum
        const int at = (kb - w.kb0) % SLAB_STAGES;
        const bool first = SLAB_STAGES == 1 || at == 0;
        const bool last = SLAB_STAGES == 1 || at == SLAB_STAGES - 1 || kb + 1 == w.kb1;
        mbar_wait(full0 + 8 * stage, phase);
        mbar_wait(split0 + 8 * stage, phase);
        const uint32_t sa = base + stage * C::STAGE_BYTES;
        const uint32_t planes = sa + A_BYTES + C::B_BYTES;
        AFrags a;
        load_frags<FORM>(a, sa, wg, warp, lane);
        const uint64_t b_big = smem_desc(planes, 16, 1024);
        const uint64_t b_small = smem_desc(planes + C::B_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // 8 k in: 32 bytes into each swizzled row (the descriptor counts
          // 16-byte units); a slab's first product overwrites s
          const int more = k % SLAB_STEPS != 0 || (k == 0 && !first);
          wgmma_tf32<BN>(s, a.lo[k], b_big + 2 * k, more);
          wgmma_tf32<BN>(s, a.hi[k], b_small + 2 * k, 1);
          wgmma_tf32<BN>(s, a.hi[k], b_big + 2 * k, 1);
          if ((k + 1) % SLAB_STEPS == 0 && k < 3) {  // a slab ends inside the slot
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc<BN / 2>(s);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) r[i] += s[i];
            wgmma_fence();
          }
        }
        wgmma_commit();
        if (last) {
          // the slab's sum is whole: into the running sum, rounded to nearest
          wgmma_wait<0>();
          fence_acc<BN / 2>(s);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) r[i] += s[i];
          if (leader && pending >= 0) mbar_arrive(empty0 + 8 * pending);
          if (leader) mbar_arrive(empty0 + 8 * stage);
          pending = -1;
        } else {
          wgmma_wait<1>();  // the previous slot's products are done
          if (leader && pending >= 0) mbar_arrive(empty0 + 8 * pending);
          pending = stage;
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (mw >= p.M) continue;  // this half has no rows to store
      float* c = p.c + (size_t)w.z * p.M * p.N;
      const int g = lane >> 2, n = w.n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi_store<EPI>(p, c, mw + row_of<FORM>(warp, g, h), n + 8 * j, r[4 * j + 2 * h],
                         r[4 * j + 2 * h + 1]);
    }
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

// A row-major fp32 (rows, cols) matrix, rows `ld` floats apart, as a TMA map
// of box_rows x 32 boxes (128 bytes wide: the swizzle's span), 128-byte
// swizzle; loads read out-of-range elements as zero.
inline bool encode_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                       int box_rows) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan of a product as its launch makes it: a TN STORE product with a
// workspace may split along K.
inline Plan plan_of(int M, int N, int K, bool may_split) {
  int sms = 1;
  sm_count(&sms);  // no card: 1, and launches fail anyway
  return f32_plan(M, N, K, may_split, sms);
}

// fp32 floats of workspace a TN product of (M, N, K) stores its slices in
// (0: unsplit)
inline size_t workspace(int M, int N, int K) {
  const Plan pl = plan_of(M, N, K, true);
  return pl.splits > 1 ? (size_t)pl.splits * M * N : 0;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <int FORM, int EPI, int BN>
cudaError_t launch_bn(const CUtensorMap* maps, const Args& p, int grid, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_kernel<FORM, EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  gemm_f32_kernel<FORM, EPI, BN><<<grid, THREADS, Cfg<BN>::SMEM, s>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

// The plan of tile width bn and at most `splits` K slices (a sweep's
// forced plan; 0 leaves the rule's choice).
inline Plan forced_plan(Plan plan, int M, int N, int K, int bn, int splits) {
  if (bn) plan.bn = bn;
  if (splits) {
    const int nk = (K + BK - 1) / BK;
    plan.kslabs = (nk + splits - 1) / splits;
    plan.splits = (nk + plan.kslabs - 1) / plan.kslabs;
  }
  plan.units = ((M + BM - 1) / BM) * ((N + plan.bn - 1) / plan.bn) * plan.splits;
  return plan;
}

// C = the form's product of A and B through the epilogue. `ws` (TN with
// STORE only; workspace(M, N, K) floats) lets the product split along K;
// nullptr keeps it whole. The contiguous axes and the row pitches `ld`
// must be multiples of 4, and the pointers 16-byte aligned. bn and splits
// force the plan (a sweep's; `ws` then holds splits * M * N floats).
template <int FORM, int EPI>
cudaError_t launch_gemm_f32(const void* a, const void* b, const void* bias, const void* resid,
                            void* c, void* aux, int M, int N, int K, void* ws, cudaStream_t s,
                            Ld ld = {}, int bn = 0, int splits = 0) {
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
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const bool may_split = FORM == TN && EPI == STORE && ws != nullptr;
  if ((bn && bn != 128 && bn != 64) || splits < 0 || (splits > 1 && !may_split))
    return cudaErrorInvalidValue;
  const Plan plan = forced_plan(f32_plan(M, N, K, may_split, sms), M, N, K, bn, splits);
  CUtensorMap maps[2];
  const bool ok_a = FORM == TN ? encode_f32(&maps[0], a, K, M, lda, BK)
                               : encode_f32(&maps[0], a, M, K, lda, BM);
  const bool ok_b = FORM == NT ? encode_f32(&maps[1], b, N, K, ldb, plan.bn)
                               : encode_f32(&maps[1], b, K, N, ldb, BK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const Args p{static_cast<const float*>(bias), static_cast<const float*>(resid),
               static_cast<float*>(plan.splits > 1 ? ws : c), static_cast<float*>(aux), M, N, K,
               plan.splits > 1 ? N : ldc,  // the split slices' planes are dense
               plan.kslabs, plan.splits};
  const int grid = plan.units < sms ? plan.units : sms;
  err = plan.bn == 128 ? launch_bn<FORM, EPI, 128>(maps, p, grid, s)
                       : launch_bn<FORM, EPI, 64>(maps, p, grid, s);
  if (err != cudaSuccess || plan.splits < 2) return err;
  const size_t n4 = (size_t)M * N / 4;
  splitk_reduce_f32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(ws), plan.splits, n4, N / 4, ldc, static_cast<float*>(c));
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace sky
