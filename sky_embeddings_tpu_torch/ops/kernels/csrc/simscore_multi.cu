// Multi-query weighted-cosine scoring of an embedding bank for Hopper (sm_90a):
//
//   dots  = X  · (W⊙T)ᵀ      (N, Q)
//   prods = X² · Wᵀ          (N, Q)
//   out   = dots / (sqrt(prods) · ‖t‖_w + 1e-6)
//
// Replaces the TPU kernel sky_embeddings_tpu/ops/kernels/simscore.py:
// weighted_bank_scores_multi_pallas (body _scores_multi_kernel). The bank X
// (N, D) is read in its storage dtype (bf16 or fp32); (W⊙T)ᵀ and Wᵀ (D, Q)
// and ‖t‖_w (Q,) come fp32 from the wrapper; the output (N, Q) is fp32. The
// TPU layout (Q padded to 128 lanes, N to 1024-row tiles) is not carried
// over: ragged N, D and Q are masked in the kernel.
//
// What bounds it on the H100: the bank's bytes. Both products run on the
// tensor cores, so at the query counts a survey search uses (1 to 64) their
// 4·N·D·Q operations take less time at the bf16 rate than one read of the
// bank at 3.35 TB/s (a 1M x 768 bf16 bank: 0.03 ms of operations at Q = 8,
// 0.21 at Q = 64, against 0.49 ms of bytes). The design streams the bank
// once per block of up to 64 queries, in its storage dtype, and keeps the
// rest of the work under that stream.
//
// The split, and why it keeps fp32 grade. wgmma multiplies bf16 operands
// exactly and sums in fp32, so each fp32 operand is split into bf16 terms:
// v = v_hi + v_lo + r with v_hi = bf16(v), v_lo = bf16(v - v_hi) and |r| <=
// 2^-16 |v|. For a bf16 bank x is exact in bf16, and x² (at most 16
// significant bits) is held exactly by x2_hi = bf16(x·x) and x2_lo =
// bf16(x·x - x2_hi): one bf16x2 multiply and one fused multiply-add a
// register (x·x is exact inside the fused operation, and the difference
// fits a bf16):
//   dots  = x·wt_lo + x·wt_hi
//   prods = x2_lo·w_hi + x2_hi·w_lo + x2_hi·w_hi     (5 products; x2_lo·w_lo,
//                                                      <= 2^-16 relative, left out)
// For an fp32 bank x splits the same way, and x² is rounded in fp32 from the
// whole x, as the plain version rounds it, then split:
//   dots  = x_hi·wt_lo + x_lo·wt_hi + x_hi·wt_hi     (6 products)
// The query operands are split where they are staged (below), so the C
// interface takes the wrapper's fp32 (D, Q) arrays as before.
//
// Tile and ring plan. A CTA is two warpgroups; each owns MW 64-row tiles of
// the CTA's BN bank rows (bf16: MW = 2, BN = 256; fp32: MW = 1, BN = 128)
// and QB = 8·NT queries (NT in {1, 2, 4, 8}: the fewest 8-query groups that
// hold Q, at most 64; larger Q takes further query blocks, which read the
// bank again, mostly from L2: the work items run row block by row block).
// The CTAs are persistent (as many as fit on the SMs) and walk their
// (row block, query block) items as one sequence of tiles of 64 bank
// columns, so the ring never drains between items. A ring slot holds a
// tile: the bank's BN x 64 columns (32 KB either dtype), copied by 16-byte
// cp.async into an XOR-swizzled layout (ldmatrix for bf16 and 8-byte loads
// for fp32 both free of bank conflicts), and the tile's fp32 (W⊙T)ᵀ and Wᵀ
// slices. The ring has STAGES = 3 slots (2 at QB = 16), and at QB <= 16
// two CTAs fit an SM, so two to four tiles are in flight an SM while others
// are computed. When a tile has landed, its query slices are split into
// four bf16 planes (wt_hi, wt_lo, w_hi, w_lo), each QB rows of 64 columns in
// wgmma's K-major 128-byte swizzle: the B operands of every product. For
// each 16-column step a warpgroup loads its A fragments, squares and splits
// them in registers, and issues wgmma m64nQBk16 with A from registers, one
// per product and 64-row tile; the next step's fragments are built while
// these run (two register sets, one wgmma group in flight). At the end of
// an item the epilogue divides and stores each accumulator pair straight
// from registers (a warp's stores fill 32-byte sectors); the next item's
// tiles are already in flight.
//
// Ragged shapes run the same kernel: a bank whose base or row width is not
// 16-byte aligned is copied element by element (plain loads and stores)
// into the same layout; (D, Q) query arrays whose rows are not 16-byte
// aligned take 4-byte cp.async. Out-of-range rows, columns and queries load
// as zeros, which add nothing, and are not stored.
#include <type_traits>

#include "common.cuh"

namespace {

using sky::bf16;

constexpr int THREADS = 256;  // two warpgroups
constexpr int BK = 64;        // bank columns a tile: one 128-byte row of a bf16 plane
constexpr int KSTEPS = BK / 16;

template <typename T, int NT>
struct Plan {
  static constexpr int MW = sizeof(T) == 2 ? 2 : 1;          // 64-row tiles a warpgroup
  static constexpr int BN = 2 * 64 * MW;                     // bank rows a CTA
  static constexpr int QB = 8 * NT;                          // queries a CTA
  static constexpr int CTAS = NT <= 2 ? 2 : 1;               // CTAs an SM
  static constexpr int STAGES = NT == 2 ? 2 : 3;             // tiles in the ring
  static constexpr int ROW_CHUNKS = BK * sizeof(T) / 16;     // 16-byte chunks a tile row
  static constexpr int BANK_BYTES = BN * BK * sizeof(T);
  static constexpr int RAW_BYTES = 2 * BK * QB * 4;          // (W⊙T)ᵀ and Wᵀ slices, fp32
  static constexpr int STAGE_BYTES = BANK_BYTES + RAW_BYTES;
  static constexpr int PLANES_BYTES = 4 * QB * BK * 2;       // four bf16 planes
  static constexpr int SMEM = PLANES_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment
  // a block's opt-in limit; an SM's 228 KB hold CTAS blocks, 1 KB reserved each
  static_assert(SMEM <= static_cast<int>(sky::SMEM_OPTIN_MAX) && CTAS * (SMEM + 1024) <= 228 * 1024,
                "plan exceeds shared memory");
};

// A bank tile row of RC 16-byte chunks: chunk c lies at (c & ~7) | ((c & 7)
// ^ swz(r)). The eight rows that ldmatrix reads at one chunk land on eight
// distinct chunks, and the four rows of a half-warp's 8-byte fp32 loads
// (chunk pairs) on four distinct pairs.
template <int RC>
__device__ __forceinline__ int bank_off(int r, int c) {
  return r * RC * 16 + (((c & ~7) | ((c & 7) ^ (((r & 3) << 1) | ((r >> 2) & 1)))) << 4);
}

// Element (q, k) of a query plane: row q of 64 bf16 (128 bytes), chunk k / 8
// at (k / 8) ^ (q % 8): wgmma's K-major 128-byte swizzle (plane 1024-byte
// aligned; 8-row groups 1024 bytes apart).
__device__ __forceinline__ int plane_off(int q, int k) {
  return q * 128 + (((k >> 3) ^ (q & 7)) << 4) + (k & 7) * 2;
}

// Element (k, q) of a staged query slice (fp32, QB a row): 16-byte chunk q / 4
// at (q / 4) ^ (2 (k / 2 % 4)), within the row, so that the split's reads of
// one column at rows k, k + 2, k + 4, k + 6 fall on distinct banks.
template <int QB>
__device__ __forceinline__ int raw_off(int k, int q) {
  return k * QB * 4 + ((((q >> 2) ^ (((k >> 1) & 3) * 2)) & (QB / 4 - 1)) << 4) + (q & 3) * 4;
}

__device__ __forceinline__ float lo_f(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sky::smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

// v = hi + lo (bf16 pairs), for the two values of one fragment register
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
  hi = sky::pack_bf16(v0, v1);
  lo = sky::pack_bf16(v0 - lo_f(hi), v1 - hi_f(hi));
}

// D[64 x N] (+)= A[64 x 16] (registers, bf16, mma.sync's fragment layout per
// warp) @ B[16 x N] (shared memory, K-major, 128-byte swizzle); scale_d = 0
// overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const unsigned (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "%8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

struct Args {
  const void* bank;
  const float* wt;
  const float* w;
  const float* tnorm;
  float* out;
  int64_t N;
  int D, Q, qblocks, kt, items;
  bool qvec;  // (D, Q) rows 16-byte aligned: 16-byte cp.async for the query slices
};

// Walks a CTA's tiles: item blockIdx.x, + gridDim.x, ... (row block item /
// qblocks, query block item % qblocks), columns d0 = 0, BK, ... of each; one
// division per item, none per tile.
template <int BN, int QB>
struct Cursor {
  int item, d0, q0;
  int64_t n0;
  __device__ __forceinline__ explicit Cursor(const Args& a) : item(blockIdx.x), d0(0) { place(a); }
  __device__ __forceinline__ void place(const Args& a) {
    const int rb = item / a.qblocks;
    n0 = static_cast<int64_t>(rb) * BN;
    q0 = (item - rb * a.qblocks) * QB;
  }
  __device__ __forceinline__ void advance(const Args& a) {
    d0 += BK;
    if (d0 >= a.D) {
      d0 = 0;
      item += gridDim.x;
      place(a);
    }
  }
};

// Issues the copies of one bank tile (or, !VEC, copies it) into a ring slot.
template <typename T, bool VEC, int NT>
__device__ __forceinline__ void load_bank(const Args& a, char* slot, int64_t n0, int d0, int tid) {
  using P = Plan<T, NT>;
  constexpr int ELTS = 16 / sizeof(T);
  if constexpr (VEC) {
    const T* bank = static_cast<const T*>(a.bank);
#pragma unroll
    for (int j = 0; j < P::BN * P::ROW_CHUNKS / THREADS; ++j) {
      const int e = tid + j * THREADS, r = e / P::ROW_CHUNKS, c = e % P::ROW_CHUNKS;
      const int64_t n = n0 + r;
      const int d = d0 + c * ELTS;
      const bool in = n < a.N && d < a.D;  // D % ELTS == 0: a chunk is wholly in or out
      sky::cp_async16(slot + bank_off<P::ROW_CHUNKS>(r, c), in ? bank + n * a.D + d : bank, in);
    }
  } else {
    using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
    const Raw* bank = static_cast<const Raw*>(a.bank);
#pragma unroll 8
    for (int j = 0; j < P::BN * BK / THREADS; ++j) {
      const int e = tid + j * THREADS, r = e / BK, col = e % BK;
      const int64_t n = n0 + r;
      const int d = d0 + col;
      const Raw v = n < a.N && d < a.D ? bank[n * a.D + d] : Raw(0);
      *reinterpret_cast<Raw*>(slot + bank_off<P::ROW_CHUNKS>(r, col / ELTS) +
                              (col % ELTS) * sizeof(T)) = v;
    }
  }
}

// Issues the copies of one tile's query slices, (W⊙T)ᵀ then Wᵀ.
template <typename T, int NT>
__device__ __forceinline__ void load_queries(const Args& a, char* slot, int d0, int q0, int tid) {
  constexpr int QB = Plan<T, NT>::QB, ARR = BK * QB * 4;  // bytes of one slice
  static_assert(2 * BK * QB / 4 % THREADS == 0, "whole chunks a thread");
  if (a.qvec) {
#pragma unroll
    for (int j = 0; j < 2 * BK * QB / 4 / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int arr = e / (BK * QB / 4), k = e % (BK * QB / 4) / (QB / 4), q = 4 * (e % (QB / 4));
      const bool in = d0 + k < a.D && q0 + q < a.Q;  // Q % 4 == 0: four queries wholly in or out
      const float* src = arr ? a.w : a.wt;
      sky::cp_async16(slot + arr * ARR + raw_off<QB>(k, q),
                      in ? src + static_cast<int64_t>(d0 + k) * a.Q + q0 + q : src, in);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < 2 * BK * QB / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int arr = e / (BK * QB), k = e % (BK * QB) / QB, q = e % QB;
      const bool in = d0 + k < a.D && q0 + q < a.Q;
      const float* src = arr ? a.w : a.wt;
      cp_async4(slot + arr * ARR + raw_off<QB>(k, q),
                in ? src + static_cast<int64_t>(d0 + k) * a.Q + q0 + q : src, in);
    }
  }
}

// A tile's query slices, split into the four bf16 planes and made visible
// to wgmma's reads (the async proxy). A warp takes 8 queries x 4 column
// pairs a step: its plane writes (one 16-byte chunk of each of 8 rows) and
// its slice reads (two rows of 8 queries at rows 2 apart) are free of bank
// conflicts.
template <typename T, int NT>
__device__ __forceinline__ void split_queries(const char* raw, char* planes, int tid) {
  constexpr int QB = Plan<T, NT>::QB, ARR = BK * QB * 4, PLANE = QB * BK * 2;
  static_assert(QB * BK / 2 % THREADS == 0, "whole column pairs a thread");
#pragma unroll
  for (int j = 0; j < QB * BK / 2 / THREADS; ++j) {
    const int e = tid + j * THREADS;
    const int blk = e >> 5;  // q group blk % (QB / 8), column pairs 4 (blk / (QB / 8)) ..
    const int q = (e & 7) + 8 * (blk % (QB / 8));
    const int k = 2 * (((e >> 3) & 3) + 4 * (blk / (QB / 8)));
    const int off = plane_off(q, k), r = raw_off<QB>(k, q);  // row k + 1: QB * 4 further
    unsigned h, l;
#pragma unroll
    for (int arr = 0; arr < 2; ++arr) {
      const char* src = raw + arr * ARR + r;
      split2(*reinterpret_cast<const float*>(src), *reinterpret_cast<const float*>(src + QB * 4), h,
             l);
      *reinterpret_cast<unsigned*>(planes + 2 * arr * PLANE + off) = h;
      *reinterpret_cast<unsigned*>(planes + (2 * arr + 1) * PLANE + off) = l;
    }
  }
  sky::fence_proxy_async();
}

// A warpgroup's A operands of one 16-column step: x (bf16) or x_hi, x_lo
// (fp32), and x2_hi, x2_lo, for each of its MW 64-row tiles.
template <typename T, int MW>
struct AFrags {
  unsigned x[MW][4], xl[MW][4], sh[MW][4], sl[MW][4];

  __device__ __forceinline__ void load(const char* slot, int row0, int kk, int lane) {
    constexpr int RC = BK * sizeof(T) / 16;
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      const int r0 = row0 + mw * 64;
      if constexpr (sizeof(T) == 2) {
        // x in bf16 straight from the tile. x² is exact inside a fused
        // bf16x2 multiply-add, so x2_hi = bf16(x·x) and x2_lo = bf16(x·x -
        // x2_hi), which is exact in bf16: two instructions a register.
        sky::ldsm4(x[mw], reinterpret_cast<const bf16*>(
                              slot + bank_off<RC>(r0 + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x[mw][i]);
          const __nv_bfloat162 h = __hmul2(v, v), l = __hfma2(v, v, __hneg2(h));
          sh[mw][i] = *reinterpret_cast<const unsigned*>(&h);
          sl[mw][i] = *reinterpret_cast<const unsigned*>(&l);
        }
      } else {
        // x fp32: rows g, g + 8, columns 2·tig, 2·tig + 1 and 8 further
        const int g = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + g + (i & 1) * 8, c = 4 * kk + (tig >> 1) + (i >> 1) * 2;
          const float2 v =
              *reinterpret_cast<const float2*>(slot + bank_off<RC>(r, c) + (tig & 1) * 8);
          split2(v.x, v.y, x[mw][i], xl[mw][i]);
          split2(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y), sh[mw][i], sl[mw][i]);
        }
      }
    }
  }
};

// One tile's products into the warpgroup's accumulators, B from the planes
// whose wgmma descriptors are desc; `first`: the item's first tile, whose
// first products overwrite them.
template <typename T, int NT>
__device__ __forceinline__ void compute_tile(const char* slot, const uint64_t (&desc)[4], bool first,
                                             float (&dot)[Plan<T, NT>::MW][4 * NT],
                                             float (&prod)[Plan<T, NT>::MW][4 * NT], int row0,
                                             int lane) {
  using P = Plan<T, NT>;
  constexpr int MW = P::MW;
  AFrags<T, MW> f[2];
  f[0].load(slot, row0, 0, lane);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const AFrags<T, MW>& a = f[kk & 1];
    // 16 columns in: 32 bytes into each swizzled row (the descriptor counts 16-byte units)
    const uint64_t wt_hi = desc[0] + 2 * kk, wt_lo = desc[1] + 2 * kk, w_hi = desc[2] + 2 * kk,
                   w_lo = desc[3] + 2 * kk;
    const int acc = !(first && kk == 0);
    sky::wgmma_fence();
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      wgmma_rs<P::QB>(dot[mw], a.x[mw], wt_lo, acc);
      if constexpr (sizeof(T) == 4) wgmma_rs<P::QB>(dot[mw], a.xl[mw], wt_hi, 1);
      wgmma_rs<P::QB>(dot[mw], a.x[mw], wt_hi, 1);
      wgmma_rs<P::QB>(prod[mw], a.sl[mw], w_hi, acc);
      wgmma_rs<P::QB>(prod[mw], a.sh[mw], w_lo, 1);
      wgmma_rs<P::QB>(prod[mw], a.sh[mw], w_hi, 1);
    }
    sky::wgmma_commit();
    if (kk + 1 < KSTEPS) f[(kk + 1) & 1].load(slot, row0, kk + 1, lane);  // while these run
    sky::wgmma_wait<0>();
  }
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    sky::fence_acc<4 * NT>(dot[mw]);
    sky::fence_acc<4 * NT>(prod[mw]);
  }
}

template <typename T, int NT>
__device__ __forceinline__ void store_item(const Args& a, float (&dot)[Plan<T, NT>::MW][4 * NT],
                                           float (&prod)[Plan<T, NT>::MW][4 * NT], int64_t n0,
                                           int q0, int row0, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const bool pairs = (a.Q & 1) == 0;  // an even q of a row is 8-byte aligned
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (q0 + j * 8 >= a.Q) break;
    const int q = q0 + j * 8 + 2 * tig;
    const float t0 = q < a.Q ? __ldg(a.tnorm + q) : 1.f;
    const float t1 = q + 1 < a.Q ? __ldg(a.tnorm + q + 1) : 1.f;
#pragma unroll
    for (int mw = 0; mw < Plan<T, NT>::MW; ++mw) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = n0 + row0 + mw * 64 + g + h * 8;
        if (n >= a.N || q >= a.Q) continue;
        const int i = 4 * j + 2 * h;
        const float s0 = dot[mw][i] / (sqrtf(prod[mw][i]) * t0 + 1e-6f);
        const float s1 = dot[mw][i + 1] / (sqrtf(prod[mw][i + 1]) * t1 + 1e-6f);
        float* o = a.out + n * a.Q + q;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(s0, s1);  // q + 1 < Q: Q is even
        } else {
          o[0] = s0;
          if (q + 1 < a.Q) o[1] = s1;
        }
      }
    }
  }
}

template <typename T, bool VEC, int NT>
__global__ void __launch_bounds__(THREADS, Plan<T, NT>::CTAS) scores_multi_kernel(const Args a) {
  using P = Plan<T, NT>;
  extern __shared__ __align__(1024) char smem_raw[];
  // the four planes (1024-byte aligned, as the swizzle needs), then the
  // ring: each slot a bank tile and its query slices
  char* planes = smem_raw + ((1024 - (sky::smem_u32(smem_raw) & 1023)) & 1023);
  char* ring = planes + P::PLANES_BYTES;
  const int tid = threadIdx.x, lane = tid & 31;
  // this thread's rows of a tile: its warpgroup's MW 64-row tiles, its warp's 16 rows of each
  const int row0 = (tid >> 7) * P::MW * 64 + ((tid >> 5) & 3) * 16;
  uint64_t desc[4];  // the planes' wgmma descriptors at column 0
#pragma unroll
  for (int p = 0; p < 4; ++p)
    desc[p] = sky::smem_desc(sky::smem_u32(planes + p * P::PLANES_BYTES / 4), 16, 1024);

  // this CTA's items: blockIdx.x, + gridDim.x, ...; each a run of kt tiles
  const int cta = blockIdx.x, ctas = gridDim.x;
  const int total = a.items > cta ? ((a.items - 1 - cta) / ctas + 1) * a.kt : 0;
  Cursor<P::BN, P::QB> next(a), cur(a);  // the next tile to copy, the tile to compute
  auto issue = [&](int u) {
    if (u < total) {
      char* slot = ring + (u % P::STAGES) * P::STAGE_BYTES;
      load_bank<T, VEC, NT>(a, slot, next.n0, next.d0, tid);
      load_queries<T, NT>(a, slot + P::BANK_BYTES, next.d0, next.q0, tid);
      next.advance(a);
    }
    sky::cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float dot[P::MW][4 * NT], prod[P::MW][4 * NT];
#pragma unroll
  for (int mw = 0; mw < P::MW; ++mw)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) dot[mw][i] = prod[mw][i] = 0.f;
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) issue(s);
  for (int t = 0; t < total; ++t) {
    sky::cp_async_wait<P::STAGES - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is consumed
    issue(t + P::STAGES - 1);
    const char* slot = ring + (t % P::STAGES) * P::STAGE_BYTES;
    split_queries<T, NT>(slot + P::BANK_BYTES, planes, tid);
    __syncthreads();
    compute_tile<T, NT>(slot, desc, cur.d0 == 0, dot, prod, row0, lane);
    if (cur.d0 + BK >= a.D) store_item<T, NT>(a, dot, prod, cur.n0, cur.q0, row0, lane);
    cur.advance(a);
  }
  sky::cp_async_wait<0>();
}

template <typename T, bool VEC, int NT>
cudaError_t launch_t(Args a, cudaStream_t s) {
  using P = Plan<T, NT>;
  const auto kernel = scores_multi_kernel<T, VEC, NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  a.qblocks = (a.Q + P::QB - 1) / P::QB;
  a.kt = (a.D + BK - 1) / BK;
  const int64_t items = (a.N + P::BN - 1) / P::BN * a.qblocks;
  if (items * a.kt > INT32_MAX) return cudaErrorInvalidValue;  // tiles are counted in int
  a.items = static_cast<int>(items);
  const int grid = sky::resident_grid(kernel, THREADS, P::SMEM, a.items);
  kernel<<<grid, THREADS, P::SMEM, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_q(const Args& a, cudaStream_t s) {
  if (a.Q <= 8) return launch_t<T, VEC, 1>(a, s);
  if (a.Q <= 16) return launch_t<T, VEC, 2>(a, s);
  if (a.Q <= 32) return launch_t<T, VEC, 4>(a, s);
  return launch_t<T, VEC, 8>(a, s);
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t s) {
  constexpr int elts = 16 / static_cast<int>(sizeof(T));
  const bool vec = a.D % elts == 0 && reinterpret_cast<uintptr_t>(a.bank) % 16 == 0;
  a.qvec = a.Q % 4 == 0 && reinterpret_cast<uintptr_t>(a.wt) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  return vec ? launch_q<T, true>(a, s) : launch_q<T, false>(a, s);
}

}  // namespace

// bank (N, D) bf16 (bank_bf16 = 1) or fp32, row-major; wt = (W⊙T)ᵀ and
// w = Wᵀ, (D, Q) fp32 row-major, so a tile's query slices are contiguous
// rows; tnorm (Q,) fp32; out (N, Q) fp32. Returns 0, or the CUDA error the
// launch reported.
extern "C" int sky_scores_multi(const void* bank, int bank_bf16, const void* wt, const void* w,
                                const void* tnorm, void* out, long long N, int D, int Q,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{bank, static_cast<const float*>(wt), static_cast<const float*>(w),
         static_cast<const float*>(tnorm), static_cast<float*>(out), N, D, Q, 0, 0, 0, false};
  const cudaError_t err = bank_bf16 ? launch<bf16>(a, s) : launch<float>(a, s);
  return static_cast<int>(err);
}
