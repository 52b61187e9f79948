// Persistent, warp-specialised bf16 GEMM for Hopper (sm_90a): wgmma fed by
// TMA, for the forward products of K1 and K2 and of their stash twins.
//
//   out[M, N] = epilogue(A[M, K] @ B[K, N] + bias[N])
//
// A is the (M, K) row-major activation (y for fc1 and qkv, h for fc2, ctx
// for proj); B the weight in its JAX (in, out) layout, (K, N) row-major.
// Neither is copied: A is K-major for wgmma and B MN-major, read through
// the transposed-B form of the shared-memory descriptor.
//
// Serves the TPU kernels sky_embeddings_tpu/ops/kernels/mlp_block.py
// _pallas_fwd / _pallas_fwd_stash (fc1, fc2: csrc/mlp_block.cu) and
// attn_block.py _pallas_fwd / _pallas_fwd_stash (qkv, proj:
// csrc/attn_block.cu), masked or not. The backward kernels keep the wmma
// GEMM of gemm.cuh, which has the transposed-A forms they need.
//
// What bounds it on the H100: tensor-core operations. At ViT-B's shapes
// (M = B*65 rows, K and N 768..3072) qkv, fc1 and fc2 do 500 to 600 bf16
// FLOP per byte they must move, well over the card's 295 FLOP/byte ridge;
// proj, which also reads its residual, does 256 and sits near it. So the
// design keeps the tensor cores fed:
// - One CTA per SM (persistent) walks output tiles of 128 x BN in a fixed
//   order, n fastest, so the CTAs in flight share A's rows in L2 (B, a
//   weight of at most 13 MB, stays there).
// - Warp specialisation. Warpgroup 0 is the producer: it gives back
//   registers (setmaxnreg 40) and one thread keeps TMA loads of A (one
//   128 x 64 box) and B (BN / 64 boxes of 64 x 64) in flight through a ring
//   of STAGES slots with full and empty mbarriers. Warpgroups 1 and 2 are
//   the consumers (setmaxnreg 232): each owns 64 rows x BN of the tile and
//   issues wgmma m64nBNk16 (bf16 -> fp32, four per 64-deep slab), keeping
//   one slab's group in flight before it frees the slot. While the
//   consumers run a tile's epilogue the producer already fills the ring
//   with the next tile's slabs.
// - TMA writes every box with the 128-byte swizzle; the descriptors say
//   so. A: K-major, 8-row groups 1024 bytes apart (SBO), k advanced by 32
//   bytes inside the swizzle atom. B: MN-major, 64-column chunks BK * 128
//   bytes apart (LBO), 8-row k groups 1024 bytes apart (SBO), k advanced
//   by 16 rows (2048 bytes).
// - The output leaves through shared memory and TMA stores, 64 x 64 boxes
//   with the same swizzle (bank-conflict-free register writes), so the
//   global writes are whole lines and run on while the consumers go on to
//   the next tile. Stores straight from the registers (bf16 pairs, 16
//   bytes of a row per quad) took twice as long at the qkv product
//   (tools/gemm_sm90_variants.py, PERF.md). The residual of
//   EPI_BIAS_RESIDUAL is loaded by TMA into the same staged tile while the
//   mainloop runs, and each thread adds it in place.
// - Tile width by wave count (gemm_sm90_plan, mirrored in Python by
//   ops/kernels/gemm.py gemm_plan): of BN = 256, 192, 128 the one whose
//   last wave ends first, counted as waves x BN; a narrower tile wins only
//   when it cuts that by more than a sixteenth, since a wider one reads
//   less shared memory per FLOP (B is read by both consumers). At mim_1
//   B=64 (M = 4160, 33 row tiles) fc2 and proj (N = 768) take 192: 132
//   tiles, one wave; fc1 (N = 3072) 256: 396 tiles, three waves; qkv
//   (N = 2304) 192: 396 tiles, three waves. The ring takes what shared
//   memory the staged tile leaves: 3 slots at BN = 256, 4 at 192, 6 at 128.
// - What is left (PERF.md): fc1's erf-GELU epilogue runs while the tensor
//   cores wait, since both consumers finish a tile together; a schedule
//   that hid it (one consumer's epilogue under the other's mainloop) would
//   give each consumer its own tile and load B once per consumer, raising
//   the L2-to-shared-memory bytes per FLOP.
//
// Deterministic: each output tile belongs to one CTA over its whole K (no
// split-K, no atomics), so every output is one fp32 sum in a fixed order,
// bit-reproducible run to run. Ragged edges: TMA zero-fills rows past M and
// K past its end and clips its stores at M and N; B's 64-column chunks
// wholly past N are neither loaded nor stored. The strides of A, B and the
// output (K and N elements) must be multiples of 8 (16 bytes), which the
// wrappers check.
//
// Epilogues, from the accumulator registers in fp32, rounded to bf16 at
// the TPU kernels' points:
//   EPI_BIAS             bf16(acc + b)                       (qkv)
//   EPI_BIAS_GELU        bf16(erf-GELU(acc + b))             (fc1 -> h)
//   EPI_BIAS_GELU_STASH  as EPI_BIAS_GELU, and out2 = bf16(acc + b), stored
//                        from the registers; GELU reads the fp32 value, so
//                        out is EPI_BIAS_GELU's
//   EPI_BIAS_RESIDUAL    bf16(resid + (acc + b)), the residual in fp32
//
// The TMA maps are encoded on the host for every launch (three or four
// cuTensorMapEncodeTiled calls, under half a microsecond together: PERF.md;
// reached through cudaGetDriverEntryPoint so the libraries link only the
// CUDA runtime) and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace sky {
namespace sm90 {

constexpr int BM = 128;        // two consumer warpgroups of 64 rows
constexpr int BK = 64;         // one 128-byte swizzle row of bf16
constexpr int THREADS = 384;   // producer warpgroup + two consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX = 64;        // columns of a B or output box (128 bytes)
constexpr int B_BOX_BYTES = BK * BOX * 2;
constexpr int OUT_BOX_BYTES = 64 * BOX * 2;  // one consumer's 64 rows
constexpr int SMEM_EXTRA = 1024 + 256;  // 1024-byte alignment slack, barriers

template <int BN>
struct Cfg {
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  static constexpr int OUT_BYTES = BM * BN * 2;  // the staged output tile
  static constexpr int STAGES = (int)((SMEM_OPTIN_MAX - SMEM_EXTRA - OUT_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + SMEM_EXTRA;
  static_assert(STAGES >= 3, "ring too shallow");
};

struct Plan {
  int bn, stages, tiles, smem;
};

// The tile width: of BN = 256, 192, 128, the fewest waves x BN over `sms`
// resident CTAs; a narrower tile must cut it by more than a sixteenth.
// Mirrored by ops/kernels/gemm.py gemm_plan.
inline Plan gemm_sm90_plan(int M, int N, int sms) {
  const int bns[3] = {256, 192, 128};
  const int stages[3] = {Cfg<256>::STAGES, Cfg<192>::STAGES, Cfg<128>::STAGES};
  const int smem[3] = {Cfg<256>::SMEM, Cfg<192>::SMEM, Cfg<128>::SMEM};
  const long long m_tiles = (M + BM - 1) / BM;
  Plan best{0, 0, 0, 0};
  long long best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    const long long tiles = m_tiles * ((N + bns[i] - 1) / bns[i]);
    const long long cost = (tiles + sms - 1) / sms * bns[i];
    if (best.bn == 0 || cost * 16 < best_cost * 15) {
      best = Plan{bns[i], stages[i], (int)tiles, smem[i]};
      best_cost = cost;
    }
  }
  return best;
}

struct Sm90Args {
  const float* bias;   // (N,)
  bf16* out2;          // (M, N): EPI_BIAS_GELU_STASH's pre-activation
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 2-D TMA box (inner coordinate c0, outer c1) into shared memory at
// dst; its bytes complete the transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One 2-D TMA box from shared memory at src to (c0, c1), clipped at the
// tensor's edges, in this thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's TMA stores have all read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over one consumer warpgroup (named barrier 1 + wg, 128 threads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
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

// D[64 x 128] (+)= A[64 x 16] @ B[16 x 128]: A K-major, B MN-major (transposed), both
// read from shared memory through descriptors; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 192] (+)= A[64 x 16] @ B[16 x 192]: A K-major, B MN-major (transposed), both
// read from shared memory through descriptors; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 16] @ B[16 x 256]: A K-major, B MN-major (transposed), both
// read from shared memory through descriptors; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256) {
    wgmma_n256(d, da, db, scale_d);
  } else if constexpr (BN == 192) {
    wgmma_n192(d, da, db, scale_d);
  } else {
    wgmma_n128(d, da, db, scale_d);
  }
}

// One consumer warpgroup's 64 x BN accumulators, rows mw.., columns n0..,
// through its staged half-tile `stg` (BN / 64 boxes of 64 x 64, swizzled
// as TMA reads them) to TMA stores, one per box. wgmma's fp32 layout:
// thread t holds, for each 8-column group j, rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 j + 2 (t % 4) (+ 1), in d[4 j .. 4 j + 3]. For
// EPI_BIAS_RESIDUAL the staged half already holds the residual, and each
// thread replaces its own elements. nb: the boxes with columns below N.
template <int EPI, int BN>
__device__ __forceinline__ void epilogue(const float* d, const Sm90Args& p,
                                         const CUtensorMap* tma_out, uint32_t stg, int mw, int n0,
                                         int nb, int wg, bool leader) {
  const int t = threadIdx.x & 127;
  const int lr0 = (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int c = 0; c < BN / BOX; ++c) {
    if (c >= nb) break;
    const uint32_t box = stg + c * OUT_BOX_BYTES;
#pragma unroll
    for (int jj = 0; jj < BOX / 8; ++jj) {
      const int j = c * (BOX / 8) + jj;
      const int col = n0 + 8 * j + 2 * (t & 3);
      const bool in_n = col < p.N;  // N % 8 == 0: the pair is whole or out
      const float b0 = in_n ? __ldg(p.bias + col) : 0.f;
      const float b1 = in_n ? __ldg(p.bias + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = lr0 + 8 * h;
        const uint32_t at = box + lr * 128 + ((jj ^ (lr & 7)) << 4) + 4 * (t & 3);
        float v0 = d[4 * j + 2 * h] + b0, v1 = d[4 * j + 2 * h + 1] + b1;
        if (EPI == EPI_BIAS_GELU_STASH && in_n && mw + lr < p.M)
          *reinterpret_cast<uint32_t*>(p.out2 + (size_t)(mw + lr) * p.N + col) =
              pack_bf16x2(v0, v1);
        if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_STASH) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (EPI == EPI_BIAS_RESIDUAL) {
          const uint32_t rv = ld_shared_b32(at);
          v0 = __uint_as_float(rv << 16) + v0;
          v1 = __uint_as_float(rv & 0xFFFF0000u) + v1;
        }
        st_shared_b32(at, pack_bf16x2(v0, v1));
      }
    }
    fence_proxy_async();
    wg_sync(wg);
    if (leader) {
      tma_store_2d(tma_out, box, n0 + c * BOX, mw);
      bulk_commit();
    }
  }
}

template <int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ CUtensorMap tma_out,
                     const __grid_constant__ CUtensorMap tma_res, const Sm90Args p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // ring slot s: A (128 x 64, 16 KB) at base + s * STAGE_BYTES, then B's
  // BN / 64 boxes (64 x 64, 8 KB each); then the staged output tile, one
  // half per consumer; every box 1024-byte aligned, as the swizzle needs.
  // Then the full and empty barriers of the ring and one residual barrier
  // per consumer.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out0 = base + C::STAGES * C::STAGE_BYTES;
  const uint32_t full0 = out0 + C::OUT_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const uint32_t res0 = empty0 + 8 * C::STAGES;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx; TMA completes it
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(res0, 1);
    mbar_init(res0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load of the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        const int nb = min(BN / BOX, (p.N - n0 + BOX - 1) / BOX);
        const uint32_t bytes = A_BYTES + nb * B_BOX_BYTES;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = base + stage * C::STAGE_BYTES;
          mbar_expect_tx(full, bytes);
          tma_load_2d(sa, &tma_a, full, kb * BK, m0);
          for (int c = 0; c < nb; ++c)
            tma_load_2d(sa + A_BYTES + c * B_BOX_BYTES, &tma_b, full, n0 + c * BOX, kb * BK);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 1 and 2: rows 64 * wg .. + 64 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const bool leader = (threadIdx.x & 127) == 0;
    const uint32_t stg = out0 + wg * (C::OUT_BYTES / 2);
    const uint32_t res_bar = res0 + 8 * wg;
    uint32_t res_phase = 0;
    float d[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int mw = m0 + 64 * wg;
      const int nb = min(BN / BOX, (p.N - n0 + BOX - 1) / BOX);
      const bool rows = mw < p.M;  // this half has rows to store
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * C::STAGE_BYTES + wg * (A_BYTES / 2);
        const uint32_t sb = base + stage * C::STAGE_BYTES + A_BYTES;
        fence_acc<BN / 2>(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_tile<BN>(d, smem_desc(sa + kk * 32, 16, 1024),
                         smem_desc(sb + kk * 16 * 128, B_BOX_BYTES, 1024), (kb | kk) != 0);
        wgmma_commit();
        if (EPI == EPI_BIAS_RESIDUAL && kb == min(2, nk - 1) && leader && rows) {
          // the staged half is free once the last tile's stores have read
          // it (two slabs in, they have); the residual then streams in
          // under the rest of this tile's mainloop
          bulk_wait_read();
          mbar_expect_tx(res_bar, nb * OUT_BOX_BYTES);
          for (int c = 0; c < nb; ++c)
            tma_load_2d(stg + c * OUT_BOX_BYTES, &tma_res, res_bar, n0 + c * BOX, mw);
        }
        if (kb > 0) {  // the previous slab's products are done: free its slot
          wgmma_wait<1>();
          if (leader) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(d);
      if (leader) mbar_arrive(empty0 + 8 * prev);
      if (rows) {
        if (EPI == EPI_BIAS_RESIDUAL) {
          mbar_wait(res_bar, res_phase);
          res_phase ^= 1;
        } else {
          if (leader) bulk_wait_read();  // the last tile's stores have read the staged half
          wg_sync(wg);
        }
        epilogue<EPI, BN>(d, p, &tma_out, stg, mw, n0, nb, wg, leader);
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the libraries link only libcudart.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix as a TMA map of box_rows x 64
// boxes (128 bytes wide: the swizzle's span), 128-byte swizzle; loads read
// out-of-range elements as zero, stores skip them.
inline bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

template <int EPI, int BN>
cudaError_t launch_bn(const CUtensorMap* maps, const Sm90Args& p, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_sm90_kernel<EPI, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  gemm_sm90_kernel<EPI, BN>
      <<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// out = epilogue(A @ B + bias) for A (M, K) and B (K, N), both row-major
// bf16, K and N multiples of 8; out2 only for EPI_BIAS_GELU_STASH, resid
// only for EPI_BIAS_RESIDUAL.
template <int EPI>
cudaError_t launch_gemm_sm90(const void* a, const void* b, const void* bias, const void* resid,
                             void* out, void* out2, int M, int N, int K, cudaStream_t stream) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_STASH ||
                    EPI == EPI_BIAS_RESIDUAL,
                "the forward epilogues only");
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan plan = gemm_sm90_plan(M, N, sms);
  // A in 128 x 64 boxes, B in 64 x 64, the output and residual in 64 x 64
  CUtensorMap maps[4];
  if (!encode_2d(&maps[0], a, M, K, BM) || !encode_2d(&maps[1], b, K, N, BK) ||
      !encode_2d(&maps[2], out, M, N, 64))
    return cudaErrorInvalidValue;
  if (EPI == EPI_BIAS_RESIDUAL) {
    if (!encode_2d(&maps[3], resid, M, N, 64)) return cudaErrorInvalidValue;
  } else {
    maps[3] = maps[2];  // not read
  }
  const Sm90Args p{static_cast<const float*>(bias), static_cast<bf16*>(out2), M, N, K};
  const int grid = plan.tiles < sms ? plan.tiles : sms;
  if (plan.bn == 256) return launch_bn<EPI, 256>(maps, p, grid, stream);
  if (plan.bn == 192) return launch_bn<EPI, 192>(maps, p, grid, stream);
  return launch_bn<EPI, 128>(maps, p, grid, stream);
}

}  // namespace sm90
}  // namespace sky
