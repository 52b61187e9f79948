// Persistent, warp-specialised bf16 GEMM for Hopper (sm_90a): wgmma fed by
// TMA, in three forms.
//
//   forward:  out[M, N] = epilogue(A[M, K] @ B[K, N] + bias[N])
//   FORM_NT:  out[M, N] = epilogue(A[M, K] @ B^T), B stored (N, K)
//   FORM_TN:  out[M, N] = epilogue(A^T @ B[K, N]), A stored (K, M)
//
// Forward: A is the (M, K) row-major activation (y for fc1 and qkv, h for
// fc2, ctx for proj); B the weight in its JAX (in, out) layout, (K, N)
// row-major. Neither is copied: A is K-major for wgmma and B MN-major,
// read through the transposed-B form of the shared-memory descriptor.
// FORM_NT reads B K-major (g @ W^T with the (in, out) weight read as (N,
// K): dh, dy); FORM_TN reads A MN-major through wgmma's transposed-A form,
// bf16 only (the weight gradients y^T @ da_c and h_c^T @ g, reduced over K
// = B*N token rows, ragged: TMA zero-fills past K). The dual product of the
// MLP backward (gemm_dual_kernel) runs the forward and FORM_NT readings of
// one hidden tile in one mainloop; the stash dh product
// (gemm_dh_stash_kernel) the FORM_NT reading alone, with an epilogue that
// reads the bf16 fc1 pre-activation the stash forward kept.
//
// Serves the TPU kernels sky_embeddings_tpu/ops/kernels/mlp_block.py
// _pallas_fwd / _pallas_fwd_stash (fc1, fc2: csrc/mlp_block.cu),
// attn_block.py _pallas_fwd / _pallas_fwd_stash (qkv, proj:
// csrc/attn_block.cu), masked or not, mlp_block.py _pallas_bwd,
// _pallas_bwd_stash and _pallas_bwd_stream (kernels 8, 7 and 9, every
// product: csrc/mlp_block_bwd.cu) and attn_block.py _pallas_bwd_stash and
// _pallas_bwd (kernels 3 and 4, every product: kernel 4's qkv recompute on
// the forward form, dctx and dy on FORM_NT, dWqkv and dWproj in one FORM_TN
// group: csrc/attn_block_bwd.cu). Every GEMM of the port runs here.
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
//   by 16 rows (2048 bytes). The backward forms reuse both readings:
//   FORM_NT's B (one BN x 64 box) is read as A is, K-major; FORM_TN's A
//   (two 64 x 64 boxes, one per consumer) as B is, MN-major, with wgmma's
//   transposed-A flag. Each form is its own kernel instantiation: a
//   runtime choice between the two wgmma forms made ptxas serialise every
//   wgmma (warning C7520).
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
// Deterministic: a forward output tile belongs to one CTA over its whole K
// (no split-K, no atomics), so every output is one fp32 sum in a fixed
// order, bit-reproducible run to run; a split weight gradient's slices are
// added in slice order by a second pass, and the dual product's column
// sums in a fixed order. Ragged edges: TMA zero-fills rows past M and
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
//   EPI_STORE_F32        acc in fp32 from the registers, no bias (the
//                        tensor-parallel proj and fc2 partials)
// and in the backward forms (per product of a group):
//   EPI_STORE            bf16(acc), staged and TMA-stored    (dW1, dW2: the
//                        weight dtype, mlp_block.py:954-956)
//   EPI_STORE_F32        acc in fp32 from the registers      (dy; a split
//                        product's partials)
//   EPI_ADD_F32          acc + out in fp32                   (kernel 9's dy
//                        over slabs, dy_j + dy: mlp_block.py:499-501)
//   the dual product:    a = acc_a + b1, da = acc_dh * gelu'(a) in fp32;
//                        da_c = bf16(da), h_c = bf16(gelu(a)) staged and
//                        TMA-stored, da's column sums for db1
//                        (mlp_block.py:322-329)
//   the stash dh product: the same with a the bf16 stash, upcast
//                        (mlp_block.py:392-399, :419)
// An fp32 output leaves from the registers: a staged fp32 tile would take
// twice the bf16 one's shared memory from the ring, and the stores drain
// under the next tile's mainloop (PERF.md).
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
#include <string.h>

#include <mutex>

#include "common.cuh"

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
  float* out_f32;      // (M, N): EPI_STORE_F32's output
};

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

// D[64 x 128] (+)= A[64 x 16] @ B[16 x 128], both read from shared memory
// through descriptors: TA / TB = 0 reads A / B K-major, 1 MN-major
// (transposed); scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 192] (+)= A[64 x 16] @ B[16 x 192], both read from shared memory
// through descriptors: TA / TB = 0 reads A / B K-major, 1 MN-major
// (transposed); scale_d = 0 overwrites D.
template <int TA, int TB>
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
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 256] (+)= A[64 x 16] @ B[16 x 256], both read from shared memory
// through descriptors: TA / TB = 0 reads A / B K-major, 1 MN-major
// (transposed); scale_d = 0 overwrites D.
template <int TA, int TB>
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
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int BN, int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256) {
    wgmma_n256<TA, TB>(d, da, db, scale_d);
  } else if constexpr (BN == 192) {
    wgmma_n192<TA, TB>(d, da, db, scale_d);
  } else {
    wgmma_n128<TA, TB>(d, da, db, scale_d);
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
              pack_bf16(v0, v1);
        if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_STASH) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (EPI == EPI_BIAS_RESIDUAL) {
          const uint32_t rv = ld_shared_b32(at);
          v0 = __uint_as_float(rv << 16) + v0;
          v1 = __uint_as_float(rv & 0xFFFF0000u) + v1;
        }
        st_shared_b32(at, pack_bf16(v0, v1));
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

// One consumer's 64 x BN accumulators straight from the registers to fp32
// rows ldo apart (each quad writes 32 contiguous bytes of a row), or added
// to what is there: every load first, then the stores, so the loads'
// latencies overlap.
template <int BN>
__device__ __forceinline__ void store_f32(float* d, float* o, int ldo, int M, int N, int mw,
                                          int n0, bool add) {
  const int t = threadIdx.x & 127;
  const int r0 = mw + (t >> 5) * 16 + ((t & 31) >> 2);
  if (add) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (t & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (col < N && row < M) {
          const float2 w = *reinterpret_cast<const float2*>(o + (size_t)row * ldo + col);
          d[4 * j + 2 * h] += w.x;
          d[4 * j + 2 * h + 1] += w.y;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (t & 3);
    if (col >= N) continue;  // N % 8 == 0: the pair is whole or out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < M)
        *reinterpret_cast<float2*>(o + (size_t)row * ldo + col) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
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
        if constexpr (EPI == EPI_STORE_F32) {
          store_f32<BN>(d, p.out_f32, p.N, p.M, p.N, mw, n0, false);
        } else {
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

// A row-major bf16 (rows, cols) matrix, rows `ld` elements apart (0: cols),
// as a TMA map of box_rows x 64 boxes (128 bytes wide: the swizzle's span),
// 128-byte swizzle; loads read out-of-range elements as zero, stores skip
// them. A pitch wider than cols reads or writes a column slab in place.
inline bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                      int ld = 0) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : cols) * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
// only for EPI_BIAS_RESIDUAL. EPI_STORE_F32 takes no bias and writes the
// fp32 product A @ B to `out` (M, N) from the registers, as the backward
// forms do: the partial sums of the tensor-parallel blocks' proj and fc2,
// which an all-reduce adds before the bias and the residual
// (attn_block.cu, mlp_block.cu).
template <int EPI>
cudaError_t launch_gemm_sm90(const void* a, const void* b, const void* bias, const void* resid,
                             void* out, void* out2, int M, int N, int K, cudaStream_t stream) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_STASH ||
                    EPI == EPI_BIAS_RESIDUAL || EPI == EPI_STORE_F32,
                "the forward epilogues only");
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan plan = gemm_sm90_plan(M, N, sms);
  // A in 128 x 64 boxes, B in 64 x 64, the output and residual in 64 x 64
  CUtensorMap maps[4];
  if (!encode_2d(&maps[0], a, M, K, BM) || !encode_2d(&maps[1], b, K, N, BK))
    return cudaErrorInvalidValue;
  if (EPI == EPI_STORE_F32)
    maps[2] = maps[0];  // not read: the fp32 output leaves from the registers
  else if (!encode_2d(&maps[2], out, M, N, 64))
    return cudaErrorInvalidValue;
  if (EPI == EPI_BIAS_RESIDUAL) {
    if (!encode_2d(&maps[3], resid, M, N, 64)) return cudaErrorInvalidValue;
  } else {
    maps[3] = maps[2];  // not read
  }
  const Sm90Args p{static_cast<const float*>(bias), static_cast<bf16*>(out2), M, N, K,
                   EPI == EPI_STORE_F32 ? static_cast<float*>(out) : nullptr};
  const int grid = plan.tiles < sms ? plan.tiles : sms;
  if (plan.bn == 256) return launch_bn<EPI, 256>(maps, p, grid, stream);
  if (plan.bn == 192) return launch_bn<EPI, 192>(maps, p, grid, stream);
  return launch_bn<EPI, 128>(maps, p, grid, stream);
}


// ---- the backward forms -------------------------------------------------
//
// FORM_NT: out[M, N] = A[M, K] @ B^T, B stored (N, K) row-major: both
// operands K-major (g @ W^T with W read as (out, in): dh, dy). FORM_TN:
// out[M, N] = A^T @ B[K, N], A stored (K, M): both MN-major (the weight
// gradients, reduced over the K = B*N token rows). One launch runs a group
// of up to three products of one form over the union of their output tiles
// (kernel 8's and 9's dW1 and dW2 share one, kernels 3 and 4's dWqkv and
// dWproj another, so that their small outputs fill the card together); a
// weight gradient (FORM_TN, EPI_STORE) may split
// its K into slices whose fp32 partials a second pass adds in order.
//
// The stream-K schedule (a group of weight gradients alone): where whole
// tiles, even cut in two K slices, leave SMs idle (the tensor-parallel
// ranks' narrow dW products over K = B*N tokens: 13 to 36 tiles for 132
// SMs), the group's (tile, 64-deep slab) iterations over all its products,
// W of them, are dealt to `grid` persistent CTAs in contiguous, equal runs
// ([g W / grid, (g + 1) W / grid) for CTA g). The plan picks grid: the
// largest multiple of the tile count within the SMs, so that each run lies
// inside one tile and the tiles' runs stream K in step (the card read the
// ViT-S TP groups so dealt 1.2 to 1.35 times faster than over min(132, W) CTAs,
// whose runs cross tiles at offsets out of step: PERF.md section 6), or
// min(132, W). A CTA walks its run's pieces from its last down:
// - a piece that covers a tile whole runs the bf16 epilogue;
// - a piece without the tile's last slab (at most one a CTA: its run's
//   last, so it comes first in the walk) stores its fp32 accumulators to the
//   CTA's workspace slot, in the accumulators' own order (16 bytes a thread,
//   coalesced, through L2), then raises its flag (one a consumer
//   warpgroup, release at gpu scope);
// - the piece with the tile's last slab belongs to the tile's owner, which
//   waits on the flags of the CTAs before it whose runs reach into the
//   tile (acquire), adds their partials to its own accumulators in segment
//   order, and rounds to bf16 once.
// An owner waits only on CTAs of lower index, which write before they wait
// on anything, and the grid is at most one CTA an SM, all resident: the
// spinning cannot deadlock. The deal and the order of the sums depend on
// the shapes alone, so the result is bit-reproducible run to run, as the
// split schedule's is. The producer, the ring and the consumers' wgmma are
// the split schedule's; only the walk, the fix-up and the plan differ.

enum Form { FORM_NT = 1, FORM_TN = 2 };

constexpr int MAX_PROBLEMS = 3;
constexpr int N_SPLIT_CANDIDATES = 2;
constexpr int SPLIT_CANDIDATES[N_SPLIT_CANDIDATES] = {1, 2};
// A product's kind in a group plan: FORM_NT (never split), a weight
// gradient (FORM_TN rounded to bf16: may split its K) or another FORM_TN
// product (fp32, not split).
enum ShapeKind { KIND_NT = 0, KIND_TN_SPLIT = 1, KIND_TN = 2 };
// The plan's cost model, in units of about 0.1 us of one CTA, fitted to
// card sweeps with tile widths and split counts forced (PERF.md PR 10):
// dy and dh alone for FORM_NT, kernel 8's and 9's weight-gradient group at
// mim_1 B=64 and 512, the MAE encoder and decoder and a ViT-H slab at B=32
// and 256 for FORM_TN, where the plan below picks the fastest of the 18
// readings at all six. A 64-deep slab of a 128 x BN tile costs
// slab_cost(kind, BN): for FORM_TN in proportion to the bytes it brings
// into shared memory (48, 40, 32 KB at BN = 256, 192, 128); for FORM_NT,
// whose fp32 epilogue leaves from the registers, more at the wider tiles.
// Its epilogue costs EPI_COST per 64 columns (the stores drain under the
// next tile's mainloop), and a split product's reduce pass, which runs on
// the whole card at HBM's rate, one unit per REDUCE_BYTES_PER_COST bytes
// it moves. Splits past two won at none of the six shapes. Stream-K (a
// candidate only where the tiles at BN = 128 cut in two slices give fewer
// units than SMs, every product a weight gradient): the most loaded CTA's
// slabs and epilogues, plus one unit per STREAMK_BYTES_PER_COST bytes of
// each 128 x BN fp32 partial it stores or, as a tile's owner, reads
// through L2.
inline int slab_cost(int kind, int bn) {
  if (kind == KIND_NT) return bn == 256 ? 11 : bn == 192 ? 7 : 5;
  return bn == 256 ? 6 : bn == 192 ? 5 : 4;
}
constexpr int EPI_COST = 1;
constexpr long long REDUCE_BYTES_PER_COST = 1 << 16;
constexpr long long STREAMK_BYTES_PER_COST = 1 << 13;
constexpr long long STREAMK_SCATTER = 2;

struct BwdProblem {
  float* out_f32;  // EPI_STORE_F32 / EPI_ADD_F32: (M, N) rows ldo apart; split-K partials: slice z at + z * M * N
  int epi, M, N, K, ldo;
  int n_tiles, splits, k_chunk, unit0;  // k_chunk: slabs per split; unit0: stream-K's first iteration
};

struct BwdArgs {
  BwdProblem p[MAX_PROBLEMS];
  int count, units;  // units: (tile, K slice) units, or stream-K's (tile, slab) iterations
  int stream_k;
  int* flags;    // stream-K: two a CTA, zeroed before the launch
  float* slots;  // stream-K: a 128 x BN fp32 partial a CTA, 64 x BN a consumer
};

// stream-K's workspace: the flags (two a CTA) padded to 64 floats, then the
// slots
inline size_t sk_flag_floats(int grid) { return (size_t)(2 * grid + 63) / 64 * 64; }

struct BwdMaps {
  CUtensorMap m[MAX_PROBLEMS][3];  // A, B, the bf16 output (EPI_STORE without splits)
};

// Unit u of a group: problem pi, output tile (m0, n0), K slice z over slabs [kb0, kb1).
template <int BN>
__device__ __forceinline__ void bwd_unit(const BwdArgs& p, int u, int& pi, int& m0, int& n0,
                                         int& z, int& kb0, int& kb1) {
  pi = 0;
  for (int i = 1; i < p.count; ++i)
    if (u >= p.p[i].unit0) pi = i;
  const BwdProblem& q = p.p[pi];
  const int local = u - q.unit0;
  const int tile = local / q.splits;
  z = local - tile * q.splits;
  m0 = (tile / q.n_tiles) * BM;
  n0 = (tile % q.n_tiles) * BN;
  kb0 = z * q.k_chunk;
  kb1 = min((q.K + BK - 1) / BK, kb0 + q.k_chunk);
}

// A piece of a CTA's walk: problem pi, output tile (m0, n0), slabs [kb0,
// kb1); z the K slice of the split schedule; t0 and nk the tile's first
// iteration and slab count under stream-K.
struct BwdSeg {
  int pi, m0, n0, z, kb0, kb1, t0, nk;
};

// A CTA's stream-K run [lo, cur) of the group's (tile, slab) iterations.
__device__ __forceinline__ void sk_run(const BwdArgs& p, int& cur, int& lo) {
  lo = (int)((long long)blockIdx.x * p.units / gridDim.x);
  cur = (int)((long long)(blockIdx.x + 1) * p.units / gridDim.x);
}

// The run's next piece, from its last iteration down, a tile's piece at a
// time; false past its first.
template <int BN>
__device__ __forceinline__ bool sk_next(const BwdArgs& p, int& cur, int lo, BwdSeg& s) {
  if (cur <= lo) return false;
  const int it = cur - 1;
  int pi = 0;
  for (int i = 1; i < p.count; ++i)
    if (it >= p.p[i].unit0) pi = i;
  const BwdProblem& q = p.p[pi];
  const int nk = (q.K + BK - 1) / BK;
  const int tile = (it - q.unit0) / nk;
  const int t0 = q.unit0 + tile * nk;
  const int from = max(lo, t0);
  s.pi = pi;
  s.z = 0;
  s.m0 = (tile / q.n_tiles) * BM;
  s.n0 = (tile % q.n_tiles) * BN;
  s.kb0 = from - t0;
  s.kb1 = cur - t0;
  s.t0 = t0;
  s.nk = nk;
  cur = from;
  return true;
}

__device__ __forceinline__ void flag_raise(int* f) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" ::"l"(f), "r"(1) : "memory");
}

__device__ __forceinline__ void flag_wait(const int* f) {
  int v = 0;
  while (v == 0)
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
}

// A consumer's slot of CTA c: 64 x BN fp32.
template <int BN>
__device__ __forceinline__ float* sk_slot(const BwdArgs& p, int c, int wg) {
  return p.slots + ((size_t)c * 2 + wg) * 64 * BN;
}

// One consumer's 64 x BN accumulators to its slot in their register order
// (float4 j of thread t at j * 128 + t: each store a coalesced 2 KB), past
// L1; sk_add reads them back in the same order and adds them.
template <int BN>
__device__ __forceinline__ void sk_store(const float* d, float* slot) {
  const int t = threadIdx.x & 127;
  float4* s4 = reinterpret_cast<float4*>(slot);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    __stcg(s4 + j * 128 + t, make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]));
}

template <int BN>
__device__ __forceinline__ void sk_add(float* d, const float* slot) {
  const int t = threadIdx.x & 127;
  const float4* s4 = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float4 v = __ldcg(s4 + j * 128 + t);
    d[4 * j] += v.x;
    d[4 * j + 1] += v.y;
    d[4 * j + 2] += v.z;
    d[4 * j + 3] += v.w;
  }
}

// One consumer's 64 x BN accumulators, rounded to bf16, through its staged
// half-tile to TMA stores (the forward epilogue's layout, no bias).
template <int BN>
__device__ __forceinline__ void store_bf16(const float* d, const CUtensorMap* map, uint32_t stg,
                                           int mw, int n0, int nb, int wg, bool leader) {
  const int t = threadIdx.x & 127;
  const int lr0 = (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int c = 0; c < BN / BOX; ++c) {
    if (c >= nb) break;
    const uint32_t box = stg + c * OUT_BOX_BYTES;
#pragma unroll
    for (int jj = 0; jj < BOX / 8; ++jj) {
      const int j = c * (BOX / 8) + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = lr0 + 8 * h;
        st_shared_b32(box + lr * 128 + ((jj ^ (lr & 7)) << 4) + 4 * (t & 3),
                      pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
      }
    }
    fence_proxy_async();
    wg_sync(wg);
    if (leader) {
      tma_store_2d(map, box, n0 + c * BOX, mw);
      bulk_commit();
    }
  }
}

// The producer's share of one piece (problem pi, tile (m0, n0), slabs [kb0,
// kb1)): its slabs' TMA loads through the ring.
template <int BN, int FORM>
__device__ __forceinline__ void bwd_produce(const BwdMaps& maps, const BwdArgs& p, int pi, int m0,
                                            int n0, int kb0, int kb1, uint32_t base,
                                            uint32_t full0, uint32_t empty0, int& stage,
                                            uint32_t& phase) {
  constexpr bool tn = FORM == FORM_TN;
  using C = Cfg<BN>;
  const BwdProblem& q = p.p[pi];
  const CUtensorMap* ma = &maps.m[pi][0];
  const CUtensorMap* mb = &maps.m[pi][1];
  const int nb = min(BN / BOX, (q.N - n0 + BOX - 1) / BOX);
  const bool a_hi = !tn || m0 + 64 < q.M;  // TN: the second 64-row box has rows
  const uint32_t bytes = tn ? (a_hi ? A_BYTES : A_BYTES / 2) + nb * B_BOX_BYTES
                            : A_BYTES + BN * BK * 2;
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const uint32_t full = full0 + 8 * stage;
    const uint32_t sa = base + stage * C::STAGE_BYTES;
    mbar_expect_tx(full, bytes);
    if constexpr (tn) {
      tma_load_2d(sa, ma, full, m0, kb * BK);
      if (a_hi) tma_load_2d(sa + A_BYTES / 2, ma, full, m0 + 64, kb * BK);
      for (int c = 0; c < nb; ++c)
        tma_load_2d(sa + A_BYTES + c * B_BOX_BYTES, mb, full, n0 + c * BOX, kb * BK);
    } else {
      tma_load_2d(sa, ma, full, kb * BK, m0);
      tma_load_2d(sa + A_BYTES, mb, full, kb * BK, n0);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer's share of one piece: the mainloop over its slabs, then the
// epilogue. SK: the stream-K schedule (seg.t0, seg.nk set), whose piece
// without its tile's last slab stores a partial for the tile's owner and
// whose owner adds the partials first; the split schedule's walk does not
// compile that code in.
template <int BN, int FORM, bool SK>
__device__ __forceinline__ void bwd_consume(const BwdMaps& maps, const BwdArgs& p,
                                            const BwdSeg& seg, float* d, uint32_t base,
                                            uint32_t full0, uint32_t empty0, uint32_t stg, int wg,
                                            bool leader, int& stage, uint32_t& phase) {
  constexpr bool tn = FORM == FORM_TN;
  using C = Cfg<BN>;
  const int pi = seg.pi, m0 = seg.m0, n0 = seg.n0, kb0 = seg.kb0, kb1 = seg.kb1;
  const BwdProblem& q = p.p[pi];
  const int mw = m0 + 64 * wg;
  const int nb = min(BN / BOX, (q.N - n0 + BOX - 1) / BOX);
  int prev = 0;
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t sa = base + stage * C::STAGE_BYTES + wg * (A_BYTES / 2);
    const uint32_t sb = base + stage * C::STAGE_BYTES + A_BYTES;
    fence_acc<BN / 2>(d);
    wgmma_fence();
    if constexpr (tn) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN, 1, 1>(d, smem_desc(sa + kk * 16 * 128, A_BYTES / 2, 1024),
                             smem_desc(sb + kk * 16 * 128, B_BOX_BYTES, 1024), (kb != kb0) | kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN, 0, 0>(d, smem_desc(sa + kk * 32, 16, 1024),
                             smem_desc(sb + kk * 32, 16, 1024), (kb != kb0) | kk);
    }
    wgmma_commit();
    if (kb > kb0) {
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
  if (mw >= q.M) return;
  if constexpr (SK) {
    if (kb1 < seg.nk) {
      // a piece without the tile's last slab: its partial for the owner
      sk_store<BN>(d, sk_slot<BN>(p, blockIdx.x, wg));
      __threadfence();
      wg_sync(wg);
      if (leader) flag_raise(p.flags + 2 * blockIdx.x + wg);
      return;
    }
    if (kb0 > 0) {
      // the tile's owner: the partials of the CTAs before it whose runs
      // reach into the tile, added in segment order
      const int c0 = (int)(((long long)(seg.t0 + 1) * gridDim.x - 1) / p.units);
      for (int c = c0; c < (int)blockIdx.x; ++c) {
        if (leader) flag_wait(p.flags + 2 * c + wg);
        wg_sync(wg);
        sk_add<BN>(d, sk_slot<BN>(p, c, wg));
      }
    }
  }
  if (q.splits == 1 && q.epi == EPI_STORE) {
    if (leader) bulk_wait_read();  // the last tile's stores have read the staged half
    wg_sync(wg);
    store_bf16<BN>(d, &maps.m[pi][2], stg, mw, n0, nb, wg, leader);
  } else {
    store_f32<BN>(d, q.out_f32 + (size_t)seg.z * q.M * q.N, q.ldo, q.M, q.N, mw, n0,
                  q.epi == EPI_ADD_F32);
  }
}

// The group kernel: the forward kernel's ring, producer and consumers,
// walking the units of every problem of one form (the split schedule:
// blockIdx.x, + gridDim.x, ...) or its stream-K run's pieces; the epilogue
// is per problem. The form is a template parameter: with a runtime choice
// between the two wgmma forms ptxas serialises every wgmma (warning C7520).
// The two walks are separate loops around one inlined body each: a first
// design with one loop whose next-piece function branched on the schedule
// made the split schedule's mainloop 20% slower at the TP forms' groups
// (PERF.md section 6).
template <int BN, int FORM>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bwd_kernel(const __grid_constant__ BwdMaps maps, const __grid_constant__ BwdArgs p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // ring slot s: A (16 KB: one 128 x 64 box K-major, or two 64 x 64 boxes
  // of its transpose, one per consumer) then B (one BN x 64 box K-major, or
  // BN / 64 boxes of 64 x 64 MN-major); then the staged output tile
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out0 = base + C::STAGES * C::STAGE_BYTES;
  const uint32_t full0 = out0 + C::OUT_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      if (!p.stream_k) {
        for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
          int pi, m0, n0, z, kb0, kb1;
          bwd_unit<BN>(p, u, pi, m0, n0, z, kb0, kb1);
          bwd_produce<BN, FORM>(maps, p, pi, m0, n0, kb0, kb1, base, full0, empty0, stage, phase);
        }
      } else {
        int cur, lo;
        sk_run(p, cur, lo);
        BwdSeg sg;
        while (sk_next<BN>(p, cur, lo, sg))
          bwd_produce<BN, FORM>(maps, p, sg.pi, sg.m0, sg.n0, sg.kb0, sg.kb1, base, full0, empty0,
                                stage, phase);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const bool leader = (threadIdx.x & 127) == 0;
    const uint32_t stg = out0 + wg * (C::OUT_BYTES / 2);
    float d[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    BwdSeg sg;
    if (!p.stream_k) {
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        bwd_unit<BN>(p, u, sg.pi, sg.m0, sg.n0, sg.z, sg.kb0, sg.kb1);
        bwd_consume<BN, FORM, false>(maps, p, sg, d, base, full0, empty0, stg, wg, leader, stage,
                                     phase);
      }
    } else {
      int cur, lo;
      sk_run(p, cur, lo);
      while (sk_next<BN>(p, cur, lo, sg))
        bwd_consume<BN, FORM, true>(maps, p, sg, d, base, full0, empty0, stg, wg, leader, stage,
                                    phase);
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- the dual product of the MLP backward ---------------------------------
//
// For one (128 x 128) tile of the (M, F) hidden layer, both products that
// share K = D: a = y @ W1 + b1 (W1 (D, F) read MN-major, as the forward
// does) and dh = g @ W2^T (W2 (F, D) read K-major), into two accumulator
// sets of 64 x 128 per consumer. The epilogue takes the TPU kernel's
// rounding points in fp32 (mlp_block.py:322-329): da = dh * gelu'(a),
// da_c = bf16(da), h_c = bf16(gelu(a)), and the column sums of the fp32 da
// over the consumer's 64 rows (for db1) into part[(row / 64) * N + col],
// added within the tile in a fixed order (quad shuffles, then the four
// warps in turn); neither fp32 (M, F) array reaches device memory.
// A template, so that only the libraries that launch the dual product
// compile it.
template <int BN>
struct DualCfg {
  static_assert(BN == 128, "two 64 x BN accumulator sets fit the registers at BN = 128");
  static constexpr int TILE_BYTES = BM * BK * 2;      // y, g, W1's two boxes or W2's box
  static constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // 64 KB
  static constexpr int OUT_BYTES = BM * BN * 2;       // one staged bf16 tile, da_c then h_c
  static constexpr int STAGES = (int)((SMEM_OPTIN_MAX - SMEM_EXTRA - OUT_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + SMEM_EXTRA;
  static_assert(STAGES >= 3, "ring too shallow");
};
constexpr int DUAL_BN = 128;

struct DualArgs {
  const float* b1;  // (N,)
  float* part;      // (ceil(M / 64), N): the column sums of da over 64 rows
  int M, N, K;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_dual_kernel(const __grid_constant__ CUtensorMap tma_y,
                     const __grid_constant__ CUtensorMap tma_g,
                     const __grid_constant__ CUtensorMap tma_w1,
                     const __grid_constant__ CUtensorMap tma_w2,
                     const __grid_constant__ CUtensorMap tma_da,
                     const __grid_constant__ CUtensorMap tma_h, const DualArgs p) {
  using C = DualCfg<BN>;
  constexpr int TILE_BYTES = C::TILE_BYTES, STAGE_BYTES = C::STAGE_BYTES, OUT_BYTES = C::OUT_BYTES;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // ring slot s: y (128 x 64), g (128 x 64), W1 (two 64 x 64 boxes), W2
  // (128 x 64), 16 KB each; then the staged output tile, one half per consumer
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out0 = base + STAGES * STAGE_BYTES;
  const uint32_t full0 = out0 + OUT_BYTES;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        const int nb = min(BN / BOX, (p.N - n0 + BOX - 1) / BOX);
        const uint32_t bytes = 3 * TILE_BYTES + nb * B_BOX_BYTES;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t s0 = base + stage * STAGE_BYTES;
          mbar_expect_tx(full, bytes);
          tma_load_2d(s0, &tma_y, full, kb * BK, m0);
          tma_load_2d(s0 + TILE_BYTES, &tma_g, full, kb * BK, m0);
          for (int c = 0; c < nb; ++c)
            tma_load_2d(s0 + 2 * TILE_BYTES + c * B_BOX_BYTES, &tma_w1, full, n0 + c * BOX, kb * BK);
          tma_load_2d(s0 + 3 * TILE_BYTES, &tma_w2, full, kb * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const uint32_t stg = out0 + wg * (OUT_BYTES / 2);
    const int lr0 = (t >> 5) * 16 + ((t & 31) >> 2);
    float da[BN / 2], dh[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int mw = m0 + 64 * wg;
      const int nb = min(BN / BOX, (p.N - n0 + BOX - 1) / BOX);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t s0 = base + stage * STAGE_BYTES;
        const uint32_t sy = s0 + wg * (TILE_BYTES / 2), sg = sy + TILE_BYTES;
        const uint32_t sw1 = s0 + 2 * TILE_BYTES, sw2 = s0 + 3 * TILE_BYTES;
        fence_acc<BN / 2>(da);
        fence_acc<BN / 2>(dh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_n128<0, 1>(da, smem_desc(sy + kk * 32, 16, 1024),
                           smem_desc(sw1 + kk * 16 * 128, B_BOX_BYTES, 1024), (kb | kk) != 0);
          wgmma_n128<0, 0>(dh, smem_desc(sg + kk * 32, 16, 1024),
                           smem_desc(sw2 + kk * 32, 16, 1024), (kb | kk) != 0);
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          if (leader) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(da);
      fence_acc<BN / 2>(dh);
      if (leader) mbar_arrive(empty0 + 8 * prev);
      if (mw >= p.M) continue;

      // da -> dh's registers, gelu(a) -> da's; each thread's column sums
      // over its two rows, then over the warp's 16 rows (lanes of one t % 4)
      float cs[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (t & 3);
        const bool in_n = col < p.N;
        const float b0 = in_n ? __ldg(p.b1 + col) : 0.f;
        const float b1 = in_n ? __ldg(p.b1 + col + 1) : 0.f;
        cs[2 * j] = 0.f;
        cs[2 * j + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float grad0, grad1;
          gelu_erf_and_grad(da[4 * j + 2 * h] + b0, da[4 * j + 2 * h], grad0);
          gelu_erf_and_grad(da[4 * j + 2 * h + 1] + b1, da[4 * j + 2 * h + 1], grad1);
          const float d0 = dh[4 * j + 2 * h] * grad0, d1 = dh[4 * j + 2 * h + 1] * grad1;
          dh[4 * j + 2 * h] = d0;
          dh[4 * j + 2 * h + 1] = d1;
          cs[2 * j] += d0;
          cs[2 * j + 1] += d1;
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 4);
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
      }
      // the four warps' sums through the staged half, added in warp order
      if (leader) bulk_wait_read();  // the last tile's stores have read the staged half
      wg_sync(wg);
      if ((t & 31) < 4) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t at = stg + ((t >> 5) * BN + 8 * j + 2 * (t & 3)) * 4;
          st_shared_b32(at, __float_as_uint(cs[2 * j]));
          st_shared_b32(at + 4, __float_as_uint(cs[2 * j + 1]));
        }
      }
      wg_sync(wg);
      if (n0 + t < p.N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += __uint_as_float(ld_shared_b32(stg + (w * BN + t) * 4));
        p.part[(size_t)(mw / 64) * p.N + n0 + t] = s;
      }
      wg_sync(wg);
      store_bf16<BN>(dh, &tma_da, stg, mw, n0, nb, wg, leader);
      if (leader) bulk_wait_read();
      wg_sync(wg);
      store_bf16<BN>(da, &tma_h, stg, mw, n0, nb, wg, leader);
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- the stash dh product of the MLP stash backward -------------------------
//
// Kernel 7's first product, for one (128 x STASH_BN) tile of the (M, F)
// hidden layer: dh = g @ W2^T (W2 (F, D) read K-major, as FORM_NT reads B)
// into one accumulator set of 64 x BN per consumer, then the dual
// product's outputs with a = the bf16 stash the stash forward kept, upcast
// (mlp_block.py:392-399, :419): da = dh * gelu'(a), da_c = bf16(da), h_c =
// bf16(gelu(a)), and da's column sums over the consumer's 64 rows into
// part[(row / 64) * N + col], added in the dual's order (a thread's two
// rows, quad shuffles, the four warps in turn). No fp32 (M, F) array
// reaches device memory.
// - A ring slot holds g's 128 x 64 box and W2's BN x 64 box.
// - Each consumer's 64 x BN half of the stash tile comes in by TMA under
//   its mainloop, as EPI_BIAS_RESIDUAL's residual does, once the last
//   tile's stores have read the buffers: three slabs before the mainloop
//   ends, so that the wait for those reads seldom holds up the ring (two
//   slabs in, as the residual, measured slower).
// - The epilogue is one pass: each thread reads its own pairs of a (a
//   box's 16 at once), writes bf16(gelu(a)) over them and bf16(da) into a
//   second buffer, both swizzled as TMA reads them, and keeps its column
//   sums in registers; each 64-column box of h_c and da_c leaves by TMA
//   store as soon as it is written, and the sums go through a
//   reduce-scatter over the warp and a small buffer.
//   The tensor cores wait meanwhile, so the pass is kept short: GELU and
//   GELU' take the TPU kernel's own erf (gelu_as_and_grad: one fast
//   reciprocal and one exp, shared), and no store waits for another
//   (tools/mlp_stash_variants.py times the alternatives; PERF.md §6).
// - Two bf16 buffers per consumer leave a four-slot ring at BN = 128; BN =
//   256 would leave one. A first design with one buffer (the stash, then
//   h_c, then da_c, in turn) ran at both widths; this one at 128 is faster
//   than either (tools/mlp_stash_variants.py).
template <int BN>
struct StashCfg {
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;  // g's box, W2's box
  static constexpr int HALF_BYTES = 64 * BN * 2;             // a consumer's 64 x BN bf16
  static constexpr int BUF_BYTES = 4 * HALF_BYTES;           // stash / h_c and da_c, each consumer
  static constexpr int SUM_BYTES = 2 * 4 * BN * 4;           // four warps' sums a consumer
  static constexpr int STAGES =
      (int)((SMEM_OPTIN_MAX - SMEM_EXTRA - BUF_BYTES - SUM_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + BUF_BYTES + SUM_BYTES + SMEM_EXTRA;
  static_assert(STAGES >= 3, "ring too shallow");
};
constexpr int STASH_BN = 128;

struct StashArgs {
  float* part;  // (ceil(M / 64), N): the column sums of da over 64 rows
  int M, N, K;
};

__global__ void __launch_bounds__(THREADS, 1)
    gemm_dh_stash_kernel(const __grid_constant__ CUtensorMap tma_g,
                         const __grid_constant__ CUtensorMap tma_w2,
                         const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_da,
                         const __grid_constant__ CUtensorMap tma_h, const StashArgs p) {
  constexpr int BN = STASH_BN;
  using C = StashCfg<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // ring slot s: g (128 x 64), then W2 (BN x 64); then each consumer's two
  // buffers (the stash, then h_c; da_c); the column sums, 4 x BN fp32 per
  // consumer; the ring's full and empty barriers and one stash barrier per
  // consumer
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t buf0 = base + C::STAGES * C::STAGE_BYTES;
  const uint32_t sums0 = buf0 + C::BUF_BYTES;
  const uint32_t full0 = sums0 + C::SUM_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const uint32_t stash0 = empty0 + 8 * C::STAGES;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_init(stash0, 1);
    mbar_init(stash0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t slot = base + stage * C::STAGE_BYTES;
          mbar_expect_tx(full, C::STAGE_BYTES);
          tma_load_2d(slot, &tma_g, full, kb * BK, m0);
          tma_load_2d(slot + A_BYTES, &tma_w2, full, kb * BK, n0);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const uint32_t sth = buf0 + wg * (2 * C::HALF_BYTES);  // the stash, then h_c
    const uint32_t std_ = sth + C::HALF_BYTES;              // da_c
    float* const sums =  // the column sums, as a pointer
        reinterpret_cast<float*>(smem_raw + (sums0 - smem_u32(smem_raw)) + wg * (C::SUM_BYTES / 2));
    const uint32_t stash_bar = stash0 + 8 * wg;
    const int lr0 = (t >> 5) * 16 + ((t & 31) >> 2);
    uint32_t stash_phase = 0;
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
        const uint32_t sg = base + stage * C::STAGE_BYTES + wg * (A_BYTES / 2);
        const uint32_t sw = base + stage * C::STAGE_BYTES + A_BYTES;
        fence_acc<BN / 2>(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_tile<BN, 0, 0>(d, smem_desc(sg + kk * 32, 16, 1024),
                               smem_desc(sw + kk * 32, 16, 1024), (kb | kk) != 0);
        wgmma_commit();
        if (kb == max(nk - 3, 0) && leader && rows) {
          bulk_wait_read();  // the last tile's stores have read both buffers
          mbar_expect_tx(stash_bar, nb * OUT_BOX_BYTES);
          for (int c = 0; c < nb; ++c)
            tma_load_2d(sth + c * OUT_BOX_BYTES, &tma_a, stash_bar, n0 + c * BOX, mw);
        }
        if (kb > 0) {
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
      if (!rows) continue;
      mbar_wait(stash_bar, stash_phase);
      stash_phase ^= 1;

      // a -> bf16(gelu(a)) in place and bf16(dh * gelu'(a)) beside it, a
      // box of 64 columns at a time, its 16 pairs of a loaded first; the
      // sums of da over the thread's two rows, per column
      float cs[BN / 4];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) cs[i] = 0.f;
#pragma unroll
      for (int c = 0; c < BN / BOX; ++c) {
        if (c >= nb) break;
        uint32_t av[BOX / 4];  // pair i: row lr0 + 8 (i % 2), columns 8 (i / 2) + 2 (t % 4) ..
#pragma unroll
        for (int i = 0; i < BOX / 4; ++i) {
          const int lr = lr0 + 8 * (i & 1);
          av[i] = ld_shared_b32(sth + c * OUT_BOX_BYTES + lr * 128 + (((i >> 1) ^ (lr & 7)) << 4) +
                                4 * (t & 3));
        }
#pragma unroll
        for (int i = 0; i < BOX / 4; ++i) {
          const int lr = lr0 + 8 * (i & 1), j = c * (BOX / 8) + (i >> 1);
          const int at = c * OUT_BOX_BYTES + lr * 128 + (((i >> 1) ^ (lr & 7)) << 4) + 4 * (t & 3);
          float h0, h1, q0, q1;
          gelu_as_and_grad(__uint_as_float(av[i] << 16), h0, q0);
          gelu_as_and_grad(__uint_as_float(av[i] & 0xFFFF0000u), h1, q1);
          const float d0 = d[4 * j + 2 * (i & 1)] * q0, d1 = d[4 * j + 2 * (i & 1) + 1] * q1;
          cs[2 * j] += d0;
          cs[2 * j + 1] += d1;
          st_shared_b32(sth + at, pack_bf16(h0, h1));
          st_shared_b32(std_ + at, pack_bf16(d0, d1));
        }
        fence_proxy_async();  // the box's h_c and da_c leave while the next is computed
        wg_sync(wg);
        if (leader) {
          tma_store_2d(&tma_h, sth + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
          tma_store_2d(&tma_da, std_ + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
          bulk_commit();
        }
      }
      // the sums over the warp's 16 rows (the 8 lanes of one t % 4) by a
      // reduce-scatter that pairs the lanes as the dual's butterfly does
      // (xor 4, then 8, then 16), so each sum is the dual's, bit for bit, in
      // 28 shuffles instead of 96: lane t keeps cs[k0 .. k0 + 3], k0 = 16 b2
      // + 8 b3 + 4 b4 for the bits b of t
      static_assert(BN == 128, "the reduce-scatter below halves 32 sums three times");
      {
        const bool b2 = t & 4, b3 = t & 8, b4 = t & 16;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float send = b2 ? cs[i] : cs[i + 16], keep = b2 ? cs[i + 16] : cs[i];
          cs[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float send = b3 ? cs[i] : cs[i + 8], keep = b3 ? cs[i + 8] : cs[i];
          cs[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float send = b4 ? cs[i] : cs[i + 4], keep = b4 ? cs[i + 4] : cs[i];
          cs[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        const int k0 = 16 * b2 + 8 * b3 + 4 * b4;  // cs index k: column 8 (k / 2) + k % 2
        float* row = sums + (t >> 5) * BN + 2 * (t & 3);
        *reinterpret_cast<float2*>(row + 4 * k0) = make_float2(cs[0], cs[1]);
        *reinterpret_cast<float2*>(row + 4 * k0 + 8) = make_float2(cs[2], cs[3]);
      }
      wg_sync(wg);
      // the four warps' sums, added in warp order
      for (int col = t; col < BN && n0 + col < p.N; col += 128) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += sums[w * BN + col];
        p.part[(size_t)(mw / 64) * p.N + n0 + col] = s;
      }
      wg_sync(wg);  // the sums are read before the next tile's are staged
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- host side of the backward forms ------------------------------------

// One product of a group: out = A @ B^T (FORM_NT: a (M, K), b (N, K)) or
// A^T @ B (FORM_TN: a (K, M), b (K, N)); b's rows ldb elements apart (0:
// contiguous); out (bf16, EPI_STORE) or out_f32 (EPI_STORE_F32,
// EPI_ADD_F32) rows ldo apart (0: N).
struct BwdSpec {
  int form, epi;
  const void* a;
  const void* b;
  int ldb;
  void* out;
  float* out_f32;
  int ldo;
  int M, N, K;
};

struct BwdPlan {
  int bn, splits, units, smem;
  long long cost;
  int stream_k;  // 1: the stream-K schedule (splits 1, units its iterations)
  int ctas;      // the CTAs it launches: min(units, sms), or stream-K's deal's
};

inline int shape_kind(int form, int epi) {
  return form == FORM_NT ? KIND_NT : epi == EPI_STORE ? KIND_TN_SPLIT : KIND_TN;
}

// Slabs per slice and the slice count of a K of nk slabs cut into at most `split`.
inline int split_count(int nk, int split, int* k_chunk) {
  const int want = split < nk ? split : nk;
  *k_chunk = (nk + want - 1) / want;
  return (nk + *k_chunk - 1) / *k_chunk;
}

inline int group_smem(int bn) {
  return bn == 256 ? Cfg<256>::SMEM : bn == 192 ? Cfg<192>::SMEM : Cfg<128>::SMEM;
}

// The modelled time of a group at tile width bn, each weight gradient
// (KIND_TN_SPLIT) cut into `split` slices: the units dealt to min(units, sms) CTAs in turn (as
// the kernel walks them), the most loaded CTA's cost, plus each split
// product's reduce pass. shapes[i] = {kind, M, N, K}.
inline long long bwd_cost(const int (*shapes)[4], int count, int bn, int split, int sms,
                          int* units_out) {
  int units = 0;
  for (int i = 0; i < count; ++i) {
    int chunk;
    const int nk = (shapes[i][3] + BK - 1) / BK;
    const int sp = shapes[i][0] == KIND_TN_SPLIT ? split_count(nk, split, &chunk) : 1;
    units += ((shapes[i][1] + BM - 1) / BM) * ((shapes[i][2] + bn - 1) / bn) * sp;
  }
  *units_out = units;
  const int grid = units < sms ? units : sms;
  long long* load = new long long[grid]();
  long long extra = 0;
  int u = 0;
  for (int i = 0; i < count; ++i) {
    const int M = shapes[i][1], N = shapes[i][2];
    const int nk = (shapes[i][3] + BK - 1) / BK;
    int chunk = nk;
    const int sp = shapes[i][0] == KIND_TN_SPLIT ? split_count(nk, split, &chunk) : 1;
    const int tiles = ((M + BM - 1) / BM) * ((N + bn - 1) / bn);
    for (int tile = 0; tile < tiles; ++tile)
      for (int z = 0; z < sp; ++z, ++u) {
        const int slabs = z < sp - 1 ? chunk : nk - (sp - 1) * chunk;
        load[u % grid] += (long long)slabs * slab_cost(shapes[i][0], bn) + EPI_COST * (bn / 64);
      }
    if (sp > 1) extra += ((long long)sp * M * N * 4 + (long long)M * N * 2) / REDUCE_BYTES_PER_COST;
  }
  long long worst = 0;
  for (int c = 0; c < grid; ++c) worst = load[c] > worst ? load[c] : worst;
  delete[] load;
  return worst + extra;
}

// Stream-K may run the group: every product a weight gradient, and the
// tiles at BN = 128 cut in two slices give fewer units than SMs.
inline bool stream_k_fits(const int (*shapes)[4], int count, int sms) {
  int units = 0;
  for (int i = 0; i < count; ++i) {
    if (shapes[i][0] != KIND_TN_SPLIT) return false;
    int chunk;
    const int nk = (shapes[i][3] + BK - 1) / BK;
    units += ((shapes[i][1] + BM - 1) / BM) * ((shapes[i][2] + 127) / 128) *
             split_count(nk, 2, &chunk);
  }
  return units < sms;
}

// Stream-K's deal at tile width bn: W (tile, slab) iterations over `tiles`
// output tiles; *aligned the CTA count whose runs each lie inside one tile
// (the largest multiple of the tile count within sms, at two or more CTAs a
// tile, where every product has the same K), 0 when there is none.
inline long long streamk_work(const int (*shapes)[4], int count, int bn, int sms, int* aligned) {
  long long W = 0;
  int tiles = 0;
  bool same_k = true;
  for (int i = 0; i < count; ++i) {
    const int t = ((shapes[i][1] + BM - 1) / BM) * ((shapes[i][2] + bn - 1) / bn);
    W += (long long)t * ((shapes[i][3] + BK - 1) / BK);
    tiles += t;
    same_k = same_k && (shapes[i][3] + BK - 1) / BK == (shapes[0][3] + BK - 1) / BK;
  }
  *aligned = same_k && sms / tiles >= 2 && W >= sms ? sms / tiles * tiles : 0;
  return W;
}

// The modelled time of the stream-K schedule at tile width bn over `grid`
// CTAs: the W iterations dealt in equal runs; each CTA's slabs and the
// epilogues of the tiles it finishes, one fp32 partial stored for a piece
// without its tile's last slab, and the owner's read of each of its tile's
// partials; the most loaded CTA's cost. Runs that cross tiles pay
// STREAMK_SCATTER times a slab's cost: their CTAs stream K at offsets out
// of step with the other tiles', and the card read the ViT-S TP groups so
// dealt at 1.8 to 2.0 times the slab cost above (PERF.md section 6), where
// runs in step (split slices) read at it. *units_out = W.
inline long long streamk_cost(const int (*shapes)[4], int count, int bn, int grid,
                              int* units_out) {
  int aligned;
  const long long W = streamk_work(shapes, count, bn, grid, &aligned);
  *units_out = (int)W;
  const long long part = (long long)BM * bn * 4 / STREAMK_BYTES_PER_COST;
  const long long slab = slab_cost(KIND_TN_SPLIT, bn) * (aligned == grid ? 1 : STREAMK_SCATTER);
  const long long epi = EPI_COST * (bn / 64);
  long long* load = new long long[grid]();
  long long t0 = 0;
  for (int i = 0; i < count; ++i) {
    const long long nk = (shapes[i][3] + BK - 1) / BK;
    const int tiles = ((shapes[i][1] + BM - 1) / BM) * ((shapes[i][2] + bn - 1) / bn);
    for (int tile = 0; tile < tiles; ++tile, t0 += nk) {
      const int first = (int)(((t0 + 1) * grid - 1) / W), last = (int)(((t0 + nk) * grid - 1) / W);
      for (int g = first; g <= last; ++g) {
        const long long lo = (long long)g * W / grid, hi = (long long)(g + 1) * W / grid;
        load[g] += ((hi < t0 + nk ? hi : t0 + nk) - (lo > t0 ? lo : t0)) * slab;
        load[g] += g == last ? epi + part * (last - first) : part;
      }
    }
  }
  long long worst = 0;
  for (int c = 0; c < grid; ++c) worst = load[c] > worst ? load[c] : worst;
  delete[] load;
  return worst;
}

// Stream-K at width bn: the deal in step with the tiles (where there is
// one), then the one over min(W, sms) CTAs, which must cut its cost by more
// than a sixteenth. Returns the plan (cost, units = W, ctas).
inline BwdPlan streamk_plan(const int (*shapes)[4], int count, int bn, int sms) {
  int aligned;
  const long long W = streamk_work(shapes, count, bn, sms, &aligned);
  BwdPlan best{bn, 1, 0, group_smem(bn), 0, 1, 0};
  const int grids[2] = {aligned, W < sms ? (int)W : sms};
  for (int i = 0; i < 2; ++i) {
    if (grids[i] <= 0 || (i == 1 && grids[1] == aligned)) continue;
    int units;
    const long long cost = streamk_cost(shapes, count, bn, grids[i], &units);
    if (best.ctas == 0 || cost * 16 < best.cost * 15) {
      best.cost = cost;
      best.units = units;
      best.ctas = grids[i];
    }
  }
  return best;
}

// The split schedule's plan: of BN = 256, 192, 128 and the split counts 1
// and 2 (only 1 when no product may split), the one of least modelled
// cost; a later candidate (narrower, or more slices) must cut it by more
// than a sixteenth. Mirrored by ops/kernels/gemm.py split_plan.
inline BwdPlan split_plan(const int (*shapes)[4], int count, int sms) {
  const int bns[3] = {256, 192, 128};
  bool any_split = false;
  for (int i = 0; i < count; ++i) any_split = any_split || shapes[i][0] == KIND_TN_SPLIT;
  BwdPlan best{0, 0, 0, 0, 0, 0, 0};
  for (int b = 0; b < 3; ++b)
    for (int s = 0; s < (any_split ? N_SPLIT_CANDIDATES : 1); ++s) {
      int units;
      const long long cost = bwd_cost(shapes, count, bns[b], SPLIT_CANDIDATES[s], sms, &units);
      if (best.bn == 0 || cost * 16 < best.cost * 15)
        best = BwdPlan{bns[b], SPLIT_CANDIDATES[s], units, group_smem(bns[b]), cost, 0,
                       units < sms ? units : sms};
    }
  return best;
}

// The group plan: split_plan's, then stream-K at each width where it may
// run (stream_k_fits; streamk_plan's deal), which must cut the cost by
// more than a sixteenth. Mirrored by ops/kernels/gemm.py bwd_plan.
inline BwdPlan bwd_plan_uncached(const int (*shapes)[4], int count, int sms) {
  const int bns[3] = {256, 192, 128};
  BwdPlan best = split_plan(shapes, count, sms);
  if (stream_k_fits(shapes, count, sms))
    for (int b = 0; b < 3; ++b) {
      const BwdPlan sk = streamk_plan(shapes, count, bns[b], sms);
      if (sk.cost * 16 < best.cost * 15) best = sk;
    }
  return best;
}

// Plans are cached by shape: the model walks every unit (a few thousand).
inline BwdPlan bwd_plan(const int (*shapes)[4], int count, int sms) {
  constexpr int SLOTS = 64;
  struct Entry {
    int key[MAX_PROBLEMS * 4 + 2];
    BwdPlan plan;
  };
  static Entry cache[SLOTS];
  static int used = 0, next = 0;
  static std::mutex mu;
  int key[MAX_PROBLEMS * 4 + 2] = {count, sms};
  for (int i = 0; i < count; ++i)
    for (int j = 0; j < 4; ++j) key[2 + 4 * i + j] = shapes[i][j];
  std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < used; ++e)
    if (memcmp(cache[e].key, key, sizeof(key)) == 0) return cache[e].plan;
  const BwdPlan plan = bwd_plan_uncached(shapes, count, sms);
  memcpy(cache[next].key, key, sizeof(key));
  cache[next].plan = plan;
  next = (next + 1) % SLOTS;
  if (used < SLOTS) ++used;
  return plan;
}

// The plan a launch runs: bwd_plan, or with bn, splits or schedule > 0
// forced (the card tests' and the tools' entries): splits > 0 or schedule
// 1 the split schedule (1 slice unless splits says), schedule 2 stream-K;
// what is not forced, the plan's. bn = -1: refused (a width none of 256,
// 192, 128; stream-K for a group that is not all weight gradients).
inline BwdPlan bwd_plan_forced(const int (*shapes)[4], int count, int sms, int bn, int splits,
                               int schedule) {
  const BwdPlan plan = bwd_plan(shapes, count, sms);
  if (bn <= 0 && splits <= 0 && schedule <= 0) return plan;
  const int b = bn > 0 ? bn : plan.bn;
  const bool sk = schedule == 2 || (schedule <= 0 && splits <= 0 && plan.stream_k);
  BwdPlan out{b, 1, 0, group_smem(b), 0, sk ? 1 : 0, 0};
  bool all_tn = true;
  for (int i = 0; i < count; ++i) all_tn = all_tn && shapes[i][0] == KIND_TN_SPLIT;
  if ((b != 256 && b != 192 && b != 128) || (sk && !all_tn) || schedule > 2) {
    out.bn = -1;
    return out;
  }
  if (sk) return streamk_plan(shapes, count, b, sms);
  out.splits = splits > 0 ? splits : plan.stream_k ? 1 : plan.splits;
  out.cost = bwd_cost(shapes, count, b, out.splits, sms, &out.units);
  out.ctas = out.units < sms ? out.units : sms;
  return out;
}

inline void bwd_shapes(const BwdSpec* specs, int count, int (*shapes)[4]) {
  for (int i = 0; i < count; ++i) {
    shapes[i][0] = shape_kind(specs[i].form, specs[i].epi);
    shapes[i][1] = specs[i].M;
    shapes[i][2] = specs[i].N;
    shapes[i][3] = specs[i].K;
  }
}

// fp32 workspace a group needs under `plan` (floats): the split partials, or
// stream-K's flags and a 128 x BN slot for each of its CTAs.
inline size_t bwd_workspace(const int (*shapes)[4], int count, const BwdPlan& plan) {
  if (plan.stream_k) return sk_flag_floats(plan.ctas) + (size_t)plan.ctas * BM * plan.bn;
  size_t n = 0;
  for (int i = 0; i < count; ++i) {
    int chunk;
    const int nk = (shapes[i][3] + BK - 1) / BK;
    const int sp = shapes[i][0] == KIND_TN_SPLIT ? split_count(nk, plan.splits, &chunk) : 1;
    if (sp > 1) n += (size_t)sp * shapes[i][1] * shapes[i][2];
  }
  return n;
}

template <int BN, int FORM>
cudaError_t launch_bwd_bn(const BwdMaps& maps, const BwdArgs& p, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bwd_kernel<BN, FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  gemm_bwd_kernel<BN, FORM><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_bwd_form(int bn, const BwdMaps& maps, const BwdArgs& p, int grid,
                            cudaStream_t stream) {
  if (bn == 256) return launch_bwd_bn<256, FORM>(maps, p, grid, stream);
  if (bn == 192) return launch_bwd_bn<192, FORM>(maps, p, grid, stream);
  return launch_bwd_bn<128, FORM>(maps, p, grid, stream);
}

// One launch over a group of products of one form (then, under the split
// schedule, one reduce per split product); ws holds bwd_workspace floats
// (stream-K's flags are zeroed here, on the stream). bn, splits, schedule >
// 0 force the plan (bwd_plan_forced: the card tests' and tools' entry).
inline cudaError_t launch_bwd_group(const BwdSpec* specs, int count, float* ws,
                                    cudaStream_t stream, int bn = 0, int splits = 0,
                                    int schedule = 0) {
  if (count < 1 || count > MAX_PROBLEMS) return cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    const BwdSpec& s = specs[i];
    // the row strides TMA reads: A's and B's K (NT) or A's M and B's N (TN)
    if (s.M <= 0 || s.N <= 0 || s.K <= 0 || s.N % 8 || (s.form == FORM_NT ? s.K % 8 : s.M % 8))
      return cudaErrorInvalidValue;
    if (s.form != specs[0].form || (s.form != FORM_NT && s.form != FORM_TN))
      return cudaErrorInvalidValue;
    if (s.epi != EPI_STORE && s.epi != EPI_STORE_F32 && s.epi != EPI_ADD_F32)
      return cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int shapes[MAX_PROBLEMS][4];
  bwd_shapes(specs, count, shapes);
  const BwdPlan plan = bwd_plan_forced(shapes, count, sms, bn, splits, schedule);
  if (plan.bn < 0 || (plan.stream_k && ws == nullptr)) return cudaErrorInvalidValue;
  BwdMaps maps;
  BwdArgs p;
  p.count = count;
  p.stream_k = plan.stream_k;
  int units = 0;
  size_t ws_off = 0;
  for (int i = 0; i < count; ++i) {
    const BwdSpec& s = specs[i];
    BwdProblem& q = p.p[i];
    const int nk = (s.K + BK - 1) / BK;
    q.epi = s.epi;
    q.M = s.M;
    q.N = s.N;
    q.K = s.K;
    q.splits = shapes[i][0] == KIND_TN_SPLIT && !plan.stream_k
                   ? split_count(nk, plan.splits, &q.k_chunk)
                   : 1;
    if (q.splits == 1) q.k_chunk = nk;
    q.n_tiles = (s.N + plan.bn - 1) / plan.bn;
    q.unit0 = units;
    // stream-K counts (tile, slab) iterations; the split schedule units
    units += ((s.M + BM - 1) / BM) * q.n_tiles * (plan.stream_k ? nk : q.splits);
    if (q.splits > 1) {
      q.out_f32 = ws + ws_off;
      q.ldo = s.N;
      ws_off += (size_t)q.splits * s.M * s.N;
    } else {
      q.out_f32 = s.out_f32;
      q.ldo = s.ldo > 0 ? s.ldo : s.N;
    }
    const bool ok =
        s.form == FORM_NT
            ? encode_2d(&maps.m[i][0], s.a, s.M, s.K, BM) &&
                  encode_2d(&maps.m[i][1], s.b, s.N, s.K, plan.bn, s.ldb)
            : encode_2d(&maps.m[i][0], s.a, s.K, s.M, 64) &&
                  encode_2d(&maps.m[i][1], s.b, s.K, s.N, BK, s.ldb);
    if (!ok) return cudaErrorInvalidValue;
    if (s.epi == EPI_STORE && q.splits == 1) {
      if (!encode_2d(&maps.m[i][2], s.out, s.M, s.N, 64, s.ldo)) return cudaErrorInvalidValue;
    } else {
      maps.m[i][2] = maps.m[i][0];  // not read
    }
  }
  for (int i = count; i < MAX_PROBLEMS; ++i) p.p[i] = p.p[0];
  p.units = units;
  const int grid = plan.stream_k ? plan.ctas : units < sms ? units : sms;
  p.flags = plan.stream_k ? reinterpret_cast<int*>(ws) : nullptr;
  p.slots = plan.stream_k ? ws + sk_flag_floats(grid) : nullptr;
  if (plan.stream_k) {
    err = cudaMemsetAsync(ws, 0, sizeof(int) * 2 * grid, stream);
    if (err != cudaSuccess) return err;
  }
  err = specs[0].form == FORM_TN ? launch_bwd_form<FORM_TN>(plan.bn, maps, p, grid, stream)
                                  : launch_bwd_form<FORM_NT>(plan.bn, maps, p, grid, stream);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < count; ++i) {
    const BwdProblem& q = p.p[i];
    if (q.splits == 1) continue;
    const size_t n4 = (size_t)q.M * q.N / 4;
    splitk_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(q.out_f32), q.splits, n4, q.N,
        specs[i].ldo > 0 ? specs[i].ldo : q.N, static_cast<bf16*>(specs[i].out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The dual product: da_c, h_c (M, N) bf16 and part (ceil(M / 64), N) fp32
// from y, g (M, K) and W1's (K, N) slab (rows ldw1 apart), W2's (N, K) rows
// and b1 (N,); K and N multiples of 8.
inline cudaError_t launch_dual(const void* y, const void* w1, int ldw1, const void* b1,
                               const void* g, const void* w2, void* da_c, void* h_c, float* part,
                               int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[6];
  if (!encode_2d(&maps[0], y, M, K, BM) || !encode_2d(&maps[1], g, M, K, BM) ||
      !encode_2d(&maps[2], w1, K, N, BK, ldw1) || !encode_2d(&maps[3], w2, N, K, DUAL_BN) ||
      !encode_2d(&maps[4], da_c, M, N, 64) || !encode_2d(&maps[5], h_c, M, N, 64))
    return cudaErrorInvalidValue;
  const int tiles = ((M + BM - 1) / BM) * ((N + DUAL_BN - 1) / DUAL_BN);
  const DualArgs p{static_cast<const float*>(b1), part, M, N, K};
  constexpr int smem = DualCfg<DUAL_BN>::SMEM;
  err = cudaFuncSetAttribute(gemm_dual_kernel<DUAL_BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  gemm_dual_kernel<DUAL_BN><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

// The stash dh product: da_c, h_c (M, N) bf16 and part (ceil(M / 64), N)
// fp32 from g (M, K), W2 (N, K) and the stash a (M, N) bf16; K and N
// multiples of 8.
inline cudaError_t launch_dh_stash(const void* g, const void* w2, const void* a, void* da_c,
                                   void* h_c, float* part, int M, int N, int K,
                                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[5];
  if (!encode_2d(&maps[0], g, M, K, BM) || !encode_2d(&maps[1], w2, N, K, STASH_BN) ||
      !encode_2d(&maps[2], a, M, N, 64) || !encode_2d(&maps[3], da_c, M, N, 64) ||
      !encode_2d(&maps[4], h_c, M, N, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = StashCfg<STASH_BN>::SMEM;
  err = cudaFuncSetAttribute(gemm_dh_stash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + BM - 1) / BM) * ((N + STASH_BN - 1) / STASH_BN);
  gemm_dh_stash_kernel<<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], StashArgs{part, M, N, K});
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace sky
