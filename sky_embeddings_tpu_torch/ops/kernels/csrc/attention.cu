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
// fp32 (Attention's default dtype, models/layers.py:125): P and dS are never
// rounded to a narrower type, and every product is an fp32 FMA chain in the
// order the plain version's fp32 GEMMs sum on the card: S_ij over the head
// dims d = 0, 1, ...; ctx and dQ over the keys j; dK and dV over the queries
// i. So the forward equals the plain version bit for bit; the backward lies
// where the CUDA-core kernels it replaces lay (7e-8 to 1.9e-7 from the plain
// version at ViT-B and ViT-H; dS's row sums run in another order than the
// plain version's). Tensor-core products
// were weighed first: three TF32 products per fp32 one (big x small, small x
// big, big x big, CUTLASS's FastF32, which fp32 SDPA runs) keep ~21 bits of
// each operand and land 1.0e-6 to 1.6e-6 from the plain version at ViT-B and
// ViT-H on the H100 (SDPA's own gap), twice the fp32 bar of 5e-7 and more.
//
// One CTA per (sample, head) stages Q, K, V (and dC) in shared memory with
// cp.async (16-byte copies where the head's offset allows; V, or Q and K in
// the backward, in a second group that lands while the first product runs),
// rows padded to NP (a multiple of 4) and HP = hd4 + 4 floats apart (so the
// eight float4 reads of a quarter warp at consecutive rows hit distinct
// banks). Each product is cut into 4 x 4 register tiles, one per thread,
// rows and keys interleaved at stride NP / 4 so a warp's rows are
// consecutive: S = Q K^T reads a float4 of 4 head dims from each of 4 query
// rows and 4 key rows per 64 FMAs and writes S * hd^-0.5 to a shared N x N
// buffer; ctx = P V reads a float4 of 4 keys from each of 4 rows of P and 4
// rows of V per 64 FMAs (P past the last key is zero). The softmax takes
// each row with four threads that replay a warp's lanes (the plain
// version's order: expf, the max and the lane sums' xor butterfly, e / sum
// by IEEE division). The backward adds dP = dC V^T into a second buffer (S
// then overwrites V), delta_i = sum_j P_ij dP_ij and dS = (P dP - P delta)
// hd^-0.5 the same way, dQ = dS K, and dK = dS^T Q with dV = P^T dC in one
// pass over the queries (32 accumulators a thread). One pass over the head;
// no float atomics: every output element is one thread's chain in a fixed
// order, so two launches give the same bits. These products are bound by
// shared-memory bandwidth (16 bytes of loads per 4 FMAs); 8 x 8 and 8 x 4
// tiles load less but leave too few warps on an SM, and ran slower.
//
// Heads whose whole plan does not fit (N > ~115 at hd = 64, or wide heads)
// read Q, K, V and dC straight from device memory (L1 and L2) with the same
// tiles and chains, in blocks of QB query rows (the S and dP buffers QB x
// NP); the backward then splits the head's columns over CTAs (HC each, every
// CTA recomputing S and dP) and carries dK and dV across query blocks in
// shared fp32 accumulators, each element by the same thread in block order.
// That plan fits every N <= 256 at any head width.
//
// Bound on the H100: bytes. Kernel 12 reads 3 B N D and writes B N D
// elements against 4 B H N^2 hd FLOP: at ViT-B (N = 65, D = 768, hd = 64)
// about 33 FLOP per bf16 byte, under the ~295 where the tensor cores become
// the limit, and 8 per fp32 byte, under the 20 of the CUDA cores (67
// TFLOP/s); kernel 13 moves 7 B N D elements for 10 B H N^2 hd FLOP (fp32:
// 12 FLOP per byte). The bf16 cores keep loads in flight (kernel 12 walks
// several heads per CTA through a two-stage cp.async ring) and move each
// byte once; the fp32 kernels move each byte once and keep two or three
// CTAs on an SM, so one CTA's loads fly while another computes: what bounds
// them in practice is the CUDA cores' loads from shared memory, not bytes.
#include "attn_f32.cuh"

// Shared-memory bytes of a kernel's plan at (N, hd): bf16 (f32 = 0) or fp32,
// forward (bwd = 0) or backward. The wrappers refuse what exceeds the
// block's limit.
extern "C" long long sky_attention_plan_bytes(int N, int hd, int f32, int bwd) {
  using namespace sky;
  if (f32) return static_cast<long long>(AttnF32Plan(N, hd, bwd != 0).bytes());
  return static_cast<long long>(bwd ? AttnBwdPlan(N, hd).bytes() : AttnPlan(N, hd).bytes());
}

// The fp32 plan at (N, hd), forward (bwd = 0) or backward, into out[5]:
// staged (1) or from device memory (0), QB, HC, threads, bytes.
extern "C" void sky_attention_f32_plan(int N, int hd, int bwd, long long* out) {
  const sky::AttnF32Plan pl(N, hd, bwd != 0);
  out[0] = pl.staged;
  out[1] = pl.QB;
  out[2] = pl.HC;
  out[3] = pl.threads;
  out[4] = static_cast<long long>(pl.bytes());
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
  return static_cast<int>(sky::launch_attn_bwd_core<true>(
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
