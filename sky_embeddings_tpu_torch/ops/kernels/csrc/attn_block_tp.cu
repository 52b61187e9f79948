// The attention block's tensor-parallel forms for Hopper (sm_90a): K2 and
// kernel 4 split at the all-reduce over the model group
// (parallel/sharding.py, ops/kernels/attn_block.py). Each is two C
// entries, the rank's half and the finish after the all-reduce, with their
// fp32 forms; their launches are K2's (attn_block.cu) and kernel 4's
// (attn_block_bwd.cu) at the rank's widths, on the same cores and GEMM
// forms. They live in a library of their own, beside the sources of the
// whole blocks' kernels.
#include "attn_core.cuh"
#include "attn_f32.cuh"
#include "bwd_common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

// ---- the tensor-parallel form of K2 -----------------------------------------
//
// K2 split at the all-reduce (parallel/sharding.py): a rank holds the qkv
// columns of its H / tp heads, [q_r | k_r | v_r], each Dl = D / tp wide,
// wqkv_r (D, 3 Dl) and bqkv_r (3 Dl,), and wproj's rows of the same heads,
// wproj_r (Dl, D). Entry sky_attn_block_tp_fwd runs the rank's half,
// part = ctx_r @ wproj_r in fp32 (no bias, no residual), ctx_r the
// attention core over the rank's Hl heads of qkv_r = bf16(LN(x) @ wqkv_r +
// bqkv_r). The caller all-reduces `part` over the model group (torch.distributed),
// then sky_attn_block_tp_finish adds bproj and the residual and rounds:
// out = bf16(x + (sum + bproj)), K2's EPI_BIAS_RESIDUAL order. What a rank
// bounds on the H100: its qkv and proj products, 8 M D Dl FLOP, and its
// heads' core; the all-reduce moves M D fp32 (4 M D bytes) over the link.
//
// Two forms of the bf16 half, picked by the shapes alone
// (attn_tp_fused_ok, mirrored by ops/kernels/attn_block.py tp_fwd_path):
// - fused, at D = ATTF_D (ViT-S), heads of 64, Hl <= 3, N <= 64 tokens and
//   no packed segments: attn_tp_fused_kernel, one launch that reads x and
//   the weights and writes only `part`. At jepa_struct's shard (M = 16 384,
//   Dl = 192) the chain below moves y, qkv and ctx through device memory
//   (75.5 MB of its ~113), and its proj product runs at about 77 FLOP a
//   byte, far under the card's 295 FLOP/byte ridge. A persistent CTA walks
//   the samples, one a row block of RB = 64 rows: x's rows by TMA, LN in
//   place (the held-row LN's arithmetic), then each head's [q | k | v] =
//   y @ wqkv_r[:, the head's three 64-column boxes] + bqkv (one m64n192
//   product) rounded to bf16 into q, k, v in shared memory, in the core's
//   padded layout (rows past N zero, as the chain's core loads them); the
//   core's own per-warp body (attn_core.cuh attn_fwd_probs, attn_fwd_pv)
//   over four warps of 16 query rows; ctx rounded to bf16 into the head's
//   64 x 64 box, swizzled as a wgmma A operand. Once every head's ctx is
//   in, part = ctx @ wproj_r over the heads in order, 16 deep a wgmma, in
//   two passes of D / 2 columns (96 accumulator registers a thread): the
//   chain's K order over Dl, so with the chain's per-element products and
//   core `part` is the chain's bit for bit. y, q, k, v and ctx never leave
//   the SM. One consumer warpgroup runs every product, its weight boxes
//   (qkv's, then proj's) through one ring of ATTF_RING boxes, five 24 KB
//   k-slabs in flight, while the other runs each head's core as its q, k,
//   v come in (the next head's qkv product on the tensor cores meanwhile),
//   the two handing the q, k, v buffer over by mbarriers; the first design,
//   the two warpgroups taking alternate heads, each through a ring of two
//   k-slabs, ran 10 % slower. What bounds it on the card is the chain of
//   waits inside a sample (LN, each head's product on the ring's round
//   trips, the core, proj), not bytes (PERF.md section 6).
// - the chain, elsewhere (mim_32's and ViT-B's rows, masked segments):
//   0. LN of the replicated x, the row held in registers
//      (launch_layernorm_held, D <= 1 280)   -> y (M, D), staged in `part`
//   1. qkv_r = y @ wqkv_r + bqkv_r            -> (M, 3 Dl) bf16
//   2. the attention core over the rank's Hl heads (attn_core.cuh reads q,
//      k and v at columns 0, Dl and 2 Dl of each row: the head-group
//      layout above)                          -> ctx_r (M, Dl) bf16
//   3. part = ctx_r @ wproj_r, fp32 (EPI_STORE_F32)
// The fp32 forms (_f32 entries, the same arguments) take the fp32 GEMM,
// core and multi-pass LN of sky_attn_block_fwd_f32.
namespace sky {
namespace sm90 {

// ---- the fused half's row block ---------------------------------------------
//
// A sample's RB = 64 token rows stay on chip from x to the fp32 partial:
// x's rows come in by TMA as 64 x 64 boxes with the 128-byte swizzle, LN
// runs on them in place (ln_block_smem), and every A operand of the wgmma
// products (y, ctx) lives in shared memory in that layout. The weights
// stream through a ring of 64 x 64 boxes filled by one producer thread in
// the order its one consumer warpgroup takes them, so the full and empty
// barriers keep the usual phases. A product's B operand is three
// neighbouring slots (n = 192, LBO one box), never split by the ring's
// end: the ring's size and every run of boxes taken together are
// multiples of three. The kernel takes D = ATTF_D only: its products'
// warpgroup holds the partial's D / 2 = 192 columns of 64 rows in 96 fp32
// registers, and y, ctx, q, k, v and the ring fill the 227 KB of shared
// memory; other widths keep the chain.

constexpr int RB = 64;                     // token rows of a row block (one wgmma M)
constexpr int ATTF_D = 384;                // the row width the fused half takes
constexpr int ATTF_DH = ATTF_D / 2;        // partial columns a pass of proj holds
constexpr int ATTF_DB = ATTF_D / BOX;      // 64-column boxes of a row
constexpr uint32_t RB_BOX = 64 * BOX * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int ATTF_RING = 15;              // boxes of the products' ring (120 KB)
constexpr int ATTF_MAX_HEADS = 3;          // a rank's heads: ctx boxes
constexpr int ATTF_HD = 64;                // the head width: one box, one core chunk
constexpr int ATTF_KT = 5;                 // the core's register footprint at N <= 64 (attn_kt)
constexpr int ATTF_HL = ATTF_HD + 8;                                  // the core's row pitch
constexpr uint32_t ATTF_QKV_BYTES = 3 * RB * ATTF_HL * 2;             // q, k, v of a head
constexpr uint32_t ATTF_CTX = ATTF_DB * RB_BOX;                       // after y: ctx boxes
constexpr uint32_t ATTF_QKV = ATTF_CTX + ATTF_MAX_HEADS * RB_BOX;     // then q, k, v
constexpr uint32_t ATTF_RINGS = ATTF_QKV + ATTF_QKV_BYTES;            // then the ring
constexpr uint32_t ATTF_BARS = ATTF_RINGS + ATTF_RING * RB_BOX;
constexpr int ATTF_SMEM = (int)ATTF_BARS + 8 * (2 * ATTF_RING + 5) + 1024;  // 225 560
static_assert(ATTF_RINGS % 1024 == 0, "the ring's boxes want 1024-byte alignment");
static_assert(ATTF_SMEM <= (int)SMEM_OPTIN_MAX, "the fused K2 half's shared memory");
static_assert(ATTF_RING % 3 == 0 && ATTF_DH == 3 * BOX, "n = 192 operands of three slots");

// byte offset of element (r, c) in a row block stored as 64-column boxes of
// RB rows, each with the 128-byte swizzle TMA writes
__device__ __forceinline__ uint32_t rb_off(int r, int c) {
  return (uint32_t)((c >> 6) * RB_BOX + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}

// the named barrier over both consumer warpgroups (ids 1, 2 are wg_sync's)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// LN in place over the RB rows of a row block at y (D / 64 boxes), rows
// warp, warp + warps, ... one warp each: ln_row_held's arithmetic, so its
// bf16 y is the held-row LN launch's bit for bit.
template <int CH>
__device__ __forceinline__ void ln_block_smem(uint32_t y, const float* __restrict__ scale,
                                              const float* __restrict__ bias, int D, int warp,
                                              int warps, int lane) {
  for (int r = warp; r < RB; r += warps) {
    float e[CH][8];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = lane * 8 + 256 * c;
      if (k < D) {
        const uint4 u = ld_shared_v4(y + rb_off(r, k));
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[c][j] = __bfloat162float(v[j]);
      }
    }
    ln_row_held<CH>(e, scale, bias, lane, D);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = lane * 8 + 256 * c;
      if (k < D) {
        uint4 u;
        bf16* v = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(e[c][j]);
        st_shared_v4(y + rb_off(r, k), u);
      }
    }
  }
}

// The consumer's side of the box ring: NS slots from `base`, one full and
// one empty barrier each; seq counts the boxes taken so far.
template <int NS>
struct BoxRing {
  uint32_t base, full, empty;
  int seq;
  // waits for the next k boxes (neighbouring slots); their first's address
  __device__ __forceinline__ uint32_t take(int k) {
    const int s0 = seq % NS;
    const uint32_t parity = (seq / NS) & 1;
    for (int i = 0; i < k; ++i) mbar_wait(full + 8 * (s0 + i), parity);
    seq += k;
    return base + s0 * RB_BOX;
  }
  // the k boxes taken from sequence number s are free again (one thread,
  // once the products that read them are done)
  __device__ __forceinline__ void give(int s, int k) const {
    for (int i = 0; i < k; ++i) mbar_arrive(empty + 8 * ((s + i) % NS));
  }
};

// The producer's side: box (c0, c1) of `map` into the ring's next slot,
// once its consumer has freed it.
template <int NS>
__device__ __forceinline__ void ring_load(uint32_t base, uint32_t full, uint32_t empty, int& seq,
                                          const CUtensorMap* map, int c0, int c1) {
  const int s = seq % NS;
  mbar_wait(empty + 8 * s, ((seq / NS) & 1) ^ 1);
  mbar_expect_tx(full + 8 * s, RB_BOX);
  tma_load_2d(base + s * RB_BOX, map, full + 8 * s, c0, c1);
  ++seq;
}

inline bool attn_tp_fused_ok(int B, int N, int D, int Dl, int Hl, int seg_len) {
  return B > 0 && N > 0 && N <= RB && D == ATTF_D && Hl >= 1 && Hl <= ATTF_MAX_HEADS &&
         Dl == ATTF_HD * Hl && !(seg_len > 0 && seg_len < N);
}

struct AttnFusedArgs {
  const float *scale, *bias, *bqkv;
  float* part;
  int B, N, Dl, Hl;
  float sm_scale;
};

// One head's [q | k | v] accumulators (64 x 192) + bqkv, rounded to bf16,
// into q, k, v at `qs` (rows ATTF_HL apart, the three RB rows apart); rows
// past N zero (EPI_BIAS's arithmetic per element)
__device__ __forceinline__ void qkv_to_smem(const float* acc, bf16* qs,
                                            const float* __restrict__ bqkv, int h, int Dl, int N,
                                            int t) {
  const int lr0 = (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < 3 * ATTF_HD / 8; ++j) {
    const int part = j / (ATTF_HD / 8), c = 8 * (j % (ATTF_HD / 8)) + 2 * (t & 3);
    const float* b = bqkv + part * Dl + h * ATTF_HD + c;
    const float b0 = __ldg(b), b1 = __ldg(b + 1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lr = lr0 + 8 * hh;
      const uint32_t v =
          lr < N ? pack_bf16(acc[4 * j + 2 * hh] + b0, acc[4 * j + 2 * hh + 1] + b1) : 0u;
      *reinterpret_cast<uint32_t*>(qs + (part * RB + lr) * ATTF_HL + c) = v;
    }
  }
}

// acc = A @ B over `slabs` units of three ring boxes (n = 192), A's slab k
// at a + k * RB_BOX: one commit group a slab, each slab's boxes freed once
// the slab after it is issued and its own products are done
__device__ __forceinline__ void ring_product(float* acc, BoxRing<ATTF_RING>& ring, uint32_t a,
                                             int slabs, bool leader) {
  int prev = 0;
#pragma unroll 1
  for (int kb = 0; kb < slabs; ++kb) {
    const int s = ring.seq;
    const uint32_t sb = ring.take(3);
    fence_acc<ATTF_DH / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n192<0, 1>(acc, smem_desc(a + kb * RB_BOX + kk * 32, 16, 1024),
                       smem_desc(sb + kk * 16 * 128, RB_BOX, 1024), (kb | kk) != 0);
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      if (leader) ring.give(prev, 3);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc<ATTF_DH / 2>(acc);
  if (leader) ring.give(prev, 3);
}

__global__ void __launch_bounds__(THREADS, 1)
    attn_tp_fused_kernel(const __grid_constant__ CUtensorMap tma_x,
                         const __grid_constant__ CUtensorMap tma_wqkv,
                         const __grid_constant__ CUtensorMap tma_wproj, const AttnFusedArgs p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // y (the sample's row block), ctx (a box a head), q, k, v, the ring, then
  // the barriers: full[slot], empty[slot], y_full (x landed), y_empty (the
  // qkv products done with y), qkv_full (a head's q, k, v written),
  // qkv_free (its core done with them), ctx_full (every head's ctx in)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t y = base, ctx = base + ATTF_CTX, ring0 = base + ATTF_RINGS;
  const uint32_t full0 = base + ATTF_BARS, empty0 = full0 + 8 * ATTF_RING;
  const uint32_t y_full = empty0 + 8 * ATTF_RING, y_empty = y_full + 8;
  const uint32_t qkv_full = y_empty + 8, qkv_free = qkv_full + 8, ctx_full = qkv_free + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ATTF_RING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    mbar_init(y_full, 1);
    mbar_init(y_empty, 1);
    mbar_init(qkv_full, 1);
    mbar_init(qkv_free, 1);
    mbar_init(ctx_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a persistent CTA walks the samples b = blockIdx.x, + gridDim.x, ...
  if (threadIdx.x < 128) {
    // producer warpgroup: lane 0 of warp 0 fills the ring, lane 0 of warp 2
    // brings each sample's x
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0 && warp == 2) {
      uint32_t ph = 0;
      for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        if (b > (int)blockIdx.x) {
          mbar_wait(y_empty, ph);
          ph ^= 1;
        }
        mbar_expect_tx(y_full, ATTF_DB * RB_BOX);
        for (int i = 0; i < ATTF_DB; ++i) tma_load_2d(y + i * RB_BOX, &tma_x, y_full, BOX * i, b * p.N);
      }
    } else if (threadIdx.x == 0) {
      int seq = 0;
      for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        // each head's [q | k | v] boxes, 64 rows of wqkv_r at a time, then
        // wproj_r's D / 2 columns of each half, a head's 64 rows at a time
        for (int h = 0; h < p.Hl; ++h)
          for (int kb = 0; kb < ATTF_DB; ++kb)
            for (int part = 0; part < 3; ++part)
              ring_load<ATTF_RING>(ring0, full0, empty0, seq, &tma_wqkv,
                                   part * p.Dl + ATTF_HD * h, BK * kb);
        for (int half = 0; half < 2; ++half)
          for (int h = 0; h < p.Hl; ++h)
            for (int i = 0; i < ATTF_DH / BOX; ++i)
              ring_load<ATTF_RING>(ring0, full0, empty0, seq, &tma_wproj,
                                   ATTF_DH * half + BOX * i, BK * h);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = threadIdx.x / 128 - 1, t = threadIdx.x & 127;
    const int w = t >> 5, lane = t & 31;
    const bool leader = t == 0;
    bf16* const qs = reinterpret_cast<bf16*>(smem_raw + (base - raw) + ATTF_QKV);
    uint32_t yph = 0, cph = 0;  // phases of y_full, ctx_full
    int heads = 0;              // heads handed over: the q, k, v hand-over's phase
    if (g == 0) {
      // the products: each head's qkv, its q, k, v handed to the cores once
      // they are done with the last head's; then proj
      BoxRing<ATTF_RING> ring{ring0, full0, empty0, 0};
      float acc[ATTF_DH / 2];  // a head's [q | k | v], then half the partial's columns
      for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        mbar_wait(y_full, yph);
        yph ^= 1;
        ln_block_smem<(ATTF_D + 255) / 256>(y, p.scale, p.bias, ATTF_D, w, 8, lane);
        fence_proxy_async();
        consumers_sync();
#pragma unroll 1
        for (int h = 0; h < p.Hl; ++h, ++heads) {
          ring_product(acc, ring, y, ATTF_DB, leader);
          if (leader && h + 1 == p.Hl) mbar_arrive(y_empty);  // the products are done with y
          mbar_wait(qkv_free, (heads & 1) ^ 1);  // the last head's core is done with q, k, v
          qkv_to_smem(acc, qs, p.bqkv, h, p.Dl, p.N, t);
          wg_sync(0);
          if (leader) mbar_arrive(qkv_full);
        }
        mbar_wait(ctx_full, cph);
        cph ^= 1;
        fence_proxy_async();
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          ring_product(acc, ring, ctx, p.Hl, leader);
          store_f32<ATTF_DH>(acc, p.part, ATTF_D, b * p.N + p.N, ATTF_D, b * p.N, ATTF_DH * half,
                             false);
        }
      }
    } else {
      // the cores: warp w the head's query rows 16 w ..
      const Frag f(lane);
      const int nk = (p.N + 15) / 16;
      for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        mbar_wait(y_full, yph);
        yph ^= 1;
        ln_block_smem<(ATTF_D + 255) / 256>(y, p.scale, p.bias, ATTF_D, 4 + w, 8, lane);
        fence_proxy_async();
        consumers_sync();
#pragma unroll 1
        for (int h = 0; h < p.Hl; ++h, ++heads) {
          mbar_wait(qkv_full, heads & 1);
          const bf16* ks = qs + RB * ATTF_HL;
          const bf16* vs = ks + RB * ATTF_HL;
          if (w < nk) {
            unsigned pa[ATTF_KT][4];
            attn_fwd_probs<ATTF_KT>(qs, nullptr, 0, ks, ATTF_HL, nk, 16 * w, p.N, ATTF_HD, 0,
                                    p.sm_scale, f, lane, pa);
            float o[ATTN_CHUNK / 8][4];
            attn_fwd_pv<ATTF_KT>(pa, vs, ATTF_HL, nk, 0, ATTF_HD, lane, o);
            const uint32_t box = ctx + h * RB_BOX;
#pragma unroll
            for (int j = 0; j < ATTN_CHUNK / 8; ++j)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                st_shared_b32(box + rb_off(16 * w + f.g + 8 * half, 8 * j + 2 * f.t),
                              pack_bf16(o[j][2 * half], o[j][2 * half + 1]));
            fence_proxy_async();  // ctx is read by the proj products' wgmma
          }
          wg_sync(1);  // every warp done with q, k, v and its ctx rows written
          if (leader) {
            mbar_arrive(qkv_free);
            if (h + 1 == p.Hl) mbar_arrive(ctx_full);
          }
        }
      }
    }
  }
}

// The fused half: part (B N, D) fp32 from x (B N, D), wqkv (D, 3 Dl), wproj
// (Dl, D) bf16; cudaErrorInvalidValue where attn_tp_fused_ok does not hold.
inline cudaError_t launch_attn_tp_fused(const void* x, const void* scale, const void* bias,
                                        const void* wqkv, const void* bqkv, const void* wproj,
                                        void* part, int B, int N, int D, int Dl, int Hl,
                                        int seg_len, cudaStream_t stream) {
  if (!attn_tp_fused_ok(B, N, D, Dl, Hl, seg_len)) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!encode_2d(&maps[0], x, B * N, D, RB) || !encode_2d(&maps[1], wqkv, D, 3 * Dl, BK) ||
      !encode_2d(&maps[2], wproj, Dl, D, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_tp_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ATTF_SMEM);
  if (err != cudaSuccess) return err;
  const AttnFusedArgs args{static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<const float*>(bqkv), static_cast<float*>(part), B, N, Dl,
                           Hl, 1.0f / sqrtf(static_cast<float>(ATTF_HD))};
  attn_tp_fused_kernel<<<resident_grid(attn_tp_fused_kernel, THREADS, ATTF_SMEM, B), THREADS,
                         ATTF_SMEM, stream>>>(maps[0], maps[1], maps[2], args);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace sky

// The bf16 chain: held-row LN (staged in `part`), qkv, the core, proj in
// fp32 -> part; null scratch (the wrapper's at a fused shape) refused.
static int attn_tp_chain(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                         void* ctx, void* part, int B, int N, int D, int Dl, int Hl, int seg_len,
                         cudaStream_t s) {
  using namespace sky;
  const int M = B * N;
  if (qkv == nullptr || ctx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  SKY_TRY(launch_layernorm_held(x, ln_scale, ln_bias, part, M, D, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_BIAS>(part, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * Dl, D,
                                           s));
  SKY_TRY(launch_attn_core(qkv, ctx, nullptr, B, N, Dl, Hl, seg_len, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_STORE_F32>(ctx, wproj, nullptr, nullptr, part, nullptr, M, D,
                                                Dl, s));
  return 0;
}

static int attn_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* wqkv, const void* bqkv, const void* wproj, void* qkv,
                             void* ctx, void* part, int B, int N, int D, int Dl, int Hl,
                             int seg_len, bool fp32, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  if (fp32) {
    SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, part, M, D, s));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(part, wqkv, bqkv, nullptr, qkv, nullptr, M,
                                                       3 * Dl, D, nullptr, s)));
    SKY_TRY(launch_f32(false, qkv, nullptr, ctx, B, N, Dl, Hl, s, nullptr, nullptr, seg_len));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::STORE>(ctx, wproj, nullptr, nullptr, part,
                                                        nullptr, M, D, Dl, nullptr, s)));
    return 0;
  }
  if (sm90::attn_tp_fused_ok(B, N, D, Dl, Hl, seg_len))
    return static_cast<int>(sm90::launch_attn_tp_fused(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                                       part, B, N, D, Dl, Hl, seg_len, s));
  return attn_tp_chain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl, Hl,
                       seg_len, s);
}

// The rank's half: qkv (M, 3 Dl) and ctx (M, Dl) scratch (the chain's), part
// (M, D) fp32 out; seg_len > 0 masks attention to packed segments of seg_len
// tokens.
extern "C" int sky_attn_block_tp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* wqkv, const void* bqkv, const void* wproj,
                                     void* qkv, void* ctx, void* part, int B, int N, int D, int Dl,
                                     int Hl, int seg_len, void* stream) {
  return attn_block_tp_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl,
                           Hl, seg_len, false, stream);
}

extern "C" int sky_attn_block_tp_fwd_f32(const void* x, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv, const void* bqkv,
                                         const void* wproj, void* qkv, void* ctx, void* part,
                                         int B, int N, int D, int Dl, int Hl, int seg_len,
                                         void* stream) {
  return attn_block_tp_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl,
                           Hl, seg_len, true, stream);
}

// The bf16 chain at any shape, for the checks that hold the fused half to
// it (tests/test_torch_cuda.py, chip_smoke.py).
extern "C" int sky_attn_block_tp_fwd_chain(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* wqkv,
                                           const void* bqkv, const void* wproj, void* qkv,
                                           void* ctx, void* part, int B, int N, int D, int Dl,
                                           int Hl, int seg_len, void* stream) {
  return attn_tp_chain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, qkv, ctx, part, B, N, D, Dl, Hl,
                       seg_len, static_cast<cudaStream_t>(stream));
}

// The path rule of the bf16 half: 1 fused, 0 the chain.
extern "C" int sky_attn_block_tp_fwd_path(int B, int N, int D, int Dl, int Hl, int seg_len) {
  return sky::sm90::attn_tp_fused_ok(B, N, D, Dl, Hl, seg_len) ? 1 : 0;
}

// After the all-reduce: out = x + (part + bproj), rounded to x's type.
extern "C" int sky_attn_block_tp_finish(const void* x, const void* part, const void* bproj,
                                        void* out, int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<sky::bf16>(
      x, part, bproj, out, M, D, static_cast<cudaStream_t>(stream)));
}

extern "C" int sky_attn_block_tp_finish_f32(const void* x, const void* part, const void* bproj,
                                            void* out, int M, int D, void* stream) {
  return static_cast<int>(sky::launch_bias_residual<float>(x, part, bproj, out, M, D,
                                                           static_cast<cudaStream_t>(stream)));
}

// ---- the tensor-parallel form of kernel 4 -------------------------------------
//
// Kernel 4 split at the all-reduce, on a rank's shard (attn_block.cu: the
// qkv columns of its Hl = H / tp heads, [q_r | k_r | v_r] each Dl = D / tp
// wide, and wproj's rows of the same heads). Entry sky_attn_block_tp_bwd
// runs the rank's half from the replicated x and output gradient g:
//   1. y = LN(x) (M, D); 1b. qkv_r = bf16(y @ wqkv_r + bqkv_r) (M, 3 Dl)
//   2. dc_r = bf16(g @ wproj_r^T) (M, Dl): FORM_NT, wproj_r (Dl, D) read as
//      (N, K)
//   3. the recompute core over the rank's heads -> dqkv_c (M, 3 Dl) bf16,
//      ctx_r, and dbqkv_r's per-sample partials
//   4. dy_r = dqkv_c @ wqkv_r^T in fp32 (M, D): the rank's partial of dy
//   5. dWqkv_r = y^T @ dqkv_c and dWproj_r = ctx_r^T @ g, one FORM_TN group
//   6. dbqkv_r, the partials added in order
// The caller all-reduces dy over the model group; sky_attn_block_tp_bwd_finish
// then runs what needs the whole dy: the LN backward (dx = g + ..., the
// partials of dscale and dbias) and dbproj's column sums of g, each added
// in order. Those gradients are of replicated parameters, computed alike on
// every rank from replicated inputs: nothing of them is all-reduced. Each
// step is kernel 4's launch at the rank's widths; the bound is a rank's 22
// M D Dl FLOP of products (the qkv recompute 6, dctx 2, dy 6, dWqkv 6,
// dWproj 2) and its heads' core. At jepa_struct's ViT-S shard (M = 16 384,
// D = 384, Dl = 192) step 5's two products are 13 tiles of 128 x 192 over
// 256 slabs each: whole tiles, even in two K slices, left 106 of 132 SMs
// idle, so the group plan runs them on its stream-K schedule
// (gemm_sm90.cuh: each tile's slabs dealt in six equal runs to 126 CTAs,
// the owners adding the partials in a fixed order; PERF.md section 6). The
// wrapper carves the scratch from one allocation; step 1's LN and the
// finish's LN backward hold the row in registers (common.cuh
// LN_REG_CHUNKS: D up to 1 280), and the LN backward sums dbproj's column
// partials as it reads g. The fp32 forms (_f32 entries) take the products,
// core and LN of sky_attn_block_bwd_f32.

// fp32 floats of workspace the rank's weight-gradient group needs (split
// partials, or stream-K's flags and slots).
extern "C" long long sky_attn_block_tp_bwd_ws(int M, int D, int Dl) {
  using namespace sky::sm90;
  int sms = 0;
  if (sky::sm_count(&sms) != cudaSuccess) return -1;
  BwdSpec spec[2];
  spec[0] = BwdSpec{FORM_TN, sky::EPI_STORE, nullptr, nullptr, 0, nullptr, nullptr, 0, D, 3 * Dl, M};
  spec[1] = BwdSpec{FORM_TN, sky::EPI_STORE, nullptr, nullptr, 0, nullptr, nullptr, 0, Dl, D, M};
  int shapes[2][4];
  bwd_shapes(spec, 2, shapes);
  return (long long)bwd_workspace(shapes, 2, bwd_plan(shapes, 2, sms));
}

extern "C" long long sky_attn_block_tp_bwd_f32_ws(int M, int D, int Dl) {
  const size_t a = sky::f32::workspace(D, 3 * Dl, M), b = sky::f32::workspace(Dl, D, M);
  return static_cast<long long>(a > b ? a : b);
}

// The caller allocates the scratch (y (M, D); qkv, dqkv (M, 3 Dl); dc, ctx
// (M, Dl), in the operand dtype; part: bf16 B * 3 Dl, fp32 3 Dl *
// ceil(M / 32) floats; ws: the _ws entry's floats) and the outputs (dy (M,
// D) fp32; dwqkv (D, 3 Dl), dwproj (Dl, D) in the operand dtype; dbqkv
// (3 Dl,) fp32).
static int attn_block_tp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* wqkv, const void* bqkv, const void* wproj, const void* g,
                             void* y, void* qkv, void* dc, void* ctx, void* dqkv, void* part,
                             void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B,
                             int N, int D, int Dl, int Hl, int seg_len, bool fp32, void* stream) {
  using namespace sky;
  using sm90::BwdSpec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  float* partf = static_cast<float*>(part);
  float* dyf = static_cast<float*>(dy);
  if (fp32) {
    SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, y, M, D, s));
    SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M,
                                                       3 * Dl, D, nullptr, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(g, wproj, nullptr, nullptr, dc, nullptr, M,
                                                       Dl, D, nullptr, s)));
    SKY_TRY(launch_f32(true, qkv, dc, dqkv, B, N, Dl, Hl, s, nullptr, ctx, seg_len));
    SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(dqkv, wqkv, nullptr, nullptr, dyf, nullptr,
                                                       M, D, 3 * Dl, nullptr, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(y, dqkv, nullptr, nullptr, dwqkv, nullptr, D,
                                                       3 * Dl, M, ws, s)));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(ctx, g, nullptr, nullptr, dwproj, nullptr,
                                                       Dl, D, M, ws, s)));
    SKY_TRY(launch_colsum_partial<float>(dqkv, M, 3 * Dl, partf, s));
    SKY_TRY(launch_colsum_final(partf, n_partials(M), 3 * Dl, dbqkv, s));
    return 0;
  }
  SKY_TRY(launch_layernorm_held(x, ln_scale, ln_bias, y, M, D, s));
  SKY_TRY(sm90::launch_gemm_sm90<EPI_BIAS>(y, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * Dl, D, s));
  const BwdSpec dctx{sm90::FORM_NT, EPI_STORE, g, wproj, 0, dc, nullptr, 0, M, Dl, D};
  SKY_TRY(sm90::launch_bwd_group(&dctx, 1, nullptr, s));
  SKY_TRY((launch_attn_bwd_core<true, true>(qkv, nullptr, dc, ctx, dqkv, B, N, Dl, Hl, seg_len, s,
                                            partf)));
  const BwdSpec dy_spec{sm90::FORM_NT, EPI_STORE_F32, dqkv, wqkv, 0, nullptr, dyf, 0, M, D, 3 * Dl};
  SKY_TRY(sm90::launch_bwd_group(&dy_spec, 1, nullptr, s));
  BwdSpec dw[2];
  dw[0] = BwdSpec{sm90::FORM_TN, EPI_STORE, y, dqkv, 0, dwqkv, nullptr, 0, D, 3 * Dl, M};
  dw[1] = BwdSpec{sm90::FORM_TN, EPI_STORE, ctx, g, 0, dwproj, nullptr, 0, Dl, D, M};
  SKY_TRY(sm90::launch_bwd_group(dw, 2, static_cast<float*>(ws), s));
  SKY_TRY(launch_colsum_final(partf, B, 3 * Dl, dbqkv, s));
  return 0;
}

extern "C" int sky_attn_block_tp_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* part, void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B, int N, int D,
    int Dl, int Hl, int seg_len, void* stream) {
  return attn_block_tp_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, g, y, qkv, dc, ctx, dqkv, part,
                           ws, dy, dwqkv, dbqkv, dwproj, B, N, D, Dl, Hl, seg_len, false, stream);
}

extern "C" int sky_attn_block_tp_bwd_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* g, void* y, void* qkv, void* dc, void* ctx, void* dqkv,
    void* part, void* ws, void* dy, void* dwqkv, void* dbqkv, void* dwproj, int B, int N, int D,
    int Dl, int Hl, int seg_len, void* stream) {
  return attn_block_tp_bwd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, g, y, qkv, dc, ctx, dqkv, part,
                           ws, dy, dwqkv, dbqkv, dwproj, B, N, D, Dl, Hl, seg_len, true, stream);
}

// After the all-reduce of dy (M, D) fp32: dx (the operand dtype), dscale,
// dbias and dbproj (D,) fp32; part holds 3 D * ceil(M / 32) floats.
extern "C" int sky_attn_block_tp_bwd_finish(const void* x, const void* ln_scale, const void* g,
                                            const void* dy, void* part, void* dx, void* dscale,
                                            void* dbias, void* dbproj, int M, int D, void* stream) {
  return sky::tp_bwd_finish<sky::bf16>(x, ln_scale, g, dy, part, dx, dscale, dbias, dbproj, M, D,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int sky_attn_block_tp_bwd_finish_f32(const void* x, const void* ln_scale,
                                                const void* g, const void* dy, void* part,
                                                void* dx, void* dscale, void* dbias, void* dbproj,
                                                int M, int D, void* stream) {
  return sky::tp_bwd_finish<float>(x, ln_scale, g, dy, part, dx, dscale, dbias, dbproj, M, D,
                                   static_cast<cudaStream_t>(stream));
}
