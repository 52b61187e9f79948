// MLP-block backward for Hopper (sm_90a): recompute (kernel 8), stash
// (kernel 7) and weight-streaming (kernel 9) variants, every product on the
// persistent wgmma + TMA GEMM of gemm_sm90.cuh.
//
// Replaces the TPU kernels sky_embeddings_tpu/ops/kernels/mlp_block.py:
// - _pallas_bwd (_bwd_kernel, mlp_block.py:309-354), entry
//   sky_mlp_block_bwd: the gradients of
//   out = x + GELU(LN(x) @ W1 + b1) @ W2 + b2 from x and the output gradient
//   g alone (the ViT-B training default, stash_mlp = False), with LN, fc1
//   and GELU recomputed;
// - _pallas_bwd_stash (_bwd_stash_kernel, mlp_block.py:378-423), entry
//   sky_mlp_block_bwd_stash: the same gradients from x, g and the bf16 fc1
//   pre-activation a that the stash forward (mlp_block.cu,
//   sky_mlp_block_fwd_stash) kept (the ViT-L default, stash_mlp = True). No
//   fc1 GEMM: GELU and GELU' are taken from the ROUNDED a, so h_c (for dW2)
//   is recomputed from bf16 a and is not the forward's h;
// - _pallas_bwd_stream (kernel 9, below).
//
// Kernel 8, at the TPU kernel's rounding points:
//   1. LayerNorm of x                                 -> y bf16    (:320-321)
//   2. the dual product (launch_dual): a = y @ W1 + b1 and dh = g @ W2^T
//      for each (128 x 128) tile of (M, F), both in fp32 registers; its
//      epilogue writes da_c = bf16(dh * gelu'(a)), h_c = bf16(gelu(a)) and
//      the fp32 column sums of da over 64 rows, for db1  (:322-329)
//   3. dy = da_c @ W1^T (FORM_NT, fp32), then one group launch
//      (launch_bwd_group) over the tiles of dW1 = y^T @ da_c and dW2 =
//      h_c^T @ g (FORM_TN, bf16, the weight dtype, mlp_block.py:954-956;
//      K = B*N split into slices added in order where the plan says)
//                                                    (:330, :351, :353)
//   4. LN backward -> dx, dscale / dbias partials (ln_bwd)      (:333-337)
//   5. db1, db2 (column sums of g), dscale, dbias: partials added in a
//      fixed order, the four in one launch.
// Kernel 7 is the same five steps with step 2 the stash dh product
// (launch_dh_stash): dh = g @ W2^T for each (128 x STASH_BN) tile of (M,
// F), its epilogue reading that tile of the bf16 stash a (TMA-loaded under
// the mainloop) in place of computing a, and writing da_c, h_c and db1's
// column partials as the dual's does (mlp_block.py:392-399, :419).
// Neither fp32 (M, F) array (a, da) reaches device memory in either.
// GELU and its derivative use erff in kernels 8 and 9 (the TPU kernel's
// A-S erf differs by at most 1.5e-7) and that A-S erf itself in kernel 7,
// whose epilogue has no fc1 product to hide behind. Parameter gradient
// sums are two-pass or fixed-order (bwd_common.cuh, the dual and stash
// epilogues), and no product uses atomics, so runs give the same bits.
//
// Bound on the H100: five GEMMs of 2 M D F FLOP each for kernel 8 (98 GFLOP
// at ViT-B B = 64), four for kernel 7 (79 GFLOP at ViT-L D = 768, B = 64):
// operation-bound. What both still move besides the products: y, da_c
// and h_c (M * (D + 2F) * 2 bytes, written once and read by the group),
// kernel 7's stash (M * F * 2 bytes, read once), dy in fp32, and the split
// weight gradients' fp32 partials.
//
// The fp32 forms of kernels 8, 7 and 9 (entries sky_mlp_block_bwd_f32,
// sky_mlp_block_bwd_stash_f32 and sky_mlp_block_bwd_stream_f32, the bf16
// entries' arguments; the fp32 configs, where JAX takes jax.vjp of
// xla_mlp_block): the same steps in fp32 at the plain version's points,
// every product on the 3xTF32 GEMM of gemm_f32.cuh, over the slabs of
// kernel 9 (one slab, fs = F, for kernels 8 and 7):
//   1. LayerNorm of x                                -> y fp32
//   per slab j (columns c0 = j * fs .. c0 + fs of F):
//   2. a = y @ W1[:, slab] + b1[slab] (FWD, W1's slab read in place)
//                                                    -> a (M, fs) fp32;
//      kernel 7 reads the fp32 stash a (M, F) instead and has no fc1
//   3. dh = g @ W2[slab, :]^T (NT) with the GELU' epilogue (exact erff,
//      as xla_mlp_block) -> da = dh * gelu'(a) (M, fs), and gelu(a): h
//      (M, fs), written over a (kernel 7: into its own buffer, the stash
//      stays as it was)
//   4. dy (+)= da @ W1[:, slab]^T (NT; slab 0 stores, later slabs add their
//      product to dy, dy_j + dy in JAX's order)
//   5. dW1[:, slab] = y^T @ da (stored in place, rows F apart), dW2[slab,
//      :] = h^T @ g (TN, each split along K = M where the tiles leave SMs
//      idle, slices added in order); db1[slab]'s column partials of da
//   6. after the last slab: LN backward -> dx fp32, dscale / dbias partials
//   7. db1, db2 (column sums of da and g), dscale, dbias: partials added in
//      a fixed order.
// So the fp32 (M, fs) a, h and da go through device memory (3 * M * F * 4
// bytes of writes, 2 * M * F * 4 of reads besides the products'), where the
// bf16 kernels keep a and da in registers: a first design, with the dual
// product's fp32 twin a later one. Kernel 7 reads its stash once (M * F * 4
// bytes) in place of fc1's 2 M D F operations.
#include "bwd_common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

// The three products that follow the dual (or stash dh) one, for the
// column slab c0 .. c0 + fs of F (kernels 8 and 7: c0 = 0, fs = F): spec[0]
// dy (+)= da_c @ W1[:, slab]^T (FORM_NT, its own launch), W1's slab read in
// place as the (D, fs) K-major operand; spec[1], spec[2] one group (FORM_TN):
// dW1[:, slab] = y^T @ da_c written in place (rows F apart), dW2[slab, :] =
// h_c^T @ g.
static void slab_group(sky::sm90::BwdSpec* spec, const void* y, const void* w1, const void* g,
                       const void* da_c, const void* h_c, float* dy, bool add, void* dw1,
                       void* dw2, size_t c0, int M, int D, int F, int fs) {
  using namespace sky;
  using namespace sky::sm90;
  spec[0] = BwdSpec{FORM_NT, add ? EPI_ADD_F32 : EPI_STORE_F32, da_c,
                    static_cast<const bf16*>(w1) + c0, F, nullptr, dy, D, M, D, fs};
  spec[1] = BwdSpec{FORM_TN, EPI_STORE, y, da_c, fs, static_cast<bf16*>(dw1) + c0, nullptr, F,
                    D, fs, M};
  spec[2] = BwdSpec{FORM_TN, EPI_STORE, h_c, g, D, static_cast<bf16*>(dw2) + c0 * D, nullptr, D,
                    fs, D, M};
}

// fp32 floats of split-K workspace the slab group of (M, D, F, fs) needs.
extern "C" long long sky_mlp_block_bwd_ws(int M, int D, int F, int fs) {
  using namespace sky::sm90;
  int sms = 0;
  if (sky::sm_count(&sms) != cudaSuccess) return -1;
  BwdSpec spec[3];
  slab_group(spec, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, false, nullptr, nullptr,
             0, M, D, F, fs);
  int shapes[2][4];  // the weight gradients' group: dy never splits
  bwd_shapes(spec + 1, 2, shapes);
  return (long long)bwd_workspace(shapes, 2, bwd_plan(shapes, 2, sms));
}

// Kernel 9: the weight-streaming backward. Replaces _pallas_bwd_stream
// (_bwd_stream_slab_kernel, mlp_block.py:459-631), the backward of
// fused_mlp_block(stash="stream") that wide blocks (D * F > 1024 * 4096,
// ViT-H) take. It computes kernel 8's gradients slab by slab over nj = F / fs
// column slabs of W1 (rows of W2), in order, as the TPU kernel's nj calls do:
//   1. LayerNorm of x                             -> y bf16, once    (:489-490)
//   per slab j (columns j*fs .. (j+1)*fs of F):
//   2. the dual product over the slab: a_j = y @ W1[:, j] + b1_j and dh_j =
//      g @ W2[j, :]^T -> da_c, h_c (M, fs) and db1_j's partials (:491-498)
//   3. dy = da_c @ W1[:, j]^T in fp32, slab 0 storing it and later slabs
//      adding their product to it (dy + dyin); then the slab's group:
//      dW1[:, j] = y^T @ da_c and dW2[j, :] = h_c^T @ g, rounded to bf16,
//      straight into their columns / rows of dw1 and dw2
//                                                  (:499-501, :514, :516)
//   4. db1_j = the partials added in order                             (:515)
//   5. after the last slab: LN backward from the summed dy -> dx, dscale,
//      dbias; db2 = column sums of g                         (:518, :520-527)
// No slab is copied: the TMA maps read W1's column slab and write dW1's
// with the row pitch F. The slabs' fp32 dy partials are added in JAX's
// order. Against kernel 8 (this entry with fs = F), da_c, h_c, db1 and db2
// are the same bits; dy (and so dx, dscale, dbias) sums in another order,
// and the weight gradients may split their K = M sums into other slices.
//
// What the slabs bound here: not a resident weight term (the TPU's
// 12 * D * fs bytes of VMEM) but the (M, fs) bf16 scratch da_c, h_c in
// device memory (4 * M * fs bytes instead of 4 * M * F) and the split-K
// workspace. Bound: the same five GEMMs of 2 M D F FLOP as kernel 8. Each
// slab's products fill less of the card than kernel 8's (17 x 10 dual tiles
// at ViT-H B = 32 for 132 SMs); the weight gradients share one launch.
//
// The caller allocates the scratch (y: (M, D) bf16; da_c, h_c: (M, fs)
// bf16; dy: (M, D) fp32; part: (fs + 3D) * ceil(M / 32) fp32; ws:
// sky_mlp_block_bwd_ws(M, D, F, fs) fp32) and the outputs as for kernel 8.
// fs divides F and is a multiple of 8.
//
// Kernels 8 and 7 are this loop over one slab (fs = F); kernel 7 passes the
// stash a (M, F) in place of b1, and its step 2 is the stash dh product.
//
// mlp_bwd_slabs is the loop (steps 1-3 and every slab's db1 but the last
// one's, left in *db1_job); mlp_block_bwd adds the LN backward and the
// column sums after it, and the tensor-parallel form (below) stops there.
static int mlp_bwd_slabs(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                         const void* b1, const void* w2, const void* a, const void* g, void* y,
                         void* da_c, void* h_c, float* dyf, float* part_b1, void* ws, void* dw1,
                         void* db1, void* dw2, int M, int D, int F, int fs, sky::ColsumJob* db1_job,
                         cudaStream_t s) {
  using namespace sky;
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  float* db1f = static_cast<float*>(db1);
  const int nj = F / fs;
  *db1_job = ColsumJob{part_b1, nullptr, (M + 63) / 64, fs};

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  for (int j = 0; j < nj; ++j) {
    const size_t c0 = (size_t)j * fs;
    if (a != nullptr)
      SKY_TRY(sm90::launch_dh_stash(g, w2b, a, da_c, h_c, part_b1, M, F, D, s));
    else
      SKY_TRY(sm90::launch_dual(y, w1b + c0, F, b1f + c0, g, w2b + c0 * D, da_c, h_c, part_b1, M,
                                fs, D, s));
    sm90::BwdSpec spec[3];
    slab_group(spec, y, w1, g, da_c, h_c, dyf, j > 0, dw1, dw2, c0, M, D, F, fs);
    SKY_TRY(sm90::launch_bwd_group(spec, 1, nullptr, s));
    SKY_TRY(sm90::launch_bwd_group(spec + 1, 2, static_cast<float*>(ws), s));
    db1_job->out = db1f + c0;
    if (j < nj - 1) SKY_TRY(launch_colsum_finals(db1_job, 1, s));  // the last one by the caller
  }
  return 0;
}

static int mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                         const void* b1, const void* w2, const void* a, const void* g, void* y,
                         void* da_c, void* h_c, void* dy, void* part, void* ws, void* dx,
                         void* dscale, void* dbias, void* dw1, void* db1, void* dw2, void* db2,
                         int M, int D, int F, int fs, cudaStream_t s) {
  using namespace sky;
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);          // ceil(M / 64) x fs, one slab at a time
  float* part_b2 = part_b1 + (size_t)parts * fs;       // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;   // parts x D
  float* dyf = static_cast<float*>(dy);
  ColsumJob db1_job;
  if (const int e = mlp_bwd_slabs(x, ln_scale, ln_bias, w1, b1, w2, a, g, y, da_c, h_c, dyf,
                                  part_b1, ws, dw1, db1, dw2, M, D, F, fs, &db1_job, s))
    return e;
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_b2, s));
  const ColsumJob jobs[4] = {db1_job, {part_b2, static_cast<float*>(db2), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 4, s));
  return 0;
}

// Kernel 8. The caller allocates the scratch (y: (M, D) bf16; da_c, h_c:
// (M, F) bf16; dy: (M, D) fp32; part: (F + 3D) * ceil(M / 32) fp32; ws:
// sky_mlp_block_bwd_ws(M, D, F, F) fp32) and the outputs (dx (M, D) bf16;
// dscale, dbias, db2 (D,) and db1 (F,) fp32; dw1 (D, F) and dw2 (F, D) bf16).
extern "C" int sky_mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* g,
                                 void* y, void* da_c, void* h_c, void* dy, void* part, void* ws,
                                 void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                                 void* dw2, void* db2, int M, int D, int F, void* stream) {
  return mlp_block_bwd(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da_c, h_c, dy, part, ws,
                       dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, F,
                       static_cast<cudaStream_t>(stream));
}

// Kernel 7: the bf16 stash a (M, F) in place of b1; scratch and outputs as
// for kernel 8.
extern "C" int sky_mlp_block_bwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* w1, const void* w2, const void* a, const void* g,
                                       void* y, void* da_c, void* h_c, void* dy, void* part,
                                       void* ws, void* dx, void* dscale, void* dbias, void* dw1,
                                       void* db1, void* dw2, void* db2, int M, int D, int F,
                                       void* stream) {
  return mlp_block_bwd(x, ln_scale, ln_bias, w1, nullptr, w2, a, g, y, da_c, h_c, dy, part, ws,
                       dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, F,
                       static_cast<cudaStream_t>(stream));
}

// Kernel 9, fs the slab width (above).
extern "C" int sky_mlp_block_bwd_stream(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* y, void* da_c, void* h_c, void* dy,
                                        void* part, void* ws, void* dx, void* dscale, void* dbias,
                                        void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                        int F, int fs, void* stream) {
  return mlp_block_bwd(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da_c, h_c, dy, part, ws,
                       dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, fs,
                       static_cast<cudaStream_t>(stream));
}

// ---- the backward forms alone, for the card tests and chip_smoke.py ----------

// One product on the group kernel: out = a @ b^T (form 1, FORM_NT: a (M, K),
// b (N, K)) or a^T @ b (form 2, FORM_TN: a (K, M), b (K, N)); epi EPI_STORE
// (3: out (M, N) bf16), EPI_STORE_F32 (4: out_f32) or EPI_ADD_F32 (9:
// out_f32 += the product). bn, splits > 0 force the tile width and the
// split count (FORM_TN with EPI_STORE only); ws holds splits * M * N fp32.
extern "C" int sky_gemm_sm90_bwd(const void* a, const void* b, void* out, void* out_f32, void* ws,
                                 int form, int epi, int M, int N, int K, int bn, int splits,
                                 void* stream) {
  using namespace sky::sm90;
  const BwdSpec spec{form, epi, a, b, 0, out, static_cast<float*>(out_f32), 0, M, N, K};
  return static_cast<int>(launch_bwd_group(&spec, 1, static_cast<float*>(ws),
                                           static_cast<cudaStream_t>(stream), bn, splits));
}

// The group plan of `count` (1 to 3) products, shapes[4 i ..] = {kind, M,
// N, K} (enum ShapeKind: 0 FORM_NT, 1 a weight gradient, which may split,
// 2 another FORM_TN product), over `sms` CTAs: plan[0..5] = BN, split
// count, units, shared-memory bytes, modelled cost, workspace floats;
// splits > 0 forces the split count (as sky_gemm_sm90_bwd's does).
// plan[0] = -1: refused.
extern "C" void sky_gemm_sm90_bwd_plan(int count, const int* shapes, int sms, int splits,
                                       long long* plan) {
  using namespace sky::sm90;
  if (count < 1 || count > MAX_PROBLEMS) {
    plan[0] = -1;
    return;
  }
  int sh[MAX_PROBLEMS][4];
  for (int i = 0; i < count; ++i)
    for (int j = 0; j < 4; ++j) sh[i][j] = shapes[4 * i + j];
  BwdPlan p = bwd_plan_uncached(sh, count, sms);
  if (splits > 0) p.splits = splits;
  plan[0] = p.bn;
  plan[1] = p.splits;
  plan[2] = p.units;
  plan[3] = p.smem;
  plan[4] = p.cost;
  plan[5] = (long long)bwd_workspace(sh, count, p);
}

// Kernel 8's weight-gradient group alone, as sky_mlp_block_bwd_stream
// launches it for its first slab: dW1[:, :fs] = y^T @ da_c (rows F apart)
// and dW2[:fs, :] = h_c^T @ g in one launch; bn, splits > 0 force the tile
// width and split count; ws holds the workspace sky_gemm_sm90_bwd_plan
// gives under them.
extern "C" int sky_mlp_bwd_weight_grads(const void* y, const void* da_c, const void* h_c,
                                        const void* g, void* dw1, void* dw2, void* ws, int M,
                                        int D, int F, int fs, int bn, int splits, void* stream) {
  using namespace sky::sm90;
  BwdSpec spec[3];
  slab_group(spec, y, nullptr, g, da_c, h_c, nullptr, false, dw1, dw2, 0, M, D, F, fs);
  return static_cast<int>(launch_bwd_group(spec + 1, 2, static_cast<float*>(ws),
                                           static_cast<cudaStream_t>(stream), bn, splits));
}

// The stash dh product alone: da_c, h_c (M, N) bf16 from g (M, K), w2 (N, K)
// and the stash a (M, N) bf16; db1 (N,) fp32 from its column partials (part:
// ceil(M / 64) * N fp32).
extern "C" int sky_gemm_sm90_dh_stash(const void* g, const void* w2, const void* a, void* da_c,
                                      void* h_c, void* part, void* db1, int M, int N, int K,
                                      void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partf = static_cast<float*>(part);
  SKY_TRY(sm90::launch_dh_stash(g, w2, a, da_c, h_c, partf, M, N, K, s));
  const ColsumJob job{partf, static_cast<float*>(db1), (M + 63) / 64, N};
  SKY_TRY(launch_colsum_finals(&job, 1, s));
  return 0;
}

// The dual product alone: da_c, h_c (M, N) bf16 from y, g (M, K), w1 (K, N),
// w2 (N, K), b1 (N,); db1 (N,) fp32 from its column partials (part:
// ceil(M / 64) * N fp32).
extern "C" int sky_gemm_sm90_dual(const void* y, const void* w1, const void* b1, const void* g,
                                  const void* w2, void* da_c, void* h_c, void* part, void* db1,
                                  int M, int N, int K, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partf = static_cast<float*>(part);
  SKY_TRY(sm90::launch_dual(y, w1, N, b1, g, w2, da_c, h_c, partf, M, N, K, s));
  const ColsumJob job{partf, static_cast<float*>(db1), (M + 63) / 64, N};
  SKY_TRY(launch_colsum_finals(&job, 1, s));
  return 0;
}

// ---- the fp32 forms of kernels 8, 7 and 9 -------------------------------------

// fp32 floats of split-K workspace the fp32 forms of (M, D, F) over slabs of
// fs columns need: the larger of a slab's two weight gradients' (they run
// one after the other).
extern "C" long long sky_mlp_block_bwd_f32_ws(int M, int D, int F, int fs) {
  (void)F;
  const size_t a = sky::f32::workspace(D, fs, M), b = sky::f32::workspace(fs, D, M);
  return static_cast<long long>(a > b ? a : b);
}

// All fp32. The caller allocates the scratch (y, dy: (M, D); da, h: (M, fs);
// part: (fs + 3D) * ceil(M / 32); ws: sky_mlp_block_bwd_f32_ws(M, D, F, fs))
// and the outputs (dx (M, D); dscale, dbias, db2 (D,); db1 (F,); dw1 (D, F);
// dw2 (F, D)). Kernel 7 passes its stash `a` (M, F) in place of b1.
//
// mlp_bwd_slabs_f32 is the loop, as mlp_bwd_slabs is kernel 8's.
static int mlp_bwd_slabs_f32(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w1, const void* b1, const void* w2, const void* a,
                             const void* g, void* y, void* da, void* h, float* dyf, float* part_b1,
                             void* ws, void* dw1, void* db1, void* dw2, int M, int D, int F, int fs,
                             sky::ColsumJob* db1_job, cudaStream_t s) {
  using namespace sky;
  using f32::Ld;
  const int parts = n_partials(M);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  float* db1f = static_cast<float*>(db1);
  float* dw1f = static_cast<float*>(dw1);
  float* dw2f = static_cast<float*>(dw2);

  const int nj = F / fs;
  *db1_job = ColsumJob{part_b1, nullptr, parts, fs};
  SKY_TRY(launch_layernorm<float>(x, ln_scale, ln_bias, y, M, D, s));
  for (int j = 0; j < nj; ++j) {
    const size_t c0 = (size_t)j * fs;
    const void* pre = a;  // the pre-activation of the slab: the stash or fc1's
    if (a == nullptr) {
      SKY_TRY((f32::launch_gemm_f32<f32::FWD, f32::BIAS>(y, w1f + c0, b1f + c0, nullptr, h,
                                                         nullptr, M, fs, D, nullptr, s,
                                                         Ld{0, F, 0})));
      pre = h;
    }
    SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::DGELU>(g, w2f + c0 * D, nullptr, pre, da, h, M, fs,
                                                       D, nullptr, s)));
    if (j == 0)
      SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::STORE>(da, w1f + c0, nullptr, nullptr, dyf,
                                                         nullptr, M, D, fs, nullptr, s,
                                                         Ld{0, F, 0})));
    else
      SKY_TRY((f32::launch_gemm_f32<f32::NT, f32::ADD>(da, w1f + c0, nullptr, nullptr, dyf,
                                                       nullptr, M, D, fs, nullptr, s,
                                                       Ld{0, F, 0})));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(y, da, nullptr, nullptr, dw1f + c0, nullptr,
                                                       D, fs, M, ws, s, Ld{0, 0, F})));
    SKY_TRY((f32::launch_gemm_f32<f32::TN, f32::STORE>(h, g, nullptr, nullptr, dw2f + c0 * D,
                                                       nullptr, fs, D, M, ws, s)));
    SKY_TRY(launch_colsum_partial<float>(da, M, fs, part_b1, s));
    db1_job->out = db1f + c0;
    if (j < nj - 1) SKY_TRY(launch_colsum_finals(db1_job, 1, s));  // the last one by the caller
  }
  return 0;
}

static int mlp_block_bwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w1, const void* b1, const void* w2, const void* a,
                             const void* g, void* y, void* da, void* h, void* dy, void* part,
                             void* ws, void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                             void* dw2, void* db2, int M, int D, int F, int fs, cudaStream_t s) {
  using namespace sky;
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);        // parts x fs, one slab at a time
  float* part_b2 = part_b1 + (size_t)parts * fs;     // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;   // parts x D
  float* part_bias = part_scale + (size_t)parts * D;  // parts x D
  float* dyf = static_cast<float*>(dy);
  ColsumJob db1_job;
  if (const int e = mlp_bwd_slabs_f32(x, ln_scale, ln_bias, w1, b1, w2, a, g, y, da, h, dyf,
                                      part_b1, ws, dw1, db1, dw2, M, D, F, fs, &db1_job, s))
    return e;
  SKY_TRY(launch_ln_bwd<float>(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  SKY_TRY(launch_colsum_partial<float>(g, M, D, part_b2, s));
  const ColsumJob jobs[4] = {db1_job, {part_b2, static_cast<float*>(db2), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 4, s));
  return 0;
}

// Kernel 8's fp32 form: scratch as above with fs = F.
extern "C" int sky_mlp_block_bwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* g, void* y, void* da, void* h, void* dy,
                                     void* part, void* ws, void* dx, void* dscale, void* dbias,
                                     void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                     int F, void* stream) {
  return mlp_block_bwd_f32(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da, h, dy, part, ws,
                           dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, F,
                           static_cast<cudaStream_t>(stream));
}

// Kernel 7's fp32 form: the fp32 stash a (M, F) in place of b1; h is its own
// (M, F) buffer.
extern "C" int sky_mlp_block_bwd_stash_f32(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* w1, const void* w2,
                                           const void* a, const void* g, void* y, void* da,
                                           void* h, void* dy, void* part, void* ws, void* dx,
                                           void* dscale, void* dbias, void* dw1, void* db1,
                                           void* dw2, void* db2, int M, int D, int F,
                                           void* stream) {
  return mlp_block_bwd_f32(x, ln_scale, ln_bias, w1, nullptr, w2, a, g, y, da, h, dy, part, ws, dx,
                           dscale, dbias, dw1, db1, dw2, db2, M, D, F, F,
                           static_cast<cudaStream_t>(stream));
}

// Kernel 9's fp32 form, fs the slab width (it divides F, a multiple of 4).
extern "C" int sky_mlp_block_bwd_stream_f32(const void* x, const void* ln_scale,
                                            const void* ln_bias, const void* w1, const void* b1,
                                            const void* w2, const void* g, void* y, void* da,
                                            void* h, void* dy, void* part, void* ws, void* dx,
                                            void* dscale, void* dbias, void* dw1, void* db1,
                                            void* dw2, void* db2, int M, int D, int F, int fs,
                                            void* stream) {
  if (fs <= 0 || F % fs) return static_cast<int>(cudaErrorInvalidValue);
  return mlp_block_bwd_f32(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da, h, dy, part, ws,
                           dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, fs,
                           static_cast<cudaStream_t>(stream));
}

// ---- the tensor-parallel form of kernel 8 -------------------------------------
//
// Kernel 8 split at the all-reduce (parallel/sharding.py): a rank holds
// the contiguous column block F_r = F / tp of W1 (w1_r (D, F_r), b1_r) and
// the same rows of W2 (w2_r (F_r, D)). Entry sky_mlp_block_tp_bwd is
// kernel 8's slab loop (mlp_bwd_slabs) over the rank's columns: LN of the
// replicated x, the dual product, dy_r = da_c @ w1_r^T in fp32 (the
// rank's partial of dy), dW1_r and dW2_r in one group, db1_r. It stops
// before the LN backward; the caller all-reduces dy over the model group
// and sky_mlp_block_tp_bwd_finish runs the LN backward (dx, dscale, dbias)
// and db2 from g (bwd_common.cuh tp_bwd_finish), the gradients of
// replicated parameters, alike on every rank. fs is the slab width: F_r
// (one slab, kernel 8's form) on the main path, or a divisor of F_r that
// kernel 9's partition gives, the same loop. A rank's bound: 10 M D F_r
// FLOP of products. The fp32 forms (_f32 entries) run mlp_bwd_slabs_f32.
// Scratch as kernel 8's (kernel 9's with fs < F_r) at F = F_r; outputs dy
// (M, D) fp32, dw1 (D, F_r), db1 (F_r,) fp32, dw2 (F_r, D).
static int mlp_block_tp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* w1, const void* b1, const void* w2, const void* g,
                            void* y, void* da_c, void* h_c, void* dy, void* part, void* ws,
                            void* dw1, void* db1, void* dw2, int M, int D, int F, int fs,
                            bool fp32, cudaStream_t s) {
  using namespace sky;
  if (fs <= 0 || F % fs) return static_cast<int>(cudaErrorInvalidValue);
  float* dyf = static_cast<float*>(dy);
  float* part_b1 = static_cast<float*>(part);
  ColsumJob db1_job;
  const int e = fp32 ? mlp_bwd_slabs_f32(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da_c,
                                         h_c, dyf, part_b1, ws, dw1, db1, dw2, M, D, F, fs,
                                         &db1_job, s)
                     : mlp_bwd_slabs(x, ln_scale, ln_bias, w1, b1, w2, nullptr, g, y, da_c, h_c,
                                     dyf, part_b1, ws, dw1, db1, dw2, M, D, F, fs, &db1_job, s);
  if (e) return e;
  SKY_TRY(launch_colsum_finals(&db1_job, 1, s));
  return 0;
}

extern "C" int sky_mlp_block_tp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                    const void* w1, const void* b1, const void* w2, const void* g,
                                    void* y, void* da_c, void* h_c, void* dy, void* part, void* ws,
                                    void* dw1, void* db1, void* dw2, int M, int D, int F, int fs,
                                    void* stream) {
  return mlp_block_tp_bwd(x, ln_scale, ln_bias, w1, b1, w2, g, y, da_c, h_c, dy, part, ws, dw1,
                          db1, dw2, M, D, F, fs, false, static_cast<cudaStream_t>(stream));
}

extern "C" int sky_mlp_block_tp_bwd_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* y, void* da, void* h, void* dy,
                                        void* part, void* ws, void* dw1, void* db1, void* dw2,
                                        int M, int D, int F, int fs, void* stream) {
  return mlp_block_tp_bwd(x, ln_scale, ln_bias, w1, b1, w2, g, y, da, h, dy, part, ws, dw1, db1,
                          dw2, M, D, F, fs, true, static_cast<cudaStream_t>(stream));
}

// After the all-reduce of dy (M, D) fp32: dx (the operand dtype), dscale,
// dbias and db2 (D,) fp32; part holds 3 D * ceil(M / 32) floats.
extern "C" int sky_mlp_block_tp_bwd_finish(const void* x, const void* ln_scale, const void* g,
                                           const void* dy, void* part, void* dx, void* dscale,
                                           void* dbias, void* db2, int M, int D, void* stream) {
  return sky::tp_bwd_finish<sky::bf16>(x, ln_scale, g, dy, part, dx, dscale, dbias, db2, M, D,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int sky_mlp_block_tp_bwd_finish_f32(const void* x, const void* ln_scale, const void* g,
                                               const void* dy, void* part, void* dx, void* dscale,
                                               void* dbias, void* db2, int M, int D,
                                               void* stream) {
  return sky::tp_bwd_finish<float>(x, ln_scale, g, dy, part, dx, dscale, dbias, db2, M, D,
                                   static_cast<cudaStream_t>(stream));
}
