// MLP-block backward for Hopper (sm_90a): recompute (kernel 8), stash
// (kernel 7) and weight-streaming (kernel 9) variants.
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
// Kernel 8, at the TPU kernel's rounding points, all five products on the
// persistent wgmma + TMA GEMM of gemm_sm90.cuh:
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
// Neither fp32 (M, F) array (a, da) reaches device memory. Kernel 7 keeps
// the wmma GEMM of gemm.cuh (mlp_block_bwd_stash below), its last caller:
// its dh epilogue reads the bf16 stash, which none of the new forms does.
// GELU and its derivative use erff (the TPU kernel's A-S erf differs by at
// most 1.5e-7). Parameter gradient sums are two-pass or fixed-order
// (bwd_common.cuh, the dual epilogue), and no product uses atomics, so runs
// give the same bits.
//
// Bound on the H100: five GEMMs of 2 M D F FLOP each for kernel 8 (98 GFLOP
// at ViT-B B = 64), four for kernel 7 (79 GFLOP at ViT-L D = 768, B = 64):
// operation-bound. What kernel 8 still moves besides the products: y,
// da_c and h_c (M * (D + 2F) * 2 bytes, written once and read by the
// group), dy in fp32, and the split weight gradients' fp32 partials.
#include "bwd_common.cuh"
#include "gemm_sm90.cuh"

// Kernel 7 (wmma GEMM, gemm.cuh). Returns 0, or the first CUDA error a
// launch reported; `da` (M, F) fp32 receives da for the db1 column sums.
static int mlp_block_bwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                               const void* w1, const void* w2, const void* a_stash, const void* g,
                               void* y, void* da, void* da_c, void* h_c, void* dy, void* part,
                               void* ws, void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                               void* dw2, void* db2, int M, int D, int F, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);          // parts x F
  float* part_b2 = part_b1 + (size_t)parts * F;        // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;   // parts x D
  float* daf = static_cast<float*>(da);
  float* dyf = static_cast<float*>(dy);

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  SKY_TRY((launch_gemm<EPI_GELU_BWD_STASH, false, true>(
      gemm_args(g, w2, a_stash, da_c, M, F, D, daf, h_c), s)));
  SKY_TRY((launch_gemm<EPI_STORE_F32, false, true>(
      gemm_args(da_c, w1, nullptr, nullptr, M, D, F, dyf), s)));
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  float* wsf = static_cast<float*>(ws);
  SKY_TRY(launch_weight_grad(y, da_c, dw1, D, F, M, wsf, s));
  SKY_TRY(launch_weight_grad(h_c, g, dw2, F, D, M, wsf, s));
  SKY_TRY(launch_colsum_partial<float>(daf, M, F, part_b1, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_b2, s));

  SKY_TRY(launch_colsum_final(part_b1, parts, F, db1, s));
  SKY_TRY(launch_colsum_final(part_b2, parts, D, db2, s));
  SKY_TRY(launch_colsum_final(part_scale, parts, D, dscale, s));
  SKY_TRY(launch_colsum_final(part_bias, parts, D, dbias, s));
  return 0;
}

// The three products that follow the dual one, for the column slab c0 ..
// c0 + fs of F (kernel 8: c0 = 0, fs = F): spec[0] dy (+)= da_c @
// W1[:, slab]^T (FORM_NT, its own launch), W1's slab read in place as the
// (D, fs) K-major operand; spec[1], spec[2] one group (FORM_TN):
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
  if (sm_count(&sms) != cudaSuccess) return -1;
  BwdSpec spec[3];
  slab_group(spec, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, false, nullptr, nullptr,
             0, M, D, F, fs);
  int shapes[2][4];  // the weight gradients' group: dy never splits
  bwd_shapes(spec + 1, 2, shapes);
  return (long long)bwd_workspace(shapes, 2, bwd_plan(shapes, 2, sms));
}

extern "C" int sky_mlp_block_bwd_stream(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* y, void* da_c, void* h_c, void* dy,
                                        void* part, void* ws, void* dx, void* dscale, void* dbias,
                                        void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                        int F, int fs, void* stream);

// Kernel 8. The caller allocates the scratch (y: (M, D) bf16; da_c, h_c:
// (M, F) bf16; dy: (M, D) fp32; part: (F + 3D) * ceil(M / 32) fp32; ws:
// sky_mlp_block_bwd_ws(M, D, F, F) fp32) and the outputs (dx (M, D) bf16;
// dscale, dbias, db2 (D,) and db1 (F,) fp32; dw1 (D, F) and dw2 (F, D) bf16).
extern "C" int sky_mlp_block_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, const void* g,
                                 void* y, void* da_c, void* h_c, void* dy, void* part, void* ws,
                                 void* dx, void* dscale, void* dbias, void* dw1, void* db1,
                                 void* dw2, void* db2, int M, int D, int F, void* stream) {
  return sky_mlp_block_bwd_stream(x, ln_scale, ln_bias, w1, b1, w2, g, y, da_c, h_c, dy, part, ws,
                                  dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, F, stream);
}

// Kernel 7: the bf16 stash a (M, F) in place of b1, and `da` (M, F) fp32
// scratch; its ws holds 8 * D * F fp32 (launch_weight_grad).
extern "C" int sky_mlp_block_bwd_stash(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* w1, const void* w2, const void* a, const void* g,
                                       void* y, void* da, void* da_c, void* h_c, void* dy,
                                       void* part, void* ws, void* dx, void* dscale, void* dbias,
                                       void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                       int F, void* stream) {
  return mlp_block_bwd_stash(x, ln_scale, ln_bias, w1, w2, a, g, y, da, da_c, h_c, dy, part, ws,
                             dx, dscale, dbias, dw1, db1, dw2, db2, M, D, F, stream);
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
extern "C" int sky_mlp_block_bwd_stream(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* y, void* da_c, void* h_c, void* dy,
                                        void* part, void* ws, void* dx, void* dscale, void* dbias,
                                        void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                        int F, int fs, void* stream) {
  using namespace sky;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = n_partials(M);
  float* part_b1 = static_cast<float*>(part);          // ceil(M / 64) x fs, one slab at a time
  float* part_b2 = part_b1 + (size_t)parts * fs;       // parts x D
  float* part_scale = part_b2 + (size_t)parts * D;     // parts x D
  float* part_bias = part_scale + (size_t)parts * D;   // parts x D
  float* dyf = static_cast<float*>(dy);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  float* db1f = static_cast<float*>(db1);

  const int nj = F / fs;
  ColsumJob db1_job{part_b1, nullptr, (M + 63) / 64, fs};

  SKY_TRY(launch_layernorm(x, ln_scale, ln_bias, y, M, D, s));
  for (int j = 0; j < nj; ++j) {
    const size_t c0 = (size_t)j * fs;
    SKY_TRY(sm90::launch_dual(y, w1b + c0, F, b1f + c0, g, w2b + c0 * D, da_c, h_c, part_b1, M,
                              fs, D, s));
    sm90::BwdSpec spec[3];
    slab_group(spec, y, w1, g, da_c, h_c, dyf, j > 0, dw1, dw2, c0, M, D, F, fs);
    SKY_TRY(sm90::launch_bwd_group(spec, 1, nullptr, s));
    SKY_TRY(sm90::launch_bwd_group(spec + 1, 2, static_cast<float*>(ws), s));
    db1_job.out = db1f + c0;
    if (j < nj - 1) SKY_TRY(launch_colsum_finals(&db1_job, 1, s));  // the last one below
  }
  SKY_TRY(launch_ln_bwd(x, g, dyf, ln_scale, dx, part_scale, part_bias, M, D, s));
  SKY_TRY(launch_colsum_partial<bf16>(g, M, D, part_b2, s));
  const ColsumJob jobs[4] = {db1_job, {part_b2, static_cast<float*>(db2), parts, D},
                             {part_scale, static_cast<float*>(dscale), parts, D},
                             {part_bias, static_cast<float*>(dbias), parts, D}};
  SKY_TRY(launch_colsum_finals(jobs, 4, s));
  return 0;
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
