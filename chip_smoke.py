#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sky_embeddings_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a). Phases, each
failing loudly (any failure exits non-zero and prints no result line):

1. device: card name and power limit; TF32 off for the plain fp32 products;
2. build: nvcc builds the CUDA kernels (attention block forward and stash
   forward; attention stash and recompute backward; the standalone
   attention forward and backward, kernels 12 and 13; MLP block forward and
   stash forward; MLP recompute, stash and weight-streaming backward; the
   multi-query bank scorer) from the sources in the
   checkout, one nvcc per source, all at once; Triton compiles the bank
   scorer;
3. kernel parity, each kernel against its plain PyTorch version on the same
   inputs: the serving kernels at the serving path's shapes (ViT-B: N=65,
   D=768, H=12, F=3072 at B=64 and B=1024; a 1M x 768 bank in bf16 and fp32;
   kernel 11 on it at Q = 1, 8, 64 and on ragged 1 000 003-row banks of
   width 3072 and 37 at Q = 130), max|a-b|/max|b| within the bars of tools/kernel_parity.py (2e-2; bank fp32
   5e-3); the training kernels at their paths' shapes, every output within
   TOL_BWD = 3e-2 and finite: kernels 2, 3, 8 at ``mim_1`` (B=64, 512 and
   the ragged 63), kernels 6, 7 at ``mim_25_large`` (ViT-L, N=65, D=768,
   F=3072; B=64, 512, 63), kernel 4 at ``mim_32`` (ViT-L with the RA/Dec
   token, N=66, D=1024, H=16; B=32, 256, 31); at ViT-H's shapes (N=66,
   D=1280, 16 heads of 80, F=5120; B=32, 256, 31) kernel 9 against its
   plain version and against kernel 8 (the gap printed), K2 and kernel 4 at
   hd = 80, and at N = 256; at the MAE path's shapes (bench_mae: four
   samples of 17 tokens packed to N = 68, seg_len = 17, D=768, H=12; B=256,
   64 and the ragged 63 packed sequences) K2, kernel 2 and kernel 4 masked
   and kernel 3 from the packed stash, each masked kernel also against the
   unmasked one on the same samples one to a sequence (the gap printed), and
   K2 and kernels 2-4 at maesimple's decoder head of 512 (N=65);
   kernels 12 and 13 (the attention core behind ``layers.Attention``) in
   bf16 at ViT-B (N=65, D=768, 12 heads; B=64, 1024, 63), ViT-H (N=66,
   D=1280, 16 heads of 80; B=32, 256, 31), the MAE decoder (N=65, D=512, 16
   heads of 32; B=1024) and N=256 at hd=64, and in fp32 at ViT-B B=64 and
   ViT-H B=32 (bar TOL_CORE_F32); kernel 12's bf16 context bit-equal to the
   one K2's core computes from the same qkv; kernel 13 twice on the same
   inputs bit-equal; each timed in bf16 at ViT-B B=1024 and ViT-H B=256
   and in fp32 at ViT-B B=64 and ViT-H B=32 beside
   ``F.scaled_dot_product_attention`` on the same (B, H, N, hd) views
   (fp32 with TF32 off), forward and forward + backward (the library
   column, measured here and used nowhere in the port), each record with
   its share of the bound and the bytes it must move per ms; the forward
   GEMM of K1 and K2 (``csrc/gemm_sm90.cuh``, wgmma fed by TMA) alone at
   the four products (qkv, proj, fc1, fc2 with their epilogues) at B=64 and
   B=1024, held to its plain version and timed beside ``torch.addmm`` on
   the same operands (the ``gemm_times`` record, with the host cost of
   encoding a launch's TMA maps); the backward products of kernels 8 and 9
   on the same GEMM (the dual product a = y @ W1 + b1 with dh = g @ W2^T,
   dh alone on the K-major-B form, dy, and dW1, dW2 on the transposed-A
   form) at ``mim_1`` B=64 and 512 and at one ViT-H slab, held to their
   plain versions and timed beside ``torch.mm`` on the same operand views,
   with kernel 8's and 9's device time by kernel name; the products of
   kernels 3 and 4 (the qkv recompute on the forward form, dctx and dy on
   the K-major-B form, dWqkv with dWproj in one transposed-A group) at
   ``mim_1`` B=64 and 512 and at ViT-H B=256 beside ``torch.addmm`` /
   ``torch.mm``, with kernel 3's and 4's device time by kernel name (the
   ``bwd_gemm_times`` record);
4. the serving path, through the entry points ``similarity_search`` calls, on
   ``configs/mim_1.ini`` (SimMIM ViT-B, bf16, full depth, seeded weights) and
   synthetic cutouts with whole-band NaNs: ``extract_latents`` of 2 targets
   with 64 augmentations, streaming ``mim_simsearch`` over 32 batches of 64,
   ``build_bank`` + ``EmbeddingBank.query(exact=True)``, and
   ``weighted_bank_scores`` / ``bank_topk`` on a seeded 1M x 768 bf16 bank.
   Launch counters are zeroed just before and read just after; the kernel
   path's tokens and top-300 are compared with the plain path on the card;
4b. the retrieval path, through the functions ``sky_sim_search`` calls, on
   ``configs/mim_1.ini``: a synthetic FITS survey (4 tiles x 5 bands,
   1024 x 1024, TAN WCS) streamed at overlap 0.4 (729 cutouts a tile, 44
   batches of 64) through ``mim_simsearch_multi`` for 4 target groups (64
   augmentations each); then the 1M x 768 bf16 bank through
   ``EmbeddingBank.query`` (int8 two-stage and exact), ``query_multi`` at
   Q = 8 (exact: kernel 11, once; int8) and the chunked scorer (the bank on
   the host behind a row-sliceable view, through ``query``'s chunked route
   and in 300 000-row slabs). Counters are zeroed just before and read just
   after; then each group against a single-group ``mim_simsearch``, the
   int8 routes' agreement with the exact ranking, ``query_multi`` against 8
   single queries, the chunked results against the single pass; queries/s,
   the chunked query's time and the FITS search's images/s;
5. the training paths, through the entry points ``pretrain_mim`` calls
   (``MIMPretrainer.train_batch`` / ``eval_batch``), bf16, full width and
   depth, seeded weights, synthetic cutouts with whole-band NaNs. Counters
   are zeroed just before each path and read just after:
   - ``configs/mim_1.ini`` (ViT-B, depth 12, batch 64): 20 steps, 4
     validation batches, then ``save`` and ``restore`` into a fresh trainer
     (params and optimizer state bit-equal); kernels 2, 3 and 8 at 12 x 20
     launches, K1 12 x 24, K2 12 x 4;
   - ``configs/mim_25_large.ini`` (ViT-L, D=768, depth 24, batch 64, the
     MLP stash): 10 steps, 2 validation batches; kernels 2, 3, 6 and 7 at
     24 x 10, K1 and K2 at 24 x 2, kernels 4 and 8 at 0;
   - ``configs/mim_32.ini`` (ViT-L, D=1024, depth 24, 9 bands, the RA/Dec
     token, batch 32, remat): 10 steps, 2 validation batches; kernels 4 and 8
     at 24 x 10, K1 and K2 at 24 x (2 x 10 + 2), the stash kernels at 0; and
     the gradients with remat bit-equal to those of the same model without
     remat (both stashes off);
   - ViT-H (``mim_32`` with ``bench.py`` ``bench_vit_h``'s model: mimhuge,
     D=1280, depth 32, 16 heads of 80, F=5120, no remat, stash off; batch
     32), built in memory: 10 steps, 2 validation batches; kernels 4 and 9
     at 32 x 10, K1 and K2 at 32 x (10 + 2), kernels 2, 3, 6, 7, 8 at 0;
   - MAE (``mim_1`` with ``bench.py`` ``bench_mae``'s model: base, ViT-B
     over 16 of 64 patches plus cls, four samples packed per encoder
     sequence (N=68, seg_len=17); the 512-wide, 8-deep decoder of 16 heads
     over all 65 tokens with its attention stash; batch 1024), built in
     memory: 10 steps, 2 validation batches (MAE masks its validation
     batches too); kernel 2 (masked) and kernel 3 at 12 x 10 in the encoder
     plus 8 x 10 (unmasked) in the decoder, kernel 8 at (12 + 8) x 10, K1 at
     (12 + 8) x (10 + 2), K2 at (12 + 8) x 2 of which 12 x 2 masked,
     kernels 4, 6, 7, 9 at 0; then the same model with remat at batch 256
     for 3 steps (K2 masked 12 x 2 x 3, kernel 4 masked 12 x 3, the
     decoder's kernels 2 and 3 8 x 3, K1 (2 x 12 + 8) x 3, kernel 8 20 x 3)
     and its gradients bit-equal to those stored without remat (the
     encoder's stash off);
   - ``attn_pool`` (``mim_1`` with ``ARCHITECTURE.attn_pool = True``: the
     encoder's tokens pooled by ``AttentionPoolLatent`` into one token that
     the decoder expands to the whole 64x64x5 image), built in memory,
     batch 64: ``train_network`` runs 10 steps, 2 validation batches and
     the linear probes once, on in-memory structured probe sets of 4 800
     labelled cutouts each (``make_structured_cutouts``, ``lp_combine =
     central``; the pooled model probes its one 768-wide token); kernels 2,
     3, 8 at 12 x 10, K1 at 12 x (10 + 2 + 150 probe batches), K2 at 12 x
     (2 + 150); the probe's ms, ``val_lp_acc`` and ``val_lp_r2``.
   For each config, the kernel path against the plain path on the card from
   the same params and masks (MAE: the same noise): one step's loss and
   per-leaf gradients, and the losses of 5 steps; then train-step times
   (ViT-H also at B=256, ``bench_vit_h``'s batch; MAE at 1024), device busy
   share and peak memory;
5b. the ``Attention`` module (``models/layers.Attention``, the only caller of
   kernels 12 and 13, as in JAX) at ViT-B width, bf16, B=64: one forward and
   ``backward()`` through autograd with the counters zeroed just before,
   kernels 12 and 13 at one launch each and nothing else; its gradients
   against the plain path's;
6. times with CUDA events after warm-up: per kernel at its path's shapes,
   the encoder (with its device busy share), queries; torch.profiler
   device breakdowns.

Lines before the last: the nvidia-smi name/power line, one line per check,
JSON lines of results (``{"kernels": [...]}`` among them). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense): bf16 tensor-core, fp32 non-tensor, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

TOL_FWD = 2e-2          # tools/kernel_parity.py
TOL_BWD = 3e-2
TOL_SCORE_F32 = 5e-3
TOL_SCORE_BF16 = 2e-2
# kernel path vs plain path, encoder tokens after 12 layers (bf16): the two
# round at the same points, so they differ only by fp32 summation order and
# erff vs torch.erf; each rounding flip is one bf16 ulp (2^-8 relative)
TOL_TOKENS = 5e-2
# kernel path vs plain path, training (bf16, 12 layers): both round at the
# same points, so they differ by fp32 summation order and erff vs torch.erf,
# and the rounding flips compound through 12 layers forward and back.
# Gradients: ||a - b|| / ||b|| per parameter leaf; losses: |a - b| / |b|.
# Measured on the H100 (PERF.md): gradients 1.07e-2 at worst
# (patch_embed.proj.kernel; median 3.6e-3), one step's loss 1.2e-5, five
# steps' losses 1.75e-4. The bars are about twice those; an indexing,
# masking or layout fault in a backward gives O(1) errors.
TOL_GRAD = 2.5e-2
TOL_LOSS = 4e-4
# the same at ViT-L depth 24, where the flips compound through twice the
# layers. Measured on the H100 (PERF.md): mim_25_large gradients
# 9.4e-3 at worst (patch_embed.proj.kernel; median 4.1e-3), one step's loss
# 1.1e-6, five steps' losses 2.4e-4; mim_32 gradients 3.1e-2 at worst (the
# RA/Dec SIREN's first layer, whose sin(30 x) scales every flip by 30;
# median 5.3e-3), loss 3.8e-5, five steps 3.6e-4. The bars are about twice
# those, per config.
TOL_GRAD_L, TOL_LOSS_L = 2e-2, 5e-4
TOL_GRAD_R, TOL_LOSS_R = 6e-2, 8e-4
# ViT-H (depth 32, the RA/Dec token, stash off). Measured on the H100
# (PERF.md): gradients 2.2e-2 at worst (the RA/Dec SIREN's first layer;
# median 6.4e-3), one step's loss 2.3e-5, five steps' losses 2.3e-4. The
# bars are about twice those.
TOL_GRAD_H, TOL_LOSS_H = 4.5e-2, 5e-4
# MAE at ViT-B (bench_mae: 12 encoder and 8 decoder layers, batch 1024,
# the encoder packed). Measured on the H100 (PERF.md): gradients 2.1e-3 at
# worst (patch_embed.proj.kernel; median 6.5e-4), one step's loss 6.8e-7,
# five steps' losses 2.2e-5 (the batch of 1024 averages the flips out).
# The bars are about twice those.
TOL_GRAD_M, TOL_LOSS_M = 4.5e-3, 5e-5
# attn_pool (mim_1 with the pool, depth 12, batch 64): the same encoder
# kernels as mim_1, but the encoder's gradient all comes through the one
# pooled token. Measured on the H100 (PERF.md): gradients 2.8e-2 at worst
# (patch_embed.proj.kernel) and 2.1e-2 at the median, spread over every
# leaf rather than on one; one step's loss 3.5e-6, five steps' losses
# 4.4e-5. The bars are about twice those.
TOL_GRAD_P, TOL_LOSS_P = 6e-2, 1e-4
# kernels 12 and 13 in fp32 against their plain versions (TF32 off).
# Measured on the H100 (PERF.md): the forward bit-equal, the backward
# 2.1e-7 at worst (its sums run in another order); the bar is about twice.
TOL_CORE_F32 = 5e-7

CONFIG = "mim_1"
DEVICE = "cuda"
N_TOK, D, H, F = 65, 768, 12, 3072
BANK_ROWS = 1 << 20
N_BATCHES, BATCH = 32, 64
N_AUG, N_SAVE = 64, 300
TRAIN_STEPS, VAL_BATCHES, TRAJ_STEPS = 20, 4, 5
TRAIN_B = (64, 512, 63)  # the config's batch, a large one, a ragged one
# the ViT-L training paths: (config, steps, validation batches, kernel-parity
# batches: the config's, a large one, a ragged one); their shapes come from
# the configs (mim_25_large: N=65, D=768, H=16, F=3072; mim_32: the RA/Dec
# token makes N=66, D=1024, H=16, F=4096)
LARGE = ("mim_25_large", 10, 2, (64, 512, 63))
REMAT = ("mim_32", 10, 2, (32, 256, 31))
# the ViT-H training path: mim_32 with bench.py bench_vit_h's model
# (mimhuge: depth 32, D=1280, 16 heads of 80, F=5120; no remat; stash off at
# huge), built in memory; (name, steps, validation batches, kernel-parity
# batches, train-step batches with their timed iterations)
VITH = ("mim_32_vith", 10, 2, (32, 256, 31), ((32, 10), (256, 3)))
VITH_OVERRIDES = {"ARCHITECTURE": {"model_type": "mimhuge", "embed_dim": "1280"},
                  "TRAINING": {"remat": "False"}}
# the MAE training path: mim_1 with bench.py bench_mae's model (base: ViT-B
# encoder over 16 of 64 patches plus cls, n = 17 tokens, four samples packed
# to N = 68 sequences with seg_len = 17; the 512-wide, 8-deep decoder of 16
# heads over all 65 tokens with its attention stash), built in memory;
# (name, steps, validation batches, kernel-parity batches in packed
# sequences: bench_mae's 1024 images, a smaller one, a ragged one; the
# remat run's batch and steps; distinct synthetic batches, cycled; the
# train-step batches with their timed iterations)
MAE = ("mim_1_mae", 10, 2, (256, 64, 63), (256, 3), 4, ((1024, 5),))
MAE_OVERRIDES = {"ARCHITECTURE": {"model_type": "base"}, "TRAINING": {"batch_size": "1024"}}
MAE_SEG, MAE_PACK = 17, 4
# kernels 12 and 13: (label, B, N, D, H, dtype); the timed ones
CORE_CASES = ([("vitb", b, 65, 768, 12, "bfloat16") for b in (64, 1024, 63)]
              + [("vith", b, 66, 1280, 16, "bfloat16") for b in (32, 256, 31)]
              + [("mae_decoder", 1024, 65, 512, 16, "bfloat16"), ("n256", 16, 256, 768, 12, "bfloat16"),
                 ("vitb", 64, 65, 768, 12, "float32"), ("vith", 32, 66, 1280, 16, "float32")])
CORE_TIMED = (("vitb", 1024), ("vith", 256))
# the attn_pool training path: (name, steps, validation batches, probe-set
# size, train-step batches with their timed iterations)
POOL = ("mim_1_attn_pool", 10, 2, 4800, ((64, 10),))
POOL_OVERRIDES = {"ARCHITECTURE": {"attn_pool": "True"}}
# the retrieval path: a FITS survey of FITS_TILES tiles of FITS_SIZE^2 pixels
# per band, searched at FITS_OVERLAP for N_GROUPS target groups; kernel 11 at
# MULTI_Q queries on the 1M bank and at RAGGED (rows, width, queries); the
# chunked scorer in SLAB_ROWS-row slabs
FITS_TILES, FITS_SIZE, FITS_OVERLAP, N_GROUPS = 4, 1024, 0.4, 4
MULTI_Q = (1, 8, 64)
RAGGED = ((1_000_003, 3072, 130), (1_000_003, 37, 130))
SLAB_ROWS = 300_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sky_embeddings_tpu_torch.configuration import Config, load_config
    from sky_embeddings_tpu_torch.data.fits_io import TanWCS, write_image
    from sky_embeddings_tpu_torch.data.fits_loader import build_fits_batcher, overlap_coords
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, build_bank
    from sky_embeddings_tpu_torch.eval.eval_fns import batch_ra_dec, extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch, mim_simsearch_multi
    from sky_embeddings_tpu_torch.models.mim import build_mim_model
    from sky_embeddings_tpu_torch.eval.linear_probe import linear_probe
    from sky_embeddings_tpu_torch.models.layers import Attention
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build
    from sky_embeddings_tpu_torch.ops.kernels.attention import (
        attention_bwd_plain,
        attention_plain,
        fused_attention,
        fused_attention_bwd,
    )
    from sky_embeddings_tpu_torch.ops.kernels.attn_block import (
        _launch_fwd,
        attn_block_bwd,
        attn_block_bwd_plain,
        attn_block_bwd_stash,
        attn_block_bwd_stash_plain,
        attn_block_fwd_stash,
        attn_block_fwd_stash_plain,
        attn_block_plain,
        fused_attn_block,
    )
    from sky_embeddings_tpu_torch.ops.kernels.gemm import (
        bwd_plan_cuda,
        dual_plan,
        gemm,
        gemm_bwd,
        gemm_bwd_plain,
        gemm_dual,
        gemm_dual_plain,
        gemm_encode_us,
        gemm_plain,
        gemm_plan,
        mlp_bwd_groups,
        attn_bwd_groups,
        attn_weight_grads,
    )
    from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
        fused_mlp_block,
        mlp_block_bwd,
        mlp_block_bwd_plain,
        mlp_block_bwd_stash,
        mlp_block_bwd_stash_plain,
        mlp_block_bwd_stream,
        mlp_block_bwd_stream_plain,
        _stream_slab,
        mlp_block_fwd_stash,
        mlp_block_fwd_stash_plain,
        mlp_block_plain,
    )
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network
    from sky_embeddings_tpu_torch.ops.kernels.simscore import (
        bank_topk,
        bank_topk_chunked,
        bank_topk_int8,
        bank_topk_multi,
        bank_topk_multi_int8,
        weighted_bank_scores,
        weighted_bank_scores_multi,
        weighted_bank_scores_multi_plain,
        weighted_bank_scores_plain,
    )

    t_start = time.perf_counter()
    phase_s, t_mark = {}, [t_start]

    def mark(name):
        """Seconds since the previous mark, by phase, for the results line."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"ptxas[{name}] {fn}: {line.strip()}", flush=True)
    t_nvcc = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):  # Triton compiles once per bank dtype
        small = torch.randn(100, D, generator=gen, device=dev).to(dt)
        weighted_bank_scores(small, torch.ones(D, device=dev), torch.ones(D, device=dev))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"build: nvcc {t_nvcc:.1f} s, with Triton JIT {t_build:.1f} s", flush=True)
    build_s = {"nvcc": t_nvcc, "total": t_build}
    mark("device_and_build")

    # ---- 3. kernel parity ---------------------------------------------------
    def rel_err(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12), float((a - b).abs().max())

    def block_args(kind_, B, n=N_TOK, d=D, f=F):
        x = (torch.randn(B, n, d, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        bias = 0.1 * torch.randn(d, generator=gen, device=dev)
        (d_in, d_mid) = (d, 3 * d) if kind_ == "attn" else (d, f)
        (e_in, e_out) = (d, d) if kind_ == "attn" else (f, d)
        wa = (torch.randn(d_in, d_mid, generator=gen, device=dev) * d_in ** -0.5).to(torch.bfloat16)
        ba = 0.01 * torch.randn(d_mid, generator=gen, device=dev)
        wb = (torch.randn(e_in, e_out, generator=gen, device=dev) * e_in ** -0.5).to(torch.bfloat16)
        bb = 0.01 * torch.randn(e_out, generator=gen, device=dev)
        return x, scale, bias, wa, ba, wb, bb

    def cuda_ms(fn, iters, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    def attn_bound(B):
        M = B * N_TOK
        flops = 2 * M * D * 3 * D + 2 * M * D * D + 4 * B * H * N_TOK * N_TOK * (D // H)
        nbytes = 2 * M * D * 2 + (3 * D * D + D * D) * 2 + (2 * D + 3 * D + D) * 4
        return flops, nbytes

    def mlp_bound(B):
        M = B * N_TOK
        return 4 * M * D * F, 2 * M * D * 2 + 2 * D * F * 2 + (3 * D + F) * 4

    def bank_bound(elt):
        nbytes = BANK_ROWS * D * elt + BANK_ROWS * 4 + 2 * D * 4 + 4
        return 4 * BANK_ROWS * D, nbytes

    def bound_ms(flops, nbytes, peak):
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    timings: dict = {}
    for B in (64, 1024):
        for name, kern, plain, extra, bound in (
            ("attn_block_fwd", fused_attn_block, attn_block_plain, (H,), attn_bound),
            ("mlp_block_fwd", fused_mlp_block, mlp_block_plain, (), mlp_bound),
        ):
            args = block_args("attn" if name.startswith("attn") else "mlp", B)
            got = kern(*args, *extra)
            want = plain(*args, *extra)
            torch.cuda.synchronize()
            rel, abs_err = rel_err(got, want)
            print(f"parity {name} B={B}: max-rel {rel:.3e} (bar {TOL_FWD}), max-abs {abs_err:.3e}",
                  flush=True)
            check(rel <= TOL_FWD and torch.isfinite(got.float()).all().item(), f"{name} B={B} parity")
            iters = 50 if B == 64 else 10
            b_ms, b_by = bound_ms(*bound(B), PEAK_BF16)
            timings[(name, B)] = {
                "max_rel_err": rel, "max_abs_err": abs_err,
                "ms": cuda_ms(lambda: kern(*args, *extra), iters),
                "plain_ms": cuda_ms(lambda: plain(*args, *extra), iters),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            del args, got, want

    def device_ms(fn, reps):
        """Device time of one call of fn: the kernels it launches, summed by
        torch.profiler over reps calls, so the wrapper's host time (which
        outlasts a B=64 product) drops out; CUDA events if the profiler
        sees no device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        t = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False))
        return t / 1e3 / reps if t > 0 else cuda_ms(fn, reps)

    # the forward GEMM of K1 and K2 alone (csrc/gemm_sm90.cuh, through its
    # test entry) at the four products with their epilogues, held to the
    # plain version and timed beside cuBLAS: torch.addmm on the same
    # operands (bias, no residual), the yardstick, which the port never
    # calls; device time from the profiler, the events' time beside it
    gemm_times = {}
    for B in (64, 1024):
        M = B * N_TOK
        for prod, K_, N_, epi in (("qkv", D, 3 * D, "bias"), ("proj", D, D, "bias_residual"),
                                  ("fc1", D, F, "bias_gelu"), ("fc2", F, D, "bias_residual")):
            a = torch.randn(M, K_, generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn(K_, N_, generator=gen, device=dev) * K_ ** -0.5).to(torch.bfloat16)
            b_ = 0.01 * torch.randn(N_, generator=gen, device=dev)
            r_ = (torch.randn(M, N_, generator=gen, device=dev).to(torch.bfloat16)
                  if epi == "bias_residual" else None)
            rel, abs_err = rel_err(gemm(a, w, b_, epi, r_)[0], gemm_plain(a, w, b_, epi, r_)[0])
            check(rel <= TOL_FWD, f"sm90 GEMM {prod} B={B} parity")
            iters = 50 if B == 64 else 10
            b_bf16 = b_.to(torch.bfloat16)
            run, lib = lambda: gemm(a, w, b_, epi, r_), lambda: torch.addmm(b_bf16, a, w)
            ms, lib_ms = device_ms(run, iters), device_ms(lib, iters)
            tflop = 2 * M * K_ * N_ / 1e12
            plan = gemm_plan(M, N_)
            gemm_times[f"{prod} B={B}"] = {
                "M": M, "N": N_, "K": K_, "epilogue": epi, "bn": plan.bn, "stages": plan.stages,
                "tiles": plan.tiles, "max_rel_err": rel, "ms": ms, "tflops": tflop / ms * 1e3,
                "events_ms": cuda_ms(run, iters), "library_ms": lib_ms,
                "library_tflops": tflop / lib_ms * 1e3, "library_events_ms": cuda_ms(lib, iters),
                "ms_over_library": ms / lib_ms,
            }
            print(f"sm90 GEMM {prod} B={B} (M={M}, N={N_}, K={K_}, {epi}, BN={plan.bn}, "
                  f"{plan.tiles} tiles): {ms:.4f} ms, {tflop / ms * 1e3:.0f} TFLOP/s; addmm "
                  f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x); max-rel {rel:.2e}", flush=True)
            del a, w, b_, r_
    big_a = torch.empty(64 * N_TOK, D, device=dev, dtype=torch.bfloat16)
    gemm_times["tma_encode_us_per_launch"] = gemm_encode_us(
        big_a, torch.empty(D, F, device=dev, dtype=torch.bfloat16),
        torch.empty(64 * N_TOK, F, device=dev, dtype=torch.bfloat16))
    del big_a
    mark("forward_gemm")

    # the backward products of kernels 8 and 9 alone (csrc/gemm_sm90.cuh's
    # dual product and K-major-B / transposed-A forms, through their test
    # entries) at mim_1 B=64 and 512 and at one ViT-H slab (B=32, D=1280, fs
    # = 1280), each held to its plain version and timed beside torch.mm on
    # the same operand views (the yardstick; the port never calls it):
    # dual = a = y @ W1 + b1 with dh = g @ W2^T (beside them, dh alone on the
    # K-major-B form and the forward fc1 product: their sum bounds a
    # two-launch form from below); dy = da_c @ W1^T in fp32; dW1 = y^T @ da_c,
    # dW2 = h_c^T @ g in bf16 with the plan's split; and one kernel 8 call's
    # device time by kernel name
    def device_by_kernel(fn, reps):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") and not getattr(
                    e, "is_user_annotation", False):
                t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                out[e.key[:60]] = out.get(e.key[:60], 0.0) + t / 1e3 / reps
        return out

    bwd_gemm_times = {}
    f_vith = 4 * 1280
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, B, n_, d_, f_, fs_ in (("mim_1 B=64", 64, N_TOK, D, F, F),
                                      ("mim_1 B=512", 512, N_TOK, D, F, F),
                                      ("vith slab B=32", 32, N_TOK + 1, 1280, f_vith,
                                       _stream_slab(1280, f_vith))):
        M = B * n_
        bf = torch.bfloat16
        y_ = torch.randn(M, d_, generator=gen, device=dev).to(bf)
        g_ = (0.1 * torch.randn(M, d_, generator=gen, device=dev)).to(bf)
        w1_ = (torch.randn(d_, fs_, generator=gen, device=dev) * d_ ** -0.5).to(bf)
        w2_ = (torch.randn(fs_, d_, generator=gen, device=dev) * fs_ ** -0.5).to(bf)
        b1_ = 0.01 * torch.randn(fs_, generator=gen, device=dev)
        da_c_, h_c_, db1_ = gemm_dual(y_, w1_, b1_, g_, w2_)
        want = gemm_dual_plain(y_, w1_, b1_, g_, w2_)
        errs = [rel_err(a_, b_)[0] for a_, b_ in zip((da_c_, h_c_, db1_), want)]
        check(max(errs) <= TOL_BWD, f"sm90 dual product {label} parity")
        iters = 20 if M < 10000 else 5
        rec = {"M": M, "D": d_, "F_slab": fs_, "dual_plan": dual_plan(M, fs_),
               "group_plans": [vars(bwd_plan_cuda(gr, sms)[0])
                               for gr in mlp_bwd_groups(M, d_, fs_)],
               "max_rel_err": {}}
        rec["max_rel_err"]["dual"] = max(errs)
        fl = 2 * M * d_ * fs_ / 1e9  # GFLOP of one product (the dual does two)
        w1t, w2t = w1_.t(), w2_.t()
        prods = {
            "dual": (2 * fl, lambda: gemm_dual(y_, w1_, b1_, g_, w2_),
                     lambda: (torch.addmm(b1_.to(bf), y_, w1_), torch.mm(g_, w2t)), None),
            "dh": (fl, lambda: gemm_bwd(g_, w2_, "nt", "store_f32"),
                   lambda: torch.mm(g_, w2t), (g_, w2_, "nt", "store_f32")),
            "fc1_fwd": (fl, lambda: gemm(y_, w1_, b1_, "bias"),
                        lambda: torch.addmm(b1_.to(bf), y_, w1_), None),
            "dy": (fl, lambda: gemm_bwd(da_c_, w1_, "nt", "store_f32"),
                   lambda: torch.mm(da_c_, w1t), None),
            "dy_bf16": (fl, lambda: gemm_bwd(da_c_, w1_, "nt", "store"),
                        lambda: torch.mm(da_c_, w1t), None),
            "dW1": (fl, lambda: gemm_bwd(y_, da_c_, "tn", "store"),
                    lambda: torch.mm(y_.t(), da_c_), (y_, da_c_, "tn", "store")),
            "dW2": (fl, lambda: gemm_bwd(h_c_, g_, "tn", "store"),
                    lambda: torch.mm(h_c_.t(), g_), (h_c_, g_, "tn", "store")),
        }
        for name, (gflop, run, lib, par) in prods.items():
            if par is not None:
                rel = rel_err(gemm_bwd(*par), gemm_bwd_plain(*par))[0]
                check(rel <= TOL_BWD, f"sm90 {name} {label} parity")
                rec["max_rel_err"][name] = rel
            ms, lib_ms = device_ms(run, iters), device_ms(lib, iters)
            rec[name] = {"ms": ms, "tflops": gflop / ms, "torch_mm_ms": lib_ms,
                         "torch_mm_tflops": gflop / lib_ms, "ms_over_torch_mm": ms / lib_ms}
            print(f"sm90 bwd {name} {label} (M={M}, D={d_}, F={fs_}): {ms:.4f} ms, "
                  f"{gflop / ms:.0f} TFLOP/s; torch.mm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)",
                  flush=True)
        rec["two_launch_lower_bound_ms"] = rec["dh"]["ms"] + rec["fc1_fwd"]["ms"]
        x_ = (torch.randn(B, n_, d_, generator=gen, device=dev) * 0.5).to(bf)
        s_ = 1.0 + 0.1 * torch.randn(d_, generator=gen, device=dev)
        c_ = 0.1 * torch.randn(d_, generator=gen, device=dev)
        gb = g_.reshape(B, n_, d_)
        if fs_ == f_:
            rec["kernel8_by_kernel_ms"] = device_by_kernel(
                lambda: mlp_block_bwd(x_, s_, c_, w1_, b1_, w2_, gb), iters)
        else:
            w1f = (torch.randn(d_, f_, generator=gen, device=dev) * d_ ** -0.5).to(bf)
            w2f = (torch.randn(f_, d_, generator=gen, device=dev) * f_ ** -0.5).to(bf)
            b1f = 0.01 * torch.randn(f_, generator=gen, device=dev)
            rec["kernel9_by_kernel_ms"] = device_by_kernel(
                lambda: mlp_block_bwd_stream(x_, s_, c_, w1f, b1f, w2f, gb), iters)
            del w1f, w2f, b1f
        bwd_gemm_times[label] = rec
        del y_, g_, w1_, w2_, b1_, da_c_, h_c_, db1_, want, x_, prods
    torch.cuda.empty_cache()

    mark("mlp_backward_products")

    # the products of kernels 3 and 4 alone (the same GEMM's forward,
    # K-major-B and transposed-A forms, through their test entries) at mim_1
    # B=64 and 512 and at ViT-H B=256, each held to its plain version and
    # timed beside torch.addmm / torch.mm on the same operand views (the
    # yardstick; the port never calls it): kernel 4's qkv recompute y @ Wqkv
    # + bqkv, dctx = g @ Wproj^T rounded to bf16, dy = dqkv_c @ Wqkv^T in
    # fp32, and dWqkv = y^T @ dqkv_c with dWproj = ctx^T @ g in one group
    # launch; then one kernel 3 and one kernel 4 call's device time by kernel
    for label, B, n_, d_, h_ in (("mim_1 B=64", 64, N_TOK, D, H),
                                 ("mim_1 B=512", 512, N_TOK, D, H),
                                 ("vith B=256", 256, N_TOK + 1, 1280, 16)):
        M = B * n_
        bf = torch.bfloat16
        x_, s_, c_, wq_, bq_, wp_, bp_ = block_args("attn", B, n_, d_)
        g_ = (0.1 * torch.randn(B, n_, d_, generator=gen, device=dev)).to(bf)
        g2 = g_.reshape(M, d_)
        y_ = torch.randn(M, d_, generator=gen, device=dev).to(bf)
        ctx_ = torch.randn(M, d_, generator=gen, device=dev).to(bf)
        dq_ = (0.1 * torch.randn(M, 3 * d_, generator=gen, device=dev)).to(bf)
        iters = 10 if M < 10000 else 3
        rec = {"M": M, "D": d_, "qkv_plan": vars(gemm_plan(M, 3 * d_)),
               "group_plans": [vars(bwd_plan_cuda(gr, sms)[0]) for gr in attn_bwd_groups(M, d_)],
               "max_rel_err": {}}
        fl = 2 * M * d_ * d_ / 1e9  # GFLOP of a (M, D) x (D, D) product
        bq16, wpt, wqt = bq_.to(bf), wp_.t(), wq_.t()
        prods = {  # name: (GFLOP, kernel, library, (kernel output, plain output) pairs)
            "qkv": (3 * fl, lambda: gemm(y_, wq_, bq_, "bias"), lambda: torch.addmm(bq16, y_, wq_),
                    lambda: [(gemm(y_, wq_, bq_, "bias")[0], gemm_plain(y_, wq_, bq_, "bias")[0])]),
            "dctx": (fl, lambda: gemm_bwd(g2, wp_, "nt", "store"), lambda: torch.mm(g2, wpt),
                     lambda: [(gemm_bwd(g2, wp_, "nt", "store"), gemm_bwd_plain(g2, wp_, "nt", "store"))]),
            "dy": (3 * fl, lambda: gemm_bwd(dq_, wq_, "nt", "store_f32"), lambda: torch.mm(dq_, wqt),
                   lambda: [(gemm_bwd(dq_, wq_, "nt", "store_f32"),
                             gemm_bwd_plain(dq_, wq_, "nt", "store_f32"))]),
            "dW": (4 * fl, lambda: attn_weight_grads(y_, dq_, ctx_, g2),
                   lambda: (torch.mm(y_.t(), dq_), torch.mm(ctx_.t(), g2)),
                   lambda: list(zip(attn_weight_grads(y_, dq_, ctx_, g2),
                                    (gemm_bwd_plain(y_, dq_, "tn", "store"),
                                     gemm_bwd_plain(ctx_, g2, "tn", "store"))))),
        }
        for name, (gflop, run, lib, pairs) in prods.items():
            rel = max(rel_err(a_, b_)[0] for a_, b_ in pairs())
            check(rel <= TOL_BWD, f"sm90 attention {name} {label} parity")
            rec["max_rel_err"][name] = rel
            ms, lib_ms = device_ms(run, iters), device_ms(lib, iters)
            rec[name] = {"ms": ms, "tflops": gflop / ms, "torch_mm_ms": lib_ms,
                         "torch_mm_tflops": gflop / lib_ms, "ms_over_torch_mm": ms / lib_ms}
            print(f"sm90 attention bwd {name} {label} (M={M}, D={d_}): {ms:.4f} ms, "
                  f"{gflop / ms:.0f} TFLOP/s; torch.mm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)",
                  flush=True)
        _, qkv_s, probs_s = attn_block_fwd_stash(x_, s_, c_, wq_, bq_, wp_, bp_, h_)
        rec["kernel3_by_kernel_ms"] = device_by_kernel(
            lambda: attn_block_bwd_stash(x_, s_, c_, wq_, wp_, qkv_s, probs_s, g_, h_), iters)
        rec["kernel4_by_kernel_ms"] = device_by_kernel(
            lambda: attn_block_bwd(x_, s_, c_, wq_, bq_, wp_, g_, h_), iters)
        bwd_gemm_times["attention " + label] = rec
        del x_, g_, g2, y_, ctx_, dq_, qkv_s, probs_s, prods
    torch.cuda.empty_cache()

    mark("attention_backward_products")

    target = torch.randn(D, generator=gen, device=dev)
    weights = torch.rand(D, generator=gen, device=dev) + 0.5
    weights = weights / weights.sum()
    bank_bf16 = torch.randn(BANK_ROWS, D, generator=gen, device=dev).to(torch.bfloat16)
    for dt, tol in ((torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_SCORE_BF16)):
        bank = bank_bf16.to(dt)
        got = weighted_bank_scores(bank, target, weights)
        want = weighted_bank_scores_plain(bank, target, weights)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, want)
        tag = str(dt).replace("torch.", "")
        print(f"parity weighted_bank_scores {tag} {BANK_ROWS}x{D}: max-rel {rel:.3e} (bar {tol}), "
              f"max-abs {abs_err:.3e}", flush=True)
        check(rel <= tol and torch.isfinite(got).all().item(), f"bank scores {tag} parity")
        b_ms, b_by = bound_ms(*bank_bound(bank.element_size()), PEAK_FP32)
        timings[("weighted_bank_scores", tag)] = {
            "max_rel_err": rel, "max_abs_err": abs_err,
            "ms": cuda_ms(lambda: weighted_bank_scores(bank, target, weights), 20),
            "plain_ms": cuda_ms(lambda: weighted_bank_scores_plain(bank, target, weights), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        del bank, got, want

    # kernel 11 on the same 1M bank at Q = 1, 8, 64 (timed at 8 and 64 on the
    # bf16 bank: the retrieval path's Q and a wide batch of targets), then on
    # ragged banks: 1 000 003 rows (not a whole number of 128-row blocks) of
    # width 3072 (central-pool banks) and 37 (the scalar loads) at Q = 130
    def multi_bound(n, d, q, elt):
        return 4 * n * d * q, n * d * elt + 2 * q * d * 4 + q * 4 + n * q * 4

    def multi_case(bank, targets, w, tol, label, timed):
        n, d = bank.shape
        got = weighted_bank_scores_multi(bank, targets, w)
        want = weighted_bank_scores_multi_plain(bank, targets, w)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, want)
        finite = bool(torch.isfinite(got).all())
        print(f"parity weighted_bank_scores_multi {label} {n}x{d} Q={targets.shape[0]}: max-rel "
              f"{rel:.3e} (bar {tol}), max-abs {abs_err:.3e}, finite {finite}", flush=True)
        check(finite and rel <= tol and got.shape == (n, targets.shape[0]),
              f"kernel 11 {label} {n}x{d} Q={targets.shape[0]} parity")
        del got, want
        if timed:
            b_ms, b_by = bound_ms(*multi_bound(n, d, targets.shape[0], bank.element_size()),
                                  PEAK_FP32)
            timings[("weighted_bank_scores_multi", targets.shape[0])] = {
                "max_rel_err": rel, "max_abs_err": abs_err,
                "ms": cuda_ms(lambda: weighted_bank_scores_multi(bank, targets, w), 10),
                "plain_ms": cuda_ms(lambda: weighted_bank_scores_multi_plain(bank, targets, w), 3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }

    def multi_queries(q, d):
        targets = torch.randn(q, d, generator=gen, device=dev)
        w = torch.rand(q, d, generator=gen, device=dev) + 0.5
        return targets, w / w.sum(dim=1, keepdim=True)

    mq_targets, mq_w = multi_queries(max(MULTI_Q), D)
    for dt, tol in ((torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_SCORE_BF16)):
        bank = bank_bf16.to(dt)
        for q in MULTI_Q:
            multi_case(bank, mq_targets[:q], mq_w[:q], tol, str(dt).replace("torch.", ""),
                       timed=dt == torch.bfloat16 and q > 1)
        del bank
    for n, d, q in RAGGED:
        rag_bank = torch.randn(n, d, generator=gen, device=dev)
        targets, w = multi_queries(q, d)
        for dt, tol in ((torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_SCORE_BF16)):
            multi_case(rag_bank.to(dt), targets, w, tol, str(dt).replace("torch.", ""), False)
        del rag_bank
    torch.cuda.empty_cache()

    mark("bank_scorers")

    # training kernels at mim_1 training shapes: kernel vs plain version on
    # every output. The stash backward takes the plain stash forward's qkv
    # and probs, so both versions see the same inputs.
    def train_bounds(B):
        M, hd = B * N_TOK, D // H
        core = B * H * N_TOK * N_TOK * hd
        w_attn, w_mlp = 4 * D * D * 2, 2 * D * F * 2
        return {
            "attn_block_fwd_stash": (8 * M * D * D + 4 * core,
                                     2 * M * D * 2 + w_attn + 6 * D * 4 + M * 3 * D * 2
                                     + B * H * N_TOK * N_TOK * 2),
            "attn_block_bwd_stash": (16 * M * D * D + 10 * core,
                                     2 * M * D * 2 + M * 3 * D * 2 + B * H * N_TOK * N_TOK * 2
                                     + 2 * w_attn + (2 * D + 6 * D) * 4 + M * D * 2),
            "mlp_block_bwd": (10 * M * D * F,
                              3 * M * D * 2 + 2 * w_mlp + (2 * D + F) * 4 + (3 * D + F) * 4),
        }

    def run_cases(cases, B, bounds, timed):
        for name, kern, plain, args, outs in cases:
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            errs = {o: rel_err(a, b) for o, a, b in zip(outs, got, want)}
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            worst = max(r for r, _ in errs.values())
            print(f"parity {name} B={B}: max-rel per output "
                  + ", ".join(f"{o} {r:.2e}" for o, (r, _) in errs.items())
                  + f" (bar {TOL_BWD}), finite {finite}", flush=True)
            check(finite and worst <= TOL_BWD, f"{name} B={B} parity")
            if timed:
                iters = 20 if B <= 64 else 5
                b_ms, b_by = bound_ms(*bounds[name], PEAK_BF16)
                timings[(name, B)] = {
                    "max_rel_err": worst, "max_abs_err": max(a for _, a in errs.values()),
                    "ms": cuda_ms(lambda: kern(*args), iters),
                    "plain_ms": cuda_ms(lambda: plain(*args), max(iters // 4, 2)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                }
            del got, want

    grads_attn = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")
    grads_mlp = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for B in TRAIN_B:
        x, scale, bias, wq, bq, wp, bp = block_args("attn", B)
        x1, s1, b1_, w1, bb1, w2, _ = block_args("mlp", B)
        g = (torch.randn(B, N_TOK, D, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        _, qkv_p, probs_p = attn_block_fwd_stash_plain(x, scale, bias, wq, bq, wp, bp, H)
        cases = (
            ("attn_block_fwd_stash", attn_block_fwd_stash, attn_block_fwd_stash_plain,
             (x, scale, bias, wq, bq, wp, bp, H), ("out", "qkv", "probs")),
            ("attn_block_bwd_stash", attn_block_bwd_stash, attn_block_bwd_stash_plain,
             (x, scale, bias, wq, wp, qkv_p, probs_p, g, H), grads_attn),
            ("mlp_block_bwd", mlp_block_bwd, mlp_block_bwd_plain, (x1, s1, b1_, w1, bb1, w2, g),
             grads_mlp),
        )
        run_cases(cases, B, train_bounds(B), B != 63)
        del x, qkv_p, probs_p, g, cases, x1

    mark("training_kernels_mim_1")

    # the ViT-L paths' kernels at their configs' shapes: the MLP stash
    # forward and backward (mim_25_large), the attention recompute backward
    # (mim_32). The stash backward takes the plain stash forward's a.
    def vitl_bounds(B, n, d, h, f):
        M, hd = B * n, d // h
        return {
            "mlp_block_fwd_stash": (4 * M * d * f,
                                    2 * M * d * 2 + M * f * 2 + 2 * d * f * 2 + (3 * d + f) * 4),
            "mlp_block_bwd_stash": (8 * M * d * f,
                                    3 * M * d * 2 + M * f * 2 + 4 * d * f * 2 + (5 * d + f) * 4),
            "attn_block_bwd": (22 * M * d * d + 12 * B * h * n * n * hd,
                               3 * M * d * 2 + 8 * d * d * 2 + (5 * d + 6 * d) * 4),
        }

    cfg_l, cfg_r = (load_config(c[0], os.path.join(ROOT, "configs")) for c in (LARGE, REMAT))
    shape_l = (N_TOK, cfg_l.architecture.int("embed_dim"), 16)
    shape_r = (N_TOK + 1, cfg_r.architecture.int("embed_dim"), 16)  # + the RA/Dec token
    for B in LARGE[3]:
        n, d, h = shape_l
        x, s_, b_, w1, bb1, w2, bb2 = block_args("mlp", B, n, d, 4 * d)
        g = (torch.randn(B, n, d, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        _, a_p = mlp_block_fwd_stash_plain(x, s_, b_, w1, bb1, w2, bb2)
        cases = (
            ("mlp_block_fwd_stash", mlp_block_fwd_stash, mlp_block_fwd_stash_plain,
             (x, s_, b_, w1, bb1, w2, bb2), ("out", "a")),
            ("mlp_block_bwd_stash", mlp_block_bwd_stash, mlp_block_bwd_stash_plain,
             (x, s_, b_, w1, w2, a_p, g), grads_mlp),
        )
        run_cases(cases, B, vitl_bounds(B, n, d, h, 4 * d), B != LARGE[3][-1])
        del x, g, a_p, cases
    for B in REMAT[3]:
        n, d, h = shape_r
        x, s_, b_, wq, bq, wp, _ = block_args("attn", B, n, d)
        g = (torch.randn(B, n, d, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        cases = (("attn_block_bwd", attn_block_bwd, attn_block_bwd_plain,
                  (x, s_, b_, wq, bq, wp, g, h), grads_attn),)
        run_cases(cases, B, vitl_bounds(B, n, d, h, 4 * d), B != REMAT[3][-1])
        del x, g, cases
    torch.cuda.empty_cache()

    mark("training_kernels_vitl")

    # the ViT-H path's kernels at its shapes (N=66 with the RA/Dec token,
    # D=1280, 16 heads of 80, F=5120): kernel 9 (four slabs of 1280) against
    # its plain version and against kernel 8, which differs from it only in
    # the order of fp32 sums; K2 and kernel 4 at hd = 80, and at N = 256
    # (the largest N, where the shared-memory plans are tightest)
    d_h = {sec: dict(cfg_r[sec].items()) for sec in cfg_r.sections()}
    for sec, over in VITH_OVERRIDES.items():
        d_h[sec].update(over)
    cfg_h = Config.from_dict(d_h, name=VITH[0])
    n_h, dm_h, h_h = N_TOK + 1, cfg_h.architecture.int("embed_dim"), 16
    f_h = 4 * dm_h

    def vith_bounds(B, n):
        M, hd = B * n, dm_h // h_h
        return {
            "mlp_block_bwd_stream": (10 * M * dm_h * f_h, 3 * M * dm_h * 2 + 4 * dm_h * f_h * 2
                                     + (2 * dm_h + f_h) * 4 + (3 * dm_h + f_h) * 4),
            "attn_block_fwd_hd80": (8 * M * dm_h * dm_h + 4 * B * h_h * n * n * hd,
                                    2 * M * dm_h * 2 + 4 * dm_h * dm_h * 2 + 6 * dm_h * 4),
            "attn_block_bwd_hd80": vitl_bounds(B, n, dm_h, h_h, f_h)["attn_block_bwd"],
        }

    stream_gap = {}
    for B in VITH[3]:
        args = block_args("mlp", B, n_h, dm_h, f_h)[:6]
        g = (torch.randn(B, n_h, dm_h, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        args = (*args, g)
        cases = (("mlp_block_bwd_stream", mlp_block_bwd_stream, mlp_block_bwd_stream_plain, args,
                  grads_mlp),)
        run_cases(cases, B, vith_bounds(B, n_h), B != VITH[3][-1])
        got, k8 = mlp_block_bwd_stream(*args), mlp_block_bwd(*args)
        torch.cuda.synchronize()
        gap = {o: rel_err(a, b)[0] for o, a, b in zip(grads_mlp, got, k8)}
        stream_gap[B] = gap
        print(f"kernel 9 vs kernel 8 B={B}: max-rel per output "
              + ", ".join(f"{o} {r:.2e}" for o, r in gap.items()) + f" (bar {TOL_BWD})", flush=True)
        check(max(gap.values()) <= TOL_BWD, f"kernel 9 vs kernel 8 B={B}")
        if B == VITH[3][0]:  # kernel 8 at the same shapes, for the table's note
            timings[("mlp_block_bwd", "vith32")] = {"ms": cuda_ms(lambda: mlp_block_bwd(*args), 20)}
        del args, g, got, k8, cases
    for B, n in [(b, n_h) for b in VITH[3]] + [(8, 256)]:
        x, s_, b_, wq, bq, wp, bp = block_args("attn", B, n, dm_h)
        g = (torch.randn(B, n, dm_h, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        cases = (("attn_block_fwd_hd80", lambda *a: (fused_attn_block(*a),),
                  lambda *a: (attn_block_plain(*a),), (x, s_, b_, wq, bq, wp, bp, h_h), ("out",)),
                 ("attn_block_bwd_hd80", attn_block_bwd, attn_block_bwd_plain,
                  (x, s_, b_, wq, bq, wp, g, h_h), grads_attn))
        run_cases(cases, B if n == n_h else f"{B} N={n}", vith_bounds(B, n),
                  n == n_h and B != VITH[3][-1])
        del x, g, cases
    torch.cuda.empty_cache()

    mark("training_kernels_vith")

    # the MAE path's kernels (bench_mae: four samples of n = 17 tokens packed
    # to N = 68, seg_len = 17, D = 768, 12 heads): K2, kernel 2 and kernel 4
    # masked, and kernel 3 from the packed stash (it takes no mask), against
    # their plain versions at B = 256 packed sequences (bench_mae's 1024
    # images), 64 and the ragged 63; each masked kernel's output against the
    # unmasked kernel's on the same samples, one to a sequence, the gap
    # printed; K2 and kernels 2-4 at maesimple's decoder head of 512 (N = 65)
    n_mae = MAE_SEG * MAE_PACK

    def mae_bounds(B):
        # the attention core needs only each sample's block: B H N seg hd
        M, hd = B * n_mae, D // H
        core = B * H * n_mae * MAE_SEG * hd
        probs = B * H * n_mae * n_mae * 2
        return {
            "attn_block_fwd_seg": (8 * M * D * D + 4 * core, 2 * M * D * 2 + 4 * D * D * 2 + 6 * D * 4),
            "attn_block_fwd_stash_seg": (8 * M * D * D + 4 * core, 2 * M * D * 2 + 4 * D * D * 2
                                         + 6 * D * 4 + M * 3 * D * 2 + probs),
            "attn_block_bwd_seg": (22 * M * D * D + 12 * core,
                                   3 * M * D * 2 + 8 * D * D * 2 + 11 * D * 4),
            "attn_block_bwd_stash_packed": (16 * M * D * D + 10 * core,
                                            2 * M * D * 2 + M * 3 * D * 2 + probs + 8 * D * D * 2
                                            + 8 * D * 4 + M * D * 2),
        }

    def seg_fwd(*a):
        return (fused_attn_block(*a[:8], seg_len=a[8]),)

    pack_gap = {}
    for B in MAE[3]:
        x, s_, b_, wq, bq, wp, bp = block_args("attn", B, n_mae)
        g = (torch.randn(B, n_mae, D, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        fwd_args = (x, s_, b_, wq, bq, wp, bp, H, MAE_SEG)
        _, qkv_s, probs_s = attn_block_fwd_stash_plain(*fwd_args)
        cases = (
            ("attn_block_fwd_seg", seg_fwd, lambda *a: (attn_block_plain(*a),), fwd_args, ("out",)),
            ("attn_block_fwd_stash_seg", attn_block_fwd_stash, attn_block_fwd_stash_plain, fwd_args,
             ("out", "qkv", "probs")),
            ("attn_block_bwd_seg", attn_block_bwd, attn_block_bwd_plain,
             (x, s_, b_, wq, bq, wp, g, H, MAE_SEG), grads_attn),
            ("attn_block_bwd_stash_packed", attn_block_bwd_stash, attn_block_bwd_stash_plain,
             (x, s_, b_, wq, wp, qkv_s, probs_s, g, H), grads_attn),
        )
        run_cases(cases, B, mae_bounds(B), B == MAE[3][0])
        # the same samples one to a sequence through the unmasked kernels
        Bu = B * MAE_PACK
        xu, gu = x.reshape(Bu, MAE_SEG, D), g.reshape(Bu, MAE_SEG, D)
        w_ = (s_, b_, wq, bq, wp, bp)
        out_p, qkv_p, probs_p = attn_block_fwd_stash(*fwd_args)
        out_u, qkv_u, probs_u = attn_block_fwd_stash(xu, *w_, H)
        diag = torch.stack([probs_p[:, :, i * MAE_SEG:(i + 1) * MAE_SEG, i * MAE_SEG:(i + 1) * MAE_SEG]
                            for i in range(MAE_PACK)], 1).reshape(Bu, H, MAE_SEG, MAE_SEG)
        gap = {"K2 out": rel_err(fused_attn_block(*fwd_args[:8], seg_len=MAE_SEG).reshape(Bu, MAE_SEG, D),
                                 fused_attn_block(xu, *w_, H))[0],
               "kernel 2 out": rel_err(out_p.reshape(Bu, MAE_SEG, D), out_u)[0],
               "kernel 2 qkv": rel_err(qkv_p.reshape(Bu, MAE_SEG, 3 * D), qkv_u)[0],
               "kernel 2 probs": rel_err(diag, probs_u)[0]}
        got_p = attn_block_bwd(x, s_, b_, wq, bq, wp, g, H, MAE_SEG)
        got_u = attn_block_bwd(xu, s_, b_, wq, bq, wp, gu, H)
        gap.update({f"kernel 4 {o}": rel_err(a.reshape(b.shape), b)[0]
                    for o, a, b in zip(grads_attn, got_p, got_u)})
        pack_gap[B] = gap
        print(f"packed (seg_len {MAE_SEG}, B={B} sequences) vs unpacked (B={Bu}, N={MAE_SEG}): max-rel "
              + ", ".join(f"{k} {v:.2e}" for k, v in gap.items()) + f" (bars {TOL_FWD} / {TOL_BWD})",
              flush=True)
        check(max(v for k, v in gap.items() if not k.startswith("kernel 4")) <= TOL_FWD
              and max(v for k, v in gap.items() if k.startswith("kernel 4")) <= TOL_BWD,
              f"packed against unpacked B={B}")
        if B == MAE[3][0]:  # the unmasked kernels at the unpacked shape, for PERF.md
            timings[("mae_unpacked", Bu)] = {
                "attn_block_fwd_ms": cuda_ms(lambda: fused_attn_block(xu, *w_, H), 5),
                "attn_block_fwd_stash_ms": cuda_ms(lambda: attn_block_fwd_stash(xu, *w_, H), 5),
                "attn_block_bwd_ms": cuda_ms(lambda: attn_block_bwd(xu, s_, b_, wq, bq, wp, gu, H), 5),
            }
        del x, g, xu, gu, cases, qkv_s, probs_s, out_p, qkv_p, probs_p, out_u, qkv_u, probs_u, got_p, got_u
    # maesimple's decoder: one head of 512 at N = 65, query blocks of 16 rows
    x, s_, b_, wq, bq, wp, bp = block_args("attn", 64, N_TOK, 512)
    g = (torch.randn(64, N_TOK, 512, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    _, qkv_s, probs_s = attn_block_fwd_stash_plain(x, s_, b_, wq, bq, wp, bp, 1)
    cases = (("attn_block_fwd_hd512", lambda *a: (fused_attn_block(*a),), lambda *a: (attn_block_plain(*a),),
              (x, s_, b_, wq, bq, wp, bp, 1), ("out",)),
             ("attn_block_fwd_stash_hd512", attn_block_fwd_stash, attn_block_fwd_stash_plain,
              (x, s_, b_, wq, bq, wp, bp, 1), ("out", "qkv", "probs")),
             ("attn_block_bwd_stash_hd512", attn_block_bwd_stash, attn_block_bwd_stash_plain,
              (x, s_, b_, wq, wp, qkv_s, probs_s, g, 1), grads_attn),
             ("attn_block_bwd_hd512", attn_block_bwd, attn_block_bwd_plain,
              (x, s_, b_, wq, bq, wp, g, 1), grads_attn))
    run_cases(cases, "64 N=65 hd=512", {}, False)
    del x, g, qkv_s, probs_s, cases
    torch.cuda.empty_cache()

    mark("training_kernels_mae")

    # kernels 12 and 13 (the attention core behind layers.Attention), each
    # against its plain version at the training paths' head geometries: bf16
    # at TOL_FWD / TOL_BWD, fp32 (TF32 off) at TOL_CORE_F32; timed at ViT-B
    # B=1024 and ViT-H B=256 beside F.scaled_dot_product_attention on the
    # same (B, H, N, hd) views, forward and forward + backward (the library
    # column; the port never calls it)
    def core_bound(B, n, d, h, elt, backward):
        flops = (10 if backward else 4) * B * h * n * n * (d // h)
        return flops, (7 if backward else 4) * B * n * d * elt

    def core_record(name, tag, kern, plain, err, work, lib, lib_name, dt):
        """One timing record of kernel 12 or 13 beside its plain version and
        SDPA (``lib``), with its share of the bound and the bytes it must
        move per ms of its time."""
        iters = 20
        flops, nbytes = work
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32)
        k_ms = cuda_ms(kern, iters)
        timings[(name, tag)] = {
            "max_rel_err": err[0], "max_abs_err": err[1],
            "ms": k_ms, "plain_ms": cuda_ms(plain, 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, iters),
            "library": lib_name, "bound_share": b_ms / k_ms, "bytes_per_ms": nbytes / k_ms,
        }

    core_gap, same_bwd = {}, None
    for label, B, n, d, h, dt_name in CORE_CASES:
        dt = getattr(torch, dt_name)
        qkv = torch.randn(B, n, 3 * d, generator=gen, device=dev).to(dt)
        dctx = torch.randn(B, n, d, generator=gen, device=dev).to(dt)
        got_f, got_b = fused_attention(qkv, h), fused_attention_bwd(qkv, dctx, h)
        want_f, want_b = attention_plain(qkv, h), attention_bwd_plain(qkv, dctx, h)
        torch.cuda.synchronize()
        (rf, af), (rb, ab) = rel_err(got_f, want_f), rel_err(got_b, want_b)
        finite = bool(torch.isfinite(got_f.float()).all() and torch.isfinite(got_b.float()).all())
        bars = (TOL_FWD, TOL_BWD) if dt == torch.bfloat16 else (TOL_CORE_F32, TOL_CORE_F32)
        tag = f"{label} B={B} N={n} D={d} H={h} {dt_name}"
        core_gap[tag] = {"fwd_max_rel": rf, "fwd_max_abs": af, "bwd_max_rel": rb, "bwd_max_abs": ab}
        print(f"parity attention (kernel 12 / 13) {tag}: max-rel {rf:.3e} / {rb:.3e} (bars "
              f"{bars[0]} / {bars[1]}), max-abs {af:.3e} / {ab:.3e}, finite {finite}", flush=True)
        check(finite and rf <= bars[0] and rb <= bars[1], f"kernels 12 / 13 {tag} parity")
        del got_f, got_b, want_f, want_b
        timed = (label, B) in CORE_TIMED and dt == torch.bfloat16
        timed_f32 = dt == torch.float32  # ViT-B B=64 and ViT-H B=32, TF32 off
        if timed or timed_f32:
            q4, k4, v4 = qkv.view(B, n, 3, h, d // h).permute(2, 0, 3, 1, 4).unbind(0)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
            g4 = dctx.view(B, n, h, d // h).transpose(1, 2)

            def sdpa_fwd_bwd():
                out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
                torch.autograd.grad(out, (qg, kg, vg), g4)

            sfx = "" if timed else "_f32"
            elt = 2 if timed else 4
            lib = "F.scaled_dot_product_attention" + ("" if timed else " (fp32, TF32 off)")
            core_record("attention_fwd" + sfx, f"{label}{B}", lambda: fused_attention(qkv, h),
                        lambda: attention_plain(qkv, h), (rf, af), core_bound(B, n, d, h, elt, False),
                        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4), lib, dt)
            core_record("attention_bwd" + sfx, f"{label}{B}", lambda: fused_attention_bwd(qkv, dctx, h),
                        lambda: attention_bwd_plain(qkv, dctx, h), (rb, ab), core_bound(B, n, d, h, elt, True),
                        sdpa_fwd_bwd, lib + " forward + backward", dt)
            del q4, k4, v4, qg, kg, vg, g4
        if timed and B == CORE_TIMED[0][1]:
            # kernel 13 twice on the same inputs gives the same bits (no atomics,
            # nothing summed in device memory)
            same_bwd = bool(torch.equal(fused_attention_bwd(qkv, dctx, h), fused_attention_bwd(qkv, dctx, h)))
            print(f"kernel 13 twice on the same inputs ({tag}): bit-equal {same_bwd}", flush=True)
            check(same_bwd, "kernel 13 deterministic")
        del qkv, dctx
    # kernel 12 in bf16 is K2's core launched alone: on the qkv kernel 2 hands
    # back, its context equals the one K2's core computed, bit for bit
    args = block_args("attn", 64)
    _, qkv_k2, _, ctx_k2 = _launch_fwd(*args, H, stash=True)
    same_core = bool(torch.equal(fused_attention(qkv_k2, H), ctx_k2))
    print(f"kernel 12 (bf16) vs K2's attention core on the same qkv (B=64, ViT-B): bit-equal "
          f"{same_core}", flush=True)
    check(same_core, "kernel 12 bit-equal to K2's core")
    del args, qkv_k2, ctx_k2
    torch.cuda.empty_cache()

    mark("attention_kernels")

    # ---- 4. serving path ------------------------------------------------------
    cfg = load_config(CONFIG, os.path.join(ROOT, "configs"))
    model = build_mim_model(cfg, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(0))
    n_layers = model.encoder.depth
    geom = dict(channels=model.in_chans, img_size=model.img_size)
    data = make_cutouts(N_BATCHES * BATCH, seed=1, **geom)  # nan_band_frac 0.1: whole-band NaNs
    tdata = make_cutouts(2, seed=2, **geom)
    check(bool(np.isnan(data["cutouts"]).any()), "test cutouts hold NaN bands")

    def as_batches(d, bs):
        rd = np.stack([d["ra"], d["dec"]], axis=1)
        return [{"cutouts": d["cutouts"][i:i + bs], "ra_dec": rd[i:i + bs]}
                for i in range(0, len(rd), bs)]

    batches = as_batches(data, BATCH)
    target_batches = as_batches(tdata, 2)

    counters = (fused_attn_block, fused_mlp_block, weighted_bank_scores,
                weighted_bank_scores_multi, attn_block_fwd_stash, attn_block_bwd_stash,
                mlp_block_bwd, attn_block_bwd, mlp_block_fwd_stash, mlp_block_bwd_stash,
                mlp_block_bwd_stream, fused_attention, fused_attention_bwd)
    # K2, kernel 2 and kernel 4 also count their launches with packed segments
    seg_counters = (fused_attn_block, attn_block_fwd_stash, attn_block_bwd)
    training_kernels = [f.__name__ for f in counters[4:]] + ["fused_attn_block_seg"]

    def zero_counters():
        for fn in counters:
            fn.launches = 0
        for fn in seg_counters:
            fn.seg_launches = 0

    def launch_counts():
        return {**{f.__name__: f.launches for f in counters},
                **{f.__name__ + "_seg": f.seg_launches for f in seg_counters}}

    zero_counters()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    target_latent = extract_latents(
        model, target_batches, remove_prefix=False, apply_augmentations=True,
        num_augmentations=N_AUG, generator=torch.Generator(device=dev).manual_seed(0),
    )
    encoder_calls = 1
    imgs_s, lat_s, ra_s, scores_s = mim_simsearch(
        model, target_latent, batches, n_save=N_SAVE, max_pool=True, log_every=0)
    encoder_calls += N_BATCHES + 1  # the stream + re-encoding the winners
    bank = build_bank(model, batches, pool="max")
    encoder_calls += N_BATCHES
    q_scores, q_idx = bank.query(target_latent, k=N_SAVE, exact=True)
    queries = 1
    big_scores = weighted_bank_scores(bank_bf16, target, weights)
    top_v, top_i = bank_topk(bank_bf16, target, weights, N_SAVE)
    queries += 2
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = launch_counts()
    print(f"serving path: {t_main:.2f} s, {encoder_calls} encoder calls, launches {launches}", flush=True)
    check(target_latent.shape == (2 * (1 + N_AUG), N_TOK, D), f"target latent shape {target_latent.shape}")
    check(lat_s.shape == (N_SAVE, N_TOK, D) and scores_s.shape == (N_SAVE,), "simsearch shapes")
    check(bool(np.isfinite(target_latent).all()), "target latents finite")
    for name, s in (("simsearch", scores_s), ("bank query", q_scores),
                    ("1M scores", big_scores.cpu().numpy()), ("1M top-k", top_v.cpu().numpy())):
        check(bool(np.isfinite(s).all()), f"{name} scores finite")
    check(bank.features.shape == (N_BATCHES * BATCH, D), "bank shape")
    check(launches["fused_attn_block"] == n_layers * encoder_calls, "attn launches = 12 x encoder calls")
    check(launches["fused_mlp_block"] == n_layers * encoder_calls, "mlp launches = 12 x encoder calls")
    check(launches["weighted_bank_scores"] >= queries, "bank-scorer launches >= queries")
    check(all(launches[k] == 0 for k in training_kernels), "serving launches no training kernel")
    check(bool((top_v[:-1] >= top_v[1:]).all()), "top-k sorted")

    # kernel path vs plain path on the card
    with torch.inference_mode():
        x0 = torch.as_tensor(batches[0]["cutouts"], device=dev)
        tok_kernel = model.encode(x0)[0]
        model.encoder.plain = True
        tok_plain = model.encode(x0)[0]
        _, _, ra_p, _ = mim_simsearch(model, target_latent, batches, n_save=N_SAVE, max_pool=True,
                                      log_every=0)
        model.encoder.plain = False
    tok_rel, tok_abs = rel_err(tok_kernel, tok_plain)
    overlap = len({tuple(r) for r in ra_s.tolist()} & {tuple(r) for r in ra_p.tolist()})
    print(f"tokens kernel vs plain path (B=64, 12 layers): max-rel {tok_rel:.3e} "
          f"(bar {TOL_TOKENS}), max-abs {tok_abs:.3e}; top-{N_SAVE} overlap {overlap}/{N_SAVE}", flush=True)
    check(tok_rel <= TOL_TOKENS, "encoder tokens kernel vs plain")

    mark("serving")

    # ---- 4b. retrieval path (sky_sim_search) ----------------------------------
    class HostRows:
        """A row-sliceable host view of a bank, as ``load(lazy=True)`` gives."""

        def __init__(self, rows):
            self.rows, self.shape = rows, rows.shape

        def __getitem__(self, sl):
            return self.rows[sl]

    def host_ms(fn, reps):
        fn()  # warm-up; every call ends in a copy of its result to the host
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def retrieval_phase(tile_dir):
        """The functions ``sky_sim_search`` calls, at ``mim_1`` width: the
        multi-target FITS stream, then the 1M bank's query routes. Returns
        (results, launches on the path)."""
        bands = cfg.data.list("bands")
        img = model.img_size
        # a synthetic survey: FITS_TILES neighbouring tiles, one fp32 file per
        # band with TAN WCS cards (HSC's 0.168"/pixel), noise plus 64
        # Gaussian sources a tile; each target group is 2 windows around
        # sources of its own tile, clipped at -3 as the batcher clips
        rng = np.random.default_rng(6)
        scale = 0.168 / 3600.0
        yy, xx = np.mgrid[-8:9, -8:9]
        windows = []
        for i in range(FITS_TILES):
            wcs = TanWCS(crpix=(FITS_SIZE / 2 + 0.5,) * 2, crval=(150.0 + 0.05 * i, 2.2),
                         cd=[[-scale, 0.0], [0.0, scale]])
            tile = rng.standard_normal((len(bands), FITS_SIZE, FITS_SIZE), dtype=np.float32)
            centres = rng.integers(40, FITS_SIZE - 40, size=(64, 2))
            for (cy, cx), sigma in zip(centres, rng.uniform(1.5, 4.0, size=64)):
                blob = np.exp(-(yy ** 2 + xx ** 2) / (2 * sigma ** 2)).astype(np.float32)
                tile[:, cy - 8:cy + 9, cx - 8:cx + 9] += rng.uniform(5, 20, (len(bands), 1, 1)) * blob
            for band, plane in zip(bands, tile):
                write_image(os.path.join(tile_dir, f"calexp-HSC-{band}-9813-{i},0.fits"), plane,
                            wcs.to_cards())
            picks = centres[:2] - img // 2
            cut = np.stack([tile[:, y:y + img, x:x + img] for y, x in picks]).clip(min=-3.0)
            ra, dec = wcs.pixel_to_world(picks[:, 1] + img // 2, picks[:, 0] + img // 2)
            windows.append({"cutouts": cut, "ra_dec": np.stack([ra, dec], 1).astype(np.float32)})

        def stream():
            return build_fits_batcher(
                [tile_dir], bands=bands, min_bands=cfg.data.int("min_bands", 2), batch_size=BATCH,
                img_size=img, use_calexp=cfg.data.bool("use_calexp", True), shuffle=False,
                use_overlap=True, overlap=FITS_OVERLAP)

        per_tile = len(overlap_coords((FITS_SIZE, FITS_SIZE), img, FITS_OVERLAP))
        n_batches = FITS_TILES * (per_tile // BATCH)
        n_rows = bank_bf16.shape[0]
        n_slabs = -(-n_rows // SLAB_ROWS)
        stats = (np.zeros((n_rows, 2), np.float32), np.zeros(D, np.float32), np.ones(D, np.float32))
        big = EmbeddingBank(bank_bf16, *stats, device=dev)
        host_bank = bank_bf16.cpu()
        held = EmbeddingBank(HostRows(host_bank), *stats, device=dev)

        zero_counters()
        torch.cuda.synchronize()
        t_path = time.perf_counter()
        groups = [extract_latents(model, [windows[g]], remove_prefix=False, apply_augmentations=True,
                                  num_augmentations=N_AUG,
                                  generator=torch.Generator(device=dev).manual_seed(g))
                  for g in range(N_GROUPS)]
        t_stream = time.perf_counter()
        multi = mim_simsearch_multi(model, groups, stream(), n_save=N_SAVE, max_pool=True,
                                    log_every=0)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t_stream
        encoder_calls = 2 * N_GROUPS + n_batches  # targets, the stream, re-encoding winners
        # 8 queries: each group's 2 targets apart, each with its 64 augmentations
        q8 = [g[i * (1 + N_AUG):(i + 1) * (1 + N_AUG)] for g in groups for i in range(2)]
        s_int8, i_int8 = big.query(q8[0], k=N_SAVE)
        s_exact, i_exact = big.query(q8[0], k=N_SAVE, exact=True)
        m_exact = big.query_multi(q8, k=N_SAVE, exact=True)
        m_int8 = big.query_multi(q8, k=N_SAVE)
        c_route = held.query(q8[0], k=N_SAVE)
        tgt0, w0 = big._query_target(q8[0], True)
        c_slabs = bank_topk_chunked(host_bank, tgt0, w0, N_SAVE, slab_rows=SLAB_ROWS)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t_path
        path_launches = launch_counts()
        print(f"retrieval path: {t_path:.2f} s, {encoder_calls} encoder calls, FITS stream "
              f"{n_batches} batches of {BATCH} ({per_tile} cutouts a tile) in {t_stream:.2f} s, "
              f"launches {path_launches}", flush=True)
        check(per_tile == 729 and n_batches == 44, f"{per_tile} cutouts a tile, {n_batches} batches")
        check(q8[0].shape == (1 + N_AUG, N_TOK, D) and len(q8) == 8, "8 target groups")
        for name_, want_n in (("fused_attn_block", n_layers * encoder_calls),
                              ("fused_mlp_block", n_layers * encoder_calls),
                              ("weighted_bank_scores", 2 + n_slabs),  # exact query, 1 + 4 slabs
                              ("weighted_bank_scores_multi", 1)):  # the exact query_multi
            check(path_launches[name_] == want_n,
                  f"retrieval: {name_} launches {path_launches[name_]} == {want_n}")
        check(all(path_launches[k] == 0 for k in training_kernels), "retrieval launches no training kernel")

        # each group of the one-pass search against a single-group search
        group_checks = []
        for g, (imgs_g, lat_g, ra_g, sc_g) in enumerate(multi):
            check(imgs_g.shape == (N_SAVE, model.in_chans, img, img) and lat_g.shape == (N_SAVE, N_TOK, D)
                  and bool(np.isfinite(sc_g).all()) and bool((sc_g[:-1] >= sc_g[1:]).all()),
                  f"group {g}: shapes, finite sorted scores")
            # a one-group pass of the same search: mim_simsearch rounds its
            # target statistics as JAX's single search does, which in bf16
            # ranks otherwise than the multi-target search (as in JAX)
            _, _, ra_1, sc_1 = mim_simsearch_multi(model, [groups[g]], stream(), n_save=N_SAVE,
                                                   max_pool=True, log_every=0)[0]
            ov = len({tuple(r) for r in ra_g.tolist()} & {tuple(r) for r in ra_1.tolist()})
            diff = float(np.abs(sc_g - sc_1).max())
            group_checks.append({"overlap": ov, "max_score_diff": diff})
            print(f"FITS group {g}: top-{N_SAVE} overlap with a single-group search {ov}/{N_SAVE}, "
                  f"max score diff {diff:.2e}, best {sc_g[0]:.4f}", flush=True)
            check(ov >= N_SAVE - 1 and diff <= 1e-5, f"FITS group {g} against a single-group search")

        # the int8 route against the exact ranking (K3 over the whole bank)
        full = weighted_bank_scores(bank_bf16, tgt0, w0)
        chosen = full[torch.as_tensor(i_int8, device=dev)]
        agree = float((chosen >= float(s_exact[-1]) - 5e-3).float().mean())
        int8_rel = rel_err(torch.as_tensor(s_int8, device=dev), chosen)[0]
        print(f"query int8 vs exact: agreement {agree:.4f} (bar 0.999), returned scores vs K3 "
              f"max-rel {int8_rel:.2e} (bar {TOL_SCORE_F32})", flush=True)
        check(agree >= 0.999 and int8_rel <= TOL_SCORE_F32 and bool(np.isfinite(s_int8).all()),
              "query int8 agreement")
        # query_multi (kernel 11) against 8 single queries (K3), and its int8 route
        pairs = [big._query_target(t_, True) for t_ in q8]
        full_m = weighted_bank_scores_multi(bank_bf16, *(torch.stack([p_[i] for p_ in pairs])
                                                         for i in (0, 1)))
        multi_checks = []
        for q in range(8):
            s1, i1 = big.query(q8[q], k=N_SAVE, exact=True)
            ov = len(set(i1.tolist()) & set(m_exact[1][q].tolist()))
            r_exact = rel_err(torch.as_tensor(m_exact[0][q]), torch.as_tensor(s1))[0]
            chosen = full_m[torch.as_tensor(m_int8[1][q], device=dev), q]
            agree_q = float((chosen >= float(m_exact[0][q][-1]) - 5e-3).float().mean())
            r_int8 = rel_err(torch.as_tensor(m_int8[0][q], device=dev), chosen)[0]
            multi_checks.append({"exact_overlap": ov, "exact_max_rel": r_exact,
                                 "int8_agreement": agree_q, "int8_max_rel": r_int8})
            check(ov >= N_SAVE - 1 and r_exact <= TOL_SCORE_F32 and agree_q >= 0.99
                  and r_int8 <= TOL_SCORE_F32, f"query_multi query {q}: {multi_checks[-1]}")
        print(f"query_multi Q=8: exact overlap with single queries min "
              f"{min(c['exact_overlap'] for c in multi_checks)}/{N_SAVE}, int8 agreement min "
              f"{min(c['int8_agreement'] for c in multi_checks):.4f} (bar 0.99)", flush=True)
        # the chunked scorer: the single pass's winners, bit for bit
        want_v, want_i = (a.cpu().numpy() for a in bank_topk(bank_bf16, tgt0, w0, N_SAVE))
        for name_, (v_, i_) in (("chunked route", c_route), (f"{SLAB_ROWS}-row slabs", c_slabs)):
            same = bool(np.array_equal(i_, want_i) and np.array_equal(v_, want_v))
            print(f"{name_}: indices and scores equal to the single pass: {same}", flush=True)
            check(same, f"{name_} against the single pass")

        times = {
            "query_int8_ms": host_ms(lambda: big.query(q8[0], k=N_SAVE), 20),
            "query_exact_ms": host_ms(lambda: big.query(q8[0], k=N_SAVE, exact=True), 20),
            "query_multi8_int8_ms": host_ms(lambda: big.query_multi(q8, k=N_SAVE), 10),
            "query_multi8_exact_ms": host_ms(lambda: big.query_multi(q8, k=N_SAVE, exact=True), 10),
            "chunked_query_ms": host_ms(lambda: held.query(q8[0], k=N_SAVE), 2),
        }
        qps = {k_.replace("_ms", "_per_s"): (8 if "multi8" in k_ else 1) * 1e3 / v_
               for k_, v_ in times.items() if k_.startswith("query")}
        # the scorers alone (CUDA events), targets already pooled on the card:
        # what a query costs beyond moving its (65, 65, 768) target group
        bank8, rnorm = big._device_int8()
        t8, w8 = (torch.stack([p_[i] for p_ in pairs]) for i in (0, 1))
        times.update({
            "scorer_exact_ms": cuda_ms(lambda: bank_topk(bank_bf16, tgt0, w0, N_SAVE), 20),
            "scorer_int8_ms": cuda_ms(lambda: bank_topk_int8(
                bank8, rnorm, bank_bf16, tgt0, w0, N_SAVE, oversample=min(8192, n_rows)), 20),
            "scorer_multi8_exact_ms": cuda_ms(lambda: bank_topk_multi(bank_bf16, t8, w8, N_SAVE), 10),
            "scorer_multi8_int8_ms": cuda_ms(lambda: bank_topk_multi_int8(
                bank8, rnorm, bank_bf16, t8, w8, N_SAVE, oversample=min(2048, n_rows)), 10),
        })
        fits_ips = n_batches * BATCH / t_stream
        print(f"retrieval times (host clock, result on the host): {times}; queries/s {qps}; FITS "
              f"multi-search {fits_ips:.0f} images/s (host reading included)", flush=True)
        result = {"seconds": t_path, "encoder_calls": encoder_calls, "launches": path_launches,
                  "fits_batches": n_batches, "fits_stream_s": t_stream, "fits_images_per_s": fits_ips,
                  "groups": group_checks, "query_int8_agreement": agree, "query_int8_max_rel": int8_rel,
                  "query_multi": multi_checks, **times, **qps}
        del big, held, host_bank, full, full_m
        return result, path_launches

    tile_dir = tempfile.mkdtemp(prefix="chip_smoke_fits_")
    try:
        retrieval, retrieval_launches = retrieval_phase(tile_dir)
    finally:
        shutil.rmtree(tile_dir)
    torch.cuda.empty_cache()

    mark("retrieval")

    # ---- 5. training paths ----------------------------------------------------
    del bank
    torch.cuda.empty_cache()

    def device_breakdown(fn, reps=3):
        """Device time by kernel name over ``reps`` calls (torch.profiler /
        CUPTI) and the device-busy share of the same window's wall time."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.key_averages():
            # kernels only: a user annotation (Optimizer.step#AdamW.step) spans
            # the kernels it encloses and would count their time twice
            if str(getattr(e, "device_type", "")).endswith("CUDA") and not getattr(
                    e, "is_user_annotation", False):
                t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                by_name[e.key[:90]] = by_name.get(e.key[:90], 0.0) + t / 1e3 / reps
        busy = sum(by_name.values())
        if busy == 0:
            return {"device_ms_per_call": "not measured"}
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:14])
        return {"device_ms_per_call": busy, "busy_share": busy / (wall_ms / reps), "top_ms": top}

    def ra_dec_of(model_, batch):
        return batch_ra_dec(batch, dev) if model_.ra_dec else None

    def draw_masking(tr, bs_, gen_):
        """The step's masking: a SimMIM pixel mask, or an MAE model's token noise."""
        return tr.draw_mask(bs_, gen_) if tr.model.simmim else tr.draw_noise(bs_, gen_)

    def model_loss(mod, x_, mk, batch):
        rd = ra_dec_of(mod, batch)
        return mod(x_, mk, ra_dec=rd)[0] if mod.simmim else mod(x_, ra_dec=rd, mae_noise=mk)[0]

    def train_with(tr, batch, mk):
        return tr.train_batch(batch, mask=mk) if tr.model.simmim else tr.train_batch(batch, noise=mk)

    def training_phase(cfg_, steps, val, expect, tol_grad, tol_loss, time_batches, seed,
                       extra=None, expect_dec=None, distinct=None, probes=None):
        """One config's training path: ``steps`` train steps and ``val``
        validation batches with the launch counts ``expect`` (kernel ->
        launches per encoder layer per step, per validation batch; for an
        MAE model ``expect_dec`` per decoder layer); ``extra`` (trainer,
        batches) runs config-specific checks; then the kernel path against
        the plain path and train-step times at ``time_batches``. ``distinct``
        synthetic batches are made and cycled (all different by default).
        With ``probes`` (the classification and regression sets, lists of
        labelled batches) the steps, the validation and the linear probes run
        through ``train_network``, and every probe batch adds one K1 and one
        K2 launch per layer."""
        tag = cfg_.name
        t_init = time.perf_counter()
        trainer = MIMPretrainer(cfg_, dtype=torch.bfloat16, seed=0, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init  # seeded init on the host, then the copy
        m = trainer.model
        bs = trainer.batch_size
        layers = m.encoder.depth
        dec_layers = 0 if m.simmim else m.decoder.depth
        n_data = distinct or steps + val
        gdata = make_cutouts(n_data * bs, seed=seed, channels=m.in_chans, img_size=m.img_size)
        check(bool(np.isnan(gdata["cutouts"]).any()), f"{tag}: training cutouts hold NaN bands")
        tbatches = as_batches(gdata, bs)
        tbatches = [tbatches[i % n_data] for i in range(steps + val)]
        n_probe = sum(len(p_) for p_ in probes) if probes else 0
        zero_counters()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        if probes:
            class ValBatches:
                def take(self, n_):
                    return iter(tbatches[steps:steps + n_])

            ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
            try:
                train_network(trainer, iter(tbatches[:steps]), ValBatches(), steps, steps, 1e9,
                              os.path.join(ckpt_dir, f"{tag}.ckpt.pt"), lp_class_data_file=probes[0],
                              lp_regress_data_file=probes[1], lp_combine="central",
                              max_val_batches=val, log_fn=lambda m_: print(f"{tag}: {m_}", flush=True))
            finally:
                shutil.rmtree(ckpt_dir)
            train_losses, val_losses = trainer.losses["train_loss"], trainer.losses["val_loss"]
        else:
            train_losses = [trainer.train_batch(b) for b in tbatches[:steps]]
            val_losses = [trainer.eval_batch(b, idx=i) for i, b in enumerate(tbatches[steps:])]
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        run_launches = launch_counts()
        train_losses = [float(v) for v in train_losses]
        val_losses = [float(v) for v in val_losses]
        print(f"training path {tag} (D={m.embed_dim}, depth {layers}, decoder depth {dec_layers}, "
              f"batch {bs}, remat {m.encoder.remat}, ra_dec {m.ra_dec}): {steps} steps + {val} val "
              f"batches in {t_run:.2f} s, launches {run_launches}", flush=True)
        print(f"{tag} train losses {[round(v, 4) for v in train_losses]}; "
              f"val {[round(v, 4) for v in val_losses]}", flush=True)
        check(all(np.isfinite(train_losses + val_losses)), f"{tag}: losses finite")
        for name_ in run_launches:
            per_step, per_val = expect.get(name_, (0, 0))
            dec_step, dec_val = (expect_dec or {}).get(name_, (0, 0))
            per_probe = int(name_ in ("fused_attn_block", "fused_mlp_block"))
            want_n = (layers * (per_step * steps + per_val * val + per_probe * n_probe)
                      + dec_layers * (dec_step * steps + dec_val * val))
            check(run_launches[name_] == want_n,
                  f"{tag}: {name_} launches {run_launches[name_]} == {layers} x "
                  f"({per_step} x {steps} + {per_val} x {val} + {per_probe} x {n_probe}) + "
                  f"{dec_layers} x ({dec_step} x {steps} + {dec_val} x {val}) = {want_n}")
        result = {"layers": layers, "decoder_layers": dec_layers, "embed_dim": m.embed_dim,
                  "batch": bs, "channels": m.in_chans,
                  "remat": m.encoder.remat, "ra_dec": m.ra_dec, "trainer_init_s": t_init,
                  "seconds": t_run, "steps": steps, "val_batches": val, "launches": run_launches,
                  "train_losses": train_losses, "val_losses": val_losses}
        if probes:
            lp = {k: trainer.losses[k][-1] for k in ("train_lp_acc", "val_lp_acc", "train_lp_r2",
                                                     "val_lp_r2")}
            # the probe alone: the same sets through linear_probe again
            torch.cuda.synchronize()
            t_p = time.perf_counter()
            again = linear_probe(m, probes[0], probes[1], combine="central", img_size=m.img_size)
            torch.cuda.synchronize()
            probe_ms = (time.perf_counter() - t_p) * 1e3
            print(f"{tag} probes ({n_probe} batches of {len(probes[0][0]['cutouts'])}, features "
                  f"{m.embed_dim if m.pooled else 4 * m.embed_dim} wide): {lp}; again in "
                  f"{probe_ms:.1f} ms: {again}", flush=True)
            check(all(np.isfinite(list(lp.values()))) and 0.0 <= lp["val_lp_acc"] <= 1.0
                  and lp["val_lp_r2"] <= 1.0, f"{tag}: probe metrics")
            check(max(abs(again[k] - lp[k]) for k in lp) <= 1e-3, f"{tag}: the probe repeats")
            result.update({"probe": lp, "probe_ms": probe_ms, "probe_batches": n_probe})
        if extra is not None:
            result.update(extra(trainer, tbatches))

        # kernel path vs plain path on the card, from the same params and
        # masks (MAE: noise); the plain path's decoder too
        pair = [MIMPretrainer(cfg_, dtype=torch.bfloat16, seed=0, device=dev) for _ in range(2)]
        pair[1].model.plain = True
        mgen = torch.Generator(device=dev).manual_seed(7)
        masks = [draw_masking(pair[0], bs, mgen) for _ in range(TRAJ_STEPS)]
        x0 = torch.as_tensor(tbatches[0]["cutouts"], device=dev).clamp_min(trainer.pixel_min)
        step_grads, step_loss = [], []
        for tr in pair:
            loss = model_loss(tr.model, x0, masks[0], tbatches[0])
            loss.backward()
            step_loss.append(float(loss.detach()))
            step_grads.append({n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                               if p.grad is not None})
            tr.optimizer.zero_grad(set_to_none=True)
        grad_rel = {n: float((a - step_grads[1][n]).norm() / (step_grads[1][n].norm() + 1e-30))
                    for n, a in step_grads[0].items()}
        worst_leaf = max(grad_rel, key=grad_rel.get)
        loss_rel = abs(step_loss[0] - step_loss[1]) / abs(step_loss[1])
        traj = [[float(train_with(tr, b, mk)) for b, mk in zip(tbatches, masks)] for tr in pair]
        traj_rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
        print(f"{tag} training kernel vs plain path (B={bs}, {layers} layers): loss rel "
              f"{loss_rel:.3e}; gradient ||a-b||/||b|| max {grad_rel[worst_leaf]:.3e} ({worst_leaf}), "
              f"median {float(np.median(list(grad_rel.values()))):.3e} over {len(grad_rel)} leaves "
              f"(bar {tol_grad}); {TRAJ_STEPS}-step losses kernel {[round(v, 5) for v in traj[0]]} "
              f"plain {[round(v, 5) for v in traj[1]]}, max rel {traj_rel:.3e} (bar {tol_loss})",
              flush=True)
        check(len(grad_rel) == sum(1 for n, _ in m.named_parameters() if n != "mask_token" or not m.simmim),
              f"{tag}: every parameter (SimMIM: but mask_token) gets a gradient")
        check(all(np.isfinite(list(grad_rel.values()))), f"{tag}: gradients finite")
        check(grad_rel[worst_leaf] <= tol_grad, f"{tag}: gradients kernel vs plain")
        check(loss_rel <= tol_loss and traj_rel <= tol_loss, f"{tag}: losses kernel vs plain")
        result.update({
            "loss_rel_vs_plain": loss_rel, "grad_rel_vs_plain_max": grad_rel[worst_leaf],
            "grad_rel_worst_leaf": worst_leaf,
            "grad_rel_vs_plain_median": float(np.median(list(grad_rel.values()))),
            "trajectory_kernel": traj[0], "trajectory_plain": traj[1], "trajectory_max_rel": traj_rel,
        })
        del pair, step_grads, tr, loss  # `tr` still held the plain-path trainer
        torch.cuda.empty_cache()

        # train-step times at the config's batch (and larger ones)
        timg = np.concatenate([b["cutouts"] for b in tbatches])
        trd = np.concatenate([b["ra_dec"] for b in tbatches])
        step_t = {}
        for B_, iters in time_batches:
            reps = -(-B_ // len(timg))
            tb = {"cutouts": torch.as_tensor(np.concatenate([timg] * reps)[:B_], device=dev),
                  "ra_dec": np.concatenate([trd] * reps)[:B_]}
            ms = cuda_ms(lambda: trainer.train_batch(tb), iters, warmup=2)
            held = torch.cuda.memory_allocated() / 1e9  # other phases' tensors included
            torch.cuda.reset_peak_memory_stats()
            trainer.train_batch(tb)
            prof = device_breakdown(lambda: trainer.train_batch(tb), reps=2)
            dev_ms = prof["device_ms_per_call"]
            # kernel time per step over the event-timed step: the profiled
            # window's own busy_share is lower, the profiler adding host time
            busy = dev_ms / ms if isinstance(dev_ms, float) else "not measured"
            step_t[f"B={B_}"] = {"ms": ms, "images_per_s": B_ / ms * 1e3, "device_busy_share": busy,
                                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                                 "held_before_step_gb": held, "profile": prof}
            print(f"{tag} train step B={B_}: {ms:.2f} ms, {B_ / ms * 1e3:.0f} images/s, peak "
                  f"{step_t[f'B={B_}']['peak_memory_gb']:.1f} GB ({held:.1f} GB held before the "
                  f"step), device busy {busy} of the step, {prof.get('busy_share', 'not measured')} "
                  f"of the profiled window", flush=True)
        result["train_step"] = step_t
        del trainer, tb
        torch.cuda.empty_cache()
        return result

    def save_restore(trainer, tbatches):
        """mim_1: the checkpoint restores params, optimizer state and the mask
        stream bit-equal into a fresh trainer."""
        ckpt_path = os.path.join(ROOT, "models", "chip_smoke_mim_1.ckpt.pt")  # gitignored
        trainer.save(ckpt_path)
        restored = MIMPretrainer(cfg, dtype=torch.bfloat16, seed=1, device=dev)
        check(restored.restore(ckpt_path), "restore found the checkpoint")
        same_params = all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                           restored.model.state_dict().values()))
        sa, sb = trainer.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
        same_opt = sa.keys() == sb.keys() and all(
            torch.equal(sa[k][f], sb[k][f].to(sa[k][f].device)) for k in sa for f in sa[k])
        same_rng = torch.equal(trainer.mask_gen.get_state(), restored.mask_gen.get_state())
        ckpt_mb = os.path.getsize(ckpt_path) / 2**20
        os.remove(ckpt_path)
        print(f"save/restore: {ckpt_mb:.0f} MB, params bit-equal {same_params}, optimizer state "
              f"bit-equal {same_opt}, mask rng equal {same_rng}, step {restored.cur_iter}", flush=True)
        check(same_params and same_opt and same_rng and restored.cur_iter == TRAIN_STEPS,
              "save/restore round trip")
        return {"checkpoint_mb": ckpt_mb}

    def remat_check(trainer, tbatches):
        """mim_32: gradients with remat (checkpointed blocks, stashes off) equal,
        bit for bit, those of the same model stored without remat."""
        d_ = {sec: dict(cfg_r[sec].items()) for sec in cfg_r.sections()}
        d_["ARCHITECTURE"].update(stash="False", stash_mlp="False")
        ref = build_mim_model(Config.from_dict(d_, name="mim_32"), dtype=torch.bfloat16,
                              device=dev, remat=False)
        ref.load_state_dict(trainer.model.state_dict())
        ref.train()
        check(trainer.model.encoder.remat and not ref.encoder.remat, "remat on, reference off")
        b = tbatches[0]
        x0 = torch.as_tensor(b["cutouts"], device=dev).clamp_min(trainer.pixel_min)
        mk = trainer.draw_mask(x0.shape[0], torch.Generator(device=dev).manual_seed(11))
        grads, losses = [], []
        for mod in (trainer.model, ref):
            mod.zero_grad(set_to_none=True)
            loss = mod(x0, mk, ra_dec=ra_dec_of(mod, b))[0]
            loss.backward()
            losses.append(loss.detach())
            grads.append({n: p.grad.clone() for n, p in mod.named_parameters() if p.grad is not None})
            mod.zero_grad(set_to_none=True)
        same = grads[0].keys() == grads[1].keys() and all(
            torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
        print(f"remat vs stored (mim_32, one step): loss bit-equal {torch.equal(*losses)}, "
              f"{len(grads[0])} gradients bit-equal {same}", flush=True)
        check(torch.equal(*losses) and same, "remat gradients bit-equal to the stored path")

        # what remat costs: forward + backward time and peak memory, each way
        def fwd_bwd(mod):
            mod(x0, mk, ra_dec=ra_dec_of(mod, b))[0].backward()
            mod.zero_grad(set_to_none=True)

        cost = {}
        for key, mod in (("remat", trainer.model), ("stored", ref)):
            ms = cuda_ms(lambda: fwd_bwd(mod), 5, warmup=1)
            held = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(mod)
            cost[key] = {"fwd_bwd_ms": ms, "peak_above_held_gb":
                         torch.cuda.max_memory_allocated() / 1e9 - held}
        print(f"remat cost (mim_32, B={x0.shape[0]}): forward + backward {cost['remat']['fwd_bwd_ms']:.2f} "
              f"vs {cost['stored']['fwd_bwd_ms']:.2f} ms stored; peak above what is held "
              f"{cost['remat']['peak_above_held_gb']:.2f} vs {cost['stored']['peak_above_held_gb']:.2f} GB",
              flush=True)
        del ref
        return {"remat_grads_bit_equal": same, "remat_cost": cost}

    def vith_init(trainer, tbatches):
        """mim_32_vith: bench_vit_h's model, every block wide (kernel 9) with
        the attention stash off (kernel 4), about 632M parameters."""
        m = trainer.model
        blocks = [getattr(m.encoder, f"block{i}") for i in range(m.encoder.depth)]
        n_params = sum(p.numel() for p in m.parameters())
        check(all(b.ffn.wide and not b.stash and b.num_heads == 16 for b in blocks)
              and 6.2e8 < n_params < 6.5e8, f"ViT-H: wide blocks, stash off, {n_params} params")
        print(f"{VITH[0]}: {n_params} parameters, {len(blocks)} wide blocks of 16 heads of "
              f"{m.embed_dim // 16}", flush=True)
        return {"parameters": n_params}

    def mae_remat(trainer, tbatches):
        """mim_1_mae: the same model with remat, MAE[4] steps at a smaller
        batch, so that kernel 4 runs masked on its real path (K2 masked twice
        per encoder block, the forward and its replay; the decoder keeps its
        stash); then its gradients bit-equal to those of the same model
        stored without remat (the encoder's stash off)."""
        d_ = {sec: dict(cfg_m[sec].items()) for sec in cfg_m.sections()}
        Br, steps_r = MAE[4]
        d_["TRAINING"].update(remat="True", batch_size=str(Br))
        cfg_rm = Config.from_dict(d_, name="mim_1_mae_remat")
        tr = MIMPretrainer(cfg_rm, dtype=torch.bfloat16, seed=0, device=dev)
        tr.model.load_state_dict(trainer.model.state_dict())
        rbatches = [{"cutouts": b["cutouts"][:Br]} for b in tbatches[:steps_r]]
        zero_counters()
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        losses_r = [float(tr.train_batch(b)) for b in rbatches]
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t_r
        rl = launch_counts()
        enc, dec = tr.model.encoder.depth, tr.model.decoder.depth
        want = {"fused_attn_block": 2 * enc * steps_r, "fused_attn_block_seg": 2 * enc * steps_r,
                "attn_block_bwd": enc * steps_r, "attn_block_bwd_seg": enc * steps_r,
                "attn_block_fwd_stash": dec * steps_r, "attn_block_bwd_stash": dec * steps_r,
                "fused_mlp_block": (2 * enc + dec) * steps_r, "mlp_block_bwd": (enc + dec) * steps_r}
        print(f"{cfg_rm.name} (remat, batch {Br}): {steps_r} steps in {t_r:.2f} s, losses "
              f"{[round(v, 4) for v in losses_r]}, launches {rl}", flush=True)
        check(tr.model.encoder.remat and all(np.isfinite(losses_r)), "MAE remat run")
        for k_, n_ in rl.items():
            check(n_ == want.get(k_, 0), f"{cfg_rm.name}: {k_} launches {n_} == {want.get(k_, 0)}")
        d_["TRAINING"].update(remat="False")
        d_["ARCHITECTURE"].update(stash="False")
        ref = build_mim_model(Config.from_dict(d_, name="mim_1_mae_stored"), dtype=torch.bfloat16,
                              device=dev, remat=False)
        ref.load_state_dict(tr.model.state_dict())
        ref.train()
        x0 = torch.as_tensor(rbatches[0]["cutouts"], device=dev).clamp_min(tr.pixel_min)
        nz = tr.draw_noise(Br, torch.Generator(device=dev).manual_seed(12))
        grads, losses = [], []
        for mod in (tr.model, ref):
            mod.zero_grad(set_to_none=True)
            loss = mod(x0, mae_noise=nz)[0]
            loss.backward()
            losses.append(loss.detach())
            grads.append({n: p.grad.clone() for n, p in mod.named_parameters() if p.grad is not None})
            mod.zero_grad(set_to_none=True)
        same = grads[0].keys() == grads[1].keys() and all(
            torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
        print(f"MAE remat vs stored (one step, B={Br}): loss bit-equal {torch.equal(*losses)}, "
              f"{len(grads[0])} gradients bit-equal {same}", flush=True)
        check(torch.equal(*losses) and same and len(grads[0]) == sum(1 for _ in ref.parameters()),
              "MAE remat gradients bit-equal to the stored path")
        del tr, ref, grads
        torch.cuda.empty_cache()
        return {"remat_run": {"batch": Br, "steps": steps_r, "seconds": t_r, "losses": losses_r,
                          "launches": rl, "grads_bit_equal_to_stored": same}}

    # launches per layer: (per train step, per validation batch)
    expect_b = {"attn_block_fwd_stash": (1, 0), "attn_block_bwd_stash": (1, 0),
                "mlp_block_bwd": (1, 0), "fused_mlp_block": (1, 1), "fused_attn_block": (0, 1)}
    expect_l = {"attn_block_fwd_stash": (1, 0), "attn_block_bwd_stash": (1, 0),
                "mlp_block_fwd_stash": (1, 0), "mlp_block_bwd_stash": (1, 0),
                "fused_mlp_block": (0, 1), "fused_attn_block": (0, 1)}
    # remat: each block's forward kernels run again in the backward
    expect_r = {"attn_block_bwd": (1, 0), "mlp_block_bwd": (1, 0),
                "fused_mlp_block": (2, 1), "fused_attn_block": (2, 1)}
    # ViT-H: stash off at huge (K2 forward, kernel 4 backward), the wide MLP
    # (K1 forward, kernel 9 backward)
    expect_h = {"fused_attn_block": (1, 1), "attn_block_bwd": (1, 0),
                "fused_mlp_block": (1, 1), "mlp_block_bwd_stream": (1, 0)}
    check(cfg.training.int("batch_size") == BATCH, "mim_1 trains at batch 64")
    paths = {}
    paths[CONFIG] = training_phase(cfg, TRAIN_STEPS, VAL_BATCHES, expect_b, TOL_GRAD, TOL_LOSS,
                                   ((64, 10), (512, 3)), seed=3, extra=save_restore)
    mark("training_" + CONFIG)
    paths[LARGE[0]] = training_phase(cfg_l, LARGE[1], LARGE[2], expect_l, TOL_GRAD_L, TOL_LOSS_L,
                                     ((64, 10),), seed=4)
    mark("training_" + LARGE[0])
    paths[REMAT[0]] = training_phase(cfg_r, REMAT[1], REMAT[2], expect_r, TOL_GRAD_R, TOL_LOSS_R,
                                     ((32, 10),), seed=5, extra=remat_check)
    mark("training_" + REMAT[0])
    paths[VITH[0]] = training_phase(cfg_h, VITH[1], VITH[2], expect_h, TOL_GRAD_H, TOL_LOSS_H,
                                    VITH[4], seed=6, extra=vith_init)
    mark("training_" + VITH[0])
    # MAE (bench_mae): the packed encoder masked (kernel 2 and, in
    # validation, K2 with seg_len), the decoder unmasked (kernels 2 and 3 in
    # training, K2 in validation); the MLPs K1 and kernel 8 throughout
    d_m = {sec: dict(cfg[sec].items()) for sec in cfg.sections()}
    for sec, over in MAE_OVERRIDES.items():
        d_m[sec].update(over)
    cfg_m = Config.from_dict(d_m, name=MAE[0])
    expect_m = {"attn_block_fwd_stash": (1, 0), "attn_block_fwd_stash_seg": (1, 0),
                "attn_block_bwd_stash": (1, 0), "mlp_block_bwd": (1, 0), "fused_mlp_block": (1, 1),
                "fused_attn_block": (0, 1), "fused_attn_block_seg": (0, 1)}
    expect_m_dec = {"attn_block_fwd_stash": (1, 0), "attn_block_bwd_stash": (1, 0),
                    "mlp_block_bwd": (1, 0), "fused_mlp_block": (1, 1), "fused_attn_block": (0, 1)}
    paths[MAE[0]] = training_phase(cfg_m, MAE[1], MAE[2], expect_m, TOL_GRAD_M, TOL_LOSS_M,
                                   MAE[6], seed=7, extra=mae_remat, expect_dec=expect_m_dec,
                                   distinct=MAE[5])
    mark("training_" + MAE[0])
    # attn_pool: mim_1 with the pool, through train_network with the probes
    # on in-memory structured sets (the card host has no h5py)
    d_p = {sec: dict(cfg[sec].items()) for sec in cfg.sections()}
    for sec, over in POOL_OVERRIDES.items():
        d_p[sec].update(over)
    cfg_p = Config.from_dict(d_p, name=POOL[0])

    def labelled(key, seed):
        arch = cfg_p.architecture
        sd = make_structured_cutouts(POOL[3], channels=arch.int("num_channels"),
                                     img_size=arch.int("img_size"), seed=seed)
        rd = np.stack([sd["ra"], sd["dec"]], 1)
        return [{"cutouts": sd["cutouts"][i:i + BATCH], "ra_dec": rd[i:i + BATCH],
                 "labels": sd[key][i:i + BATCH]} for i in range(0, POOL[3], BATCH)]

    t_sets = time.perf_counter()
    probe_sets = (labelled("class", 11), labelled("zspec", 12))
    print(f"{POOL[0]}: probe sets of {POOL[3]} structured cutouts made in "
          f"{time.perf_counter() - t_sets:.1f} s", flush=True)

    def pool_init(trainer, tbatches):
        m = trainer.model
        n_params = sum(p.numel() for p in m.parameters())
        check(m.pooled and tuple(m.decoder_pred.kernel.shape) == (m.embed_dim, m.img_size ** 2 * m.in_chans),
              f"{POOL[0]}: the pool and the whole-image decoder")
        return {"parameters": n_params, "pool_parameters": sum(p.numel() for p in m.pool.parameters())}

    paths[POOL[0]] = training_phase(cfg_p, POOL[1], POOL[2], expect_b, TOL_GRAD_P, TOL_LOSS_P,
                                    POOL[4], seed=8, extra=pool_init, probes=probe_sets)
    mark("training_" + POOL[0])
    del probe_sets
    shapes = {c: tuple(r[k] for k in ("layers", "embed_dim", "batch", "channels", "remat", "ra_dec"))
              for c, r in paths.items()}
    check(shapes == {CONFIG: (12, 768, 64, 5, False, False), LARGE[0]: (24, 768, 64, 5, False, False),
                     REMAT[0]: (24, 1024, 32, 9, True, True), VITH[0]: (32, 1280, 32, 9, False, True),
                     MAE[0]: (12, 768, 1024, 5, False, False), POOL[0]: (12, 768, 64, 5, False, False)},
          f"the configs train at full width and depth: {shapes}")

    # ---- 5b. the Attention module ---------------------------------------------
    attn_mod = Attention(D, H, torch.bfloat16)
    for lin in (attn_mod.qkv, attn_mod.proj):
        lin.reset_parameters(torch.Generator().manual_seed(5))
    attn_mod.to(dev)
    xa = (torch.randn(64, N_TOK, D, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    ga = (torch.randn(64, N_TOK, D, generator=gen, device=dev) * 0.1).to(torch.bfloat16)

    def attention_module_grads(plain):
        attn_mod.plain = plain
        attn_mod.zero_grad(set_to_none=True)
        xi = xa.clone().requires_grad_()
        attn_mod(xi).backward(ga)
        return {"x": xi.grad, **{n_: p_.grad for n_, p_ in attn_mod.named_parameters()}}

    zero_counters()
    torch.cuda.synchronize()
    grads_k = attention_module_grads(False)
    torch.cuda.synchronize()
    attn_launches = launch_counts()
    grads_p = attention_module_grads(True)
    attn_errs = {k: rel_err(g_, grads_p[k])[0] for k, g_ in grads_k.items()}
    print(f"Attention module (D={D}, {H} heads, B=64, bf16): forward + backward launches "
          f"{ {k: v for k, v in attn_launches.items() if v} }; gradients vs plain max-rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in attn_errs.items()) + f" (bar {TOL_BWD})", flush=True)
    check(attn_launches == {k: int(k in ("fused_attention", "fused_attention_bwd")) for k in attn_launches},
          "the Attention module launches kernels 12 and 13 once each and nothing else")
    check(max(attn_errs.values()) <= TOL_BWD and all(torch.isfinite(g_).all() for g_ in grads_k.values()),
          "Attention module gradients kernel vs plain")
    attention_module = {"launches": attn_launches, "grad_max_rel_vs_plain": attn_errs}
    del attn_mod, xa, ga, grads_k, grads_p
    check(paths[MAE[0]]["decoder_layers"] == 8, "bench_mae's decoder is 8 deep")

    mark("attention_module")

    # ---- 6. times -------------------------------------------------------------
    enc = {}
    with torch.inference_mode():
        for B, iters in ((64, 20), (1024, 5)):
            imgs = torch.as_tensor(np.concatenate([b["cutouts"] for b in batches])[:B], device=dev)
            ms = cuda_ms(lambda: model.encode(imgs), iters, warmup=2)
            prof = device_breakdown(lambda: model.encode(imgs))
            dev_ms = prof["device_ms_per_call"]
            busy = dev_ms / ms if isinstance(dev_ms, float) else "not measured"
            enc[B] = {"ms": ms, "images_per_s": B / ms * 1e3, "device_busy_share": busy,
                      "profile": prof}
            print(f"encoder B={B}: {ms:.3f} ms, {B / ms * 1e3:.0f} images/s, device busy {busy}",
                  flush=True)
    torch.cuda.empty_cache()
    big = EmbeddingBank(bank_bf16, np.zeros((BANK_ROWS, 2), np.float32), np.zeros(D, np.float32),
                        np.ones(D, np.float32), device=dev)
    big.query(target_latent[:8], k=N_SAVE, exact=True)
    n_q = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_q):
        big.query(target_latent[:8], k=N_SAVE, exact=True)
    q_host_ms = (time.perf_counter() - t0) / n_q * 1e3
    topk_ms = cuda_ms(lambda: bank_topk(bank_bf16, target, weights, N_SAVE), 20)
    mark("times")
    t_total = time.perf_counter() - t_start

    src = "sky_embeddings_tpu_torch/ops/kernels/"
    jsrc = "sky_embeddings_tpu/ops/kernels/"
    meta = {
        "attn_block_fwd": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:899",
                           "fused_attn_block", 64),
        "mlp_block_fwd": ("cuda", src + "csrc/mlp_block.cu", jsrc + "mlp_block.py:634",
                          "fused_mlp_block", 64),
        "weighted_bank_scores": ("triton", src + "simscore_triton.py", jsrc + "simscore.py:95",
                                 "weighted_bank_scores", "bfloat16"),
        "attn_block_fwd_stash": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:940",
                                 "attn_block_fwd_stash", TRAIN_B[0]),
        "attn_block_bwd_stash": ("cuda", src + "csrc/attn_block_bwd.cu", jsrc + "attn_block.py:988",
                                 "attn_block_bwd_stash", TRAIN_B[0]),
        "mlp_block_bwd": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:834",
                          "mlp_block_bwd", TRAIN_B[0]),
        "attn_block_bwd": ("cuda", src + "csrc/attn_block_bwd.cu", jsrc + "attn_block.py:1052",
                           "attn_block_bwd", REMAT[3][0]),
        "mlp_block_fwd_stash": ("cuda", src + "csrc/mlp_block.cu", jsrc + "mlp_block.py:687",
                                "mlp_block_fwd_stash", LARGE[3][0]),
        "mlp_block_bwd_stash": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:774",
                                "mlp_block_bwd_stash", LARGE[3][0]),
        "weighted_bank_scores_multi": ("cuda", src + "csrc/simscore_multi.cu",
                                       jsrc + "simscore.py:183", "weighted_bank_scores_multi", 8),
        "mlp_block_bwd_stream": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:532",
                                 "mlp_block_bwd_stream", VITH[3][0]),
        # the packed-segment launches of kernels 1, 2 and 4 (seg_len = 17, N = 68)
        "attn_block_fwd_seg": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:899",
                               "fused_attn_block_seg", MAE[3][0]),
        "attn_block_fwd_stash_seg": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:940",
                                     "attn_block_fwd_stash_seg", MAE[3][0]),
        "attn_block_bwd_seg": ("cuda", src + "csrc/attn_block_bwd.cu", jsrc + "attn_block.py:1052",
                               "attn_block_bwd_seg", MAE[3][0]),
        "attention_fwd": ("cuda", src + "csrc/attention.cu", jsrc + "attention.py:59",
                          "fused_attention", "".join(map(str, CORE_TIMED[0]))),
        "attention_bwd": ("cuda", src + "csrc/attention.cu", jsrc + "attention.py:142",
                          "fused_attention_bwd", "".join(map(str, CORE_TIMED[0]))),
    }
    kernels = []
    for name, (route, source, replaces, counter, shape) in meta.items():
        t = timings[(name, shape)]
        by_path = {f"serving_{CONFIG}": launches[counter],
                   f"retrieval_{CONFIG}": retrieval_launches[counter],
                   **{f"training_{c}": r["launches"][counter] for c, r in paths.items()},
                   f"training_{MAE[0]}_remat": paths[MAE[0]]["remat_run"]["launches"][counter],
                   "attention_module": attn_launches[counter]}
        check(sum(by_path.values()) > 0, f"{name} launched on a main path")
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"kernel_times": [{"name": n, "shape": s_, **v} for (n, s_), v in timings.items()],
          "kernel9_vs_kernel8_max_rel": {str(b): v for b, v in stream_gap.items()},
          "packed_vs_unpacked_max_rel": {str(b): v for b, v in pack_gap.items()},
          "attention_core_max_rel": core_gap, "kernel12_equals_k2_core": same_core,
          "kernel13_twice_bit_equal": same_bwd})
    emit({
        "main_path": {"seconds": t_main, "encoder_calls": encoder_calls, "launches": launches,
                      "tokens_max_rel_vs_plain": tok_rel, "tokens_max_abs_vs_plain": tok_abs,
                      "top300_overlap_vs_plain": overlap},
        "encoder": {f"B={b}": v for b, v in enc.items()},
        "gemm_times": gemm_times,
        "bwd_gemm_times": bwd_gemm_times,
        "training_paths": paths,
        "attention_module": attention_module,
        "retrieval_path": retrieval,
        "bank_1M_bf16": {"query_ms_host": q_host_ms, "queries_per_s": 1e3 / q_host_ms,
                         "bank_topk_ms": topk_ms},
        "build_s": build_s,
        "phase_s": phase_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_s": t_total,
    })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
