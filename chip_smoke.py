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
   fp32 forms of every block kernel, masked too, in the same libraries; the
   multi-query bank scorer) from the sources in the checkout, one nvcc per
   source, all at once; Triton compiles the bank scorer;
3. kernel parity, each kernel against its plain PyTorch version on the same
   inputs: the serving kernels at the serving path's shapes (ViT-B: N=65,
   D=768, H=12, F=3072 at B=64 and B=1024; a 1M x 768 bank in bf16 and fp32;
   kernel 11 on it at Q = 1, 8, 64 and on ragged 1 000 003-row banks of
   width 3072 and 37 at Q = 130; timed at Q = 1, 8, 64 on the bf16 bank and
   Q = 8 on the fp32 one, by CUDA events and device time, beside its bound
   and ``torch.mm`` of the bank with ``[wt | w]``, which reads the same
   bytes once, as ``read_yardstick_ms``), max|a-b|/max|b| within the bars
   of tools/kernel_parity.py (2e-2; bank fp32 5e-3); the training kernels at their paths' shapes, every output within
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
   inputs bit-equal (bf16 at ViT-B B=1024, fp32 at both fp32 shapes); each
   timed in bf16 at ViT-B B=1024 and ViT-H B=256 and in fp32 at ViT-B B=64
   and ViT-H B=32 beside ``F.scaled_dot_product_attention`` on the same
   (B, H, N, hd) views (fp32 with TF32 off), forward and forward +
   backward (the library column, measured here and used nowhere in the
   port; beside kernel 13 also SDPA's backward alone), by CUDA events and
   by the profiler's device time, each record with its share of the bound
   (fp32: the faster of the CUDA cores' FMAs and 3xTF32 on the tensor
   cores, PEAK_FP32_PRODUCTS) and the bytes it must move per ms; fp32
   SDPA's gap to the plain versions printed as information; the forward
   GEMM of K1 and K2 (``csrc/gemm_sm90.cuh``, wgmma fed by TMA) alone at
   the four products (qkv, proj, fc1, fc2 with their epilogues) at B=64 and
   B=1024, held to its plain version and timed beside ``torch.addmm`` on
   the same operands (the ``gemm_times`` record, with the host cost of
   encoding a launch's TMA maps); the backward products of kernels 8, 9
   and 7 on the same GEMM (the dual product a = y @ W1 + b1 with dh = g @
   W2^T, dh alone on the K-major-B form, the stash dh product, dh with an
   epilogue that reads the bf16 stash a, dy, and
   dW1, dW2 on the transposed-A form) at ``mim_1`` B=64 and 512 (kernel 7's
   ``mim_25_large`` shapes at B=64 and 512) and at one ViT-H slab, held to
   their plain versions and timed beside ``torch.mm`` on the same operand
   views, with kernel 8's, 7's and 9's device time by kernel name; the
   products of
   kernels 3 and 4 (the qkv recompute on the forward form, dctx and dy on
   the K-major-B form, dWqkv with dWproj in one transposed-A group) at
   ``mim_1`` B=64 and 512 and at ViT-H B=256 beside ``torch.addmm`` /
   ``torch.mm``, with kernel 3's and 4's device time by kernel name (the
   ``bwd_gemm_times`` record); the fp32 forms of K2, kernels 2 and 3, K1
   and kernel 8 (the fp32 configs' path) at ViT-B B=64 (N=65) and at
   ``cls_fs_1k``'s B=256 (N=66) on inputs drawn in fp32, every output
   against the plain version (TF32 off) at TOL_F32_FORMS, each launch an
   fp32 one, timed by CUDA events and device time beside the plain
   version, bound at PEAK_FP32_PRODUCTS; their GEMM (``csrc/gemm_f32.cuh``,
   3xTF32 on wgmma fed by TMA) alone at ``cls_fs_1k``'s twelve products (the
   forward, NT and TN forms with their epilogues) and at three M = 2 112
   ones (kernel 4's dctx and dy at ``mim_32`` B=32, kernel 9's dy over one
   ViT-H slab at B=32) at TOL_GEMM_F32 beside fp32 ``torch.addmm`` /
   ``torch.mm``, with the plan's tile width and split (the
   ``gemm_f32_times`` record);
   then the fp32 forms of kernels 4, 6, 7, 9 and of the masked K2, 2 and 4
   alone (F32_NEW) at the fp32 paths' full widths: kernels 6 and 7 at
   ``cls_ft_1k_large``'s B=256 and ``mim_25_large``'s B=64 (ViT-L, 16
   heads of 48), kernel 4 at ``mim_32``'s B=32 (N=66, 16 heads of 64), the
   masked forms at MAE's packing (B=256, N=68, seg_len 17), kernel 9 at
   ViT-H B=32, the same way (kernel 6's out bit-equal to K1's fp32 form);
   then the five kernels of an I-JEPA step (K2, kernels 2 and 3, K1 and
   kernel 8) alone at the JEPA paths' widths (JEPA_SHAPES): in bf16 at
   jepa_struct's and jepa_1's ViT-S encoder (D=384, 6 heads of 64, N=64;
   B=256 and 64) and 192-wide predictor (3 heads of 64, N=77), in fp32 at
   jepa_tiny's encoder (D=192, N=16) and predictor (one head of 96, N=21),
   every output against the plain version (bf16 at TOL_FWD / TOL_BWD, fp32
   at TOL_F32_FORMS), one launch each, timed the same way;
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
5c. the predictor, through the entry points ``train_predictor`` and
   ``test_predictor`` call (``PredictorTrainer.train_batch`` / ``eval_batch``,
   ``warm_start``, ``predictor_infer``), at ``configs/mim_struct.ini``'s
   full ViT-B (depth 12, D=768, ``map`` pooling with 2 heads of 384), bf16,
   B=256, warm-started from the ``mim_1`` path's trained weights (the same
   width) and served from in-memory ``DeviceDataset`` s of structured
   cutouts on the card: ``z_struct_ft_512`` (``ft``: kernels 2, 3 and 8 at
   12 x 5, K1 at 12 x (5 + 2), K2 at 12 x 2), ``z_struct_fs_512`` (``fs``,
   from scratch, the same launches), ``z_struct_ap_512`` (``lp``: the frozen
   backbone under no grad, K1 and K2 at 12 x (5 + 2), no backward kernel)
   and ``ft`` with a 3-class crossentropy head, 5 steps and 2 validation
   batches each with the counters zeroed just before and read just after;
   each route's kernel path against its plain path from the same weights,
   optimizer state and augmentation draws (one step's gradients and loss,
   5 steps' losses); train-step times, device busy share and peak memory
   (``ft``, ``fs``, ``lp``); then ``predictor_infer`` over 4 batches (K1
   and K2 at 12 x 4) and its images/s;
5d. the fp32 predictor paths (configs that set no ``dtype``), as shipped,
   full width and depth, the sets in memory: ``cls_fs_1k`` (``fs``, ViT-B,
   9 bands, the RA/Dec token: N=66, B=256, 3-class cross-entropy) with the
   fp32 forms of kernels 2, 3 and 8 at 12 x 3, K1 at 12 x (3 + 1), K2 at
   12 x 1; ``lp_1`` (``lp`` over ``mim_1``'s ViT-B warm-started from the
   ``mim_1`` path's weights, B=128) with those of K1 and K2 at 12 x (3 + 1)
   alone; every launch fp32, counted apart (``*_f32``). Each route's kernel
   path against its plain path (TOL_PRED_F32), the step's time, busy share
   and peak memory; each route's ``predictor_infer`` in fp32 over 4
   batches (K1 and K2 alone) and its images/s;
5e. the fp32 large and tiny configs, as shipped, the sets in memory as in
   5d: the predictor's ``cls_ft_1k_large`` (``ft`` over ``mim_25_large``'s
   ``mimlarge``: ViT-L, depth 24, 16 heads of 48, the MLP stash; B=256,
   3-class cross-entropy), ``z_ft_2`` (``ft`` over ``mim_32``'s: D=1024, 16
   heads of 64, the RA/Dec token, N=66, B=128, mse) and ``z_tiny`` (``ft``
   over ``mim_tiny``: heads of 4), each from seeded weights, the fp32 forms
   of kernels 2, 3, 6 and 7 (or K1 and kernel 8 without the MLP stash) in
   training and K1, K2 in validation and ``predictor_infer``; then
   pretraining ``mim_tiny``, ``mim_tiny_large`` (kernels 6 and 7) and
   ``mae_tiny`` (the encoder packed four 5-token samples a sequence: kernel
   2 masked and kernel 3; the one-head, 512-wide decoder without its stash:
   K2 and kernel 4; then MAE_TINY_REMAT's remat run, kernel 4 masked, and
   its gradients bit-equal to the stored path's) through ``training_phase``
   in the configs' own dtype, fp32, and ViT-H (``mim_32_vith`` in fp32,
   full depth: kernel 9's fp32 form); each with every launch an fp32 one,
   the kernel path against the plain path (TOL_PRED_F32, TOL_F32_PATHS),
   the step's time, busy share and peak memory;
5g. checkpoints and the sweep: ``mim_struct``'s ViT-B trainer state (bf16,
   B=256; the ``mim_1`` path's weights and AdamW moments) written as the
   JAX package's ``.ckpt.msgpack`` and as the port's ``.ckpt.pt``, each
   restored into a fresh trainer: params, moments and the next step's loss
   and every gradient bit-equal, with the write and read seconds, the
   file's GB and the host RSS; ``z_struct_ft_512`` warm-started from each
   file, its first step bit-equal; then ``z_struct_{ft,fs,ap}`` at 128 and
   512 labels as shipped but for 10 steps, through
   ``train_predictor_network`` with exact launches (``ft``, ``fs``: K2,
   kernels 2, 3, 8 and K1; ``ap``: K1 and K2 alone), scored through the
   compare twin's ``evaluate_model`` (JAX's row keys, finite);
5f. I-JEPA, through the entry points ``pretrain_jepa`` calls
   (``JEPATrainer``, ``train_network``), each config as shipped, seeded
   weights, cutouts in memory: ``jepa_struct`` (bf16, B=256, ViT-S: D=384,
   depth 12, 6 heads of 64, over 64 tokens; the 192-wide predictor, depth
   4, 3 heads of 64, over 64 + 13 tokens, four passes a step) through
   ``train_network`` for 10 steps, 2 validation batches and one probe
   pass on the ``attn_pool`` path's structured sets; kernels 2, 3 and 8
   at 28 a step, K1 at 40, K2 at 12 (the EMA target's encode), K2 and K1
   at 40 a validation batch and 12 a probe batch, nothing else; the EMA
   target equal to the online encoder at step 0 and moving less than it;
   the kernel path against the plain path (TOL_JEPA); save, restore and
   one more step bit-equal to the uninterrupted run's; the step's time,
   busy share, peak memory, and by part (inputs, masks, target encode,
   context and predictor forward, backward, AdamW, EMA) the device's ms
   (CUDA events, the device drained and then held by a sleep kernel while
   the host queues the part) and the host's ms to queue it.
   ``jepa_1`` (9 bands, B=64): 3 steps, the same launches a step, timed.
   ``jepa_tiny`` (fp32, B=16, D=192 over 16 tokens, the 96-wide one-head
   predictor over 21): 10 steps and 2 validation batches, every launch an
   fp32 one, kernel vs plain path, timed;
5h. CosmicEmbeds (``models/cosmos.py``) at the module's defaults (64 x 64,
   patch 8, 5 bands, D=384, depth 12, 6 heads of 64: 70 tokens), B=256,
   seeded weights, synthetic cutouts with whole-band NaNs, their RA/Dec and
   HSC's five wavelengths, in fp32 (its default) and bf16: 4 Adam steps of
   ``loss`` at lr 3e-3 alternating no context and a context hidden by
   per-band ``MaskGenerator(64, 8, 0.9, 5)`` pixel masks (kernels 2, 3, 8
   and K1 at 12 a step, fp32 forms in fp32), then ``generate`` under no
   grad with each (K2 and K1 at 12 a call), counters zeroed just before
   each and read just after; each loss, every gradient and ``generate``'s
   images kernel path against plain path, under the L1 loss as shipped and,
   with no context, the MSE loss (TOL_COSMOS); the step's time, busy share
   and peak memory, ``generate``'s images/s;
5i. the training loop's host-to-device prefetch (``data/prefetch``): the
   ``mim_1`` (B=64) and ``jepa_struct`` (B=256) trainers through
   ``train_network`` on numpy batches, against the synchronous copy
   ``train_batch`` takes, from one seed on the same batches: every loss
   and parameter bit-equal, launches exact; then both loops timed in turns
   (synchronous, prefetch, prefetch, synchronous, twice), wall and device
   ms a step and the busy share;
5j. data parallelism across processes (``parallel/``; :func:`dp_phase`):
   ``mim_1`` with DDP and ZeRO-1 at world 1 under NCCL against no process
   group, then two ranks on the one card through gloo against one process;
5k. the figures, the per-GPU launcher and the data stages
   (:func:`figures_phase`): ``mim_reconstruct`` on ``mim_1`` (B=64) and on
   the MAE path's model (B=256) through K2 and K1 (the masked K2 in MAE's
   packed encoder), launches exact, the masked input NaN exactly at the
   drawn mask, the prediction the input outside it, the kernel path within
   TOL_FWD of ``Encoder.plain``; ``train_network`` with and without
   ``fig_dir`` bit-equal (without matplotlib each figure warns and writes
   nothing); two chained runs queued through ``cluster/queue_gpu``'s local
   backend, one ``--queue-worker`` process a GPU through the ``SKY_*``
   contract (NCCL), bit-equal to one continuous run; the data stages on
   1M sources and a 1024² FITS patch, their planted answers recovered and
   every h5 stage refused without h5py, each timed;
5l. tensor parallelism (``parallel/sharding.py``; :func:`tp_phase`): the
   tensor-parallel forms of K2, kernel 4, K1 and kernel 8 (each split at
   the all-reduce into the rank's half and a finish), bf16 and fp32,
   against the unsharded plain block at mim_32's shapes, masked at N = 68,
   seg_len = 17, and at jepa_struct's ViT-S encoder (3 local heads of 64,
   F / 2 = 768, B = 256 over the 64-token grid, which is also its context
   budget), both ranks' halves in one process, the partials summed; then
   ``mim_32`` as shipped at full depth and width, the predictor's
   ``z_struct_ft_512`` (bf16 ``ft``) and ``lp_1`` (fp32 ``lp``),
   ``mim_tiny`` (fp32), ``jepa_struct`` as shipped (its encoder and EMA
   target split, its 3-head predictor whole on both ranks) and
   ``mae_tiny`` (fp32, its one-head decoder whole) at ``tensor_parallel =
   2`` on two ``--tp-worker`` processes (gloo on one card, NCCL across two)
   against one process: gradients, losses, parameters (and the EMA
   target's) within TOL_TP, the replicated parameters (the whole blocks'
   and the target's too) bit-equal across the ranks after every step, each
   rank's launches the predicted ones (the TP forms in the split blocks,
   K2, kernel 4, K1 and kernel 8 in the whole ones), the ranks' mim_32 and
   jepa_struct saves restored by one process bit-equal and each rank's
   restored step bit-equal; step ms, collectives' ms and share, device ms
   and peak GB per rank; then (``tp_stream_k``) the C group plan against
   its Python mirror at every TP form's weight-gradient group, kernel 4's
   and 8's TP backward halves launch by launch at the timed shapes (the
   parent's, for the same table: ``tools/tp_bwd_breakdown.py``), and the
   TP_GROUPS groups alone: against their plain versions, twice bit-equal,
   timed under the plan beside the split schedule's plan forced (1 and 2
   slices);
5b. the ``Attention`` module (``models/layers.Attention``, the only caller of
   kernels 12 and 13, as in JAX) at ViT-B width, B=64, in bf16 and at its
   default fp32: one forward and ``backward()`` through autograd with the
   counters zeroed just before, kernels 12 and 13 at one launch each and
   nothing else; its gradients against the plain path's (bf16 at TOL_BWD,
   fp32 at TOL_ATTN_F32);
6. times with CUDA events after warm-up: per kernel at its path's shapes,
   the encoder (with its device busy share), queries; torch.profiler
   device breakdowns.

Lines before the last: the nvidia-smi name/power line, one line per check,
JSON lines of results (``{"kernels": [...]}`` among them). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # a --queue-worker times its imports from here

# H100 SXM data sheet (dense): bf16 tensor-core, fp32 non-tensor, TF32
# tensor-core, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the fastest way the card does an fp32 product: FMAs at PEAK_FP32 or three
# TF32 products per fp32 one (3xTF32, as fp32 SDPA runs) at PEAK_TF32
PEAK_FP32_PRODUCTS = max(PEAK_FP32, PEAK_TF32 / 3)

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
# Measured on the H100 (PERF.md): the forward bit-equal (the same fp32 FMA
# chains, expf and e / sum), the backward 1.87e-7 at ViT-B B=64 and 1.47e-7
# at ViT-H B=32 (dS's row sums run in another order); fp32 SDPA (3xTF32)
# lies 1.07e-6 to 1.57e-6 from the plain versions on the same inputs, over
# the bar, which stays as first set.
TOL_CORE_F32 = 5e-7
# the Attention module in fp32 at ViT-B, B=64 (kernels 12 and 13 between
# fp32 Linears), gradients against the plain path's. Measured on the H100
# (PERF.md): 1.80e-7 at worst (x; qkv.kernel 3.8e-8, proj's bit-equal:
# kernel 12 is). The bar is about twice.
TOL_ATTN_F32 = 4e-7
# the predictor (ViT-B, depth 12, B=256, pool and head on top): one step's
# gradients (||a - b|| / ||b|| per trainable leaf) and loss, and the
# losses of PRED[3] steps, kernel path against the plain path from the same
# weights, optimizer state and augmentation draws. Measured on the H100
# (PERF.md): gradients 7.4e-3 at worst (fs, patch_mask_values; ft
# 5.4e-3, lp 7.0e-3 over the head's 17 leaves, ce 3.4e-3), one step's loss
# 8.4e-5, five steps' losses 2.2e-4. The bars are about twice those.
TOL_GRAD_PRED, TOL_LOSS_PRED = 1.5e-2, 5e-4
# the fp32 forms of K1, K2 and kernels 2, 3 and 8 alone against their plain
# versions (TF32 off), max|a-b|/max|b| per output, and their GEMM
# (csrc/gemm_f32.cuh, 3xTF32) alone against fp32 torch.mm at cls_fs_1k's
# products. Measured on the H100 (PERF.md): the forms 2.25e-6 at worst
# (kernel 8's dx at B=256; K1 2.1e-6, kernel 3's dx 1.4e-6), the GEMM
# 2.5e-6 (dy = da @ W1^T, K = 3 072; 8.5e-7 to 2.0e-6 elsewhere). The bars
# are about twice those; none may be looser than 1e-4, which keeps them
# fp32 results (the bf16 bars are 2e-2 and 3e-2).
TOL_F32_FORMS = 5e-6
TOL_GEMM_F32 = 5e-6
# the fp32 predictor paths (ViT-B depth 12), kernel path against plain path
# from the same weights, optimizer state and generator: one step's
# gradients (||a - b|| / ||b|| per trainable leaf) and loss, and the losses
# of PRED_F32_RUN[0] steps, by route. Measured on the H100 (PERF.md): fs
# (cls_fs_1k) gradients 6.7e-6 at worst (pool.xattn.q.kernel; median
# 2.2e-7), lp (lp_1: the head's 17 leaves) 7.0e-4 at worst on the same
# leaf, whose gradient is a near-cancelling sum over the keys of tokens
# that differ by about 1e-6 (median 2.9e-7); losses 1.8e-7 (fs) and 0
# (lp). The bars are about twice those.
TOL_PRED_F32 = {"fs": (1.5e-5, 4e-7), "lp": (1.5e-3, 4e-7)}  # route: (gradients, losses)
# the fp32 large and tiny predictor paths (ft over mimlarge and simmim
# backbones), the same way, by label. Measured on the H100 (PERF.md):
# cls_ft_1k_large gradients 1.24e-4 at worst (pool.xattn.q.kernel, as lp;
# median 1.4e-6), one step's loss 3.0e-7, three steps' losses 1.76e-5: the
# shipped ft learning rate (weight_decay's 0.05, JAX's quirk) drives the
# seeded ViT-L's loss from 1.1 to 6e4 in six steps, and the trajectories
# part as the losses grow; z_ft_2 2.23e-4 on the same leaf (median 3.5e-7),
# loss 0, steps 4.6e-6 (its loss too grows to 2e5, then falls); z_tiny
# 4.6e-6 (pool.mlp.fc2.bias), losses 0. The bars are about twice those; a
# loss gap measured 0 gets two fp32 ulps (2.5e-7).
TOL_PRED_F32.update({"ft_large": (2.5e-4, 4e-5), "ft_z": (4.5e-4, 1e-5), "ft_tiny": (1e-5, 2.5e-7)})
# the fp32 pretraining paths (tiny configs as shipped; ViT-H in fp32),
# kernel path against plain path: (gradients, losses). Measured on the H100
# (PERF.md): mim_tiny gradients 5.7e-7 at worst, one step's loss 0, five
# steps' 6.4e-8; mim_tiny_large 8.3e-7, 1.0e-7, 1.3e-7; mae_tiny 5.3e-7, 0,
# 6.7e-7; ViT-H in fp32 7.4e-7 (the RA/Dec SIREN's first layer), 0, 0. The
# bars are about twice those (two fp32 ulps where 0 was measured).
TOL_F32_PATHS = {"mim_tiny": (1.2e-6, 2.5e-7), "mim_tiny_large": (1.7e-6, 2.6e-7),
                 "mae_tiny": (1.1e-6, 1.4e-6), "mim_32_vith_f32": (1.5e-6, 2.5e-7)}

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
# the predictor path: mim_struct's ViT-B (the width of mim_1, whose trained
# weights it warm-starts from) under each route's config, the "ce" route
# z_struct_ft_512 with a 3-class crossentropy head; (pretraining config,
# route -> config, batch, train steps, validation batches, predictor_infer
# batches, timed steps)
PRED = ("mim_struct", {"ft": "z_struct_ft_512", "fs": "z_struct_fs_512", "lp": "z_struct_ap_512",
                       "ce": "z_struct_ft_512"}, 256, 5, 2, 4, 10)
PRED_CE = {"DATA": {"label_keys": "['class']", "num_classes": "3", "label_means": "[0]",
                    "label_stds": "[1]"}, "TRAINING": {"loss_fn": "crossentropy"}}
# the fp32 predictor paths (configs without a dtype, as 43 shipped ones
# are), as shipped: label -> (config, label key, training-set batches); then
# (train steps, validation batches, predictor_infer batches, timed steps).
# PRED_F32 (phase 5d): fs over ViT-B, lp over mim_1's; PRED_F32_LARGE
# (phase 5e): ft over mim_25_large's mimlarge (ViT-L, 16 heads of 48, the
# MLP stash), over mim_32's (D=1024, 16 heads of 64, the RA/Dec token) and
# over mim_tiny's (heads of 4)
PRED_F32 = {"fs": ("cls_fs_1k", "class", 5), "lp": ("lp_1", "zspec", 4)}
PRED_F32_LARGE = {"ft_large": ("cls_ft_1k_large", "class", 5), "ft_z": ("z_ft_2", "zspec", 4),
                  "ft_tiny": ("z_tiny", "zspec", 4)}
PRED_F32_RUN = (3, 1, 4, 5)
# the fp32 pretraining paths (phase 5e): the tiny configs as shipped (heads
# of 4; mim_tiny_large with the MLP stash; mae_tiny with four 5-token
# samples packed per encoder sequence and its one-head, 512-wide decoder
# without the stash) and ViT-H (mim_32_vith) in fp32, whose wide blocks
# take kernel 9; (config, steps, validation batches, train-step batches
# with their timed iterations); then mae_tiny's remat run (batch, steps)
F32_TRAIN = (("mim_tiny", 10, 2, ((16, 10),)), ("mim_tiny_large", 10, 2, ((16, 10),)),
             ("mae_tiny", 10, 2, ((16, 10),)), ("mim_32_vith_f32", 3, 1, ((32, 3),)))
MAE_TINY_REMAT = (16, 3)
# the fp32 forms alone: (label, B, N) at mim_1's ViT-B (N=65) and at
# cls_fs_1k's batch with the RA/Dec token (N=66)
F32_SHAPES = (("vitb", 64, 65), ("cls_fs", 256, 66))
# the fp32 forms kernels 4, 6, 7, 9 and the masks added, alone at the fp32
# paths' full widths: (label, B, N, D, H, F, seg_len, forms): kernels 6 and
# 7 at cls_ft_1k_large's B=256 and mim_25_large's B=64 (ViT-L, 16 heads of
# 48), kernel 4 at mim_32's B=32 (N=66, 16 heads of 64), the masked K2,
# kernel 2 and kernel 4 at MAE's ViT-B packing (256 sequences of four
# 17-token samples), kernel 9 at ViT-H B=32 (four slabs of 1280)
F32_NEW = (("cls_ft_large", 256, 65, 768, 16, 3072, 0,
            ("mlp_block_fwd_stash_f32", "mlp_block_bwd_stash_f32")),
           ("mim_25_large", 64, 65, 768, 16, 3072, 0,
            ("mlp_block_fwd_stash_f32", "mlp_block_bwd_stash_f32")),
           ("mim_32", 32, 66, 1024, 16, 4096, 0, ("attn_block_bwd_f32",)),
           ("mae", 256, 68, 768, 12, 3072, 17,
            ("attn_block_fwd_seg_f32", "attn_block_fwd_stash_seg_f32", "attn_block_bwd_seg_f32")),
           ("vith", 32, 66, 1280, 16, 5120, 0, ("mlp_block_bwd_stream_f32",)))
# the five kernels an I-JEPA step runs (K2, kernels 2 and 3, K1 and kernel
# 8) alone at the widths of the JEPA paths (phase 5f): (label, B, N, D, H,
# F, dtype): jepa_struct's ViT-S encoder (B=256, N=64, 6 heads of 64) and
# 192-wide predictor (N=77: 64 context slots and 13 queries, 3 heads of
# 64), jepa_1's two at B=64, jepa_tiny's fp32 encoder (B=16, N=16, 3 heads
# of 64) and predictor (N=21, one head of 96)
JEPA_SHAPES = (("jepa_struct_enc", 256, 64, 384, 6, 1536, "bfloat16"),
               ("jepa_struct_pred", 256, 77, 192, 3, 768, "bfloat16"),
               ("jepa_1_enc", 64, 64, 384, 6, 1536, "bfloat16"),
               ("jepa_1_pred", 64, 77, 192, 3, 768, "bfloat16"),
               ("jepa_tiny_enc", 16, 16, 192, 3, 768, "float32"),
               ("jepa_tiny_pred", 16, 21, 96, 1, 384, "float32"))
# the I-JEPA paths (phase 5f), as shipped: (config, train steps, validation
# batches, timed steps); jepa_struct runs through train_network with one
# probe pass on the attn_pool path's structured probe sets, then the
# kernel-vs-plain check, save/restore and the step's parts; jepa_1 (9
# bands, B=64) its launches and step time; jepa_tiny in fp32
JEPA_RUNS = (("jepa_struct", 10, 2, 10), ("jepa_1", 3, 0, 10), ("jepa_tiny", 10, 2, 10))
# kernel path vs plain path (context and target encoders and the
# predictor), one step's gradients (||a - b|| / ||b|| per leaf) and loss and
# TRAJ_STEPS steps' losses: (gradients, losses). Measured on the H100
# (PERF.md): jepa_struct gradients 2.78e-3 at worst
# (encoder.patch_embed.proj.kernel; median 3.7e-4), one step's loss
# 9.6e-6, five steps' losses 3.3e-5; jepa_tiny (fp32) gradients 7.0e-7 at
# worst (median 4.0e-7), losses 0. The bars are about twice those (two
# fp32 ulps where 0 was measured).
TOL_JEPA = {"jepa_struct": (5.5e-3, 7e-5), "jepa_tiny": (1.4e-6, 2.5e-7)}
# CosmicEmbeds (phase 5h) at the module's defaults (img 64, patch 8, 5 bands,
# D=384, depth 12, 6 heads of 64: N = 1 + 5 + 64 = 70 tokens), in fp32 (its
# default) and bf16: (batch, Adam steps, timed steps, timed generate
# calls); the steps alternate the loss with no context and with a context
# hidden by per-band MaskGenerator(64, 8, 0.9, 5) pixel masks; wavelengths
# HSC's g, r, i, z, y (nm)
COSMOS = (256, 4, 10, 10)
HSC_NM = (477.0, 622.0, 770.0, 891.0, 978.0)
# kernel path vs plain path (Encoder.plain) from the same weights, per
# dtype: each loss's gradients (||a - b|| / ||b|| per leaf), the losses
# |a - b| / |b|, and generate's images max|a - b| / max|b|; the L1 loss as
# shipped with no context and with the masked context, and the MSE loss
# with no context. Measured on the H100 (PERF.md): fp32 gradients 1.60e-4
# at worst (patch_embed.proj.kernel, masked context; median 3.1e-5), losses
# bit-equal, images 1.73e-6; bf16 gradients 8.69e-3 (the SIREN's first
# layer; median 1.6e-3), losses 1.52e-5, images 1.10e-2. The L1 gradient of
# a pixel is the sign of its error, so the few of B x 5 x 64 x 64 = 5.2M
# pixels whose prediction lies within the two paths' difference of its
# target flip, and each flip moves a leaf's gradient by far more than the
# kernels' rounding does (the MSE loss's gradients show that rounding
# alone). The bars are about twice the L1 gaps (two fp32 ulps where 0 was
# measured).
TOL_COSMOS = {"float32": (3.5e-4, 2.5e-7, 3.5e-6), "bfloat16": (1.75e-2, 3e-5, 2.2e-2)}
# the prefetching loop against the synchronous copy (phase 5i): (config,
# train steps checked bit-equal, steps a timed loop, steps a profiled
# loop); the loops are timed in four turns each, synchronous first
PREFETCH = (("mim_1", 6, 20, 4), ("jepa_struct", 4, 10, 4))
# phase 5j, data parallelism (parallel/): the mim_1 trainer (bf16 ViT-B)
# with DDP and [TRAINING] zero_optimizer = True, (config, global batch,
# steps, timed steps); at world 1 under NCCL against no process group, then
# on DP_RANKS ranks on the one card through gloo (NCCL refuses two ranks on
# one device); then the ft and I-JEPA legs on the ranks, (config, steps),
# at their shipped batch of 256
DP = ("mim_1", 64, 10, 10)
DP_LEGS = (("z_struct_ft_512", 3), ("jepa_struct", 3))
DP_RANKS = 2
# two ranks of 32 against one process over the global 64: the same
# arithmetic but for the order of each weight gradient's sum over the
# batch (two halves summed by the all-reduce) and the GEMM plans the
# halved M picks, so the runs part by rounding flips, which Adam turns
# into steps that differ by up to lr where a gradient is near 0. Bars:
# (step 1's gradients ||a - b|| / ||b|| per leaf, the losses |a - b| / |b|,
# the parameters after the steps max |a - b| but for the key biases whose
# gradient is rounding noise, parallel/smoke.param_gaps, those to twice
# the summed lr: each run's Adam step of that noise is up to lr, either
# way). Measured on the H100 (PERF.md), the same in two runs: mim_1
# gradients 2.15e-3 at worst (cls_token, whose gradient sums the batch;
# median 7.3e-8), 10 steps' losses 5.86e-5, parameters 3.43e-4; ft losses
# 8.5e-6, parameters 6.56e-5; I-JEPA losses 1.22e-5, parameters 3.59e-4.
# The bars are about twice those.
TOL_DP = {"mim_1": (4.5e-3, 1.2e-4, 7e-4), "z_struct_ft_512": (None, 2e-5, 1.3e-4),
          "jepa_struct": (None, 2.5e-5, 7.2e-4)}
# the command that runs one rank of phase 5j (its spec file appended)
DP_WORKER = [os.path.abspath(__file__), "--dp-worker"]

# phase 5l, tensor parallelism. The four TP forms (K2, kernel 4, K1, kernel
# 8 split at the all-reduce), bf16 and fp32, against the unsharded plain
# block at TP_SHAPES (tag, B, N, D, heads, F, seg_len): mim_32's (8 local
# heads of 64, F / 2 = 2 048), masked, the MAE encoder's at N = 68,
# seg_len = 17, and jepa_struct's ViT-S encoder (3 local heads of 64, F / 2
# = 768; B = 256 over the 64-token grid, the target's sequence and the
# context budget alike); both ranks' halves in one process, the partials
# summed, then finished (TOL_FWD, TOL_BWD; the comparisons' launches
# uncounted), each form timed on one rank's shard at the TP_TIMED shapes
# in bf16. At jepa_struct's shard K2 TP's bf16 forward half takes the fused
# kernel: each rank's twice bit-equal and bit-equal to its chain, timed
# beside it; the C path rule equals its Python mirror at every TP_SHAPES
# shape and every bf16 leg's split-block shape; the chains' held-row LN
# gives the multi-pass LN's bits at LN_WIDTHS. Then TP_RANKS
# processes at tensor_parallel = 2 (--tp-worker; gloo on one card, NCCL
# across cards) take TP_LEGS (config, steps) as
# shipped: mim_32 at full depth and width (ViT-L, remat, RA/Dec, bf16, B =
# 32), the predictor's bf16 ft and fp32 lp, mim_tiny in fp32 (the fp32
# backward forms), jepa_struct (ViT-S depth 12, 5 bands, the 192-wide
# 3-head predictor whole on both ranks, bf16, B = 256) and mae_tiny (fp32,
# the one-head decoder whole), against one process from the same weights,
# batches and draws; the TP_CKPT legs' saves restored.
TP_SHAPES = (("mim_32", 32, 66, 1024, 16, 4096, 0), ("mae", 32, 68, 768, 12, 3072, 17),
             ("jepa_struct", 256, 64, 384, 6, 1536, 0))
TP_TIMED = ("mim_32", "jepa_struct")
# the launches of a bf16 forward half in each form (csrc/attn_block_tp.cu,
# csrc/mlp_block.cu), and the widths at which the held-row LN of the TP
# forms is compared with the whole blocks' multi-pass LN
TP_HALF_LAUNCHES = {"attn_block_tp": {"fused": 1, "chain": 4}, "mlp_block_tp": {"chain": 3}}
LN_WIDTHS = (384, 768, 1024, 1280)
TP_RANKS = 2
TP_LEGS = (("mim_32", 3), ("z_struct_ft_512", 3), ("lp_1", 3), ("mim_tiny", 3),
           ("jepa_struct", 3), ("mae_tiny", 3))
TP_CKPT = ("mim_32", "jepa_struct")
# two ranks against one process: the same arithmetic but for where the
# proj and fc2 products' fp32 sums split (each rank sums its half of K, the
# all-reduce adds the halves) and the local GEMMs' plans, so the runs part
# by rounding flips, which Adam turns into steps that differ by up to lr
# where a gradient is near 0. Bars (step 1's gradients ||a - b|| / ||b||
# per leaf, the losses |a - b| / |b|, the parameters after the steps max
# |a - b| but for the key biases (parallel/smoke.param_gaps), those to
# twice the summed lr), about twice the gaps measured on the H100
# (PERF.md §2). Measured (NVIDIA H100 80GB HBM3, 700.00 W): mim_32
# gradients 2.774e-2 at the RA/Dec Siren's first kernel (it sums the batch
# in bf16), 3 steps' losses 2.755e-4, parameters 5.578e-4; ft 4.048e-3 /
# 2.312e-5 / 1.072e-4; lp_1 (fp32) 3.282e-6 / 0 / 2.105e-6; mim_tiny
# (fp32) 3.397e-7 / 0 / 6.147e-6; jepa_struct 2.702e-3 at the patch
# embedding (it sums the batch in bf16) / 3.298e-5 / 6.941e-4, its EMA
# target 6.766e-6; mae_tiny (fp32, its decoder whole) 3.304e-7 / 0 /
# 1.695e-5. A gap measured 0 gets two fp32 ulps, 2.5e-7, as §2 of PERF.md
# does.
TOL_TP = {"mim_32": (5.5e-2, 5.5e-4, 1.1e-3), "z_struct_ft_512": (8e-3, 4.6e-5, 2.2e-4),
          "lp_1": (6.6e-6, 2.5e-7, 4.2e-6), "mim_tiny": (7e-7, 2.5e-7, 1.23e-5),
          "jepa_struct": (5.4e-3, 6.6e-5, 1.4e-3), "mae_tiny": (6.6e-7, 2.5e-7, 3.4e-5)}
# the EMA target's parameters after the steps (max |a - b|), where a leg has one
TOL_TP_TARGET = {"jepa_struct": 1.4e-5}
# the command that runs one rank of phase 5l (its spec file appended)
TP_WORKER = [os.path.abspath(__file__), "--tp-worker"]
# the weight-gradient groups phase 5l times alone (label, [(M, N, K), ...]):
# every group of the bf16 paths this script drives where the group plan
# takes stream-K (tests/test_torch_gemm_plan.py holds the list whole): the
# backward TP forms' at jepa_struct's ViT-S shard, the whole kernels 3 / 4
# and 7 / 8 at jepa_struct's and jepa_1's encoder and predictor, and the
# bench's kernels 3 / 4 at the MAE decoder (B=1024) and the head of 512;
# and jepa_struct's encoder kernel 8 group, where the split schedule stays
TP_GROUPS = (("4 TP jepa_struct", ((384, 576, 16384), (192, 384, 16384))),
             ("8 TP jepa_struct", ((384, 768, 16384), (768, 384, 16384))),
             ("kernel 3 jepa_struct", ((384, 1152, 16384), (384, 384, 16384))),
             ("kernel 8 jepa_struct", ((384, 1536, 16384), (1536, 384, 16384))),
             ("kernel 3 jepa_struct predictor", ((192, 576, 19712), (192, 192, 19712))),
             ("kernel 8 jepa_struct predictor", ((192, 768, 19712), (768, 192, 19712))),
             ("kernel 3 jepa_1", ((384, 1152, 4096), (384, 384, 4096))),
             ("kernel 3 jepa_1 predictor", ((192, 576, 4928), (192, 192, 4928))),
             ("kernel 8 jepa_1 predictor", ((192, 768, 4928), (768, 192, 4928))),
             ("kernel 3 mae decoder B=1024", ((512, 1536, 66560), (512, 512, 66560))),
             ("kernel 3 head of 512 B=64", ((512, 1536, 4160), (512, 512, 4160))))

# the retrieval path: a FITS survey of FITS_TILES tiles of FITS_SIZE^2 pixels
# per band, searched at FITS_OVERLAP for N_GROUPS target groups; kernel 11 at
# MULTI_Q queries on the 1M bank and at RAGGED (rows, width, queries); the
# chunked scorer in SLAB_ROWS-row slabs
FITS_TILES, FITS_SIZE, FITS_OVERLAP, N_GROUPS = 4, 1024, 0.4, 4
MULTI_Q = (1, 8, 64)
RAGGED = ((1_000_003, 3072, 130), (1_000_003, 37, 130))
SLAB_ROWS = 300_000


# phase 5g, checkpoints and the sweep: mim_struct's ViT-B trainer state (the
# mim_1 path's weights and AdamW moments) through the JAX package's
# format and the port's, a warm start of the second config from each, then
# a mini sweep of the families at the sizes through the compare twin;
# (pretraining config, warm-started config, families, sizes, train steps,
# structured train rows, val rows)
CKPT = ("mim_struct", "z_struct_ft_512", ("ft", "fs", "ap"), ("128", "512"), 10, 512, 512)

# phase 5k, the figures, the launcher and the data stages: mim_reconstruct
# on mim_1 (SimMIM, B=FIG[1]) and on the MAE path's model (bench_mae's
# base, B=FIG[2]); train_network for FIG_TRAIN[0] steps validating every
# FIG_TRAIN[1], with and without fig_dir; QUEUE[1] chained runs of
# QUEUE[0] steps each through cluster/queue_gpu's local backend, each run
# one QUEUE_WORKER process a GPU; the data stages on CATALOG (sources,
# references, planted pairs) and a PATCH (side, bands present of the five)
FIG = ("mim_1", 64, 256)
FIG_TRAIN = (4, 2)
QUEUE = (3, 2)
QUEUE_SEED = 41
QUEUE_WORKER = [os.path.abspath(__file__), "--queue-worker"]
CATALOG = (1_000_000, 100_000, 10_000)
PATCH = (1024, ("G", "R", "I", "Z"))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def predictor_phase(dev, mim_ckpt, zero_counters, launch_counts, step_times):
    """The predictor path, through the entry points ``train_predictor`` and
    ``test_predictor`` call, at mim_struct's full ViT-B width (depth 12,
    D=768, ``map`` pooling with 2 heads of 384), bf16, B=256, the sets in
    memory (structured cutouts) served from a ``DeviceDataset`` on the card.
    For each route (``ft``, ``fs``, ``lp``, and ``ft`` with a crossentropy
    head): the trainer, warm-started (not ``fs``) from ``mim_ckpt``, takes
    PRED[3] steps and PRED[4] validation batches with the counters zeroed
    just before and read just after (``lp``: K1 and K2 only, no kernel of
    the backward); then the kernel path against the plain path from the
    same weights, optimizer state and generator; then (not for the
    crossentropy head, which runs ``ft``'s kernels) the step's time, device
    busy share and peak memory.
    Last, ``predictor_infer`` over PRED[5] batches (K1 and K2 only), and its
    images/s."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
    from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
    from sky_embeddings_tpu_torch.data.synthetic import make_structured_cutouts
    from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer

    mae_name, routes, B, steps, val_b, infer_b, timed = PRED
    cfg_dir = os.path.join(ROOT, "configs")
    mae = load_config(mae_name, cfg_dir)
    t0 = time.perf_counter()
    geom = dict(channels=mae.architecture.int("num_channels"),
                img_size=mae.architecture.int("img_size"))
    sets = {"train": make_structured_cutouts(2 * B, seed=14, **geom),
            "val": make_structured_cutouts(B * max(val_b, infer_b), seed=15, **geom)}
    print(f"predictor: sets of {2 * B} and {B * max(val_b, infer_b)} structured cutouts made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {"batch": B, "steps": steps, "val_batches": val_b, "routes": {}}
    for route, name in routes.items():
        cfg = load_config(name, cfg_dir)
        if route == "ce":
            cfg = apply_overrides(cfg, [f"{s}.{k}={v}" for s, kv in PRED_CE.items()
                                        for k, v in kv.items()], name + "_ce")
        key = "class" if route == "ce" else "zspec"
        check(cfg.training.int("batch_size") == B and cfg.training.str("dtype") == "bfloat16",
              f"{name}: bf16 at batch {B}")
        t_init = time.perf_counter()
        trainer = PredictorTrainer(cfg, mae, seed=0, device=dev)
        warm = []
        if route != "fs":
            check(trainer.warm_start(mim_ckpt, log_fn=warm.append), f"{route}: warm start")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        m = trainer.model
        layers = m.encoder.depth
        data = dict(label_keys=[key], device=dev)
        train_ds = DeviceDataset.from_arrays(
            sets["train"], B, shuffle=True,
            indices=range(cfg.training.int("num_train")), **data)
        val_ds = DeviceDataset.from_arrays(sets["val"], B, shuffle=False, **data)
        stream = train_ds.forever()
        zero_counters()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        train = [trainer.train_batch(next(stream)) for _ in range(steps)]
        val = [trainer.eval_batch(b) for b in val_ds.take(val_b)]
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        launches = launch_counts()
        if route == "lp":  # the frozen backbone: the inference kernels alone
            want = {"fused_attn_block": layers * (steps + val_b),
                    "fused_mlp_block": layers * (steps + val_b)}
        else:
            want = {"attn_block_fwd_stash": layers * steps, "attn_block_bwd_stash": layers * steps,
                    "mlp_block_bwd": layers * steps, "fused_mlp_block": layers * (steps + val_b),
                    "fused_attn_block": layers * val_b}
        losses = [[float(v) for v in pair] for pair in train + val]
        print(f"predictor {route} ({name}, {m.global_pool} pool, {m.num_labels} labels, "
              f"{trainer.loss_fn_name}, depth {layers}, D={m.embed_dim}, B={B}): {steps} steps + "
              f"{val_b} val batches in {t_run:.2f} s; (loss, metric) {losses}; {' '.join(warm)}; "
              f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
        check(bool(np.isfinite(losses).all()), f"predictor {route}: losses finite")
        for k_, n_ in launches.items():
            check(n_ == want.get(k_, 0), f"predictor {route}: {k_} launches {n_} == {want.get(k_, 0)}")

        # kernel path vs plain path from the same weights, optimizer state
        # and generator: one step's gradients and loss, then PRED[3] losses
        plain = PredictorTrainer(cfg, mae, seed=0, device=dev)
        plain.model.load_state_dict(m.state_dict())
        # a copy: load_state_dict keeps the tensors it is given
        plain.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
        plain.generator.set_state(trainer.generator.get_state())
        plain.step = trainer.step
        plain.model.plain = True
        batches = [next(stream) for _ in range(steps)]
        traj, grads = [], []
        for tr in (trainer, plain):
            traj.append([float(tr.train_batch(b)[0]) for b in batches[:1]])
            grads.append({n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                          if p.grad is not None})
            traj[-1] += [float(tr.train_batch(b)[0]) for b in batches[1:]]
        grad_rel = {n: float((a - grads[1][n]).norm() / (grads[1][n].norm() + 1e-30))
                    for n, a in grads[0].items()}
        worst = max(grad_rel, key=grad_rel.get)
        loss_rel = abs(traj[0][0] - traj[1][0]) / abs(traj[1][0])
        traj_rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
        n_train = sum(1 for p in m.parameters() if p.requires_grad)
        print(f"predictor {route} kernel vs plain path: loss rel {loss_rel:.3e}; gradient "
              f"||a-b||/||b|| max {grad_rel[worst]:.3e} ({worst}), median "
              f"{float(np.median(list(grad_rel.values()))):.3e} over {len(grad_rel)} leaves (bar "
              f"{TOL_GRAD_PRED}); {steps}-step losses kernel {[round(v, 5) for v in traj[0]]} "
              f"plain {[round(v, 5) for v in traj[1]]}, max rel {traj_rel:.3e} (bar {TOL_LOSS_PRED})",
              flush=True)
        check(len(grad_rel) == n_train and grads[0].keys() == grads[1].keys(),
              f"predictor {route}: every trainable leaf, and only those, gets a gradient")
        check(all(np.isfinite(list(grad_rel.values()))) and grad_rel[worst] <= TOL_GRAD_PRED,
              f"predictor {route}: gradients kernel vs plain")
        check(loss_rel <= TOL_LOSS_PRED and traj_rel <= TOL_LOSS_PRED,
              f"predictor {route}: losses kernel vs plain")
        del plain, grads
        torch.cuda.empty_cache()

        out["routes"][route] = {
            "config": cfg.name, "loss_fn": trainer.loss_fn_name, "train_method": trainer.train_method,
            "layers": layers, "embed_dim": m.embed_dim, "num_labels": m.num_labels,
            "trainer_init_s": t_init, "seconds": t_run, "launches": launches, "losses": losses,
            "warm_start": warm, "trainable_leaves": n_train,
            "loss_rel_vs_plain": loss_rel, "grad_rel_vs_plain_max": grad_rel[worst],
            "grad_rel_worst_leaf": worst,
            "grad_rel_vs_plain_median": float(np.median(list(grad_rel.values()))),
            "trajectory_kernel": traj[0], "trajectory_plain": traj[1], "trajectory_max_rel": traj_rel}
        if route == "ce":  # ft's kernels and step with another loss: not timed again
            del trainer
            continue
        tb = next(stream)
        out["routes"][route]["train_step"] = step_times(lambda: trainer.train_batch(tb), B, timed,
                                                        f"predictor {route}")
        if route == "ft":
            kept = (trainer, val_ds)
        del trainer
        torch.cuda.empty_cache()

    # predictor_infer over PRED[5] batches of the fine-tuned model
    trainer, val_ds = kept
    model = trainer.model.eval()
    zero_counters()
    torch.cuda.synchronize()
    t_inf = time.perf_counter()
    targets, preds = predictor_infer(model, val_ds.take(infer_b))
    torch.cuda.synchronize()
    t_inf = time.perf_counter() - t_inf
    launches = launch_counts()
    layers = model.encoder.depth
    check(targets.shape == preds.shape == (infer_b * B, 1) and bool(np.isfinite(preds).all()),
          f"predictor_infer: {preds.shape} finite")
    for k_, n_ in launches.items():
        want_n = layers * infer_b if k_ in ("fused_attn_block", "fused_mlp_block") else 0
        check(n_ == want_n, f"predictor_infer: {k_} launches {n_} == {want_n}")
    reps = 3
    torch.cuda.synchronize()
    t_warm = time.perf_counter()
    for _ in range(reps):
        predictor_infer(model, val_ds.take(infer_b))
    torch.cuda.synchronize()
    t_warm = (time.perf_counter() - t_warm) / reps
    resid = (preds[:, 0] - targets[:, 0]) / (1 + targets[:, 0])
    print(f"predictor_infer: {infer_b} batches of {B} in {t_inf:.3f} s (first), {t_warm:.3f} s "
          f"warm, {infer_b * B / t_warm:.0f} images/s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; |dz/(1+z)| median "
          f"{float(np.median(np.abs(resid))):.3f}", flush=True)
    out["infer"] = {"batches": infer_b, "first_s": t_inf, "warm_s": t_warm,
                    "images_per_s": infer_b * B / t_warm, "launches": launches}
    del kept, trainer, model
    torch.cuda.empty_cache()
    return out


def host_rss_gb() -> tuple[float, float]:
    """(resident, peak resident) host memory of this process, GB: VmRSS of
    ``/proc/self/status`` and ``getrusage``'s ``ru_maxrss``."""
    import resource

    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024 / 1e9
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def checkpoint_phase(dev, mim_ckpt, zero_counters, launch_counts):
    """Phase 5g. (a) The ``mim_struct`` ViT-B trainer (bf16, B=256 as
    shipped) restored from ``mim_ckpt``, the ``mim_1`` path's state with its
    AdamW moments, is written as the JAX package's ``.ckpt.msgpack`` (params,
    optax-form ``opt_state``, ``step``, ``losses``) and as the port's
    ``.ckpt.pt``; a fresh trainer restored from each; their params and
    moments, then the next step's loss and every gradient on the same batch
    and mask, bit-equal. Write and read seconds, the file's GB, the host
    RSS around the read. (b) ``z_struct_ft_512`` warm-started from each file:
    the first step bit-equal. (c) The ``z_struct_{ft,fs,ap}`` families at
    128 and 512 labels, B as shipped, ``total_batch_iters`` cut to CKPT[4],
    through ``train_predictor_network`` (``ft`` and ``ap`` warm-started
    from the JAX-format file) with the counters zeroed just before and read
    just after (``ft``, ``fs``: K2, 2, 3, K1, 8; ``ap``: K1 and K2 alone),
    then each best checkpoint scored through the compare twin's
    ``evaluate_model`` (K1 and K2 per inference batch): JAX's row keys,
    finite values."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.compare_predictors import evaluate_model, json_rows
    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
    from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, train_predictor_network
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
    from sky_embeddings_tpu_torch.utils.checkpoint import load_checkpoint

    mae_name, warm_name, families, sizes, steps, n_train, n_val = CKPT
    cfg_dir = os.path.join(ROOT, "configs")
    mae = load_config(mae_name, cfg_dir)
    work = os.path.join(ROOT, "models", "chip_smoke_ckpt")  # gitignored, removed below
    os.makedirs(work, exist_ok=True)
    out: dict = {}

    def bit_equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def grads(tr):
        return [p.grad for _, p in sorted(tr.model.named_parameters())]

    try:
        # (a) the full-width round trip through the JAX package's format
        src = MIMPretrainer(mae, seed=0, device=dev)
        check(src.restore(mim_ckpt) and src.cur_iter > 0 and len(src.optimizer.state) > 0,
              "5g: the mim_1 path's state (with AdamW moments) restores into mim_struct's trainer")
        jax_path, pt_path = (os.path.join(work, "mim_struct" + s_) for s_ in (".ckpt.msgpack",
                                                                               ".ckpt.pt"))
        times = {}
        for key, path in (("write_jax_s", jax_path), ("write_pt_s", pt_path)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            src.save(path)
            times[key] = time.perf_counter() - t0
        gb, gb_pt = os.path.getsize(jax_path) / 1e9, os.path.getsize(pt_path) / 1e9
        rss0, _ = host_rss_gb()
        t0 = time.perf_counter()
        payload = load_checkpoint(jax_path)
        times["read_jax_s"] = time.perf_counter() - t0
        rss1, _ = host_rss_gb()
        check(int(payload["step"]) == src.cur_iter and "mu" in payload["opt_state"]["0"],
              "5g: the JAX-format payload holds the step and optax's Adam state")
        del payload
        restored = {}
        for key, path in (("jax", jax_path), ("pt", pt_path)):
            tr = MIMPretrainer(mae, seed=1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(tr.restore(path), f"5g: restore from {os.path.basename(path)}")
            torch.cuda.synchronize()
            times[f"restore_{key}_s"] = time.perf_counter() - t0
            restored[key] = tr
        _, hwm = host_rss_gb()
        a, b = restored["jax"], restored["pt"]
        same_params = bit_equal(a.model.state_dict().values(), b.model.state_dict().values()) \
            and bit_equal(a.model.state_dict().values(), src.model.state_dict().values())
        pa = {n: p for n, p in a.model.named_parameters()}
        pb = {n: p for n, p in b.model.named_parameters()}
        same_moments = all(
            torch.equal(a.optimizer.state[pa[n]][k], b.optimizer.state[pb[n]][k].to(dev))
            for n in pa for k in ("exp_avg", "exp_avg_sq")) and all(
            float(a.optimizer.state[pa[n]]["step"]) == float(b.optimizer.state[pb[n]]["step"])
            for n in pa)
        bs, m = a.batch_size, a.model
        data = make_cutouts(bs, seed=21, channels=m.in_chans, img_size=m.img_size)
        batch = {"cutouts": data["cutouts"], "ra_dec": np.stack([data["ra"], data["dec"]], 1)}
        mask = a.draw_mask(bs, torch.Generator(device=dev).manual_seed(3))
        la, lb = a.train_batch(batch, mask=mask), b.train_batch(batch, mask=mask)
        same_step = torch.equal(la, lb) and bit_equal(grads(a), grads(b)) and \
            bit_equal(a.model.state_dict().values(), b.model.state_dict().values())
        print(f"5g round trip (mim_struct ViT-B, step {src.cur_iter}, bf16, B={bs}): "
              f".ckpt.msgpack {gb:.3f} GB written in {times['write_jax_s']:.2f} s "
              f"({gb / times['write_jax_s']:.2f} GB/s), read in {times['read_jax_s']:.2f} s "
              f"({gb / times['read_jax_s']:.2f} GB/s), restored onto the card in "
              f"{times['restore_jax_s']:.2f} s; .ckpt.pt {gb_pt:.3f} GB in "
              f"{times['write_pt_s']:.2f} / {times['restore_pt_s']:.2f} s; host RSS "
              f"{rss0:.2f} -> {rss1:.2f} GB over the read (peak so far {hwm:.2f} GB); params "
              f"bit-equal {same_params}, moments {same_moments}; next step's loss "
              f"{float(la):.6f} / {float(lb):.6f}, loss, every gradient and the params "
              f"bit-equal {same_step}", flush=True)
        check(same_params and same_moments, "5g: params and AdamW moments restored bit-equal "
                                            "from both formats")
        check(same_step, "5g: the next step from the JAX-format file bit-equal to the port's")
        out["round_trip"] = {"step": src.cur_iter, "file_gb": gb, "file_pt_gb": gb_pt, **times,
                             "write_gb_per_s": gb / times["write_jax_s"],
                             "read_gb_per_s": gb / times["read_jax_s"],
                             "host_rss_before_read_gb": rss0, "host_rss_after_read_gb": rss1,
                             "host_peak_rss_gb": hwm, "next_step_bit_equal": same_step}
        del src, restored, a, b, pa, pb
        torch.cuda.empty_cache()

        # (b) the warm start from each format
        sets = {"train": make_structured_cutouts(n_train, seed=14, channels=m.in_chans,
                                                 img_size=m.img_size),
                "val": make_structured_cutouts(n_val, seed=15, channels=m.in_chans,
                                               img_size=m.img_size)}
        wcfg = load_config(warm_name, cfg_dir)
        warm = [PredictorTrainer(wcfg, mae, seed=0, device=dev) for _ in range(2)]
        logs = []
        for tr, path in zip(warm, (jax_path, pt_path)):
            check(tr.warm_start(path, log_fn=logs.append), f"5g: warm start from {path}")
        wb = next(iter(DeviceDataset.from_arrays(sets["train"], wcfg.training.int("batch_size"),
                                                 shuffle=False, label_keys=["zspec"], device=dev)))
        same_init = bit_equal(warm[0].model.state_dict().values(),
                              warm[1].model.state_dict().values())
        l0, l1 = (tr.train_batch(wb) for tr in warm)
        same_first = torch.equal(l0[0], l1[0]) and bit_equal(grads(warm[0]), grads(warm[1]))
        print(f"5g warm start of {warm_name} from each format: {logs[0]}; weights bit-equal "
              f"{same_init}; first step's loss {float(l0[0]):.6f} / {float(l1[0]):.6f}, loss "
              f"and every gradient bit-equal {same_first}", flush=True)
        check(same_init and same_first, "5g: the warm starts from both formats bit-equal")
        out["warm_start"] = {"config": warm_name, "first_step_bit_equal": same_first}
        del warm
        torch.cuda.empty_cache()

        # (c) the mini sweep through the compare twin
        with open(os.path.join(ROOT, "results", "compare_predictors_struct.json")) as f:
            jax_keys = set(json.load(f)["z_struct_ft"][0])
        results, sweep = {}, {}
        for fam in families:
            for size in sizes:
                name = f"z_struct_{fam}_{size}"
                over = [f"TRAINING.total_batch_iters={steps}"]
                cfg = apply_overrides(load_config(name, cfg_dir), over, name)
                B, n = cfg.training.int("batch_size"), cfg.training.int("num_train")
                check(n <= n_train and cfg.training.str("dtype") == "bfloat16",
                      f"5g {name}: bf16, {n} labels of the {n_train} made")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr = PredictorTrainer(cfg, mae, seed=0, device=dev)
                if fam != "fs":
                    check(tr.warm_start(jax_path, log_fn=lambda _: None), f"5g {name}: warm start")
                ds = dict(label_keys=["zspec"], device=dev)
                train_ds = DeviceDataset.from_arrays(sets["train"], B, shuffle=True,
                                                     indices=range(n), **ds)
                val_ds = DeviceDataset.from_arrays(sets["val"], B, shuffle=False, **ds)
                zero_counters()
                train_predictor_network(tr, train_ds.forever(), val_ds, steps, 1e9,
                                        os.path.join(work, name + ".ckpt.pt"),
                                        log_fn=lambda _: None)
                torch.cuda.synchronize()
                t_train = time.perf_counter() - t0
                launches = launch_counts()
                L, n_vb = tr.model.encoder.depth, len(val_ds)
                if fam == "ap":  # the frozen backbone: the inference kernels alone
                    want = {"fused_attn_block": L * (steps + n_vb),
                            "fused_mlp_block": L * (steps + n_vb)}
                else:
                    want = {"attn_block_fwd_stash": L * steps, "attn_block_bwd_stash": L * steps,
                            "mlp_block_bwd": L * steps, "fused_mlp_block": L * (steps + n_vb),
                            "fused_attn_block": L * n_vb}
                for k_, n_ in launches.items():
                    check(n_ == want.get(k_, 0), f"5g {name}: {k_} launches {n_} == {want.get(k_, 0)}")
                check(tr.cur_iter == steps, f"5g {name}: {steps} steps")
                del tr, train_ds, val_ds
                torch.cuda.empty_cache()
                zero_counters()
                t0 = time.perf_counter()
                row = evaluate_model(name, cfg_dir, work, val=sets["val"], train_rows=n_train,
                                     overrides=over, device=dev)
                torch.cuda.synchronize()
                t_eval = time.perf_counter() - t0
                ev = launch_counts()
                n_ib = -(-n_val // B)
                for k_, n_ in ev.items():
                    want_n = L * n_ib if k_ in ("fused_attn_block", "fused_mlp_block") else 0
                    check(n_ == want_n, f"5g {name} evaluate_model: {k_} launches {n_} == {want_n}")
                check(row is not None and row[0] == n, f"5g {name}: scored at num_train {n}")
                results.setdefault(f"z_struct_{fam}", []).append(row)
                check(set(row[1]) | {"num_train"} == jax_keys
                      and bool(np.isfinite(list(row[1].values())).all()),
                      f"5g {name}: JAX's row keys {sorted(jax_keys)}, finite: {row[1]}")
                sweep[name] = {"train_s": t_train, "evaluate_s": t_eval, "batch": B,
                               "launches": {k: v for k, v in launches.items() if v},
                               "evaluate_launches": {k: v for k, v in ev.items() if v}}
                print(f"5g {name} ({cfg.training.str('train_method')}, {n} labels, B={B}): "
                      f"{steps} steps + {n_vb} val batches in {t_train:.2f} s, scored in "
                      f"{t_eval:.2f} s: {row[1]}; launches "
                      f"{sweep[name]['launches']}, evaluate {sweep[name]['evaluate_launches']}",
                      flush=True)
        out["sweep"] = {"rows": json_rows(results), "runs": sweep}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def predictor_f32_phase(dev, mim_ckpt, zero_counters, launch_counts, step_times, configs):
    """fp32 predictor paths (configs that set no dtype), through the entry
    points ``train_predictor`` and ``test_predictor`` call, full width and
    depth, the sets in memory: each of ``configs`` (label -> config, label
    key, training-set batches) as shipped. A config over ``mim_1`` (the
    ``CONFIG`` path's width) warm-starts from ``mim_ckpt``; the others start
    from seeded weights. Each takes PRED_F32_RUN[0] steps and
    PRED_F32_RUN[1] validation batches with the counters zeroed just before
    and read just after: ``lp`` the fp32 forms of K1 and K2 alone, ``fs`` and
    ``ft`` those of the training kernels the backbone's blocks pick (the
    attention stash: kernels 2 and 3; the MLP stash at ``mimlarge``:
    kernels 6 and 7, else K1 and kernel 8), K1 and K2 in validation, every
    launch an fp32 one. Then the kernel path against the plain path from
    the same weights, optimizer state and generator; the step's time,
    device busy share and peak memory; ``predictor_infer`` in fp32 (K1 and
    K2 alone) over PRED_F32_RUN[2] batches and its images/s."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
    from sky_embeddings_tpu_torch.data.synthetic import make_structured_cutouts
    from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer

    steps, val_b, infer_b, timed = PRED_F32_RUN
    cfg_dir = os.path.join(ROOT, "configs")
    out = {"routes": {}}
    for label, (name, key, n_train) in configs.items():
        cfg = load_config(name, cfg_dir)
        mae_name = cfg.pretrained_mae_name()
        mae = cfg if mae_name is None else load_config(mae_name, cfg_dir)
        B = cfg.training.int("batch_size")
        route = cfg.training.str("train_method")
        check("dtype" not in cfg.training and label.split("_")[0] == route,
              f"{name}: {route}, no dtype (fp32)")
        geom = dict(channels=mae.architecture.int("num_channels"),
                    img_size=mae.architecture.int("img_size"))
        sets = {"train": make_structured_cutouts(n_train * B, seed=16, **geom),
                "val": make_structured_cutouts(B * max(val_b, infer_b), seed=17, **geom)}
        t_init = time.perf_counter()
        trainer = PredictorTrainer(cfg, mae, seed=0, device=dev)
        warm = []
        if mae_name == CONFIG:
            check(trainer.warm_start(mim_ckpt, log_fn=warm.append), f"{name}: warm start")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        m = trainer.model
        layers = m.encoder.depth
        block = m.encoder.block0
        check(all(p.dtype == torch.float32 for p in m.parameters()) and m.dtype == torch.float32,
              f"{name}: an fp32 model")
        n_idx = cfg.training.int("num_train")
        data = dict(label_keys=[key], device=dev)
        train_ds = DeviceDataset.from_arrays(sets["train"], B, shuffle=True,
                                             indices=range(n_idx) if n_idx > 0 else None, **data)
        val_ds = DeviceDataset.from_arrays(sets["val"], B, shuffle=False, **data)
        stream = train_ds.forever()
        zero_counters()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        train = [trainer.train_batch(next(stream)) for _ in range(steps)]
        val = [trainer.eval_batch(b) for b in val_ds.take(val_b)]
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        launches = launch_counts()
        want = {"fused_attn_block": layers * val_b, "fused_mlp_block": layers * val_b}
        if route == "lp":  # the frozen backbone: the inference kernels alone
            want = {k: v + layers * steps for k, v in want.items()}
        else:
            attn = (("attn_block_fwd_stash", "attn_block_bwd_stash") if block.stash
                    else ("fused_attn_block", "attn_block_bwd"))
            mlp = (("mlp_block_fwd_stash", "mlp_block_bwd_stash") if block.ffn.stash
                   else ("fused_mlp_block", "mlp_block_bwd"))
            for k in attn + mlp:
                want[k] = want.get(k, 0) + layers * steps
        want.update({k + "_f32": v for k, v in want.items()})  # every launch an fp32 one
        losses = [[float(v) for v in pair] for pair in train + val]
        print(f"predictor fp32 {label} ({name}, {route}, {m.global_pool} pool, {m.num_labels} "
              f"labels, {trainer.loss_fn_name}, depth {layers}, D={m.embed_dim}, "
              f"{block.num_heads} heads, N={m.grid_size ** 2 + m.num_extra_tokens}, B={B}, "
              f"attention stash {block.stash}, MLP stash {block.ffn.stash}): {steps} steps + "
              f"{val_b} val batches in {t_run:.2f} s; (loss, metric) {losses}; {' '.join(warm)}; "
              f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
        check(bool(np.isfinite(losses).all()), f"predictor fp32 {label}: losses finite")
        for k_, n_ in launches.items():
            check(n_ == want.get(k_, 0),
                  f"predictor fp32 {label}: {k_} launches {n_} == {want.get(k_, 0)}")

        # kernel path vs plain path from the same weights, optimizer state
        # and generator: one step's gradients and loss, then the steps' losses
        plain = PredictorTrainer(cfg, mae, seed=0, device=dev)
        plain.model.load_state_dict(m.state_dict())
        plain.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
        plain.generator.set_state(trainer.generator.get_state())
        plain.step = trainer.step
        plain.model.plain = True
        batches = [next(stream) for _ in range(steps)]
        traj, grads = [], []
        for tr in (trainer, plain):
            traj.append([float(tr.train_batch(b)[0]) for b in batches[:1]])
            grads.append({n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                          if p.grad is not None})
            traj[-1] += [float(tr.train_batch(b)[0]) for b in batches[1:]]
        grad_rel = {n: float((a - grads[1][n]).norm() / (grads[1][n].norm() + 1e-30))
                    for n, a in grads[0].items()}
        worst = max(grad_rel, key=grad_rel.get)
        loss_rel = abs(traj[0][0] - traj[1][0]) / abs(traj[1][0])
        traj_rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
        n_train_leaves = sum(1 for p in m.parameters() if p.requires_grad)
        tol_grad, tol_loss = TOL_PRED_F32[label]
        print(f"predictor fp32 {label} kernel vs plain path: loss rel {loss_rel:.3e}; gradient "
              f"||a-b||/||b|| max {grad_rel[worst]:.3e} ({worst}), median "
              f"{float(np.median(list(grad_rel.values()))):.3e} over {len(grad_rel)} leaves (bar "
              f"{tol_grad}); {steps}-step losses kernel {traj[0]} plain {traj[1]}, max rel "
              f"{traj_rel:.3e} (bar {tol_loss})", flush=True)
        check(len(grad_rel) == n_train_leaves and grads[0].keys() == grads[1].keys(),
              f"predictor fp32 {label}: every trainable leaf, and only those, gets a gradient")
        check(all(np.isfinite(list(grad_rel.values()))) and grad_rel[worst] <= tol_grad,
              f"predictor fp32 {label}: gradients kernel vs plain")
        check(loss_rel <= tol_loss and traj_rel <= tol_loss,
              f"predictor fp32 {label}: losses kernel vs plain")
        del plain, grads
        torch.cuda.empty_cache()

        tb = next(stream)
        out["routes"][label] = {
            "config": cfg.name, "loss_fn": trainer.loss_fn_name, "train_method": trainer.train_method,
            "layers": layers, "embed_dim": m.embed_dim, "num_heads": block.num_heads, "batch": B,
            "channels": m.in_chans, "ra_dec": m.ra_dec, "num_labels": m.num_labels,
            "attn_stash": block.stash, "mlp_stash": block.ffn.stash, "trainer_init_s": t_init,
            "seconds": t_run, "launches": launches, "losses": losses, "warm_start": warm,
            "trainable_leaves": n_train_leaves, "loss_rel_vs_plain": loss_rel,
            "grad_rel_vs_plain_max": grad_rel[worst], "grad_rel_worst_leaf": worst,
            "grad_rel_vs_plain_median": float(np.median(list(grad_rel.values()))),
            "trajectory_kernel": traj[0], "trajectory_plain": traj[1], "trajectory_max_rel": traj_rel,
            "train_step": step_times(lambda: trainer.train_batch(tb), B, timed,
                                     f"predictor fp32 {label}")}
        # predictor_infer in fp32 over PRED_F32_RUN[2] batches
        model = trainer.model.eval()
        zero_counters()
        torch.cuda.synchronize()
        t_inf = time.perf_counter()
        targets, preds = predictor_infer(model, val_ds.take(infer_b))
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t_inf
        il = launch_counts()
        check(len(targets) == len(preds) == infer_b * B and preds.shape[1] == m.num_labels
              and bool(np.isfinite(preds).all()), f"fp32 predictor_infer ({name}): {preds.shape} finite")
        for k_, n_ in il.items():
            want_n = layers * infer_b if k_ in ("fused_attn_block", "fused_mlp_block",
                                                 "fused_attn_block_f32", "fused_mlp_block_f32") else 0
            check(n_ == want_n, f"fp32 predictor_infer ({name}): {k_} launches {n_} == {want_n}")
        reps = 3
        torch.cuda.synchronize()
        t_warm = time.perf_counter()
        for _ in range(reps):
            predictor_infer(model, val_ds.take(infer_b))
        torch.cuda.synchronize()
        t_warm = (time.perf_counter() - t_warm) / reps
        print(f"fp32 predictor_infer ({name}): {infer_b} batches of {B} in {t_inf:.3f} s (first), "
              f"{t_warm:.3f} s warm, {infer_b * B / t_warm:.0f} images/s; launches "
              f"{ {k: v for k, v in il.items() if v} }", flush=True)
        out["routes"][label]["infer"] = {"batches": infer_b, "first_s": t_inf, "warm_s": t_warm,
                                         "images_per_s": infer_b * B / t_warm, "launches": il}
        del trainer, model, train_ds, val_ds, sets
        torch.cuda.empty_cache()
    return out


def jepa_phase(dev, probe_sets, zero_counters, launch_counts, step_times):
    """The I-JEPA paths, through the entry points ``pretrain_jepa`` calls
    (``JEPATrainer.train_batch`` / ``eval_batch``, ``train_network``), each
    config as shipped (its dtype, width, depth and batch), seeded weights,
    synthetic cutouts in memory (structured ones for jepa_struct). For each
    of JEPA_RUNS: the EMA target equal to the online encoder at step 0; the
    steps and validation batches with the counters zeroed just before and
    read just after, every launch one of K2, kernels 2 and 3, K1 and kernel 8
    (their fp32 forms in fp32) in the counts the target encoder (K2, K1),
    the context encoder and ``num_pred`` predictor passes (kernels 2, 3, 8
    and K1) give, validation K2 and K1 over all three, each probe batch K2
    and K1 over the encoder; afterwards the target moved, less than the
    online encoder. jepa_struct runs through ``train_network`` with the
    probes once on ``probe_sets``; then for the configs of TOL_JEPA the
    kernel path against the plain path (every block of the context and
    target encoders and the predictor) from the same weights and masks;
    jepa_struct's save/restore (one more step bit-equal to the uninterrupted
    run's); every config's step time, images/s, busy share and peak memory,
    and jepa_struct's device and host ms by part of the step."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
    from sky_embeddings_tpu_torch.ops.jepa_masks import mask_budgets
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
    from sky_embeddings_tpu_torch.train.pretrain import train_network

    # (dtype, batch, channels, D, depth, heads, predictor D, depth, heads, K_ctx, K_tgt)
    shipped = {"jepa_struct": ("bfloat16", 256, 5, 384, 12, 6, 192, 4, 3, 64, 13),
               "jepa_1": ("bfloat16", 64, 9, 384, 12, 6, 192, 4, 3, 64, 13),
               "jepa_tiny": ("float32", 16, 3, 192, 12, 3, 96, 2, 1, 16, 5)}
    out = {}
    for name, steps, val_b, timed in JEPA_RUNS:
        cfg = load_config(name, os.path.join(ROOT, "configs"))
        t_init = time.perf_counter()
        trainer = JEPATrainer(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        m = trainer.model
        enc, pred = m.encoder.encoder, m.predictor.blocks
        mp = trainer.mask_params
        k_ctx, k_tgt = mask_budgets(m.grid_size, mp["pred_mask_scale"], mp["enc_mask_scale"],
                                    mp["min_keep"])
        B, E, P, n_pred = trainer.batch_size, enc.depth, pred.depth, mp["num_pred"]
        geometry = (str(m.dtype).replace("torch.", ""), B, m.in_chans, m.embed_dim, E,
                    enc.block0.num_heads, m.predictor.pred_embed_dim, P, pred.block0.num_heads,
                    k_ctx, k_tgt)
        print(f"jepa {name}: (dtype, B, bands, D, depth, heads, predictor D, depth, heads, K_ctx, "
              f"K_tgt) = {geometry}; {sum(p.numel() for p in m.parameters())} parameters",
              flush=True)
        check(geometry == shipped[name], f"jepa {name}: full width and depth as shipped {shipped[name]}")
        fp32 = m.dtype == torch.float32
        n_b = steps + val_b + 1
        make = make_structured_cutouts if name == "jepa_struct" else make_cutouts
        t_data = time.perf_counter()
        x = make(n_b * B, channels=m.in_chans, img_size=m.img_size, seed=20)["cutouts"]
        check(bool(np.isnan(x).any()), f"jepa {name}: cutouts hold NaN bands")
        tbatches = [{"cutouts": x[i * B:(i + 1) * B]} for i in range(n_b)]
        t_data = time.perf_counter() - t_data

        online0 = [p.detach().clone() for p in m.encoder.parameters()]
        check(all(torch.equal(a, b) for a, b in zip(trainer.target.parameters(), online0)),
              f"jepa {name}: the EMA target equals the online encoder at step 0")
        probes = probe_sets if name == "jepa_struct" else None
        n_probe = sum(len(p_) for p_ in probes) if probes else 0
        zero_counters()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        if probes:
            class ValBatches:
                def take(self, n_):
                    return iter(tbatches[steps:steps + n_])

            ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_jepa_")
            try:
                train_network(trainer, iter(tbatches[:steps]), ValBatches(), steps, steps, 1e9,
                              os.path.join(ckpt_dir, f"{name}.ckpt.pt"), lp_class_data_file=probes[0],
                              lp_regress_data_file=probes[1], lp_combine="central",
                              max_val_batches=val_b, log_fn=lambda m_: print(f"jepa {name}: {m_}", flush=True))
            finally:
                shutil.rmtree(ckpt_dir)
            train_losses, val_losses = trainer.losses["train_loss"], trainer.losses["val_loss"]
        else:
            train_losses = [trainer.train_batch(b) for b in tbatches[:steps]]
            val_losses = [trainer.eval_batch(b, idx=i) for i, b in enumerate(tbatches[steps:steps + val_b])]
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        launches = launch_counts()
        train_losses, val_losses = [float(v) for v in train_losses], [float(v) for v in val_losses]
        # per train step: the target's E layers (K2, K1), the context's E and
        # n_pred predictor passes of P (kernels 2, 3, 8 and K1); per
        # validation batch K2 and K1 over all three; per probe batch over E
        grad_layers = E + n_pred * P
        per_step = {"fused_attn_block": E, "attn_block_fwd_stash": grad_layers,
                    "attn_block_bwd_stash": grad_layers, "fused_mlp_block": E + grad_layers,
                    "mlp_block_bwd": grad_layers}
        per_val = {"fused_attn_block": 2 * E + n_pred * P, "fused_mlp_block": 2 * E + n_pred * P}
        want = {k: v * steps + per_val.get(k, 0) * val_b
                + E * n_probe * (k in ("fused_attn_block", "fused_mlp_block")) for k, v in per_step.items()}
        if fp32:
            want.update({k + "_f32": v for k, v in want.items()})
        print(f"jepa {name}: {steps} steps + {val_b} val batches + {n_probe} probe batches in "
              f"{t_run:.2f} s (cutouts made in {t_data:.1f} s); train losses "
              f"{[round(v, 4) for v in train_losses]}, val {[round(v, 4) for v in val_losses]}; "
              f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
        check(bool(train_losses) and all(np.isfinite(train_losses + val_losses)),
              f"jepa {name}: losses finite")
        expect = ({"fused_attn_block": 12, "attn_block_fwd_stash": 28, "attn_block_bwd_stash": 28,
                   "fused_mlp_block": 40, "mlp_block_bwd": 28} if name != "jepa_tiny" else
                  {"fused_attn_block": 12, "attn_block_fwd_stash": 20, "attn_block_bwd_stash": 20,
                   "fused_mlp_block": 32, "mlp_block_bwd": 20})
        check(per_step == expect, f"jepa {name}: launches per step {per_step} == {expect}")
        for k_, n_ in launches.items():
            check(n_ == want.get(k_, 0), f"jepa {name}: {k_} launches {n_} == {want.get(k_, 0)}")
        d_online = sum(float((p.detach() - p0).abs().sum()) for p, p0 in zip(m.encoder.parameters(), online0))
        d_target = sum(float((p - p0).abs().sum()) for p, p0 in zip(trainer.target.parameters(), online0))
        print(f"jepa {name}: summed |change| of the encoder's parameters over {steps} steps: online "
              f"{d_online:.4e}, EMA target {d_target:.4e}", flush=True)
        check(0 < d_target < d_online, f"jepa {name}: the EMA target moved, less than the online encoder")
        del online0
        res = {"config": name, "geometry": dict(zip(
            ("dtype", "batch", "channels", "embed_dim", "depth", "heads", "pred_embed_dim",
             "pred_depth", "pred_heads", "k_ctx", "k_tgt"), geometry)),
            "trainer_init_s": t_init, "seconds": t_run, "steps": steps, "val_batches": val_b,
            "launches": launches, "launches_per_step": per_step, "train_losses": train_losses,
            "val_losses": val_losses, "ema_change_online": d_online, "ema_change_target": d_target}
        if probes:
            lp = {k: trainer.losses[k][-1] for k in ("train_lp_acc", "val_lp_acc", "train_lp_r2",
                                                     "val_lp_r2")}
            print(f"jepa {name} probes ({n_probe} batches, the online encoder's central 4 tokens): "
                  f"{lp}", flush=True)
            check(all(np.isfinite(list(lp.values()))) and 0.0 <= lp["val_lp_acc"] <= 1.0
                  and lp["val_lp_r2"] <= 1.0, f"jepa {name}: probe metrics")
            res.update({"probe": lp, "probe_batches": n_probe})

        if name in TOL_JEPA:
            # kernel path vs plain path from the same weights and masks
            tol_grad, tol_loss = TOL_JEPA[name]
            pair = [JEPATrainer(cfg, seed=0, device=dev) for _ in range(2)]
            pair[1].plain = True
            mgen = torch.Generator(device=dev).manual_seed(7)
            masks = [pair[0].draw_masks(B, mgen) for _ in range(TRAJ_STEPS)]
            x0 = pair[0]._cutouts(tbatches[0])
            grads, step_loss = [], []
            for tr in pair:
                loss = tr.loss(x0, masks[0])
                loss.backward()
                step_loss.append(float(loss.detach()))
                grads.append({n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                              if p.grad is not None})
                tr.optimizer.zero_grad(set_to_none=True)
            grad_rel = {n: float((a - grads[1][n]).norm() / (grads[1][n].norm() + 1e-30))
                        for n, a in grads[0].items()}
            worst = max(grad_rel, key=grad_rel.get)
            loss_rel = abs(step_loss[0] - step_loss[1]) / abs(step_loss[1])
            traj = [[float(tr.train_batch(b, masks=mk)) for b, mk in zip(tbatches, masks)] for tr in pair]
            traj_rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
            print(f"jepa {name} kernel vs plain path: loss rel {loss_rel:.3e}; gradient ||a-b||/||b|| "
                  f"max {grad_rel[worst]:.3e} ({worst}), median "
                  f"{float(np.median(list(grad_rel.values()))):.3e} over {len(grad_rel)} leaves (bar "
                  f"{tol_grad}); {TRAJ_STEPS}-step losses kernel {traj[0]} plain {traj[1]}, max rel "
                  f"{traj_rel:.3e} (bar {tol_loss})", flush=True)
            check(len(grad_rel) == sum(1 for _ in m.parameters()) and grads[0].keys() == grads[1].keys(),
                  f"jepa {name}: every parameter gets a gradient")
            check(all(np.isfinite(list(grad_rel.values()))) and grad_rel[worst] <= tol_grad,
                  f"jepa {name}: gradients kernel vs plain")
            check(loss_rel <= tol_loss and traj_rel <= tol_loss, f"jepa {name}: losses kernel vs plain")
            res.update({"loss_rel_vs_plain": loss_rel, "grad_rel_vs_plain_max": grad_rel[worst],
                        "grad_rel_worst_leaf": worst,
                        "grad_rel_vs_plain_median": float(np.median(list(grad_rel.values()))),
                        "trajectory_kernel": traj[0], "trajectory_plain": traj[1],
                        "trajectory_max_rel": traj_rel})
            del pair, grads, tr, loss
            torch.cuda.empty_cache()

        if name == "jepa_struct":
            # save, restore into a fresh trainer, one more step each: bit-equal
            ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_jepa_")
            try:
                path = os.path.join(ckpt_dir, f"{name}.ckpt.pt")
                trainer.save(path)
                other = JEPATrainer(cfg, seed=1, device=dev)
                check(other.restore(path), f"jepa {name}: restore found the checkpoint")
            finally:
                shutil.rmtree(ckpt_dir)
            nb = tbatches[-1]
            la, lb = trainer.train_batch(nb), other.train_batch(nb)
            same = [torch.equal(la, lb)] + [
                all(torch.equal(a, b) for a, b in zip(u.state_dict().values(), v.state_dict().values()))
                for u, v in ((trainer.model, other.model), (trainer.target, other.target))]
            sa, sb = trainer.optimizer.state_dict()["state"], other.optimizer.state_dict()["state"]
            same.append(sa.keys() == sb.keys() and all(
                torch.equal(sa[k][f], sb[k][f].to(sa[k][f].device)) for k in sa for f in sa[k]))
            print(f"jepa {name} save/restore, then one step each: loss, params, EMA target, "
                  f"optimizer state bit-equal {same}, step {other.cur_iter}", flush=True)
            check(all(same) and other.cur_iter == trainer.cur_iter == steps + 1,
                  f"jepa {name}: a restored run's next step bit-equal to the uninterrupted run's")
            res["save_restore_next_step_bit_equal"] = same
            del other

        tb = {"cutouts": torch.as_tensor(np.concatenate([b["cutouts"] for b in tbatches])[:B], device=dev)}
        res["train_step"] = step_times(lambda: trainer.train_batch(tb), B, timed, f"jepa {name}")
        if name == "jepa_struct":
            # the step by part: before each part the device is drained and
            # then held by a sleep kernel while the host queues the part, so
            # CUDA events around the part time its kernels back to back
            # (device ms) and the clock times the queueing (host ms). One part
            # at a time: a whole held step overflows the launch queue, and
            # the host then waits on the device.
            parts = ("inputs", "masks", "target", "forward", "backward", "adamw", "ema")
            hold = 200_000_000  # sleep cycles: about 100 ms, past the longest part's queueing
            s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s0.record()
            torch.cuda._sleep(hold)
            s1.record()
            s1.synchronize()
            sleep_ms = s0.elapsed_time(s1)
            runs = []
            for _ in range(timed + 2):
                rec, cur = [], {}

                def begin(cur=cur):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(hold)
                    cur["event"] = torch.cuda.Event(enable_timing=True)
                    cur["event"].record()
                    cur["t"] = time.perf_counter()

                def mark(part_, rec=rec, cur=cur, begin=begin):
                    e_ = torch.cuda.Event(enable_timing=True)
                    e_.record()
                    rec.append((part_, cur["event"], e_, (time.perf_counter() - cur["t"]) * 1e3))
                    if part_ != parts[-1]:
                        begin()

                begin()
                trainer.train_batch(tb, mark=mark)
                runs.append(rec)
            torch.cuda.synchronize()
            dev_part, host_part = dict.fromkeys(parts, 0.0), dict.fromkeys(parts, 0.0)
            queue_ms = dict.fromkeys(parts, 0.0)
            for k_, rec in enumerate(runs):
                for part_, e0, e1, h_ms in rec:
                    queue_ms[part_] = max(queue_ms[part_], h_ms)
                    if k_ >= 2:
                        dev_part[part_] += e0.elapsed_time(e1) / timed
                        host_part[part_] += h_ms / timed
            # a part whose queueing outlasted the hold let the device wait on
            # the host: its device ms are not a measurement
            dev_part = {k: v if queue_ms[k] < 0.9 * sleep_ms else "not measured"
                        for k, v in dev_part.items()}
            print(f"jepa {name} step by part, device ms (CUDA events, the device held "
                  f"{sleep_ms:.1f} ms while each part is queued): "
                  + ", ".join(f"{k} {v if isinstance(v, str) else round(v, 3)}" for k, v in dev_part.items())
                  + "; host ms to queue: " + ", ".join(f"{k} {v:.3f}" for k, v in host_part.items())
                  + f", sum {sum(host_part.values()):.3f}; longest queueing by part {queue_ms}", flush=True)
            check(list(dev_part) == list(parts), f"jepa {name}: the step's parts")
            res["step_parts"] = {"device_ms": dev_part, "host_queue_ms": host_part,
                                 "held_ms": sleep_ms, "longest_queue_ms": queue_ms}
        out[name] = res
        del trainer, tb, tbatches, x
        torch.cuda.empty_cache()
    return out


def cosmos_phase(dev, zero_counters, launch_counts, step_times):
    """CosmicEmbeds at the module's full default width, through its public
    entry points (``loss`` under Adam at lr 3e-3, as ``tests/test_cosmos.py``
    trains JAX's; ``generate`` under no grad), seeded weights, synthetic
    cutouts with whole-band NaNs, their RA/Dec and HSC wavelengths, in fp32
    and bf16. For each dtype: COSMOS[1] Adam steps alternating the loss with
    no context and with a context under per-band ``MaskGenerator`` pixel
    masks, with the counters zeroed just before and read just after (kernels
    2, 3, 8 and K1 once per block a step, their fp32 forms in fp32, nothing
    else); two ``generate`` calls (no context, and the masked context) the
    same way (K2 and K1 once per block a call); the kernel path against the
    plain path (``Encoder.plain``) from the same weights: each loss and
    every gradient, and ``generate``'s images, under the L1 loss as shipped
    and, with no context, the MSE loss (TOL_COSMOS); a step's time,
    images/s, busy share and peak memory, and ``generate``'s images/s."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.data.mask_generator import MaskGenerator
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.models.cosmos import CosmicEmbeds

    B, steps, timed, gen_timed = COSMOS
    arch = CosmicEmbeds()  # the defaults' geometry (weights not drawn)
    img, p, C = arch.img_size, arch.patch_size, arch.in_chans
    check(C == len(HSC_NM), "cosmos: one wavelength a band")
    x = make_cutouts(B, channels=C, img_size=img, seed=30)
    check(bool(np.isnan(x["cutouts"]).any()), "cosmos: cutouts hold NaN bands")
    target = torch.as_tensor(x["cutouts"], device=dev)
    ra_dec = torch.as_tensor(np.stack([x["ra"], x["dec"]], 1), device=dev)
    waves = torch.tensor(HSC_NM, device=dev).expand(B, -1).contiguous()
    masks = MaskGenerator(img, p, 0.9, C, rng=np.random.default_rng(31))
    hidden = torch.as_tensor(np.stack([masks() for _ in range(B)]), device=dev)
    conds = {"no_context": (), "masked_context": (target, hidden)}
    # the kernel-vs-plain cases: (conditioning, loss)
    cases = {"no_context": ("no_context", "l1"), "masked_context": ("masked_context", "l1"),
             "no_context_mse": ("no_context", "mse")}
    out = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tag = f"cosmos {dt_name}"

        def build():
            m_ = CosmicEmbeds(dtype=dt)
            m_.reset_parameters(torch.Generator().manual_seed(0))
            return m_.to(dev)

        model = build()
        depth = model.encoder.depth
        geometry = (model.img_size, model.patch_size, model.in_chans, model.embed_dim, depth,
                    model.encoder.block0.num_heads, 1 + model.in_chans + model.grid_size ** 2)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{tag}: (img, patch, bands, D, depth, heads, tokens) = {geometry}; {n_params} "
              f"parameters; B={B}", flush=True)
        check(geometry == (64, 8, 5, 384, 12, 6, 70), f"{tag}: full width and depth, the defaults")
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)

        def step(args):
            loss = model.loss(target, ra_dec, waves, *args)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            for p_ in model.parameters():
                if p_.grad is None:  # unread (patch_embed, no context): optax's zero gradient
                    p_.grad = torch.zeros_like(p_)
            opt.step()
            return loss.detach()

        order = [list(conds)[i % 2] for i in range(steps)]
        zero_counters()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        losses = [float(step(conds[c])) for c in order]
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        launches = launch_counts()
        want = dict.fromkeys(("attn_block_fwd_stash", "attn_block_bwd_stash", "mlp_block_bwd",
                              "fused_mlp_block"), depth * steps)
        if dt == torch.float32:
            want.update({k + "_f32": v for k, v in want.items()})
        print(f"{tag}: {steps} Adam steps ({order}) in {t_run:.2f} s, losses "
              f"{[round(v, 5) for v in losses]}, launches { {k: v for k, v in launches.items() if v} }",
              flush=True)
        check(all(np.isfinite(losses)), f"{tag}: losses finite")
        for k_, n_ in launches.items():
            check(n_ == want.get(k_, 0), f"{tag}: training {k_} launches {n_} == {want.get(k_, 0)}")

        zero_counters()
        torch.cuda.synchronize()
        with torch.no_grad():
            imgs = [model.generate(ra_dec, waves, *args) for args in conds.values()]
        torch.cuda.synchronize()
        gen_launches = launch_counts()
        want_gen = dict.fromkeys(("fused_attn_block", "fused_mlp_block"), depth * len(conds))
        if dt == torch.float32:
            want_gen.update({k + "_f32": v for k, v in want_gen.items()})
        print(f"{tag}: generate, no grad, launches { {k: v for k, v in gen_launches.items() if v} }",
              flush=True)
        for k_, n_ in gen_launches.items():
            check(n_ == want_gen.get(k_, 0),
                  f"{tag}: generate {k_} launches {n_} == {want_gen.get(k_, 0)}")
        check(all(tuple(im.shape) == (B, C, img, img) and im.dtype == torch.float32
                  and bool(torch.isfinite(im).all()) for im in imgs), f"{tag}: generate's images")

        # kernel path vs plain path from the same weights
        tol_grad, tol_loss, tol_img = TOL_COSMOS[dt_name]
        pair = [build(), build()]
        pair[1].plain = True
        gaps = {}
        for c, (cond, loss_fn) in cases.items():
            args = conds[cond]
            grads, ls = [], []
            for m_ in pair:
                m_.loss_fn = loss_fn
                loss = m_.loss(target, ra_dec, waves, *args)
                loss.backward()
                ls.append(float(loss.detach()))
                grads.append({n: p.grad.float().clone() for n, p in m_.named_parameters()
                              if p.grad is not None})
                m_.zero_grad(set_to_none=True)
            names = {n for n, _ in model.named_parameters() if cond != "no_context"
                     or not n.startswith("patch_embed.")}
            check(grads[0].keys() == grads[1].keys() == names,
                  f"{tag} {c}: every parameter the loss reads gets a gradient")
            rel = {n: float((a - grads[1][n]).norm() / (grads[1][n].norm() + 1e-30))
                   for n, a in grads[0].items()}
            worst = max(rel, key=rel.get)
            loss_rel = abs(ls[0] - ls[1]) / abs(ls[1])
            with torch.no_grad():
                im_k, im_p = (m_.generate(ra_dec, waves, *args) for m_ in pair)
            img_rel = float((im_k - im_p).abs().max() / im_p.abs().max())
            print(f"{tag} {c} kernel vs plain path: loss rel {loss_rel:.3e} (bar {tol_loss}); "
                  f"gradient ||a-b||/||b|| max {rel[worst]:.3e} ({worst}), median "
                  f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} leaves (bar {tol_grad}); "
                  f"generate max-rel {img_rel:.3e} (bar {tol_img})", flush=True)
            gaps[c] = {"loss_rel": loss_rel, "grad_rel_max": rel[worst], "grad_rel_worst_leaf": worst,
                       "grad_rel_median": float(np.median(list(rel.values()))),
                       "generate_max_rel": img_rel}
        for c, g_ in gaps.items():  # every case measured, then held to the bars
            check(np.isfinite(g_["grad_rel_max"]) and g_["grad_rel_max"] <= tol_grad,
                  f"{tag} {c}: gradients kernel vs plain")
            check(g_["loss_rel"] <= tol_loss, f"{tag} {c}: loss kernel vs plain")
            check(g_["generate_max_rel"] <= tol_img, f"{tag} {c}: generate kernel vs plain")
        del pair, grads, im_k, im_p
        torch.cuda.empty_cache()

        train_step = step_times(lambda: step(conds["masked_context"]), B, timed, tag)
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            for _ in range(2):
                model.generate(ra_dec, waves)
            s0.record()
            for _ in range(gen_timed):
                model.generate(ra_dec, waves)
            s1.record()
        s1.synchronize()
        gen_ms = s0.elapsed_time(s1) / gen_timed
        print(f"{tag}: generate (no context) B={B}: {gen_ms:.3f} ms, {B / gen_ms * 1e3:.0f} images/s",
              flush=True)
        out[dt_name] = {"geometry": dict(zip(("img_size", "patch_size", "bands", "embed_dim", "depth",
                                               "heads", "tokens"), geometry)),
                        "parameters": n_params, "batch": B, "steps": order, "seconds": t_run,
                        "train_losses": losses, "launches": launches, "generate_launches": gen_launches,
                        "kernel_vs_plain": gaps, "train_step": train_step,
                        "generate_ms": gen_ms, "generate_images_per_s": B / gen_ms * 1e3}
        del model, opt, imgs
        torch.cuda.empty_cache()
    del arch
    return out


def prefetch_phase(dev, zero_counters, launch_counts, device_breakdown):
    """The training loop's host-to-device prefetch (``data/prefetch``) on the
    numpy batches of the mim_1 B=64 and jepa_struct B=256 paths: for each of
    PREFETCH, ``train_network`` (two batches in flight on a side stream)
    against the synchronous copy each ``train_batch`` takes of a numpy
    batch, two trainers from the same seed on the same batches: every
    step's loss and the final parameters bit-equal, the launches of the
    prefetching run exact; then both loops timed in turns (synchronous,
    prefetch, prefetch, synchronous, twice) over the same batches, each with
    its wall ms a step (the median of its four turns), the profiler's device
    ms a step over a shorter loop and their ratio, the busy share."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network

    out = {}
    for name, steps, timed, profiled in PREFETCH:
        cfg = load_config(name, os.path.join(ROOT, "configs"))
        jepa = name.startswith("jepa")

        def trainer():
            if jepa:
                return JEPATrainer(cfg, seed=0, device=dev)
            return MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device=dev)

        pair = [trainer(), trainer()]
        B = pair[0].batch_size
        make = make_structured_cutouts if jepa else make_cutouts
        n_b = max(steps, timed)
        x = make(n_b * B, channels=pair[0].model.in_chans, img_size=pair[0].model.img_size,
                 seed=21)["cutouts"]
        batches = [{"cutouts": x[i * B:(i + 1) * B]} for i in range(n_b)]

        def prefetched(tr, bs, record=None):
            train_step = tr.train_batch
            if record is not None:
                tr.train_batch = lambda b_: record.append(train_step(b_)) or record[-1]
            try:
                train_network(tr, iter(bs), None, 10 ** 9, 10 ** 9, 1e9, "unused",
                              log_fn=lambda m_: None)
            finally:
                tr.__dict__.pop("train_batch", None)

        def synchronous(tr, bs):
            return [tr.train_batch(b_) for b_ in bs]

        zero_counters()
        torch.cuda.synchronize()
        got = []
        prefetched(pair[0], batches[:steps], got)
        torch.cuda.synchronize()
        launches = launch_counts()
        ref = synchronous(pair[1], batches[:steps])
        same_losses = len(got) == len(ref) == steps and all(torch.equal(a, b) for a, b in zip(got, ref))
        same_params = all(torch.equal(a, b) for a, b in zip(pair[0].model.state_dict().values(),
                                                           pair[1].model.state_dict().values()))
        if jepa:
            E, P_ = pair[0].model.encoder.encoder.depth, pair[0].model.predictor.blocks.depth
            grad_layers = E + pair[0].mask_params["num_pred"] * P_
            per_step = {"fused_attn_block": E, "attn_block_fwd_stash": grad_layers,
                        "attn_block_bwd_stash": grad_layers, "fused_mlp_block": E + grad_layers,
                        "mlp_block_bwd": grad_layers}
        else:
            per_step = dict.fromkeys(("attn_block_fwd_stash", "attn_block_bwd_stash",
                                      "mlp_block_bwd", "fused_mlp_block"), pair[0].model.encoder.depth)
        print(f"prefetch {name} (B={B}): {steps} steps through the prefetching train_network against "
              f"the synchronous copy: losses bit-equal {same_losses}, parameters bit-equal "
              f"{same_params}; launches { {k: v for k, v in launches.items() if v} }", flush=True)
        check(same_losses and same_params, f"prefetch {name}: bit-equal to the synchronous copy")
        for k_, n_ in launches.items():
            want = per_step.get(k_, 0) * steps
            check(n_ == want, f"prefetch {name}: {k_} launches {n_} == {want}")
        del pair[1]
        torch.cuda.empty_cache()

        tr = pair[0]
        loops = {"synchronous": lambda n_: synchronous(tr, batches[:n_]),
                 "prefetch": lambda n_: prefetched(tr, batches[:n_])}
        walls = {k: [] for k in loops}
        for k in ("synchronous", "prefetch", "prefetch", "synchronous") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loops[k](timed)
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3 / timed)
        res = {"batch": B, "steps": steps, "timed_steps": timed, "losses_bit_equal": same_losses,
               "params_bit_equal": same_params, "launches": launches}
        for k, fn in loops.items():
            prof = device_breakdown(lambda: fn(profiled), reps=1)
            dev_ms = prof["device_ms_per_call"]
            dev_step = dev_ms / profiled if isinstance(dev_ms, float) else "not measured"
            wall = float(np.median(walls[k]))
            busy = dev_step / wall if isinstance(dev_step, float) else "not measured"
            print(f"prefetch {name} {k}: wall {[round(w, 3) for w in walls[k]]} ms a step, device "
                  f"{dev_step} ms a step, busy {busy}", flush=True)
            res[k] = {"wall_ms_per_step": walls[k], "device_ms_per_step": dev_step,
                      "device_busy_share": busy, "images_per_s": B / wall * 1e3,
                      "profile_top_ms": prof.get("top_ms")}
        out[name] = res
        del tr, pair, batches, x
        torch.cuda.empty_cache()
    return out


def kernel_counters():
    """The wrappers that count their launches: (every one, those that also
    count packed-segment launches, those that also count fp32 ones)."""
    from sky_embeddings_tpu_torch.ops.kernels.attention import fused_attention, fused_attention_bwd
    from sky_embeddings_tpu_torch.ops.kernels.attn_block import (
        attn_block_bwd, attn_block_bwd_stash, attn_block_fwd_stash, attn_block_tp_bwd,
        attn_block_tp_fwd, fused_attn_block)
    from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
        fused_mlp_block, mlp_block_bwd, mlp_block_bwd_stash, mlp_block_bwd_stream,
        mlp_block_fwd_stash, mlp_block_tp_bwd, mlp_block_tp_fwd)
    from sky_embeddings_tpu_torch.ops.kernels.simscore import (
        weighted_bank_scores, weighted_bank_scores_multi)

    tp = (attn_block_tp_fwd, attn_block_tp_bwd, mlp_block_tp_fwd, mlp_block_tp_bwd)
    counters = (fused_attn_block, fused_mlp_block, weighted_bank_scores,
                weighted_bank_scores_multi, attn_block_fwd_stash, attn_block_bwd_stash,
                mlp_block_bwd, attn_block_bwd, mlp_block_fwd_stash, mlp_block_bwd_stash,
                mlp_block_bwd_stream, fused_attention, fused_attention_bwd, *tp)
    seg_counters = (fused_attn_block, attn_block_fwd_stash, attn_block_bwd, attn_block_tp_fwd,
                    attn_block_tp_bwd)
    f32_counters = (fused_attn_block, fused_mlp_block, attn_block_fwd_stash, attn_block_bwd_stash,
                    mlp_block_bwd, attn_block_bwd, mlp_block_fwd_stash, mlp_block_bwd_stash,
                    mlp_block_bwd_stream, *tp)
    fused_counters = (attn_block_tp_fwd,)
    return counters, seg_counters, f32_counters, tp, fused_counters


def counter_fns():
    """``(zero_counters, launch_counts)`` over :func:`kernel_counters`; the
    tensor-parallel forms' finishes (their second C entry, after the
    all-reduce) as ``<form>_finish``, K2 TP's fused forward launches as
    ``<form>_fused``."""
    counters, seg_counters, f32_counters, finish_counters, fused_counters = kernel_counters()

    def zero_counters():
        for fn in counters:
            fn.launches = 0
        for fn in seg_counters:
            fn.seg_launches = 0
        for fn in f32_counters:
            fn.f32_launches = 0
        for fn in finish_counters:
            fn.finish_launches = 0
        for fn in fused_counters:
            fn.fused_launches = 0

    def launch_counts():
        return {**{f.__name__: f.launches for f in counters},
                **{f.__name__ + "_seg": f.seg_launches for f in seg_counters},
                **{f.__name__ + "_f32": f.f32_launches for f in f32_counters},
                **{f.__name__ + "_finish": f.finish_launches for f in finish_counters},
                **{f.__name__ + "_fused": f.fused_launches for f in fused_counters}}

    return zero_counters, launch_counts


def free_port() -> int:
    """A free localhost port for a process group's coordinator."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _lr_sum(tr, n):
    """The summed learning rate of a trainer's first ``n`` steps."""
    sched = getattr(tr, "lr_schedule", None) or tr.schedule
    return sum(sched(t) for t in range(n))


def profile_device_ms(fn, reps):
    """Kernel time a call of ``fn`` by torch.profiler (CUPTI), or "not
    measured" when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum((getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False))
    return total / 1e3 / reps if total else "not measured"


def _dp_data(cfg_name, n_batches, seed):
    """Phase 5j's global batches for a config, from a seed: cutouts (and
    the labels of a predictor config), made alike in every process."""
    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts

    cfg = load_config(cfg_name, os.path.join(ROOT, "configs"))
    B = cfg.training.int("batch_size")
    arch = cfg
    if "pretained_mae" in cfg.training or "pretrained_mae" in cfg.training:
        arch = load_config(cfg.pretrained_mae_name(), os.path.join(ROOT, "configs"))
    geom = dict(channels=arch.architecture.int("num_channels"),
                img_size=arch.architecture.int("img_size"))
    make = make_cutouts if cfg_name == DP[0] else make_structured_cutouts
    out = []
    for i in range(n_batches):  # batch i from seed + i, whatever the count
        d = make(B, seed=seed + i, **geom)
        b = {"cutouts": d["cutouts"]}
        if arch is not cfg:
            b["labels"] = d["zspec"][:, None]
        out.append(b)
    return out


def _dp_trainer(cfg_name, dev, zero_on=True):
    """Phase 5j's trainer of a config as shipped (bf16), seed 0, with
    ``zero_optimizer``; a predictor config fresh (no warm start)."""
    import torch

    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    cfg_dir = os.path.join(ROOT, "configs")
    cfg = apply_overrides(load_config(cfg_name, cfg_dir), [f"TRAINING.zero_optimizer={zero_on}"],
                          cfg_name)
    check(cfg.training.str("dtype") == "bfloat16", f"{cfg_name} trains in bf16 as shipped")
    if cfg_name.startswith("jepa"):
        return JEPATrainer(cfg, seed=0, device=dev)
    if cfg.pretrained_mae_name():
        return PredictorTrainer(cfg, load_config(cfg.pretrained_mae_name(), cfg_dir), seed=0,
                                device=dev)
    return MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device=dev)


def _loss_of(out):
    """The loss of a train_batch result (the predictor's is (loss, metric))."""
    return float(out[0] if isinstance(out, tuple) else out)


def dp_worker(spec_path: str) -> int:
    """One rank of phase 5j (started by :func:`dp_phase` with its
    ``SKY_*`` variables): the mim_1 leg (its rows of the global batches
    through ``device_prefetch(sharding=...)``, counters zeroed just before
    the steps and read just after, wall ms a step, the device ms of two
    steps, the moment bytes, a consolidated save, the next step
    uninterrupted and from a restore), then the ft and I-JEPA legs. Writes
    its results as JSON, and rank 0 its tensors, under the spec's
    directory."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, ROOT)
    import torch

    from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
    from sky_embeddings_tpu_torch.parallel import distributed, zero

    check(distributed.initialize_from_env(backend=spec["backend"], device=spec["device"]),
          "the SKY_* contract starts the process group")
    rank, world = distributed.process_index(), distributed.process_count()
    dev = distributed.rank_device(spec["device"])
    print(f"rank {rank}/{world}: {torch.distributed.get_backend()} on {dev}", flush=True)
    zero_counters, launch_counts = counter_fns()
    res, tensors = {"rank": rank, "world": world, "legs": {}}, {}
    name, B, steps, _ = DP
    for cfg_name, n_steps in ((name, steps),) + tuple(tuple(leg) for leg in spec["legs"]):
        tr = _dp_trainer(cfg_name, dev)
        check(zero.is_sharded(tr.optimizer) and tr.forward is not tr.model,
              f"{cfg_name}: DDP and ZeRO-1 under the group")
        rows = distributed.batch_rows(tr.batch_size // world)[0]
        glob = _dp_data(cfg_name, n_steps + 1, spec["seed"])
        local = [{k: v[rows] for k, v in b.items()} for b in glob]
        zero_counters()
        torch.cuda.synchronize()
        losses, walls = [], []
        t0 = time.perf_counter()
        for i, batch in enumerate(device_prefetch(local[:n_steps], size=2, sharding=tr.batch_shard)):
            losses.append(_loss_of(tr.train_batch(batch)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            if i == 0 and rank == 0 and cfg_name == name:
                tensors["grads1"] = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
        leg = {"batch": len(local[0]["cutouts"]), "losses": losses, "wall_ms_per_step": walls,
               "launches": launch_counts(), "moment_bytes": zero.moment_bytes(tr.optimizer)}
        tensors[cfg_name] = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
        if cfg_name == name:
            path = os.path.join(spec["out"], "dp2.ckpt.pt")
            t0 = time.perf_counter()
            tr.save(path)  # every rank: the moments collected, rank 0 writes
            torch.distributed.barrier()
            leg["save_s"] = time.perf_counter() - t0
            nxt = local[n_steps]
            leg["next_loss"] = _loss_of(tr.train_batch(nxt))
            uninterrupted = {k: v.clone() for k, v in tr.model.state_dict().items()}
            fresh = _dp_trainer(cfg_name, dev)
            check(fresh.restore(path) and fresh.cur_iter == n_steps, "the ranks restore the file")
            leg["restored_loss"] = _loss_of(fresh.train_batch(nxt))
            leg["restored_bit_equal"] = leg["restored_loss"] == leg["next_loss"] and all(
                torch.equal(v, uninterrupted[k]) for k, v in fresh.model.state_dict().items())
            tensors["restored"] = {k: v.detach().cpu() for k, v in fresh.model.state_dict().items()}
            del fresh, uninterrupted
            leg["device_ms_per_step"] = profile_device_ms(lambda: tr.train_batch(nxt), 2)
        res["legs"][cfg_name] = leg
        del tr
        torch.cuda.empty_cache()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        torch.save(tensors, os.path.join(spec["out"], "rank0.pt"))
    torch.distributed.destroy_process_group()
    return 0


def dp_phase(dev, zero_counters, launch_counts):
    """Phase 5j, data parallelism across processes (``parallel/``).

    World 1 under NCCL: the mim_1 trainer with DDP and ZeRO-1 takes DP[2]
    steps, counters zeroed just before and read just after, its losses
    and parameters bit-equal to the same trainer with no process group
    from the same seed, batches and masks; a consolidated save, a restore
    and the next step bit-equal to the no-group trainer restored from the
    same file; both timed in turns (none, DDP, DDP, none), wall ms a step
    and the profiler's device ms.

    Two ranks on the one card through gloo (CUDA tensors in every
    collective: DDP's all-reduce, ZeRO's broadcasts, the losses' sums;
    no staging through the host by this phase): DP_RANKS processes through
    the ``SKY_*`` contract (:func:`dp_worker`), global batch DP[1], against
    the no-group run over the global batch: step 1's gradients, the
    losses and the parameters within TOL_DP, the launches per rank equal
    to the one-process run's at half the batch, each rank's moment bytes
    about half the unsharded optimizer's, the restored step bit-equal to
    the uninterrupted one on each rank and within TOL_DP of the no-group
    trainer restored from the same file; the ft and I-JEPA legs, DP_LEGS,
    against one process the same way."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.parallel import distributed, zero
    from sky_embeddings_tpu_torch.parallel.smoke import param_gaps

    name, B, steps, timed = DP
    check(not torch.distributed.is_initialized(), "no process group before phase 5j")
    glob = _dp_data(name, steps + 1, 31)
    out = {"config": name, "batch": B, "steps": steps, "ranks": DP_RANKS, "launches": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    walls = {"none": [], "ddp_zero": [], "ddp": []}
    device_ms = {}

    def turn(tr, tag):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in glob[:timed]:
            tr.train_batch(b)
        torch.cuda.synchronize()
        walls[tag].append((time.perf_counter() - t0) * 1e3 / timed)

    def state(tr):
        return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}

    try:
        # ---- world 1: no group, then NCCL --------------------------------
        plain = _dp_trainer(name, dev)
        check(plain.forward is plain.model and not zero.is_sharded(plain.optimizer),
              "no process group: the model itself and AdamW")
        zero_counters()
        torch.cuda.synchronize()
        ref_losses = [plain.train_batch(b) for b in glob[:steps]]
        torch.cuda.synchronize()
        ref_launches = launch_counts()
        ref_state = state(plain)
        full_moments = zero.moment_bytes(plain.optimizer)
        half = {"cutouts": glob[steps]["cutouts"][:B // DP_RANKS]}
        zero_counters()
        plain.train_batch(half)
        half_launches = launch_counts()
        turn(plain, "none")  # every turn before any profiler session

        os.environ.update({distributed.ENV_FLAG: "1",
                           distributed.ENV_COORD: f"127.0.0.1:{free_port()}",
                           distributed.ENV_NPROC: "1", distributed.ENV_PID: "0"})
        try:
            check(distributed.initialize_from_env(device=DEVICE), "world 1 starts")
            backend = torch.distributed.get_backend()
            w1 = _dp_trainer(name, dev)
            check(zero.is_sharded(w1.optimizer) and w1.forward is not w1.model,
                  "world 1: DDP and ZeRO-1")
            zero_counters()
            torch.cuda.synchronize()
            w1_losses = [w1.train_batch(b) for b in glob[:steps]]
            torch.cuda.synchronize()
            out["launches"]["world1_" + name] = launch_counts()
            same_losses = all(torch.equal(a, b) for a, b in zip(w1_losses, ref_losses))
            same_params = all(torch.equal(v, ref_state[k]) for k, v in state(w1).items())
            check(out["launches"]["world1_" + name] == ref_launches,
                  "world 1: the launches of the no-group run")
            # DDP with ZeRO-1 beside DDP alone, in turns
            w1d = _dp_trainer(name, dev, zero_on=False)
            for tr_, tag in ((w1, "ddp_zero"), (w1d, "ddp"), (w1d, "ddp"), (w1, "ddp_zero")):
                turn(tr_, tag)
            path1 = os.path.join(work, "dp1.ckpt.pt")
            t_save = time.perf_counter()
            w1.save(path1)
            t_save = time.perf_counter() - t_save
            w1r = _dp_trainer(name, dev)
            check(w1r.restore(path1), "world 1: restore")
            w1r_loss = w1r.train_batch(glob[steps])
            w1r_state = state(w1r)
            del w1r
            device_ms["ddp_zero"] = profile_device_ms(lambda: w1.train_batch(glob[0]), 3)
            device_ms["ddp"] = profile_device_ms(lambda: w1d.train_batch(glob[0]), 3)
            del w1d
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
            for k in (distributed.ENV_FLAG, distributed.ENV_COORD, distributed.ENV_NPROC,
                      distributed.ENV_PID):
                os.environ.pop(k, None)
        del w1
        back = _dp_trainer(name, dev)
        check(back.restore(path1), "no group: restore the world-1 file")
        back_loss = back.train_batch(glob[steps])
        restored_equal = torch.equal(back_loss, w1r_loss) and all(
            torch.equal(v, w1r_state[k]) for k, v in state(back).items())
        del back, w1r_state
        turn(plain, "none")
        device_ms["none"] = profile_device_ms(lambda: plain.train_batch(glob[0]), 3)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        out["world1"] = {"backend": backend, "losses_bit_equal": same_losses,
                         "params_bit_equal": same_params, "restored_step_bit_equal": restored_equal,
                         "save_s": t_save, "wall_ms_per_step": walls, "median_wall_ms": med,
                         "device_ms_per_step": device_ms}
        print(f"dp world 1 ({backend}, {name}, B={B}, DDP + ZeRO-1): {steps} steps, losses bit-equal "
              f"{same_losses}, parameters bit-equal {same_params}, restored step bit-equal "
              f"{restored_equal}, save {t_save:.2f} s; wall ms a step (turns) none {walls['none']}, "
              f"DDP + ZeRO-1 {walls['ddp_zero']}, DDP {walls['ddp']}; device ms a step none "
              f"{device_ms['none']}, DDP + ZeRO-1 {device_ms['ddp_zero']}, DDP {device_ms['ddp']}",
              flush=True)
        check(same_losses and same_params, "world 1: bit-equal to no process group")
        check(restored_equal, "world 1: the restored step bit-equal to the no-group restore")

        # ---- two ranks through gloo ---------------------------------------
        lr_sum, lr_sum_next = 2 * _lr_sum(plain, steps), 2 * _lr_sum(plain, steps + 1)
        del plain
        torch.cuda.empty_cache()
        one = _dp_trainer(name, dev)
        one.train_batch(glob[0])
        one_grads1 = {n: p.grad.detach().clone() for n, p in one.model.named_parameters()}
        del one
        torch.cuda.empty_cache()
        spec = {"backend": "gloo", "device": DEVICE, "seed": 31, "out": work,
                "legs": [list(leg) for leg in DP_LEGS]}
        spec_path = os.path.join(work, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        env_base = dict(os.environ, SKY_DISTRIBUTED="1",
                        SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                        SKY_NUM_PROCESSES=str(DP_RANKS))
        procs = [subprocess.Popen([sys.executable, *DP_WORKER, spec_path],
                                  env=dict(env_base, SKY_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(DP_RANKS)]
        logs = []
        try:
            for p_ in procs:
                logs.append(p_.communicate(timeout=600)[0])
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
        t_ranks = time.perf_counter() - t0
        for r, (p_, log) in enumerate(zip(procs, logs)):
            print(f"dp rank {r} exit {p_.returncode}; its output's end:\n{log[-1500:]}", flush=True)
            check(p_.returncode == 0, f"dp rank {r} ran to its end")
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t_ = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
        legs = {}
        tol_g, tol_l, tol_p = TOL_DP[name]
        gaps1 = {n: float((t_["grads1"][n].to(dev) - g).norm() / (g.norm() + 1e-30))
                 for n, g in one_grads1.items()}
        worst = max(gaps1, key=gaps1.get)
        grad_gap = gaps1[worst]
        loss_gap = max(abs(a - float(b)) / abs(float(b))
                       for a, b in zip(ranks[0]["legs"][name]["losses"], ref_losses))
        rest, keys = param_gaps({k: v.to(dev) for k, v in t_[name].items()}, ref_state)
        for r in ranks:
            check(r["legs"][name]["losses"] == ranks[0]["legs"][name]["losses"],
                  "the ranks report the same global losses")
            check(r["legs"][name]["restored_bit_equal"], f"rank {r['rank']}: the restored step "
                  "bit-equal to the uninterrupted one")
            for k_, n_ in r["legs"][name]["launches"].items():
                check(n_ == half_launches[k_] * steps,
                      f"rank {r['rank']}: {k_} launches {n_} == {half_launches[k_]} x {steps}")
            share = r["legs"][name]["moment_bytes"] / full_moments
            check(0.4 < share < 0.6, f"rank {r['rank']}: moment bytes {share:.3f} of unsharded")
        # the no-group trainer restored from the ranks' file, its next step
        back = _dp_trainer(name, dev)
        check(back.restore(os.path.join(work, "dp2.ckpt.pt")) and back.cur_iter == steps,
              "no group: restore the 2-rank file")
        back_loss = float(back.train_batch(glob[steps]))
        r_rest, r_keys = param_gaps({k: v.to(dev) for k, v in t_["restored"].items()}, state(back))
        r_loss_gap = abs(ranks[0]["legs"][name]["restored_loss"] - back_loss) / abs(back_loss)
        del back
        legs[name] = {"grad_gap": grad_gap, "grad_gap_leaf": worst,
                      "grad_gap_median": float(np.median(list(gaps1.values()))),
                      "loss_gap": loss_gap, "param_gap": rest,
                      "key_bias_gap": keys, "restored_param_gap": r_rest,
                      "restored_loss_gap": r_loss_gap, "lr_sum": lr_sum}
        print(f"dp {DP_RANKS} ranks ({name}, B={B}, {B // DP_RANKS} a rank, gloo): step 1's gradients "
              f"{grad_gap:.3e} at {worst} (bar {tol_g}; median {legs[name]['grad_gap_median']:.2e}), losses {loss_gap:.3e} (bar {tol_l}), parameters after "
              f"{steps} steps {rest:.3e} (bar {tol_p}), key biases {keys:.3e} (bar {lr_sum:.3e}); "
              f"restored step against the no-group restore: parameters {r_rest:.3e}, loss "
              f"{r_loss_gap:.3e}; moment bytes {[r['legs'][name]['moment_bytes'] for r in ranks]} of "
              f"{full_moments} unsharded; wall ms a step {ranks[0]['legs'][name]['wall_ms_per_step']}",
              flush=True)
        check(grad_gap <= tol_g and loss_gap <= tol_l and rest <= tol_p and keys <= lr_sum,
              f"{name}: {DP_RANKS} ranks against one process")
        check(r_rest <= tol_p and r_loss_gap <= tol_l and r_keys <= lr_sum_next,
              f"{name}: the restored 2-rank step against the no-group restore")

        # the ft and I-JEPA legs against one process over the global batch
        for cfg_name, n_steps in DP_LEGS:
            tr = _dp_trainer(cfg_name, dev)
            gb = _dp_data(cfg_name, n_steps, 31)
            zero_counters()
            torch.cuda.synchronize()
            l1 = [_loss_of(tr.train_batch(b)) for b in gb]
            torch.cuda.synchronize()
            l1_launches = launch_counts()
            _, tol_l2, tol_p2 = TOL_DP[cfg_name]
            lr2 = 2 * _lr_sum(tr, n_steps)
            rest2, keys2 = param_gaps({k: v.to(dev) for k, v in t_[cfg_name].items()}, state(tr))
            lg = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["legs"][cfg_name]["losses"], l1))
            for r in ranks:
                check(r["legs"][cfg_name]["losses"] == ranks[0]["legs"][cfg_name]["losses"],
                      f"{cfg_name}: the ranks report the same global losses")
                check(r["legs"][cfg_name]["launches"] == l1_launches,
                      f"{cfg_name}: rank {r['rank']} launches those of one process")
            legs[cfg_name] = {"loss_gap": lg, "param_gap": rest2, "key_bias_gap": keys2, "lr_sum": lr2,
                              "one_process_losses": l1}
            print(f"dp {DP_RANKS} ranks ({cfg_name}, B={tr.batch_size}, gloo): losses {lg:.3e} (bar "
                  f"{tol_l2}), parameters after {n_steps} steps {rest2:.3e} (bar {tol_p2}), key "
                  f"biases {keys2:.3e} (bar {lr2:.3e}); wall ms a step "
                  f"{ranks[0]['legs'][cfg_name]['wall_ms_per_step']}", flush=True)
            check(lg <= tol_l2 and rest2 <= tol_p2 and keys2 <= lr2,
                  f"{cfg_name}: {DP_RANKS} ranks against one process")
            del tr
            torch.cuda.empty_cache()
        for r in ranks:
            for cfg_name, leg in r["legs"].items():
                out["launches"][f"rank{r['rank']}_{cfg_name}"] = leg["launches"]
        out["two_ranks"] = {"backend": "gloo", "seconds": t_ranks, "gaps": legs,
                            "unsharded_moment_bytes": full_moments,
                            "ranks": [{k: v for k, v in r.items()} for r in ranks]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out

def _tp_data(cfg_name, n_batches, seed):
    """Phase 5l's global batches of a config as shipped: cutouts, RA/Dec and
    (a predictor config) zspec labels, batch i from seed + i, made alike in
    every process."""
    import numpy as np

    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_structured_cutouts

    cfg = load_config(cfg_name, os.path.join(ROOT, "configs"))
    mae = cfg.pretrained_mae_name()
    arch = load_config(mae, os.path.join(ROOT, "configs")) if mae else cfg
    geom = dict(channels=arch.architecture.int("num_channels"),
                img_size=cfg.architecture.int("img_size"))
    out = []
    for i in range(n_batches):
        d = make_structured_cutouts(cfg.training.int("batch_size"), seed=seed + i, **geom)
        b = {"cutouts": d["cutouts"], "ra_dec": np.stack([d["ra"], d["dec"]], 1)}
        if mae:
            b["labels"] = d["zspec"][:, None]
        out.append(b)
    return out


def _tp_trainer(cfg_name, dev, tp):
    """Phase 5l's trainer of a config as shipped (its dtype) at
    ``tensor_parallel = tp``, seed 0; a predictor config fresh; an I-JEPA
    config (one with a ``[MASK]`` section) its ``JEPATrainer``."""
    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    cfg_dir = os.path.join(ROOT, "configs")
    cfg = apply_overrides(load_config(cfg_name, cfg_dir), [f"TRAINING.tensor_parallel={tp}"],
                          cfg_name)
    if "MASK" in cfg:
        return JEPATrainer(cfg, seed=0, device=dev)
    if cfg.pretrained_mae_name():
        return PredictorTrainer(cfg, load_config(cfg.pretrained_mae_name(), cfg_dir), seed=0,
                                device=dev)
    return MIMPretrainer(cfg, seed=0, device=dev)


def _tp_modules(tr) -> list:
    """A trainer's sharded modules: its model, and an I-JEPA trainer's EMA
    target."""
    return [tr.model] + ([tr.target] if hasattr(tr, "target") else [])


def _tp_whole(tr) -> dict:
    """A trainer's state: ``params`` and, for I-JEPA, ``target`` (whole
    arrays in one process; this rank's shards under tensor parallelism)."""
    return dict(zip(("params", "target"), (m.state_dict() for m in _tp_modules(tr))))


def _block_tally(tr, tp):
    """Phase 5l's prediction of a rank's block launches, read from one
    process's run: forward hooks on every ``Block`` of the trainer's model
    (and EMA target) count, for the blocks ``tp`` ranks split and for those
    they leave whole (``parallel/sharding.split_blocks``), the forward
    calls (each a forward kernel launch, remat's replays too, which stop
    inside the forward once the backward has its tensors: so a pre-hook
    counts them) and, through a hook on the output's gradient, the backward
    passes (each a backward kernel launch), with the packed-segment ones
    apart, and the split blocks' forwards whose rank shapes take K2 TP's
    fused bf16 half (``attn_block.tp_fwd_path``).
    Returns the tally, the hooks' handles and the set of the split blocks'
    rank shapes ``(B, N, D, Dl, local heads, F_r, seg_len, dtype)``."""
    from sky_embeddings_tpu_torch.models.layers import Block
    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.parallel.sharding import split_blocks

    tally = {f"{kind}_{what}": 0 for kind in ("split", "whole")
             for what in ("fwd", "fwd_seg", "bwd", "bwd_seg")}
    tally.update(split_fwd_fused_attn=0)
    shapes, handles = set(), []

    def seg_of(args):
        return int(len(args) > 2 and 0 < args[2] < args[0].shape[1])

    def hooks(kind):
        def before(mod, args):  # remat's replay stops inside the forward: counted here
            tally[f"{kind}_fwd"] += 1
            tally[f"{kind}_fwd_seg"] += seg_of(args)
            if kind == "split":
                B, N, D = args[0].shape
                Hl, hd = mod.num_heads // tp, D // mod.num_heads
                Fl, seg = mod.ffn.fc1_kernel.shape[1] // tp, args[2] if len(args) > 2 else 0
                shapes.add((B, N, D, Hl * hd, Hl, Fl, seg, str(mod.dtype)))
                tally["split_fwd_fused_attn"] += ab.tp_fwd_path(N, D, Hl * hd, Hl, seg,
                                                                mod.dtype) == "fused"

        def after(mod, args, out):
            if out.requires_grad:
                def on_backward(g, seg=seg_of(args)):
                    tally[f"{kind}_bwd"] += 1
                    tally[f"{kind}_bwd_seg"] += seg
                out.register_hook(on_backward)
        return before, after

    for module in _tp_modules(tr):
        split = split_blocks(module, tp)
        for name, b in module.named_modules():
            if isinstance(b, Block):
                before, after = hooks("split" if name in split else "whole")
                handles += [b.register_forward_pre_hook(before), b.register_forward_hook(after)]
    return tally, handles, shapes


def _tp_steps(tr, batches, zero_counters, launch_counts):
    """Phase 5l's steps of a trainer: counters zeroed just before and read
    just after; wall ms a step; step 1's gradients; under tensor
    parallelism the collectives' seconds a step (the model group's
    all-reduces timed on the host) and a digest of the replicated
    parameters (an I-JEPA trainer's EMA target's too) after every step."""
    import hashlib

    import torch

    from sky_embeddings_tpu_torch.parallel.sharding import shard_of, split_of

    mesh = getattr(tr, "mesh", None)
    coll = [0.0]
    if mesh is not None:
        reduce = mesh.all_reduce_model

        def timed_reduce(t):
            t0 = time.perf_counter()
            reduce(t)
            coll[0] += time.perf_counter() - t0
            return t

        mesh.all_reduce_model = timed_reduce
    zero_counters()
    torch.cuda.synchronize()
    losses, walls, colls, digests, grads1 = [], [], [], [], None
    for i, b in enumerate(batches):
        c0, t0 = coll[0], time.perf_counter()
        losses.append(_loss_of(tr.train_batch(b)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        colls.append((coll[0] - c0) * 1e3)
        if i == 0:
            grads1 = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None}
        h = hashlib.sha256()
        for module in _tp_modules(tr):
            split = split_of(module)
            for n, v in module.state_dict().items():
                if shard_of(n, split) is None:
                    h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        digests.append(h.hexdigest())
    if mesh is not None:
        mesh.all_reduce_model = reduce
    return {"losses": losses, "wall_ms_per_step": walls, "collective_ms_per_step": colls,
            "replicated_digests": digests, "launches": launch_counts()}, grads1


def _tp_device_ms(fn) -> dict:
    """Device ms of one call of ``fn`` by torch.profiler: every device
    event's, and the kernels' alone (gloo's staging copies of the
    all-reduced tensors through the host excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = kernels = 0.0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or getattr(
                e, "is_user_annotation", False):
            continue
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total += t
        if not e.key.startswith(("Memcpy", "Memset")):
            kernels += t
    if not total:
        return {"all": "not measured", "kernels": "not measured"}
    return {"all": total / 1e3, "kernels": kernels / 1e3}


def tp_worker(spec_path: str) -> int:
    """One rank of phase 5l (started by :func:`tp_phase` with its ``SKY_*``
    variables): each leg of TP_LEGS at tensor_parallel = TP_RANKS on the
    global batches (:func:`_tp_steps`), step 1's gradients and the final
    parameters (and EMA target) gathered on rank 0, peak memory; for the
    TP_CKPT legs also a save, the next step uninterrupted and from a
    restore, and the device ms of a step. Writes its results as JSON, and
    rank 0 its tensors, under the spec's directory."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, ROOT)
    import torch

    from sky_embeddings_tpu_torch.parallel import distributed
    from sky_embeddings_tpu_torch.parallel.sharding import gather_to_main, split_of

    check(distributed.initialize_from_env(backend=spec["backend"], device=spec["device"]),
          "the SKY_* contract starts the process group")
    rank = distributed.process_index()
    dev = distributed.rank_device(spec["device"])
    print(f"tp rank {rank}: {torch.distributed.get_backend()} on {dev}", flush=True)
    zero_counters, launch_counts = counter_fns()
    res, tensors = {"rank": rank, "legs": {}}, {}
    for cfg_name, steps in spec["legs"]:
        tr = _tp_trainer(cfg_name, dev, TP_RANKS)
        check(tr.mesh.shape == (1, TP_RANKS) and tr.mesh.model_index == rank
              and tr.forward is tr.model, f"{cfg_name}: a (1, {TP_RANKS}) mesh, no DDP")
        glob = _tp_data(cfg_name, steps + 1, spec["seed"])
        torch.cuda.reset_peak_memory_stats(dev)
        leg, grads1 = _tp_steps(tr, glob[:steps], zero_counters, launch_counts)
        leg["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        grads1 = gather_to_main(grads1, tr.mesh, split_of(tr.model))
        whole = {k: gather_to_main(sd, tr.mesh, split_of(m))
                 for (k, sd), m in zip(_tp_whole(tr).items(), _tp_modules(tr))}
        if rank == 0:
            tensors[cfg_name] = {"grads1": grads1, **whole}
        if cfg_name in spec["ckpt"]:
            path = os.path.join(spec["out"], f"tp_{cfg_name}.ckpt.pt")
            tr.save(path)  # every rank: the shards gathered, rank 0 writes whole arrays
            torch.distributed.barrier()
            nxt = glob[steps]
            leg["next_loss"] = _loss_of(tr.train_batch(nxt))
            uninterrupted = {k: {n: v.clone() for n, v in sd.items()}
                             for k, sd in _tp_whole(tr).items()}
            fresh = _tp_trainer(cfg_name, dev, TP_RANKS)
            check(fresh.restore(path) and fresh.cur_iter == steps, "the ranks restore the file")
            restored = []
            leg["device_ms_per_step"] = _tp_device_ms(lambda: restored.append(
                _loss_of(fresh.train_batch(nxt))))  # the restored step, profiled
            leg["restored_bit_equal"] = restored == [leg["next_loss"]] and all(
                torch.equal(v, uninterrupted[k][n]) for k, sd in _tp_whole(fresh).items()
                for n, v in sd.items())
            del fresh, uninterrupted
        res["legs"][cfg_name] = leg
        del tr
        torch.cuda.empty_cache()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        torch.save(tensors, os.path.join(spec["out"], "rank0.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _tp_timers(name, x, scale, bias, g, w, s0, errs, B, N, D, Hl, Fl, hd, seg, fused):
    """:func:`tp_kernels`'s timers of one form: ``(key, operations, bytes,
    kernel call, plain call, (max-rel, max-abs), chain call)`` for its
    forward and its backward, one rank's work on its shard ``s0`` (its half
    and its finish): its products and core, and what it must move. Where
    the bf16 forward half takes the fused kernel (``fused``) its key ends in
    ``_fused`` and the chain forced at the same shape is timed beside it."""
    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as mb

    fwd_err, bwd_err, worst = errs
    M, Dl = B * N, Hl * hd
    core = B * Hl * N * N * hd
    if name == "attn_block_tp":
        f_ops = 8 * M * D * Dl + 4 * core
        # the qkv recompute, dctx, dy, dWqkv, dWproj: kernel 4's 22 M D^2 at Dl
        b_ops = 22 * M * D * Dl + 10 * core
        w_bytes = 4 * D * Dl * 2
        half = lambda: ab.attn_block_tp_fwd(x, scale, bias, *s0, Hl, seg)  # noqa: E731
        chain = lambda: ab.attn_block_tp_fwd_chain(x, scale, bias, *s0, Hl, seg)  # noqa: E731
        half_b = lambda: ab.attn_block_tp_bwd(x, scale, bias, *s0, g, Hl, seg)  # noqa: E731
        finish, finish_b = ab.attn_block_tp_finish, ab.attn_block_tp_bwd_finish
        plain_h = lambda: ab.attn_block_tp_fwd_plain(x, scale, bias, *s0, Hl, seg)  # noqa: E731
        plain_hb = lambda: ab.attn_block_tp_bwd_plain(x, scale, bias, *s0, g, Hl, seg)  # noqa: E731
    else:
        f_ops, b_ops = 4 * M * D * Fl, 10 * M * D * Fl
        w_bytes = 2 * D * Fl * 2
        half = lambda: mb.mlp_block_tp_fwd(x, scale, bias, *s0)  # noqa: E731
        chain = None  # K1 TP's bf16 half is its chain at every shape
        half_b = lambda: mb.mlp_block_tp_bwd(x, scale, bias, *s0, g)  # noqa: E731
        finish, finish_b = mb.mlp_block_tp_finish, mb.mlp_block_tp_bwd_finish
        plain_h = lambda: mb.mlp_block_tp_fwd_plain(x, scale, bias, *s0)  # noqa: E731
        plain_hb = lambda: mb.mlp_block_tp_bwd_plain(x, scale, bias, *s0, g)  # noqa: E731
    # forward: x read, the weights read, the fp32 partial written and read,
    # out written; backward: x and g read, the weights read, their gradients
    # and dy written, dy read, dx written
    f_bytes = 2 * M * D * 2 + w_bytes + 2 * M * D * 4
    b_bytes = 3 * M * D * 2 + 2 * w_bytes + 2 * M * D * 4
    return ((name + "_fwd" + "_fused" * fused, f_ops, f_bytes, lambda: finish(x, half(), w[3]),
             lambda: mb.tp_finish_plain(x, plain_h(), w[3]), (fwd_err[0], fwd_err[1]),
             (lambda: finish(x, chain(), w[3])) if fused else None),
            (name + "_bwd", b_ops, b_bytes, lambda: finish_b(x, scale, bias, g, half_b()[0]),
             lambda: mb.tp_bwd_finish_plain(x, scale, bias, g, plain_hb()[0]),
             (worst, max(a for _, a in bwd_err.values())), None))


def tp_kernels(dev, timings, cuda_ms, rel_err, bound_ms):
    """Phase 5l's kernel checks: at each TP_SHAPES shape, in bf16 and fp32,
    both ranks' halves of each TP form on their shards, the partials summed
    (the all-reduce's sum) and finished, against the plain whole block
    (TOL_FWD, TOL_BWD per output), with the form each bf16 forward half
    takes (the C path rule equal to its Python mirror) and, where that is
    the fused kernel, each rank's fused half twice bit-equal and bit-equal
    to its chain forced at the same shape; the held-row LN against the
    multi-pass LN, bit for bit, at LN_WIDTHS. Returns the gaps per form and
    case and a function that times, at each TP_TIMED shape in bf16, each
    form on one rank's shard (its half and its finish) beside its plain
    version (and a fused forward beside its chain), with the bound of one
    rank's products and core and the bytes it must move, into ``timings``:
    :func:`tp_phase` calls it once its ranks are done."""
    import torch

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as mb
    from sky_embeddings_tpu_torch.parallel.sharding import TPShard, gather_tensor, shard_tensor

    gen = torch.Generator(device=dev).manual_seed(24)
    heads_rule = (TPShard(1, True), TPShard(0, True), TPShard(0))
    cols_rule = (TPShard(1), TPShard(0), TPShard(0))
    gaps, timers = {}, []
    for tag, B, N, D, H, F, seg in TP_SHAPES:
        Dl, Hl, Fl, hd, M = D // TP_RANKS, H // TP_RANKS, F // TP_RANKS, D // H, B * N
        for dt in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0, cast=False):
                t = torch.randn(*shape, generator=gen, device=dev) * scale
                return t.to(dt) if cast else t
            x = rnd(B, N, D, scale=0.5, cast=True)
            scale, bias = 1 + rnd(D, scale=0.1), rnd(D, scale=0.1)
            g = rnd(B, N, D, scale=0.1, cast=True)
            attn = (rnd(D, 3 * D, scale=D ** -0.5, cast=True), rnd(3 * D, scale=0.01),
                    rnd(D, D, scale=D ** -0.5, cast=True), rnd(D, scale=0.01))
            mlp = (rnd(D, F, scale=D ** -0.5, cast=True), rnd(F, scale=0.01),
                   rnd(F, D, scale=F ** -0.5, cast=True), rnd(D, scale=0.01))
            forms = (("attn_block_tp", attn, heads_rule, ab.attn_block_plain, ab.attn_block_bwd_plain,
                      lambda w: ab.attn_block_tp_fwd(x, scale, bias, *w, Hl, seg),
                      lambda o, p_, b_: ab.attn_block_tp_finish(o, p_, b_),
                      lambda w: ab.attn_block_tp_bwd(x, scale, bias, *w, g, Hl, seg),
                      ab.attn_block_tp_bwd_finish, (H, seg),
                      lambda w: ab.attn_block_tp_fwd_chain(x, scale, bias, *w, Hl, seg),
                      (ab.tp_fwd_path(N, D, Dl, Hl, seg, dt),
                       ab.tp_fwd_path_cuda(B, N, D, Dl, Hl, seg))),
                     ("mlp_block_tp", mlp, cols_rule, mb.mlp_block_plain, mb.mlp_block_bwd_plain,
                      lambda w: mb.mlp_block_tp_fwd(x, scale, bias, *w),
                      lambda o, p_, b_: mb.mlp_block_tp_finish(o, p_, b_),
                      lambda w: mb.mlp_block_tp_bwd(x, scale, bias, *w, g),
                      mb.mlp_block_tp_bwd_finish, (),
                      None, ("chain", None)))
            for (name, w, rule, plain_fwd, plain_bwd, half, finish, half_bwd, finish_bwd, extra,
                 chain, (path, c_path)) in forms:
                if name == "mlp_block_tp" and seg:
                    continue  # the MLP is per token: no mask
                shards = [[shard_tensor(t, r_, k, TP_RANKS) for t, r_ in zip(w[:3], rule)]
                          for k in range(TP_RANKS)]
                parts = [half(s_) for s_ in shards]
                out = finish(x, sum(parts), w[3])
                if dt == torch.bfloat16 and c_path is not None:
                    check(path == c_path, f"{name} {tag}: the C path rule ({c_path}) equals its "
                          f"mirror ({path})")
                fused_eq = None
                if path == "fused":  # each rank's fused half twice, and its chain
                    fused_eq = all(torch.equal(p_, half(s_)) and torch.equal(p_, chain(s_))
                                   for p_, s_ in zip(parts, shards))
                    check(fused_eq, f"{name} {tag}: each rank's fused half twice bit-equal and "
                          "bit-equal to its chain")
                want = plain_fwd(x, scale, bias, *w, *extra)
                halves = [half_bwd(s_) for s_ in shards]
                grads = finish_bwd(x, scale, bias, g, sum(h_[0] for h_ in halves))
                dw = [gather_tensor([h_[i] for h_ in halves], r_) for i, r_ in zip((1, 2, 3), rule)]
                got_g = (*grads[:3], *dw, grads[3])
                want_g = plain_bwd(x, scale, bias, *w[:3], g, *extra) if name == "attn_block_tp" \
                    else plain_bwd(x, scale, bias, *w[:3], g)
                torch.cuda.synchronize()
                fwd_err = rel_err(out, want)
                bwd_err = {i: rel_err(a, b_) for i, (a, b_) in enumerate(zip(got_g, want_g))}
                worst = max(r_ for r_, _ in bwd_err.values())
                finite = bool(torch.isfinite(out.float()).all()) and all(
                    bool(torch.isfinite(a.float()).all()) for a in got_g)
                dname = "bf16" if dt == torch.bfloat16 else "fp32"
                print(f"tp parity {name} {tag} {dname} (B={B}, N={N}, D={D}, {Hl} local heads of "
                      f"{hd}, F/tp={Fl}, seg_len={seg}): forward half {path} ("
                      f"{TP_HALF_LAUNCHES[name][path] if dname == 'bf16' else 'fp32 chain'}), "
                      f"fused twice and chain bit-equal {fused_eq}, forward max-rel "
                      f"{fwd_err[0]:.3e} (bar {TOL_FWD}), backward max-rel per output "
                      + ", ".join(f"{r_:.2e}" for r_, _ in bwd_err.values())
                      + f" (bar {TOL_BWD}), finite {finite}", flush=True)
                check(finite and fwd_err[0] <= TOL_FWD and worst <= TOL_BWD,
                      f"{name} {tag} {dname}: the TP form against the unsharded plain block")
                gaps[f"{name}_{tag}_{dname}"] = {"fwd": fwd_err[0], "bwd": worst, "path": path,
                                                 "fused_bit_equal": fused_eq}
                if tag not in TP_TIMED or dt != torch.bfloat16:
                    continue
                timers.extend((tag, t_) for t_ in _tp_timers(
                    name, x, scale, bias, g, w, shards[0], (fwd_err, bwd_err, worst), B, N, D, Hl,
                    Fl, hd, seg, path == "fused"))
            torch.cuda.empty_cache()
    gaps["ln_held_vs_multi_pass"] = {}
    for D in LN_WIDTHS:  # the TP chains' LN against the whole blocks'
        x = (torch.randn(4096, D, generator=gen, device=dev) * 3 + 0.25).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        bias = 0.1 * torch.randn(D, generator=gen, device=dev)
        held = mb.layernorm_cuda(x, scale, bias, True)
        multi = mb.layernorm_cuda(x, scale, bias, False)
        same = bool(torch.equal(held, multi))
        differ = int((held != multi).sum())
        gaps["ln_held_vs_multi_pass"][str(D)] = {"bit_equal": same, "elements_differing": differ}
        print(f"tp LN bits at D={D} (4 096 rows): held-row LN bit-equal to the multi-pass LN "
              f"{same} ({differ} elements differ)", flush=True)
        check(same, f"D={D}: the held-row LN gives the multi-pass LN's bits")

    def time_forms():
        """The timings, run once the card is otherwise idle."""
        for tag, (key, ops, nbytes, kern_fn, plain_fn, (rel, abs_err), chain_fn) in timers:
            b_ms, b_by = bound_ms(ops, nbytes, PEAK_BF16)
            timings[(key, tag)] = {
                "max_rel_err": rel, "max_abs_err": abs_err, "ms": cuda_ms(kern_fn, 20),
                "plain_ms": cuda_ms(plain_fn, 5), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}
            if chain_fn is not None:
                timings[(key, tag)]["chain_ms"] = cuda_ms(chain_fn, 20)
        timers.clear()

    return gaps, time_forms


def _by_launch(fn, reps=20):
    """Device µs a call of each kernel of ``fn``, by name in order of first
    launch, and its launches a call, by torch.profiler over ``reps`` calls:
    ``[name, µs, launches]``, a kernel's mean over its records times its
    launches a call (the whole number nearest its records over ``reps``: a
    trace can miss a call's records, or carry one of the session before
    it). None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows, first = {}, {}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or getattr(
                e, "is_user_annotation", False):
            continue
        row = rows.setdefault(e.name[:90], [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
        first[e.name[:90]] = min(first.get(e.name[:90], e.time_range.start), e.time_range.start)
    out = []
    for name in sorted(rows, key=first.get):
        total, count = rows[name]
        per = max(1, round(count / reps))
        out.append([name, total / count * per, per])
    return out or None


def tp_stream_k(dev, cuda_ms, rel_err):
    """Phase 5l's look at the TP backward halves (kernel 4's and 8's) and
    their weight-gradient groups, once the card is otherwise idle:

    - the C group plan (``gemm.bwd_plan_cuda``) against its Python mirror
      (``gemm.bwd_plan``) at each TP_SHAPES shape's two groups: the same
      schedule, tile width, units, CTAs and workspace;
    - each half (forward and backward) and its finish at the TP_TIMED
      shapes in bf16, on one rank's shard, kernel by kernel (device µs and
      launches a call by torch.profiler), their sums, the call's CUDA-event
      ms and the host µs a call to enqueue; "paced" host where the event
      time is more than 1.5x the device sum;
    - each TP_GROUPS group alone (``gemm.gemm_bwd_group``) against its
      plain version (TOL_FWD) and twice bit-equal under its plan, and its
      device time under the plan, the split schedule at the width of
      ``gemm.split_plan`` (the plan without stream-K) with 1 and 2 slices,
      and stream-K forced; where the plan takes stream-K, whether it was
      no slower than the split schedule's plan."""
    import time

    import torch

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.ops.kernels import gemm
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as mb

    out = {"plans": {}, "breakdown": {}, "groups": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, B, N, D, H, F, _ in TP_SHAPES:
        Dl, Fl, M = D // TP_RANKS, F // TP_RANKS, B * N
        for form, shapes in (("attn_block_tp_bwd", [(gemm.KIND_TN_SPLIT, D, 3 * Dl, M),
                                                    (gemm.KIND_TN_SPLIT, Dl, D, M)]),
                             ("mlp_block_tp_bwd", [(gemm.KIND_TN_SPLIT, D, Fl, M),
                                                   (gemm.KIND_TN_SPLIT, Fl, D, M)])):
            got, ws = gemm.bwd_plan_cuda(shapes, sms)
            want = gemm.bwd_plan(shapes, sms)
            key = lambda p_: (p_.schedule, p_.bn, p_.units, p_.ctas)  # noqa: E731
            same = key(got) == key(want) and ws == gemm.bwd_workspace(shapes, want)
            print(f"tp plan {form} {tag}: C {got} ws {ws}, mirror {want}, equal {same}",
                  flush=True)
            check(same, f"{form} {tag}: the C group plan equals its Python mirror")
            out["plans"][f"{form}_{tag}"] = {"schedule": got.schedule, "bn": got.bn,
                                            "splits": got.splits, "units": got.units,
                                            "workspace": ws, "cost": got.cost}

    gen = torch.Generator(device=dev).manual_seed(26)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dt)

    def host_us(fn, iters=20, batches=5):
        """The least of ``batches`` means of ``iters`` enqueued calls (the
        host's clock is shared and noisy)."""
        best = None
        for _ in range(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            best = min(best or t1 - t0, t1 - t0)
        return best / iters * 1e6

    for tag, B, N, D, H, F, seg in TP_SHAPES:
        if tag not in TP_TIMED:
            continue
        Hl, Fl, hd = H // TP_RANKS, F // TP_RANKS, D // H
        Dl = Hl * hd
        x, g = rnd(B, N, D, s=0.5, dt=bf), rnd(B, N, D, s=0.1, dt=bf)
        scale, bias = 1 + rnd(D, s=0.1), rnd(D, s=0.1)
        attn = (rnd(D, 3 * Dl, s=D ** -0.5, dt=bf), rnd(3 * Dl, s=0.01),
                rnd(Dl, D, s=D ** -0.5, dt=bf))
        mlp = (rnd(D, Fl, s=D ** -0.5, dt=bf), rnd(Fl, s=0.01), rnd(Fl, D, s=Fl ** -0.5, dt=bf))
        b_out = rnd(D, s=0.01)
        calls = {"attn_block_tp_fwd": lambda: ab.attn_block_tp_finish(
                     x, ab.attn_block_tp_fwd(x, scale, bias, *attn, Hl, seg), b_out),
                 "attn_block_tp_fwd_chain": lambda: ab.attn_block_tp_finish(
                     x, ab.attn_block_tp_fwd_chain(x, scale, bias, *attn, Hl, seg), b_out),
                 "mlp_block_tp_fwd": lambda: mb.mlp_block_tp_finish(
                     x, mb.mlp_block_tp_fwd(x, scale, bias, *mlp), b_out),
                 "attn_block_tp_bwd": lambda: ab.attn_block_tp_bwd_finish(
                     x, scale, bias, g, ab.attn_block_tp_bwd(x, scale, bias, *attn, g, Hl, seg)[0]),
                 "mlp_block_tp_bwd": lambda: mb.mlp_block_tp_bwd_finish(
                     x, scale, bias, g, mb.mlp_block_tp_bwd(x, scale, bias, *mlp, g)[0])}
        for name, fn in calls.items():
            rows = _by_launch(fn)
            dev_sum = sum(r_[1] for r_ in rows) if rows else None
            ev = cuda_ms(fn, 50)
            rec = {"launches": rows, "device_sum_us": dev_sum, "event_ms": ev,
                   "host_us": host_us(fn),
                   "paced": None if dev_sum is None else
                   ("host" if ev * 1e3 > 1.5 * dev_sum else "device")}
            print(f"tp breakdown {name} {tag}: event {ev:.4f} ms, device sum {dev_sum} us, host "
                  f"{rec['host_us']:.1f} us a call, paced {rec['paced']}, launches "
                  f"{sum(r_[2] for r_ in rows or [])}; "
                  + ", ".join(f"{n.split('(')[0][-40:]} {us:.2f} x{k}" for n, us, k in rows or []),
                  flush=True)
            out["breakdown"][f"{name}_{tag}"] = rec
        torch.cuda.empty_cache()

    for label, dims in TP_GROUPS:
        ops = [(rnd(K, M, dt=bf), rnd(K, N, dt=bf)) for M, N, K in dims]
        shapes = [(gemm.KIND_TN_SPLIT, M, N, K) for M, N, K in dims]
        plan = gemm.gemm_bwd_group_plan(ops)[0]
        old = gemm.split_plan(shapes, sms)
        got = gemm.gemm_bwd_group(ops)
        again = gemm.gemm_bwd_group(ops)
        torch.cuda.synchronize()
        errs = [rel_err(o, p_) for o, p_ in zip(got, gemm.gemm_bwd_group_plain(ops))]
        twice = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        check(max(r_ for r_, _ in errs) <= TOL_FWD and twice,
              f"{label}: the group under its plan ({plan.schedule}) within TOL_FWD of its plain "
              "version and twice bit-equal")
        cases = {"plan": {}, "split 1": {"bn": old.bn, "splits": 1},
                 "split 2": {"bn": old.bn, "splits": 2},
                 "stream_k": {"bn": plan.bn if plan.schedule == "stream_k" else 0,
                              "schedule": "stream_k"}}
        times = {}
        for c, kw in cases.items():
            rows = _by_launch(lambda: gemm.gemm_bwd_group(ops, **kw))
            times[c] = sum(r_[1] for r_ in rows) / 1e3 if rows else "not measured"
        old_key = f"split {old.splits}"
        no_slower = (None if plan.schedule != "stream_k"
                     or any(isinstance(times[k], str) for k in ("plan", old_key))
                     else times["plan"] <= times[old_key])
        out["groups"][label] = {"plan": str(plan), "old_plan": str(old),
                                "max_rel_err": max(r_ for r_, _ in errs), "twice_bit_equal": twice,
                                "device_ms": times, "stream_k_no_slower_than_old": no_slower}
        print(f"tp group {label}: plan {plan.schedule} bn {plan.bn}, old {old.bn}x{old.splits}; "
              f"device ms " + ", ".join(f"{c} {t if isinstance(t, str) else round(t, 5)}"
                                        for c, t in times.items())
              + f"; max-rel {max(r_ for r_, _ in errs):.2e}, twice bit-equal {twice}, stream-K no "
              f"slower than the split schedule's plan {no_slower}", flush=True)
        del ops, got, again
        torch.cuda.empty_cache()
    return out


def tp_rules_at_leg_shapes(ones) -> dict:
    """K2 TP's bf16 forward path rule as the C source computes it against
    its Python mirror at every rank shape a TP leg's split blocks took
    (phase 5l's one-process tallies): the same form at each."""
    import torch

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab

    out = {}
    for cfg_name, one in ones.items():
        for B, N, D, Dl, Hl, Fl, seg, dt in one["shapes"]:
            if dt != "torch.bfloat16":
                continue
            got = ab.tp_fwd_path_cuda(B, N, D, Dl, Hl, seg)
            want = ab.tp_fwd_path(N, D, Dl, Hl, seg, torch.bfloat16)
            key = f"{cfg_name} B={B} N={N} D={D} Hl={Hl} F_r={Fl} seg={seg}"
            out[key] = {"c": got, "mirror": want}
            print(f"tp path rule {key}: K2 TP C {got}, mirror {want}", flush=True)
            check(got == want, f"{key}: the C path rule equals its Python mirror")
    return out


def tp_phase(dev, zero_counters, launch_counts, timings, cuda_ms, rel_err, bound_ms, smi):
    """Phase 5l, tensor parallelism (``parallel/sharding.py``).

    :func:`tp_kernels`; then each TP_LEGS config as shipped in one process
    (tensor_parallel = 1), counters zeroed just before its steps and read
    just after, its blocks' calls tallied (:func:`_block_tally`); then
    TP_RANKS processes (:func:`tp_worker`, gloo on one card, NCCL where the
    host has TP_RANKS cards) take the same legs at tensor_parallel =
    TP_RANKS from the same seed, batches and draws. Held: step 1's
    gradients, the losses, the parameters and an I-JEPA leg's EMA target
    against one process within TOL_TP and TOL_TP_TARGET; the replicated
    parameters' digests (the whole blocks' and the target's included)
    equal across the ranks after every step; each rank's launches exact
    against the prediction from one process's tally: a split block's
    forward and backward passes launch the TP forms (and their finishes), a
    whole block's K2 and kernel 4, K1 and kernel 8, every other kernel 0,
    and the tally's passes equal one process's block launches; the ranks'
    TP_CKPT saves restored by one process bit-equal to the gathered
    parameters and target, and each rank's restored step bit-equal to its
    uninterrupted one."""
    import torch

    from sky_embeddings_tpu_torch.parallel.smoke import param_gaps

    check(not torch.distributed.is_initialized(), "no process group before phase 5l")
    out = {"legs": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= TP_RANKS else "gloo"
    spec = {"backend": backend, "device": DEVICE, "seed": 24, "out": work,
            "legs": [list(leg) for leg in TP_LEGS], "ckpt": list(TP_CKPT)}
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    # the ranks start first and run while this process checks the kernels
    # and takes the one-process references (their walls are gloo's: the
    # card is mostly idle under them)
    t0 = time.perf_counter()
    env_base = dict(os.environ, SKY_DISTRIBUTED="1",
                    SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                    SKY_NUM_PROCESSES=str(TP_RANKS))
    procs = [subprocess.Popen([sys.executable, *TP_WORKER, spec_path],
                              env=dict(env_base, SKY_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(TP_RANKS)]
    try:
        out["kernels"], time_forms = tp_kernels(dev, timings, cuda_ms, rel_err, bound_ms)
        ones = {}
        for cfg_name, steps in TP_LEGS:
            tr = _tp_trainer(cfg_name, dev, 1)
            glob = _tp_data(cfg_name, steps, 24)
            tally, handles, shapes = _block_tally(tr, TP_RANKS)
            leg, grads1 = _tp_steps(tr, glob, zero_counters, launch_counts)
            for h_ in handles:
                h_.remove()
            leg["tally"], leg["shapes"] = tally, sorted(shapes)
            leg["whole"] = {k: {n: v.detach().clone() for n, v in sd.items()}
                            for k, sd in _tp_whole(tr).items()}
            leg["grads1"], leg["lr_sum"] = grads1, 2 * _lr_sum(tr, steps)
            ones[cfg_name] = leg
            del tr
            torch.cuda.empty_cache()
        logs = [p_.communicate(timeout=600)[0] for p_ in procs]
        out["seconds_ranks"] = time.perf_counter() - t0
        time_forms()
        out["stream_k"] = tp_stream_k(dev, cuda_ms, rel_err)
        for r, (p_, log) in enumerate(zip(procs, logs)):
            print(f"tp rank {r} exit {p_.returncode}; its output's end:\n{log[-1500:]}", flush=True)
            check(p_.returncode == 0, f"tp rank {r} ran to its end")
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t_ = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
        label = ("gloo on one card: every all-reduce staged through the host, so these walls "
                 "time gloo, not tensor parallelism; NCCL across cards not measured"
                 if backend == "gloo" else f"NCCL across {TP_RANKS} cards")
        for cfg_name, steps in TP_LEGS:
            one = ones[cfg_name]
            legs = [r["legs"][cfg_name] for r in ranks]
            gaps1 = {n: float((t_[cfg_name]["grads1"][n].to(dev).float() - g_.float()).norm()
                              / (g_.float().norm() + 1e-30)) for n, g_ in one["grads1"].items()}
            worst = max(gaps1, key=gaps1.get)
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(legs[0]["losses"], one["losses"]))
            rest, keys = param_gaps({k: v.to(dev) for k, v in t_[cfg_name]["params"].items()},
                                    one["whole"]["params"])
            target_gap = None
            if "target" in one["whole"]:
                target_gap = param_gaps({k: v.to(dev) for k, v in t_[cfg_name]["target"].items()},
                                        one["whole"]["target"])
            # the prediction: each block pass of one process becomes a TP
            # form's where the block splits and K2, kernel 4, K1, kernel 8's
            # where it stays whole; nothing else launches
            o_l, ty = one["launches"], one["tally"]
            passes = {"fwd": (o_l["fused_attn_block"] + o_l["attn_block_fwd_stash"],
                              o_l["fused_mlp_block"] + o_l["mlp_block_fwd_stash"]),
                      "bwd": (o_l["attn_block_bwd"] + o_l["attn_block_bwd_stash"],
                              o_l["mlp_block_bwd"] + o_l["mlp_block_bwd_stash"]
                              + o_l["mlp_block_bwd_stream"])}
            for d_, (attn_n, mlp_n) in passes.items():
                check(attn_n == mlp_n == ty[f"split_{d_}"] + ty[f"whole_{d_}"],
                      f"{cfg_name}: one process's block {d_} launches ({attn_n}, {mlp_n}) are the "
                      f"tally's {ty}")
            dtype_f32 = o_l["fused_attn_block_f32"] + o_l["attn_block_fwd_stash_f32"] > 0
            per = {"attn_block_tp_fwd": ty["split_fwd"], "mlp_block_tp_fwd": ty["split_fwd"],
                   "attn_block_tp_bwd": ty["split_bwd"], "mlp_block_tp_bwd": ty["split_bwd"],
                   "fused_attn_block": ty["whole_fwd"], "fused_mlp_block": ty["whole_fwd"],
                   "attn_block_bwd": ty["whole_bwd"], "mlp_block_bwd": ty["whole_bwd"]}
            want = {k: 0 for k in legs[0]["launches"]}
            for k, n_ in per.items():
                want[k] = n_
                want[k + "_f32"] = n_ if dtype_f32 else 0
                if "_tp_" in k:
                    want[k + "_finish"] = n_
            want.update(attn_block_tp_fwd_seg=ty["split_fwd_seg"],
                        attn_block_tp_bwd_seg=ty["split_bwd_seg"],
                        fused_attn_block_seg=ty["whole_fwd_seg"],
                        attn_block_bwd_seg=ty["whole_bwd_seg"],
                        attn_block_tp_fwd_fused=ty["split_fwd_fused_attn"])
            for r, leg in enumerate(legs):
                check(leg["losses"] == legs[0]["losses"], f"{cfg_name}: the ranks' losses equal")
                check(leg["replicated_digests"] == legs[0]["replicated_digests"],
                      f"{cfg_name}: the replicated parameters bit-equal across the ranks after "
                      "every step")
                check(leg["launches"] == want,
                      f"{cfg_name}: rank {r} launches {leg['launches']} == predicted {want}")
            tol_g, tol_l, tol_p = TOL_TP[cfg_name]
            rec = {"grad_gap": gaps1[worst], "grad_gap_leaf": worst, "loss_gap": loss_gap,
                   "param_gap": rest, "key_bias_gap": keys, "lr_sum": one["lr_sum"],
                   "one_process_losses": one["losses"], "launches_per_rank": legs[0]["launches"],
                   "one_process_launches": o_l, "block_tally": ty,
                   "wall_ms_per_step": [leg["wall_ms_per_step"] for leg in legs],
                   "one_process_wall_ms_per_step": one["wall_ms_per_step"],
                   "collective_ms_per_step": [leg["collective_ms_per_step"] for leg in legs],
                   "peak_gb_per_rank": [leg["peak_gb"] for leg in legs], "backend": backend}
            if target_gap is not None:
                rec["target_gap"], rec["target_key_bias_gap"] = target_gap
            share = [sum(c) / sum(w) for c, w in zip(rec["collective_ms_per_step"],
                                                      rec["wall_ms_per_step"])]
            rec["collective_share"] = share
            if "restored_bit_equal" in legs[0]:
                rec["restored_bit_equal"] = [leg["restored_bit_equal"] for leg in legs]
                rec["device_ms_per_step"] = [leg["device_ms_per_step"] for leg in legs]
            out["legs"][cfg_name] = rec
            target_msg = ("" if target_gap is None else
                          f", EMA target {target_gap[0]:.3e} (bar {TOL_TP_TARGET[cfg_name]}), its "
                          f"key biases {target_gap[1]:.3e}")
            print(f"tp {TP_RANKS} ranks ({cfg_name} as shipped, {steps} steps, {backend}): step 1's "
                  f"gradients {gaps1[worst]:.3e} at {worst} (bar {tol_g}), losses {loss_gap:.3e} "
                  f"(bar {tol_l}), parameters {rest:.3e} (bar {tol_p}), key biases {keys:.3e} (bar "
                  f"{one['lr_sum']:.3e}){target_msg}; block passes (split, whole) fwd "
                  f"({ty['split_fwd']}, {ty['whole_fwd']}) bwd ({ty['split_bwd']}, "
                  f"{ty['whole_bwd']}); launches per rank "
                  f"{ {k: v for k, v in legs[0]['launches'].items() if v} }; step ms per rank "
                  f"{rec['wall_ms_per_step']} (one process {one['wall_ms_per_step']}); collectives "
                  f"ms {rec['collective_ms_per_step']}, share {[round(x, 4) for x in share]}; "
                  f"device ms {rec.get('device_ms_per_step')}; peak GB per rank "
                  f"{rec['peak_gb_per_rank']}; {label}; {smi}", flush=True)
            for bar, got in ((tol_g, gaps1[worst]), (tol_l, loss_gap), (tol_p, rest),
                             (TOL_TP_TARGET.get(cfg_name), target_gap and target_gap[0])):
                check(bar is None or got <= bar, f"{cfg_name}: {TP_RANKS} ranks against one process")
            check(keys <= one["lr_sum"] and (target_gap is None or target_gap[1] <= one["lr_sum"]),
                  f"{cfg_name}: key biases within twice the summed lr")
        out["fwd_path_rules"] = tp_rules_at_leg_shapes(ones)
        out["restored"] = {}
        for name in TP_CKPT:
            steps = dict(TP_LEGS)[name]
            check(all(out["legs"][name]["restored_bit_equal"]),
                  f"{name}: each rank's restored step bit-equal to its uninterrupted one")
            back = _tp_trainer(name, dev, 1)
            check(back.restore(os.path.join(work, f"tp_{name}.ckpt.pt")) and back.cur_iter == steps,
                  f"{name}: one process restores the ranks' file")
            same = all(torch.equal(v.cpu(), t_[name][k][n]) for k, sd in _tp_whole(back).items()
                       for n, v in sd.items())
            out["restored"][name] = same
            print(f"tp: the ranks' {name} save ({', '.join(_tp_whole(back))}) restored by one "
                  f"process bit-equal {same}", flush=True)
            check(same, f"{name}: the TP save restores into one process bit-equal")
            del back
        out["one_process_restore_bit_equal"] = all(out["restored"].values())
        out["launches"] = {f"rank{r['rank']}_{c}": leg["launches"] for r in ranks
                           for c, leg in r["legs"].items()}
        out["backend"], out["label"] = backend, label
    finally:
        for p_ in procs:  # a failed check leaves no rank behind
            if p_.poll() is None:
                p_.kill()
                p_.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def _queue_trainer(dev):
    """Phase 5k's trainer: FIG[0] as shipped (bf16), seed 0."""
    import torch

    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    cfg = load_config(FIG[0], os.path.join(ROOT, "configs"))
    return MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device=dev)


def _queue_batch(tr, step):
    """Phase 5k's global batch of training step ``step``, made from the
    step alone, and this rank's rows of it."""
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.parallel import distributed

    m = tr.model
    x = make_cutouts(tr.batch_size, channels=m.in_chans, img_size=m.img_size,
                     seed=QUEUE_SEED + step)["cutouts"]
    rows = distributed.batch_rows(tr.batch_size // distributed.process_count())
    return {"cutouts": x if rows is None else x[rows[0]]}


def queue_worker(spec_path: str) -> int:
    """One rank of one chained run of phase 5k's job, as the job script of
    ``cluster/queue_gpu`` starts it: prints the ``SKY_*`` variables it was
    given, starts the process group through them
    (``parallel/distributed.initialize_from_env``), resumes from the run's
    checkpoint when there is one, trains ``steps`` more steps of FIG[0] on
    batches made from the step index, saves the checkpoint (every rank
    calls ``save``, rank 0 writes) and writes its losses as JSON beside
    it."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, ROOT)
    import torch

    from sky_embeddings_tpu_torch.parallel import distributed

    secs, t0 = {"imports": time.perf_counter() - T_START}, time.perf_counter()
    env = {k: os.environ.get(k) for k in (distributed.ENV_FLAG, distributed.ENV_COORD,
                                          distributed.ENV_NPROC, distributed.ENV_PID)}
    print("queue worker: " + " ".join(f"{k}={v}" for k, v in env.items()), flush=True)
    check(distributed.initialize_from_env(device=spec["device"]),
          "the SKY_* contract starts the process group")
    rank, world = distributed.process_index(), distributed.process_count()
    dev = distributed.rank_device(spec["device"])

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name], t0 = time.perf_counter() - t0, time.perf_counter()

    lap("process_group")
    tr = _queue_trainer(dev)
    lap("trainer")
    restored = tr.restore(spec["ckpt"])
    start = tr.cur_iter
    lap("restore")
    losses = [float(tr.train_batch(_queue_batch(tr, start + i))) for i in range(spec["steps"])]
    lap("steps")
    tr.save(spec["ckpt"])
    torch.distributed.barrier()
    lap("save")
    res = {"env": env, "rank": rank, "world": world, "backend": torch.distributed.get_backend(),
           "device": str(dev), "restored": restored, "start": start, "end": tr.cur_iter,
           "losses": losses, "seconds": secs}
    with open(os.path.join(spec["out"], f"run{start}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"queue worker rank {rank}/{world}: steps {start}..{tr.cur_iter}, losses {losses}",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


def reconstruct_check(model, tag, B, dev, zero_counters, launch_counts):
    """``mim_reconstruct`` of one batch of B synthetic cutouts (whole-band
    NaNs) through the kernels, counters zeroed just before and read just
    after: the launches exact (K2 and K1 once a layer; MAE's packed encoder
    through the masked K2), the masked input NaN exactly where the drawn
    mask (drawn again from the same seed) or the input is, the prediction
    equal to the input outside the mask and finite inside; then the
    kernel path against ``Encoder.plain`` on the drawn mask (TOL_FWD over
    the masked pixels) and both timed."""
    import numpy as np
    import torch

    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.eval.eval_fns import mim_reconstruct
    from sky_embeddings_tpu_torch.ops.masking import (mae_random_masking, simmim_batch_mask,
                                                      upsample_patch_mask)

    C, S, p, g = model.in_chans, model.img_size, model.patch_size, model.grid_size
    depth = model.encoder.depth
    batch = {"cutouts": make_cutouts(B, channels=C, img_size=S, seed=51)["cutouts"]}
    check(bool(np.isnan(batch["cutouts"]).any()), f"reconstruction {tag}: NaN bands in the input")
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred, masked, orig = mim_reconstruct(model, batch, torch.Generator(device=dev).manual_seed(17),
                                         max_mask_ratio=0.9)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = launch_counts()
    gen = torch.Generator(device=dev).manual_seed(17)
    if model.simmim:
        draw = simmim_batch_mask(gen, B, C, S, p, 0.9)
        pix = draw
        want = {"fused_attn_block": depth, "fused_mlp_block": depth}
    else:
        noise = torch.rand(B, g * g, generator=gen, device=dev)
        draw = mae_random_masking(torch.zeros(B, g * g, 1, device=dev), model.mask_ratio,
                                  noise).mask
        pix = upsample_patch_mask(draw.reshape(B, g, g), p)[:, None].expand(B, C, S, S)
        dec = model.decoder.depth
        want = {"fused_attn_block": depth + dec, "fused_attn_block_seg": depth,
                "fused_mlp_block": depth + dec}
    pix = pix.float().cpu().numpy().transpose(0, 2, 3, 1) == 1
    nan_exact = bool(np.array_equal(np.isnan(masked), pix | np.isnan(orig)))
    kept_equal = bool(np.array_equal(pred[~pix], orig[~pix], equal_nan=True))
    finite = bool(np.isfinite(pred[pix]).all())
    for k_, n_ in launches.items():
        check(n_ == want.get(k_, 0), f"reconstruction {tag}: {k_} launches {n_} == {want.get(k_, 0)}")
    check(nan_exact, f"reconstruction {tag}: the masked input is NaN exactly at the mask and the "
          "input's NaNs")
    check(kept_equal and finite, f"reconstruction {tag}: the input outside the mask, finite inside")
    kernel = mim_reconstruct(model, batch, mask=draw)[0]
    model.plain = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mim_reconstruct(model, batch, mask=draw)[0]
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    model.plain = False
    diff = np.abs(kernel[pix] - plain[pix])
    rel = float(diff.max()) / (float(np.abs(plain[pix]).max()) + 1e-12)
    print(f"reconstruction {tag} (B={B}, depth {depth}): launches {want}, masked {pix.mean():.3f} "
          f"of the pixels, NaN exactly at mask and input NaNs {nan_exact}, input kept outside "
          f"{kept_equal}; kernel vs plain max rel {rel:.3e} (bar {TOL_FWD}); {t_kernel * 1e3:.1f} ms "
          f"kernel, {t_plain * 1e3:.1f} ms plain, host to host", flush=True)
    check(rel <= TOL_FWD, f"reconstruction {tag}: kernel path within TOL_FWD of the plain path")
    return {"batch": B, "launches": launches, "masked_share": float(pix.mean()),
            "nan_exact": nan_exact, "kept_equal": kept_equal, "max_rel_vs_plain": rel,
            "max_abs_vs_plain": float(diff.max()), "kernel_s": t_kernel, "plain_s": t_plain}


def data_stages(smi):
    """The offline data stages on the card host (no h5py there), each
    timed: ``cross_match_mask`` of CATALOG[0] sources on a jittered 5"
    grid (3" apart at least) against CATALOG[1] references, half planted
    within 0.5" of a source and half at cell centres (2" from any source),
    recovering the planted sources exactly; ``isolated_mask`` and
    ``duplicate_mask`` on the grid with CATALOG[2] companions 0.4" from
    sources; the split and probe indices; ``cutouts_for_patch`` and
    ``measure_resolution`` on a PATCH-side TAN-WCS patch of four of the five
    bands written with ``write_image`` (the fifth band NaN, every cutout
    equal to its window of the tile); and every h5 stage refused with an
    ``ImportError`` naming h5py while it cannot be imported."""
    import importlib.util

    import numpy as np

    from sky_embeddings_tpu_torch.data.fits_io import TanWCS, write_image
    from sky_embeddings_tpu_torch.data.fits_loader import find_band_files
    from sky_embeddings_tpu_torch.data_processing import (combine, create_h5, cross_match, dedup,
                                                          probe_sets, resolution, split)

    secs, out = {}, {}
    n_src, n_ref, n_pair = CATALOG
    rng = np.random.default_rng(61)
    side = int(np.ceil(np.sqrt(n_src)))
    grid = 5.0 / 3600
    i = np.arange(n_src)
    dec = (i // side) * grid + rng.uniform(-1, 1, n_src) / 3600
    ra = 150.0 + (i % side) * grid / np.cos(np.deg2rad(dec)) + rng.uniform(-1, 1, n_src) / 3600

    def offset(ra_, dec_, arcsec):
        ang = rng.uniform(0, 2 * np.pi, len(ra_))
        return (ra_ + arcsec * np.cos(ang) / 3600 / np.cos(np.deg2rad(dec_)),
                dec_ + arcsec * np.sin(ang) / 3600)

    planted = rng.choice(n_src, n_ref // 2, replace=False)
    p_ra, p_dec = offset(ra[planted], dec[planted], rng.uniform(0, 0.5, n_ref // 2))
    cells = rng.choice(side * side, n_ref - n_ref // 2, replace=False)
    c_dec = (cells // side + 0.5) * grid
    c_ra = 150.0 + (cells % side + 0.5) * grid / np.cos(np.deg2rad(c_dec))
    ref_ra, ref_dec = np.concatenate([p_ra, c_ra]), np.concatenate([p_dec, c_dec])
    t0 = time.perf_counter()
    got = cross_match.cross_match_mask(ra, dec, ref_ra, ref_dec, 1.0)
    secs["cross_match_mask"] = time.perf_counter() - t0
    out["cross_match_exact"] = bool(np.array_equal(got, np.isin(i, planted)))
    check(out["cross_match_exact"], "cross_match_mask recovers the planted sources exactly")

    base = n_src - n_pair
    twins = rng.choice(base, n_pair, replace=False)
    t_ra, t_dec = offset(ra[twins], dec[twins], np.full(n_pair, 0.4))
    pr, pd = np.concatenate([ra[:base], t_ra]), np.concatenate([dec[:base], t_dec])
    t0 = time.perf_counter()
    iso = cross_match.isolated_mask(pr, pd, 1.0)
    secs["isolated_mask"] = time.perf_counter() - t0
    want = np.ones(n_src, bool)
    want[twins] = want[base:] = False
    out["isolated_exact"] = bool(np.array_equal(iso, want))
    t0 = time.perf_counter()
    keep = dedup.duplicate_mask(pr, pd, 1.0)
    secs["duplicate_mask"] = time.perf_counter() - t0
    out["duplicate_exact"] = bool(np.array_equal(keep, np.arange(n_src) < base))
    check(out["isolated_exact"], "isolated_mask drops both members of every planted pair alone")
    check(out["duplicate_exact"], "duplicate_mask drops the second member of every planted pair alone")

    t0 = time.perf_counter()
    parts = split.split_indices(n_src)
    classes = rng.integers(0, 3, n_src)
    probe = probe_sets.probe_indices(classes, 2000, seed=0)
    secs["split_and_probe_indices"] = time.perf_counter() - t0
    whole = np.sort(np.concatenate(parts))
    out["split_sizes"] = [len(q) for q in parts]
    n8, n1 = int(0.8 * n_src), int(0.1 * n_src)
    check(out["split_sizes"] == [n8, n1, n_src - n8 - n1] and np.array_equal(whole, i)
          and all(np.array_equal(a, b) for a, b in zip(parts, split.split_indices(n_src))),
          "split_indices: 80/10/10, disjoint, covering, the same from the same seed")
    check(len(probe) == 6000 and len(np.unique(probe)) == 6000
          and np.bincount(classes[probe]).tolist() == [2000] * 3
          and np.array_equal(probe, probe_sets.probe_indices(classes, 2000, seed=0)),
          "probe_indices: 2000 distinct rows a class, the same from the same seed")

    work = tempfile.mkdtemp(prefix="chip_smoke_fits_")
    try:
        px, scale = PATCH[0], 0.168 / 3600
        wcs = TanWCS(crpix=(px / 2 + 0.5, px / 2 + 0.5), crval=(150.0, 2.0),
                     cd=[[-scale, 0], [0, scale]])
        tiles = {}
        for b in PATCH[1]:
            tiles[b] = rng.normal(size=(px, px)).astype(np.float32)
            write_image(os.path.join(work, f"calexp-HSC-{b}-9813-3,4.fits"), tiles[b],
                        wcs.to_cards())
        n_in, img = 300, 64
        xs = np.concatenate([rng.integers(img, px - img, n_in), rng.integers(0, 20, 20)])
        ys = np.concatenate([rng.integers(img, px - img, n_in), rng.integers(img, px - img, 20)])
        c_ra, c_dec = wcs.pixel_to_world(xs.astype(np.float64), ys.astype(np.float64))
        catalog = {"ra": np.asarray(c_ra), "dec": np.asarray(c_dec),
                   "zspec": rng.uniform(0.1, 1.5, n_in + 20).astype(np.float32)}
        t0 = time.perf_counter()
        bands = ("G", "R", "I", "Z", "Y")
        files = find_band_files([work], bands, 2, verbose=False)
        cut = create_h5.cutouts_for_patch(files[0], catalog, img)
        secs["cutouts_for_patch"] = time.perf_counter() - t0
        h = img // 2
        ok = len(files) == 1 and len(cut["cutouts"]) == n_in and np.isnan(cut["cutouts"][:, 4]).all()
        for j in range(n_in):
            for c, b in enumerate(PATCH[1]):
                ok = ok and np.array_equal(cut["cutouts"][j, c],
                                           tiles[b][ys[j] - h:ys[j] + h, xs[j] - h:xs[j] + h])
        out["cutouts"] = int(len(cut["cutouts"]))
        check(bool(ok), f"cutouts_for_patch: the {n_in} sources inside, each its window, Y NaN")
        t0 = time.perf_counter()
        res = resolution.measure_resolution([work])
        secs["measure_resolution"] = time.perf_counter() - t0
        out["resolution"] = res
        check(res["n"] == len(PATCH[1]) and abs(res["mean_arcsec"] - 0.168) < 1e-6,
              f"measure_resolution: {res}")

        out["h5py_installed"] = importlib.util.find_spec("h5py") is not None
        saved = sys.modules.get("h5py")
        sys.modules["h5py"] = None  # unimportable, as on a host without it
        try:
            stages = {
                "create_h5_dataset": lambda: create_h5.create_h5_dataset(
                    [work], catalog, os.path.join(work, "o.h5"), bands=bands, verbose=False),
                "combine_h5_files": lambda: combine.combine_h5_files(["a.h5"], "b.h5"),
                "deduplicate_h5": lambda: dedup.deduplicate_h5("a.h5", "b.h5"),
                "split_dataset": lambda: split.split_dataset("a.h5"),
                "make_probe_set": lambda: probe_sets.make_probe_set("a.h5", "b.h5"),
                "make_regression_probe_set": lambda: probe_sets.make_regression_probe_set(
                    "a.h5", "b.h5"),
                "h5_to_csv": lambda: cross_match.h5_to_csv("a.h5", "b.csv"),
            }
            refused = {}
            for name, stage in stages.items():
                try:
                    stage()
                    refused[name] = "ran"
                except ImportError as e:
                    refused[name] = str(e)
        finally:
            if saved is None:
                del sys.modules["h5py"]
            else:
                sys.modules["h5py"] = saved
        out["h5_stages"] = refused
        check(all("h5py" in v and v != "ran" for v in refused.values()),
              f"every h5 stage raises an ImportError naming h5py: {refused}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = secs
    print(f"data stages ({n_src} sources, {n_ref} references, {n_pair} pairs; a {PATCH[0]}^2 "
          f"patch of {len(PATCH[1])} bands): planted matches exact {out['cross_match_exact']}, "
          f"isolated {out['isolated_exact']}, duplicates {out['duplicate_exact']}, h5py "
          f"installed {out['h5py_installed']}; seconds {secs}; {smi}", flush=True)
    return out


def figures_phase(dev, zero_counters, launch_counts, smi):
    """Phase 5k: the figures, the per-GPU launcher and the data stages.

    First a ``JobQueue`` on the local backend with the accelerator of the
    card count starts QUEUE[1] chained runs of :func:`queue_worker` through
    the job script's ``SKY_*`` variables (NCCL), the second resuming from
    the first's checkpoint; each run starts its own processes, so the
    checks in this process run while they do. Reconstruction
    (``eval/eval_fns.mim_reconstruct``) on FIG[0] (SimMIM ViT-B, bf16,
    seeded weights, B=FIG[1]) and on the MAE path's model (bench_mae's
    base, B=FIG[2]) by :func:`reconstruct_check`. ``train_network`` for
    FIG_TRAIN[0] steps validating every FIG_TRAIN[1], with ``fig_dir`` and
    without: losses, parameters and the mask generator bit-equal, the run
    with ``fig_dir`` launching one reconstruction's K2 and K1 more; without
    matplotlib each figure warns once a call and writes no file (with it,
    the three PNGs). :func:`data_stages`. Then one in-process run of the
    queued steps with no process group, and the chain's final parameters
    and every loss bit-equal to it. The times of the parts overlap the
    queued runs'."""
    import shlex
    import warnings

    import torch

    from sky_embeddings_tpu_torch.cluster.queue_gpu import ACCELERATORS, JobQueue, JobSpec
    from sky_embeddings_tpu_torch.configuration import Config, load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.models.mim import build_mim_model
    from sky_embeddings_tpu_torch.train.pretrain import train_network
    from sky_embeddings_tpu_torch.utils import plotting
    from sky_embeddings_tpu_torch.utils.checkpoint import load_checkpoint

    out = {"launches": {}, "seconds": {}}
    t_phase = time.perf_counter()
    # ---- the launcher: its chained runs start now ------------------------------
    n_gpu = torch.cuda.device_count()
    acc = f"h100-{n_gpu}"
    check(acc in ACCELERATORS, f"{acc} is in the accelerator table")
    qwork = tempfile.mkdtemp(prefix="chip_smoke_queue_")
    queue = JobQueue(os.path.join(qwork, "scripts"), backend="local")
    codes = None
    try:
        spec = {"device": DEVICE, "ckpt": os.path.join(qwork, "queue.ckpt.pt"), "steps": QUEUE[0],
                "out": qwork}
        spec_path = os.path.join(qwork, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        command = " ".join(shlex.quote(a_) for a_ in [sys.executable, *QUEUE_WORKER, spec_path])
        job = JobSpec(name="chip_smoke_queue", command=f"cd {shlex.quote(ROOT)} && {command}",
                      accelerator=acc, num_runs=QUEUE[1])
        torch.cuda.synchronize()
        t_queue = time.perf_counter()
        queue.submit(job)

        # ---- reconstruction, SimMIM and MAE ---------------------------------------
        cfg = load_config(FIG[0], os.path.join(ROOT, "configs"))
        d_m = {sec: dict(cfg[sec].items()) for sec in cfg.sections()}
        for sec, over in MAE_OVERRIDES.items():
            d_m[sec].update(over)
        for tag, cfg_, B in (("simmim", cfg, FIG[1]),
                             ("mae", Config.from_dict(d_m, name=MAE[0]), FIG[2])):
            t0 = time.perf_counter()
            model = build_mim_model(cfg_, dtype=torch.bfloat16, device=dev,
                                    generator=torch.Generator().manual_seed(0))
            out[f"reconstruct_{tag}"] = reconstruct_check(model, tag, B, dev, zero_counters,
                                                          launch_counts)
            out["launches"][f"reconstruct_{tag}"] = out[f"reconstruct_{tag}"]["launches"]
            out["seconds"][f"reconstruct_{tag}"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()

        # ---- the figures inside training ------------------------------------------
        t0 = time.perf_counter()
        steps, every = FIG_TRAIN
        x = make_cutouts((steps + 1) * cfg.training.int("batch_size"),
                         channels=cfg.architecture.int("num_channels"),
                         img_size=cfg.architecture.int("img_size"), seed=53)["cutouts"]
        bs = cfg.training.int("batch_size")
        batches = [{"cutouts": x[k * bs:(k + 1) * bs]} for k in range(steps + 1)]

        class ValBatches:
            def take(self, n_):
                return iter(batches[steps:steps + n_])

        fwork = tempfile.mkdtemp(prefix="chip_smoke_figs_")
        runs = {}
        try:
            fig_dir = os.path.join(fwork, "figures")
            os.makedirs(fig_dir)
            for tag, fd in (("fig_dir", fig_dir), ("none", None)):
                tr = _queue_trainer(dev)
                zero_counters()
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    # no save: the steps end before total_batch_iters and the clock
                    train_network(tr, iter(batches[:steps]), ValBatches(), 10 ** 9, every, 1e9,
                                  os.path.join(fwork, f"{tag}.ckpt.pt"), fig_dir=fd,
                                  max_val_batches=1, log_fn=lambda m_: None)
                torch.cuda.synchronize()
                runs[tag] = {"trainer": tr, "launches": launch_counts(),
                             "warnings": [str(w.message) for w in caught
                                          if str(w.message).startswith("matplotlib unavailable")]}
            pngs = sorted(os.listdir(fig_dir))
        finally:
            shutil.rmtree(fwork, ignore_errors=True)
        a, b = runs["fig_dir"]["trainer"], runs["none"]["trainer"]
        same = (a.losses == b.losses and a.cur_iter == b.cur_iter == steps
                and torch.equal(a.mask_gen.get_state(), b.mask_gen.get_state())
                and all(torch.equal(v, b.model.state_dict()[k])
                        for k, v in a.model.state_dict().items()))
        extra = {k: n - runs["none"]["launches"][k] for k, n in runs["fig_dir"]["launches"].items()}
        depth = a.model.encoder.depth
        last = steps - steps % every
        draws = ("plot_progress", "plot_batch", "plot_batch_tiled")
        if plotting.plt is None:
            want_warn, want_png = [f"matplotlib unavailable; skipping {f}" for f in draws], []
        else:
            want_warn = []
            want_png = sorted(["fig_dir_progress.png", f"fig_dir_{last}iters.png",
                               f"fig_dir_{last}iters_tiled.png"])
        out["train_figures"] = {"steps": steps, "verbose_iters": every, "bit_equal": same,
                                "extra_launches": {k: v for k, v in extra.items() if v},
                                "warnings": runs["fig_dir"]["warnings"], "pngs": pngs,
                                "matplotlib": plotting.plt is not None,
                                "losses": a.losses.get("train_loss")}
        out["launches"]["train_fig_dir"] = runs["fig_dir"]["launches"]
        print(f"train_network with fig_dir ({FIG[0]}, {steps} steps, validating every {every}): "
              f"bit-equal to the run without {same}; extra launches "
              f"{out['train_figures']['extra_launches']}; warnings {runs['fig_dir']['warnings']}; "
              f"PNGs {pngs}", flush=True)
        check(same, "training with fig_dir bit-equal to training without it")
        check(extra == {k: (depth if k in ("fused_attn_block", "fused_mlp_block") else 0)
                        for k in extra},
              f"fig_dir: one reconstruction's K2 and K1 launches more ({depth} each)")
        check(runs["fig_dir"]["warnings"] == want_warn and pngs == want_png
              and runs["none"]["warnings"] == [], "fig_dir: each figure warns once and writes no "
              "file without matplotlib (with it, its PNG)")
        del a, b, runs
        torch.cuda.empty_cache()
        out["seconds"]["train_figures"] = time.perf_counter() - t0

        # ---- the data stages ------------------------------------------------------
        t0 = time.perf_counter()
        out["data_stages"] = data_stages(smi)
        out["seconds"]["data_stages"] = time.perf_counter() - t0

        # ---- the queued runs against one continuous run ---------------------------
        t0 = time.perf_counter()
        ref = _queue_trainer(dev)
        ref_losses = [float(ref.train_batch(_queue_batch(ref, k)))
                      for k in range(QUEUE[0] * QUEUE[1])]
        state = {k: v.cpu() for k, v in ref.model.state_dict().items()}
        del ref
        torch.cuda.empty_cache()
        out["seconds"]["queue_reference"] = time.perf_counter() - t0
        codes = queue.wait(timeout=max(1.0, 300 - (time.perf_counter() - t_queue)))
        t_queue = time.perf_counter() - t_queue
        with open(os.path.join(qwork, "scripts", "stdout", f"{job.name}.out")) as f:
            log = f.read()
        print(f"queue ({acc}, {QUEUE[1]} chained runs of {QUEUE[0]} steps) exit {codes} in "
              f"{t_queue:.1f} s; its log's end:\n{log[-3000:]}", flush=True)
        check(codes == [0], "the queued job chain ran to its end")
        results = []
        for r in range(QUEUE[1]):
            for rank in range(n_gpu):
                with open(os.path.join(qwork, f"run{r * QUEUE[0]}_rank{rank}.json")) as f:
                    results.append(json.load(f))
        saved = load_checkpoint(spec["ckpt"])
    finally:
        if codes is None:  # a check failed first: stop the chain and its ranks
            queue.wait(timeout=0.0)
        shutil.rmtree(qwork, ignore_errors=True)
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    for res in results:
        e = res["env"]
        host, _, port = e["SKY_COORDINATOR_ADDRESS"].partition(":")
        check(e["SKY_DISTRIBUTED"] == "1" and e["SKY_NUM_PROCESSES"] == str(n_gpu)
              and e["SKY_PROCESS_ID"] == str(res["rank"]) and host == "127.0.0.1" and port.isdigit()
              and res["world"] == n_gpu and res["backend"] == want_backend,
              f"queue rank {res['rank']}: its SKY_* values and {want_backend}: {e}")
    firsts = results[::n_gpu]
    check([(r_["restored"], r_["start"], r_["end"]) for r_ in firsts]
          == [(k > 0, k * QUEUE[0], (k + 1) * QUEUE[0]) for k in range(QUEUE[1])],
          "each chained run resumes where the previous one saved")
    chained = [v for r_ in firsts for v in r_["losses"]]
    params = saved["params"]
    same_params = params.keys() == state.keys() and all(
        torch.equal(params[k], v) for k, v in state.items())
    same_losses = chained == ref_losses
    out["queue"] = {"accelerator": acc, "runs": QUEUE[1], "steps_a_run": QUEUE[0],
                    "seconds": t_queue, "exit_codes": codes, "ranks": results,
                    "losses_bit_equal": same_losses, "params_bit_equal": same_params,
                    "losses": chained}
    out["seconds"]["queue"] = t_queue
    print(f"queue: {QUEUE[1]} chained runs against one in-process run of {len(ref_losses)} steps: "
          f"losses bit-equal {same_losses}, parameters bit-equal {same_params}; worker seconds "
          f"by part {[r_['seconds'] for r_ in results]}", flush=True)
    check(same_losses and same_params, "the chained runs bit-equal to one continuous run")
    out["seconds"]["total"] = time.perf_counter() - t_phase
    print(f"phase 5k: {out['seconds']}", flush=True)
    return out


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
        f32_plan,
        gemm,
        gemm_bwd,
        gemm_bwd_plain,
        gemm_dh_stash,
        gemm_dh_stash_plain,
        gemm_dual,
        gemm_dual_plain,
        gemm_encode_us,
        gemm_f32,
        gemm_f32_plain,
        gemm_plain,
        gemm_plan,
        mlp_bwd_groups,
        attn_bwd_groups,
        attn_weight_grads,
        dh_stash_plan,
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
    # dW2 = h_c^T @ g in bf16 with the plan's split; one kernel 8 call's
    # device time by kernel name; and, at the unsliced widths (mim_1's are
    # mim_25_large's: D = 768, F = 3 072), kernel 7's stash dh product, dh =
    # g @ W2^T with the epilogue that reads the stash a (the bf16 fc1
    # pre-activation y @ W1 + b1), beside dh alone in torch.mm, then one
    # kernel 7 call by kernel
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
            a_ = gemm(y_, w1_, b1_, "bias")[0]
            rel = max(rel_err(a__, b__)[0] for a__, b__ in zip(
                gemm_dh_stash(g_, w2_, a_), gemm_dh_stash_plain(g_, w2_, a_)))
            check(rel <= TOL_BWD, f"sm90 stash dh product {label} parity")
            rec["max_rel_err"]["dh_stash"] = rel
            ms, lib_ms = (device_ms(fn, iters) for fn in (
                lambda: gemm_dh_stash(g_, w2_, a_), lambda: torch.mm(g_, w2t)))
            rec["dh_stash"] = {"plan": dh_stash_plan(M, fs_), "ms": ms, "tflops": fl / ms,
                               "torch_mm_ms": lib_ms, "torch_mm_tflops": fl / lib_ms,
                               "ms_over_torch_mm": ms / lib_ms}
            print(f"sm90 bwd dh_stash {label} (M={M}, D={d_}, F={fs_}): {ms:.4f} ms, "
                  f"{fl / ms:.0f} TFLOP/s; torch.mm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)",
                  flush=True)
            rec["kernel7_by_kernel_ms"] = device_by_kernel(
                lambda: mlp_block_bwd_stash(x_, s_, c_, w1_, w2_, a_, gb), iters)
            del a_
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

    # kernel 11 on the same 1M bank at Q = 1, 8, 64 (each timed on the bf16
    # bank: one target, the retrieval path's Q and a wide batch of targets;
    # Q = 8 also on the fp32 bank), then on ragged banks: 1 000 003 rows (not
    # a whole number of 256-row blocks) of width 3072 (central-pool banks) and
    # 37 (the element loads) at Q = 130. Its bound counts the operations of
    # the two products, 4·N·D·Q, at the bf16 tensor-core rate: the least
    # work any design does (kernel 11 runs five or six bf16 products of split
    # operands per fp32 one, PEAK_BF16 / 5 > PEAK_FP32_PRODUCTS, so a bound at
    # an fp32 rate would be one the kernel beats)
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
            q = targets.shape[0]
            b_ms, b_by = bound_ms(*multi_bound(n, d, q, bank.element_size()), PEAK_BF16)
            # torch.mm of the bank with [wt | w] (D, 2Q) reads the same bytes once:
            # a yardstick of the read rate, not library_ms (no PyTorch call computes
            # kernel 11's function); the port never calls it
            yard = torch.cat([(w * targets).t(), w.t()], 1).to(bank.dtype)
            key = q if bank.dtype == torch.bfloat16 else f"{label} Q={q}"
            timings[("weighted_bank_scores_multi", key)] = rec = {
                "max_rel_err": rel, "max_abs_err": abs_err,
                "ms": cuda_ms(lambda: weighted_bank_scores_multi(bank, targets, w), 10),
                "device_ms": device_ms(lambda: weighted_bank_scores_multi(bank, targets, w), 10),
                "plain_ms": cuda_ms(lambda: weighted_bank_scores_multi_plain(bank, targets, w), 3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "read_yardstick_ms": cuda_ms(lambda: torch.mm(bank, yard), 10),
            }
            print(f"kernel 11 {label} {n}x{d} Q={q}: {rec['ms']:.4f} ms (device "
                  f"{rec['device_ms']:.4f}), bound {b_ms:.4f} ({b_by}), read yardstick "
                  f"{rec['read_yardstick_ms']:.4f}", flush=True)

    def multi_queries(q, d):
        targets = torch.randn(q, d, generator=gen, device=dev)
        w = torch.rand(q, d, generator=gen, device=dev) + 0.5
        return targets, w / w.sum(dim=1, keepdim=True)

    mq_targets, mq_w = multi_queries(max(MULTI_Q), D)
    for dt, tol in ((torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_SCORE_BF16)):
        bank = bank_bf16.to(dt)
        for q in MULTI_Q:
            multi_case(bank, mq_targets[:q], mq_w[:q], tol, str(dt).replace("torch.", ""),
                       timed=dt == torch.bfloat16 or q == 8)
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

    # the fp32 forms of K1, K2 and kernels 2, 3 and 8 (the fp32 configs'
    # path) alone, at mim_1's ViT-B at B=64 and at cls_fs_1k's B=256, N=66:
    # every output against the plain version (TF32 off) at TOL_F32_FORMS, on
    # fp32 inputs drawn in fp32 (bf16-rounded ones would hide the 3xTF32
    # split); times by CUDA events and the profiler's device time beside the
    # plain version's, bound at the faster fp32 product rate
    # (PEAK_FP32_PRODUCTS); each launch checked to be an fp32 one. Then the
    # fp32 GEMM (csrc/gemm_f32.cuh) alone at cls_fs_1k's products beside
    # fp32 torch.addmm / torch.mm on the same operands (the yardstick; the
    # port never calls it)
    def f32_block_args(kind_, B, n, d=D, f=F):
        rn = lambda *s_: torch.randn(*s_, generator=gen, device=dev)
        (d_in, d_mid), (e_in, e_out) = ((d, 3 * d), (d, d)) if kind_ == "attn" else ((d, f), (f, d))
        return (rn(B, n, d) * 0.5, 1.0 + 0.1 * rn(d), 0.1 * rn(d), rn(d_in, d_mid) * d_in ** -0.5,
                0.01 * rn(d_mid), rn(e_in, e_out) * e_in ** -0.5, 0.01 * rn(e_out))

    def f32_bounds(B, n):
        M, hd = B * n, D // H
        core, probs = B * H * n * n * hd, B * H * n * n * 4
        w_attn, w_mlp = 4 * D * D * 4, 2 * D * F * 4
        fwd_bytes = 2 * M * D * 4 + w_attn + 6 * D * 4
        return {
            "attn_block_fwd_f32": (8 * M * D * D + 4 * core, fwd_bytes),
            "attn_block_fwd_stash_f32": (8 * M * D * D + 4 * core, fwd_bytes + M * 3 * D * 4 + probs),
            "attn_block_bwd_stash_f32": (16 * M * D * D + 10 * core,
                                         6 * M * D * 4 + probs + 2 * w_attn + 8 * D * 4),
            "mlp_block_fwd_f32": (4 * M * D * F, 2 * M * D * 4 + w_mlp + (3 * D + F) * 4),
            "mlp_block_bwd_f32": (10 * M * D * F, 3 * M * D * 4 + 2 * w_mlp + (5 * D + 2 * F) * 4),
        }

    f32_gap = {}
    for label, B, n in F32_SHAPES:
        xa, xm = f32_block_args("attn", B, n), f32_block_args("mlp", B, n)
        g = torch.randn(B, n, D, generator=gen, device=dev) * 0.1
        _, qkv_p, probs_p = attn_block_fwd_stash_plain(*xa, H)
        cases = (
            ("attn_block_fwd_f32", fused_attn_block, attn_block_plain, (*xa, H), ("out",)),
            ("attn_block_fwd_stash_f32", attn_block_fwd_stash, attn_block_fwd_stash_plain,
             (*xa, H), ("out", "qkv", "probs")),
            ("attn_block_bwd_stash_f32", attn_block_bwd_stash, attn_block_bwd_stash_plain,
             (xa[0], xa[1], xa[2], xa[3], xa[5], qkv_p, probs_p, g, H), grads_attn),
            ("mlp_block_fwd_f32", fused_mlp_block, mlp_block_plain, xm, ("out",)),
            ("mlp_block_bwd_f32", mlp_block_bwd, mlp_block_bwd_plain, (*xm[:6], g), grads_mlp),
        )
        bounds = f32_bounds(B, n)
        for name, kern, plain, args, outs in cases:
            before = kern.f32_launches
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = {o: rel_err(a, b) for o, a, b in zip(outs, got, want)}
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            worst = max(r for r, _ in errs.values())
            f32_gap[f"{name} {label}"] = {o: r for o, (r, _) in errs.items()}
            print(f"parity {name} {label} B={B} N={n}: max-rel per output "
                  + ", ".join(f"{o} {r:.2e}" for o, (r, _) in errs.items())
                  + f" (bar {TOL_F32_FORMS}), finite {finite}, dtypes "
                  + " ".join(str(a.dtype).replace("torch.", "") for a in got), flush=True)
            check(kern.f32_launches == before + 1 and all(a.dtype == torch.float32 for a in got),
                  f"{name} {label}: one fp32 launch, fp32 outputs")
            check(finite and worst <= TOL_F32_FORMS, f"{name} {label} parity")
            iters = 10 if B <= 64 else 4
            b_ms, b_by = bound_ms(*bounds[name], PEAK_FP32_PRODUCTS)
            timings[(name, label)] = {
                "max_rel_err": worst, "max_abs_err": max(a for _, a in errs.values()),
                "ms": cuda_ms(lambda: kern(*args), iters),
                "device_ms": device_ms(lambda: kern(*args), 2),
                "plain_ms": cuda_ms(lambda: plain(*args), max(iters // 2, 2)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            t_ = timings[(name, label)]
            print(f"time {name} {label}: {t_['ms']:.4f} ms (device {t_['device_ms']:.4f}), plain "
                  f"{t_['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
            del got, want
        del xa, xm, g, qkv_p, probs_p, cases
    torch.cuda.empty_cache()

    M32 = F32_SHAPES[-1][1] * F32_SHAPES[-1][2]
    M_SMALL = 32 * 66  # mim_32's and ViT-H's B=32
    gemm_f32_times = {}
    for name, form, epi, sa, sb in (
            ("qkv", "fwd", "bias", (M32, D), (D, 3 * D)),
            ("proj", "fwd", "bias_residual", (M32, D), (D, D)),
            ("fc1", "fwd", "bias_gelu", (M32, D), (D, F)),
            ("fc2", "fwd", "bias_residual", (M32, F), (F, D)),
            ("dctx", "nt", "store", (M32, D), (D, D)),
            ("dh", "nt", "dgelu", (M32, D), (F, D)),
            ("dy_mlp", "nt", "store", (M32, F), (D, F)),
            ("dy_attn", "nt", "store", (M32, 3 * D), (D, 3 * D)),
            ("dW1", "tn", "store", (M32, D), (M32, F)),
            ("dW2", "tn", "store", (M32, F), (M32, D)),
            ("dWqkv", "tn", "store", (M32, D), (M32, 3 * D)),
            ("dWproj", "tn", "store", (M32, D), (M32, D)),
            # M = 2 112, where one 128 x 128 tile left a second wave nearly
            # empty: kernel 4's dctx and dy at mim_32 B=32 (D = 1 024) and
            # kernel 9's dy over one slab at ViT-H B=32 (D = fs = 1 280),
            # summed onto the last slab's
            ("k4_dctx", "nt", "store", (M_SMALL, 1024), (1024, 1024)),
            ("k4_dy", "nt", "store", (M_SMALL, 3 * 1024), (1024, 3 * 1024)),
            ("k9_dy", "nt", "add", (M_SMALL, 1280), (1280, 1280))):
        a = torch.randn(*sa, generator=gen, device=dev)
        b = torch.randn(*sb, generator=gen, device=dev) * (sb[0] if form == "fwd" else sb[1]) ** -0.5
        if form == "tn":
            a, b = a * 0.1, b * 0.1
        Mg, Kg = (a.shape[1], a.shape[0]) if form == "tn" else tuple(a.shape)
        Ng = b.shape[0] if form == "nt" else b.shape[1]
        bias = 0.01 * torch.randn(Ng, generator=gen, device=dev)
        resid = (torch.randn(Mg, Ng, generator=gen, device=dev)
                 if epi in ("bias_residual", "add") else None)
        aux = torch.randn(Mg, Ng, generator=gen, device=dev) if epi == "dgelu" else None
        got, got_aux = gemm_f32(a, b, form, epi, bias, resid, aux)
        want, want_aux = gemm_f32_plain(a, b, form, epi, bias, resid, aux)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, want)
        if got_aux is not None:
            rel = max(rel, rel_err(got_aux, want_aux)[0])
        check(rel <= TOL_GEMM_F32 and bool(torch.isfinite(got).all()), f"fp32 GEMM {name} parity")
        fn = lambda: gemm_f32(a, b, form, epi, bias, resid, aux)
        lib = {"fwd": lambda: torch.addmm(bias, a, b),
               "nt": (lambda: torch.addmm(resid, a, b.t())) if epi == "add" else
               (lambda: torch.mm(a, b.t())), "tn": lambda: torch.mm(a.t(), b)}[form]
        flops = 2 * Mg * Ng * Kg
        plan = f32_plan(Mg, Ng, Kg, form == "tn",
                        torch.cuda.get_device_properties(0).multi_processor_count)
        rec = {"form": form, "epilogue": epi, "M": Mg, "N": Ng, "K": Kg, "bn": plan.bn,
               "splits": plan.splits, "units": plan.units, "max_rel_err": rel,
               "ms": cuda_ms(fn, 5), "device_ms": device_ms(fn, 2), "library_ms": cuda_ms(lib, 5),
               "library_device_ms": device_ms(lib, 2),
               "bound_ms": flops / PEAK_FP32_PRODUCTS * 1e3}
        rec["tflops"] = flops / rec["device_ms"] / 1e9
        rec["library_tflops"] = flops / rec["library_device_ms"] / 1e9
        gemm_f32_times[name] = rec
        print(f"fp32 GEMM {name} ({form}, {epi}, M={Mg} N={Ng} K={Kg}, BN={plan.bn}, "
              f"{plan.splits} slices, {plan.units} units): max-rel {rel:.2e} (bar "
              f"{TOL_GEMM_F32}); {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} "
              f"({rec['tflops']:.1f} TFLOP/s), torch {rec['library_ms']:.4f} / device "
              f"{rec['library_device_ms']:.4f} ({rec['library_tflops']:.1f}), bound "
              f"{rec['bound_ms']:.4f}", flush=True)
        del a, b, resid, aux, got, want, got_aux, want_aux
    torch.cuda.empty_cache()

    # the fp32 forms kernels 4, 6, 7, 9 and the masks added, alone at the
    # fp32 paths' full widths (F32_NEW), the same way: every output against
    # the plain version at TOL_F32_FORMS, one fp32 launch each, timed beside
    # the plain version; kernel 6's out bit-equal to K1's fp32 form
    def f32_new_bounds(B, n, d, h, f, seg):
        M, hd = B * n, d // h
        # the work a masked core needs: each query's own segment of keys
        core = B * h * n * (min(seg, n) if seg else n) * hd
        w_attn, w_mlp = 4 * d * d * 4, 2 * d * f * 4
        fwd_bytes = 2 * M * d * 4 + w_attn + 6 * d * 4
        bwd_attn = (22 * M * d * d + 12 * core, 3 * M * d * 4 + 2 * w_attn + 11 * d * 4)
        return {
            "attn_block_fwd_seg_f32": (8 * M * d * d + 4 * core, fwd_bytes),
            "attn_block_fwd_stash_seg_f32": (8 * M * d * d + 4 * core,
                                             fwd_bytes + M * 3 * d * 4 + B * h * n * n * 4),
            "attn_block_bwd_f32": bwd_attn, "attn_block_bwd_seg_f32": bwd_attn,
            "mlp_block_fwd_stash_f32": (4 * M * d * f,
                                        2 * M * d * 4 + M * f * 4 + w_mlp + (3 * d + f) * 4),
            "mlp_block_bwd_stash_f32": (8 * M * d * f,
                                        3 * M * d * 4 + M * f * 4 + 2 * w_mlp + (5 * d + f) * 4),
            "mlp_block_bwd_stream_f32": (10 * M * d * f,
                                         3 * M * d * 4 + 2 * w_mlp + (5 * d + 2 * f) * 4),
        }

    for label, B, n, d, h, f, seg, names in F32_NEW:
        xa, xm = f32_block_args("attn", B, n, d, f), f32_block_args("mlp", B, n, d, f)
        g = torch.randn(B, n, d, generator=gen, device=dev) * 0.1
        a_p = mlp_block_fwd_stash_plain(*xm)[1] if "mlp_block_bwd_stash_f32" in names else None
        forms = {
            "mlp_block_fwd_stash_f32": (lambda: mlp_block_fwd_stash(*xm),
                                        lambda: mlp_block_fwd_stash_plain(*xm), ("out", "a"),
                                        mlp_block_fwd_stash),
            "mlp_block_bwd_stash_f32": (lambda: mlp_block_bwd_stash(*xm[:4], xm[5], a_p, g),
                                        lambda: mlp_block_bwd_stash_plain(*xm[:4], xm[5], a_p, g),
                                        grads_mlp, mlp_block_bwd_stash),
            "attn_block_bwd_f32": (lambda: attn_block_bwd(*xa[:6], g, h),
                                   lambda: attn_block_bwd_plain(*xa[:6], g, h), grads_attn,
                                   attn_block_bwd),
            "attn_block_bwd_seg_f32": (lambda: attn_block_bwd(*xa[:6], g, h, seg),
                                       lambda: attn_block_bwd_plain(*xa[:6], g, h, seg),
                                       grads_attn, attn_block_bwd),
            "attn_block_fwd_seg_f32": (lambda: fused_attn_block(*xa, h, seg_len=seg),
                                       lambda: attn_block_plain(*xa, h, seg), ("out",),
                                       fused_attn_block),
            "attn_block_fwd_stash_seg_f32": (lambda: attn_block_fwd_stash(*xa, h, seg),
                                             lambda: attn_block_fwd_stash_plain(*xa, h, seg),
                                             ("out", "qkv", "probs"), attn_block_fwd_stash),
            "mlp_block_bwd_stream_f32": (lambda: mlp_block_bwd_stream(*xm[:6], g),
                                         lambda: mlp_block_bwd_stream_plain(*xm[:6], g),
                                         grads_mlp, mlp_block_bwd_stream),
        }
        bounds = f32_new_bounds(B, n, d, h, f, seg)
        for name in names:
            kern, plain, outs, counted = forms[name]
            before = counted.f32_launches
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = {o: rel_err(a, b) for o, a, b in zip(outs, got, want)}
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            worst = max(r for r, _ in errs.values())
            f32_gap[f"{name} {label}"] = {o: r for o, (r, _) in errs.items()}
            print(f"parity {name} {label} B={B} N={n} D={d} H={h} seg_len={seg}: max-rel per output "
                  + ", ".join(f"{o} {r:.2e}" for o, (r, _) in errs.items())
                  + f" (bar {TOL_F32_FORMS}), finite {finite}", flush=True)
            check(counted.f32_launches == before + 1 and all(a.dtype == torch.float32 for a in got),
                  f"{name} {label}: one fp32 launch, fp32 outputs")
            check(finite and worst <= TOL_F32_FORMS, f"{name} {label} parity")
            if name == "mlp_block_fwd_stash_f32":
                check(torch.equal(got[0], fused_mlp_block(*xm)),
                      f"kernel 6's fp32 out bit-equal to K1's fp32 form ({label})")
            b_ms, b_by = bound_ms(*bounds[name], PEAK_FP32_PRODUCTS)
            iters = 10 if B <= 64 else 4
            timings[(name, label)] = {
                "max_rel_err": worst, "max_abs_err": max(a for _, a in errs.values()),
                "ms": cuda_ms(kern, iters), "device_ms": device_ms(kern, 2),
                "plain_ms": cuda_ms(plain, max(iters // 2, 2)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            t_ = timings[(name, label)]
            print(f"time {name} {label}: {t_['ms']:.4f} ms (device {t_['device_ms']:.4f}), plain "
                  f"{t_['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
            del got, want
        del xa, xm, g, a_p, forms
    torch.cuda.empty_cache()
    mark("f32_kernels")

    # the five kernels of an I-JEPA step alone at the JEPA paths' widths
    # (JEPA_SHAPES), the same way: every output against the plain version
    # on the same inputs (bf16 at TOL_FWD / TOL_BWD, fp32 at TOL_F32_FORMS),
    # one launch each (fp32: an fp32 one), timed beside the plain version
    def block_bounds(B, n, d, h, f, e):
        M, hd = B * n, d // h
        core, probs = B * h * n * n * hd, B * h * n * n * e
        w_attn, w_mlp = 4 * d * d * e, 2 * d * f * e
        fwd_bytes = 2 * M * d * e + w_attn + 6 * d * 4
        return {
            "attn_block_fwd": (8 * M * d * d + 4 * core, fwd_bytes),
            "attn_block_fwd_stash": (8 * M * d * d + 4 * core, fwd_bytes + M * 3 * d * e + probs),
            "attn_block_bwd_stash": (16 * M * d * d + 10 * core,
                                     6 * M * d * e + probs + 2 * w_attn + 8 * d * 4),
            "mlp_block_fwd": (4 * M * d * f, 2 * M * d * e + w_mlp + (3 * d + f) * 4),
            "mlp_block_bwd": (10 * M * d * f, 3 * M * d * e + 2 * w_mlp + (5 * d + 2 * f) * 4),
        }

    jepa_gap = {}
    for label, B, n, d, h, f, dt in JEPA_SHAPES:
        fp32 = dt == "float32"
        make = f32_block_args if fp32 else block_args
        xa, xm = make("attn", B, n, d, f), make("mlp", B, n, d, f)
        g = (torch.randn(B, n, d, generator=gen, device=dev) * 0.1).to(xa[0].dtype)
        _, qkv_p, probs_p = attn_block_fwd_stash_plain(*xa, h)
        cases = (
            ("attn_block_fwd", fused_attn_block, attn_block_plain, (*xa, h), ("out",)),
            ("attn_block_fwd_stash", attn_block_fwd_stash, attn_block_fwd_stash_plain,
             (*xa, h), ("out", "qkv", "probs")),
            ("attn_block_bwd_stash", attn_block_bwd_stash, attn_block_bwd_stash_plain,
             (*xa[:4], xa[5], qkv_p, probs_p, g, h), grads_attn),
            ("mlp_block_fwd", fused_mlp_block, mlp_block_plain, xm, ("out",)),
            ("mlp_block_bwd", mlp_block_bwd, mlp_block_bwd_plain, (*xm[:6], g), grads_mlp),
        )
        bounds = block_bounds(B, n, d, h, f, 4 if fp32 else 2)
        for name, kern, plain, args, outs in cases:
            tol = TOL_F32_FORMS if fp32 else (TOL_BWD if name.endswith("bwd_stash") or
                                              name == "mlp_block_bwd" else TOL_FWD)
            before = (kern.launches, kern.f32_launches)
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            launched = (kern.launches - before[0], kern.f32_launches - before[1])
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = {o: rel_err(a, b) for o, a, b in zip(outs, got, want)}
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            worst = max(r for r, _ in errs.values())
            key = name + ("_f32" if fp32 else "")
            jepa_gap[f"{key} {label}"] = {o: r for o, (r, _) in errs.items()}
            print(f"parity {key} {label} B={B} N={n} D={d} H={h} F={f}: max-rel per output "
                  + ", ".join(f"{o} {r:.2e}" for o, (r, _) in errs.items())
                  + f" (bar {tol}), finite {finite}, launches {launched}", flush=True)
            check(launched == (1, int(fp32)), f"{key} {label}: one launch{' (fp32)' if fp32 else ''}")
            check(finite and worst <= tol and len(got) == len(outs) == len(want)
                  and all(a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want)),
                  f"{key} {label} parity (dtypes and shapes as the plain version's)")
            b_ms, b_by = bound_ms(*bounds[name], PEAK_FP32_PRODUCTS if fp32 else PEAK_BF16)
            iters = 10 if B * n <= 64 * 77 else 5
            timings[(key, label)] = {
                "max_rel_err": worst, "max_abs_err": max(a for _, a in errs.values()),
                "ms": cuda_ms(lambda: kern(*args), iters),
                "device_ms": device_ms(lambda: kern(*args), 2),
                "plain_ms": cuda_ms(lambda: plain(*args), max(iters // 2, 2)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            t_ = timings[(key, label)]
            print(f"time {key} {label}: {t_['ms']:.4f} ms (device {t_['device_ms']:.4f}), plain "
                  f"{t_['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
            del got, want
        del xa, xm, g, qkv_p, probs_p, cases
    torch.cuda.empty_cache()
    mark("jepa_kernels")

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
        SDPA (``lib``), CUDA events and profiler device time, with its share
        of the bound and the bytes it must move per ms of its time. The fp32
        bound takes the faster of the card's two ways to an fp32 product
        (PEAK_FP32_PRODUCTS)."""
        iters = 20
        flops, nbytes = work
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32_PRODUCTS)
        k_ms = cuda_ms(kern, iters)
        timings[(name, tag)] = {
            "max_rel_err": err[0], "max_abs_err": err[1],
            "ms": k_ms, "device_ms": device_ms(kern, iters), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, iters),
            "library_device_ms": device_ms(lib, iters),
            "library": lib_name, "bound_share": b_ms / k_ms, "bytes_per_ms": nbytes / k_ms,
        }

    core_gap, same_bwd, same_bwd_f32, sdpa_gap = {}, None, {}, {}
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
            # SDPA's backward alone, from one forward's saved tensors
            out_s = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
            sdpa_bwd = lambda: torch.autograd.grad(out_s, (qg, kg, vg), g4, retain_graph=True)
            rec = timings[("attention_bwd" + sfx, f"{label}{B}")]
            rec["library_bwd_ms"], rec["library_bwd_device_ms"] = cuda_ms(sdpa_bwd, 20), device_ms(sdpa_bwd, 20)
            if timed_f32:  # information, no check: what 3xTF32 gives at these shapes
                grads_s = torch.stack(sdpa_bwd(), 2).permute(0, 3, 2, 1, 4).reshape(B, n, 3 * d)
                sdpa_gap[tag] = {
                    "fwd_max_rel": rel_err(out_s.detach().transpose(1, 2).reshape(B, n, d),
                                           attention_plain(qkv, h))[0],
                    "bwd_max_rel": rel_err(grads_s, attention_bwd_plain(qkv, dctx, h))[0]}
                print(f"SDPA fp32 (3xTF32) against the plain versions, {tag}: max-rel "
                      f"{sdpa_gap[tag]['fwd_max_rel']:.3e} / {sdpa_gap[tag]['bwd_max_rel']:.3e} "
                      f"(information; kernels 12 / 13 {rf:.3e} / {rb:.3e})", flush=True)
                del grads_s
            del q4, k4, v4, qg, kg, vg, g4, out_s
        if timed and B == CORE_TIMED[0][1]:
            # kernel 13 twice on the same inputs gives the same bits (no atomics,
            # nothing summed in device memory)
            same_bwd = bool(torch.equal(fused_attention_bwd(qkv, dctx, h), fused_attention_bwd(qkv, dctx, h)))
            print(f"kernel 13 twice on the same inputs ({tag}): bit-equal {same_bwd}", flush=True)
            check(same_bwd, "kernel 13 deterministic")
        if dt == torch.float32:
            same_bwd_f32[tag] = bool(torch.equal(fused_attention_bwd(qkv, dctx, h),
                                                 fused_attention_bwd(qkv, dctx, h)))
            print(f"kernel 13 fp32 twice on the same inputs ({tag}): bit-equal {same_bwd_f32[tag]}",
                  flush=True)
            check(same_bwd_f32[tag], f"kernel 13 fp32 deterministic ({tag})")
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

    # K2, kernel 2 and kernel 4 also count their launches with packed
    # segments; every block kernel its launches in fp32
    counters = kernel_counters()[0]
    training_kernels = [f.__name__ for f in counters[4:]] + ["fused_attn_block_seg"]
    zero_counters, launch_counts = counter_fns()

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

    def step_times(step, B_, iters, tag):
        """A train step's CUDA-event ms and images/s at batch ``B_``, its
        peak memory above what is held before it, and its device time and
        busy share from the profiler."""
        ms = cuda_ms(step, iters, warmup=2)
        held = torch.cuda.memory_allocated() / 1e9  # other phases' tensors included
        torch.cuda.reset_peak_memory_stats()
        step()
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = device_breakdown(step, reps=2)
        dev_ms = prof["device_ms_per_call"]
        # kernel time per step over the event-timed step: the profiled
        # window's own busy_share is lower, the profiler adding host time
        busy = dev_ms / ms if isinstance(dev_ms, float) else "not measured"
        print(f"{tag} train step B={B_}: {ms:.2f} ms, {B_ / ms * 1e3:.0f} images/s, peak "
              f"{peak:.2f} GB ({held:.2f} GB held before the step), device busy {busy} of the "
              f"step, {prof.get('busy_share', 'not measured')} of the profiled window", flush=True)
        return {"ms": ms, "images_per_s": B_ / ms * 1e3, "device_busy_share": busy,
                "peak_memory_gb": peak, "held_before_step_gb": held, "profile": prof}

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
                       extra=None, expect_dec=None, distinct=None, probes=None,
                       dtype=torch.bfloat16):
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
        K2 launch per layer. ``dtype`` None: the config's own (fp32 where it
        names none)."""
        tag = cfg_.name
        t_init = time.perf_counter()
        trainer = MIMPretrainer(cfg_, dtype=dtype, seed=0, device=dev)
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
                  "batch": bs, "channels": m.in_chans, "dtype": str(m.dtype).replace("torch.", ""),
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
        pair = [MIMPretrainer(cfg_, dtype=dtype, seed=0, device=dev) for _ in range(2)]
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
            step_t[f"B={B_}"] = step_times(lambda: trainer.train_batch(tb), B_, iters, tag)
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
        ckpt_mb = os.path.getsize(ckpt_path) / 2**20  # kept: the predictor warm-starts from it
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

    def mae_remat(trainer, tbatches, cfg_src=None, batch_steps=MAE[4], dtype=torch.bfloat16):
        """mim_1_mae (or ``cfg_src``): the same model with remat,
        ``batch_steps`` (batch, steps) at a smaller batch, so that kernel 4
        runs masked on its real path (K2 masked twice per encoder block, the
        forward and its replay; the decoder as it is, with or without its
        stash); then its gradients bit-equal to those of the same model
        stored without remat (the encoder's stash off). ``dtype`` None: the
        config's (fp32: every launch an fp32 one)."""
        cfg_src = cfg_src or cfg_m
        d_ = {sec: dict(cfg_src[sec].items()) for sec in cfg_src.sections()}
        Br, steps_r = batch_steps
        d_["TRAINING"].update(remat="True", batch_size=str(Br))
        cfg_rm = Config.from_dict(d_, name=cfg_src.name + "_remat")
        tr = MIMPretrainer(cfg_rm, dtype=dtype, seed=0, device=dev)
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
        dec_stash = tr.model.decoder.block0.stash
        want = {"fused_attn_block": (2 * enc + (0 if dec_stash else dec)) * steps_r,
                "fused_attn_block_seg": 2 * enc * steps_r,
                "attn_block_bwd": (enc + (0 if dec_stash else dec)) * steps_r,
                "attn_block_bwd_seg": enc * steps_r,
                "attn_block_fwd_stash": dec * steps_r * dec_stash,
                "attn_block_bwd_stash": dec * steps_r * dec_stash,
                "fused_mlp_block": (2 * enc + dec) * steps_r, "mlp_block_bwd": (enc + dec) * steps_r}
        if tr.model.dtype == torch.float32:  # every launch an fp32 one
            want = with_f32(want)
        print(f"{cfg_rm.name} (remat, batch {Br}): {steps_r} steps in {t_r:.2f} s, losses "
              f"{[round(v, 4) for v in losses_r]}, launches {rl}", flush=True)
        check(tr.model.encoder.remat and all(np.isfinite(losses_r)), "MAE remat run")
        for k_, n_ in rl.items():
            check(n_ == want.get(k_, 0), f"{cfg_rm.name}: {k_} launches {n_} == {want.get(k_, 0)}")
        d_["TRAINING"].update(remat="False")
        d_["ARCHITECTURE"].update(stash="False")
        ref = build_mim_model(Config.from_dict(d_, name=cfg_src.name + "_stored"),
                              dtype=tr.model.dtype, device=dev, remat=False)
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

    def with_f32(expect):
        """The same launches, every one an fp32 one (``*_f32`` counters;
        the ``*_seg`` ones count masked launches of any dtype)."""
        return {**expect, **{k + "_f32": v for k, v in expect.items() if not k.endswith("_seg")}}

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

    # ---- 5c. the predictor ------------------------------------------------------
    pred_ckpt = os.path.join(ROOT, "models", "chip_smoke_mim_1.ckpt.pt")
    try:
        predictor = predictor_phase(dev, pred_ckpt, zero_counters, launch_counts, step_times)
        mark("predictor")
        predictor_f32 = predictor_f32_phase(dev, pred_ckpt, zero_counters, launch_counts,
                                            step_times, PRED_F32)
        mark("predictor_f32")
        # ---- 5e. the fp32 large and tiny configs: the predictor ones first
        predictor_f32["routes"].update(predictor_f32_phase(
            dev, pred_ckpt, zero_counters, launch_counts, step_times, PRED_F32_LARGE)["routes"])
        mark("predictor_f32_large_tiny")
        # ---- 5g. checkpoints and the sweep ------------------------------------
        checkpoints = checkpoint_phase(dev, pred_ckpt, zero_counters, launch_counts)
        mark("checkpoints")
    finally:
        if os.path.exists(pred_ckpt):
            os.remove(pred_ckpt)

    # then the fp32 pretraining paths: the tiny configs as shipped (the
    # config's dtype, fp32) and ViT-H in fp32 (kernel 9's fp32 form)
    expect_f32 = {"mim_tiny": (expect_b, None), "mim_tiny_large": (expect_l, None),
                  "mae_tiny": (expect_m, {"fused_attn_block": (1, 1), "attn_block_bwd": (1, 0),
                                          "mlp_block_bwd": (1, 0), "fused_mlp_block": (1, 1)}),
                  "mim_32_vith_f32": (expect_h, None)}
    f32_paths = {}
    for name_, steps_, val_, time_b in F32_TRAIN:
        if name_ == "mim_32_vith_f32":
            d_f = {sec: dict(cfg_h[sec].items()) for sec in cfg_h.sections()}
            d_f["TRAINING"].update(dtype="float32")
            cfg_f = Config.from_dict(d_f, name=name_)
        else:
            cfg_f = load_config(name_, os.path.join(ROOT, "configs"))
            check("dtype" not in cfg_f.training, f"{name_}: as shipped, no dtype (fp32)")
        enc_exp, dec_exp = expect_f32[name_]
        extra_f = vith_init if name_ == "mim_32_vith_f32" else None
        if name_ == "mae_tiny":
            extra_f = lambda tr_, tb_, c_=cfg_f: mae_remat(tr_, tb_, c_, MAE_TINY_REMAT, None)
        f32_paths[name_] = training_phase(
            cfg_f, steps_, val_, with_f32(enc_exp), *TOL_F32_PATHS[name_], time_b, seed=9,
            extra=extra_f, expect_dec=dec_exp and with_f32(dec_exp), dtype=None)
        check(f32_paths[name_]["dtype"] == "float32", f"{name_} trains in fp32")
        mark("training_f32_" + name_)
    # ---- 5f. I-JEPA -----------------------------------------------------------
    jepa = jepa_phase(dev, probe_sets, zero_counters, launch_counts, step_times)
    del probe_sets
    mark("jepa")
    # ---- 5h. CosmicEmbeds, 5i. the prefetching loop ----------------------------
    cosmos = cosmos_phase(dev, zero_counters, launch_counts, step_times)
    mark("cosmos")
    prefetch = prefetch_phase(dev, zero_counters, launch_counts, device_breakdown)
    mark("prefetch")
    # ---- 5j. data parallelism across processes ----------------------------------
    data_parallel = dp_phase(dev, zero_counters, launch_counts)
    print(smi, flush=True)
    mark("data_parallel")
    # ---- 5k. the figures, the per-GPU launcher, the data stages ----------------
    figures = figures_phase(dev, zero_counters, launch_counts, smi)
    mark("figures_launcher_data")
    # ---- 5l. tensor parallelism ---------------------------------------------------
    tensor_parallel = tp_phase(dev, zero_counters, launch_counts, timings, cuda_ms, rel_err,
                               bound_ms, smi)
    mark("tensor_parallel")
    shapes = {c: tuple(r[k] for k in ("layers", "embed_dim", "batch", "channels", "remat", "ra_dec"))
              for c, r in paths.items()}
    check(shapes == {CONFIG: (12, 768, 64, 5, False, False), LARGE[0]: (24, 768, 64, 5, False, False),
                     REMAT[0]: (24, 1024, 32, 9, True, True), VITH[0]: (32, 1280, 32, 9, False, True),
                     MAE[0]: (12, 768, 1024, 5, False, False), POOL[0]: (12, 768, 64, 5, False, False)},
          f"the configs train at full width and depth: {shapes}")

    # ---- 5b. the Attention module ---------------------------------------------
    # at ViT-B width and B=64, in bf16 and at its default fp32 (the path of
    # the fp32 configs): one forward and backward() through autograd with the
    # counters zeroed just before, then the same through the plain versions
    attention_module, attn_launches_by_dtype = {}, {}
    for dt_name, bar in (("bfloat16", TOL_BWD), ("float32", TOL_ATTN_F32)):
        dt = getattr(torch, dt_name)
        attn_mod = Attention(D, H, dt)
        for lin in (attn_mod.qkv, attn_mod.proj):
            lin.reset_parameters(torch.Generator().manual_seed(5))
        attn_mod.to(dev)
        xa = (torch.randn(64, N_TOK, D, generator=gen, device=dev) * 0.5).to(dt)
        ga = (torch.randn(64, N_TOK, D, generator=gen, device=dev) * 0.1).to(dt)

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
        print(f"Attention module (D={D}, {H} heads, B=64, {dt_name}): forward + backward launches "
              f"{ {k: v for k, v in attn_launches.items() if v} }; gradients vs plain max-rel "
              + ", ".join(f"{k} {v:.2e}" for k, v in attn_errs.items()) + f" (bar {bar})", flush=True)
        check(attn_launches == {k: int(k in ("fused_attention", "fused_attention_bwd")) for k in attn_launches},
              f"the Attention module ({dt_name}) launches kernels 12 and 13 once each and nothing else")
        check(max(attn_errs.values()) <= bar and all(torch.isfinite(g_).all() for g_ in grads_k.values()),
              f"Attention module ({dt_name}) gradients kernel vs plain")
        attention_module[dt_name] = {"launches": attn_launches, "grad_max_rel_vs_plain": attn_errs}
        attn_launches_by_dtype[dt_name] = attn_launches
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
        # the fp32 kernels behind the same wrappers, timed at ViT-B B=64;
        # their launches are the fp32 Attention module's
        "attention_fwd_f32": ("cuda", src + "csrc/attention.cu", jsrc + "attention.py:59",
                              "fused_attention", "vitb64"),
        "attention_bwd_f32": ("cuda", src + "csrc/attention.cu", jsrc + "attention.py:142",
                              "fused_attention_bwd", "vitb64"),
        # the fp32 forms of K2, kernels 2 and 3, K1 and kernel 8, timed at
        # cls_fs_1k's B=256, N=66; their launches are the fp32 predictor
        # paths' (csrc/gemm_f32.cuh, csrc/attn_f32.cuh beside each source)
        "attn_block_fwd_f32": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:899",
                               "fused_attn_block_f32", "cls_fs"),
        "attn_block_fwd_stash_f32": ("cuda", src + "csrc/attn_block.cu",
                                     jsrc + "attn_block.py:940", "attn_block_fwd_stash_f32",
                                     "cls_fs"),
        "attn_block_bwd_stash_f32": ("cuda", src + "csrc/attn_block_bwd.cu",
                                     jsrc + "attn_block.py:988", "attn_block_bwd_stash_f32",
                                     "cls_fs"),
        "mlp_block_fwd_f32": ("cuda", src + "csrc/mlp_block.cu", jsrc + "mlp_block.py:634",
                              "fused_mlp_block_f32", "cls_fs"),
        "mlp_block_bwd_f32": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:834",
                              "mlp_block_bwd_f32", "cls_fs"),
        # the fp32 forms of kernels 4, 6, 7, 9 and the masked K2, 2 and 4,
        # timed at F32_NEW's shapes; their launches are the fp32 paths' (the
        # masked ones counted by the *_seg counters, on fp32 paths alone)
        "attn_block_bwd_f32": ("cuda", src + "csrc/attn_block_bwd.cu", jsrc + "attn_block.py:1052",
                               "attn_block_bwd_f32", "mim_32"),
        "mlp_block_fwd_stash_f32": ("cuda", src + "csrc/mlp_block.cu", jsrc + "mlp_block.py:687",
                                    "mlp_block_fwd_stash_f32", "cls_ft_large"),
        "mlp_block_bwd_stash_f32": ("cuda", src + "csrc/mlp_block_bwd.cu",
                                    jsrc + "mlp_block.py:774", "mlp_block_bwd_stash_f32",
                                    "cls_ft_large"),
        "mlp_block_bwd_stream_f32": ("cuda", src + "csrc/mlp_block_bwd.cu",
                                     jsrc + "mlp_block.py:532", "mlp_block_bwd_stream_f32", "vith"),
        "attn_block_fwd_seg_f32": ("cuda", src + "csrc/attn_block.cu", jsrc + "attn_block.py:899",
                                   "fused_attn_block_seg", "mae"),
        "attn_block_fwd_stash_seg_f32": ("cuda", src + "csrc/attn_block.cu",
                                         jsrc + "attn_block.py:940", "attn_block_fwd_stash_seg",
                                         "mae"),
        "attn_block_bwd_seg_f32": ("cuda", src + "csrc/attn_block_bwd.cu",
                                   jsrc + "attn_block.py:1052", "attn_block_bwd_seg", "mae"),
        # the tensor-parallel forms of K2, kernel 4, K1 and kernel 8 (bf16 and
        # fp32, masked too), timed at mim_32's shapes on one rank's shard;
        # their launches are phase 5l's ranks'
        "attn_block_tp_fwd": ("cuda", src + "csrc/attn_block_tp.cu", jsrc + "attn_block.py:899",
                              "attn_block_tp_fwd", "mim_32"),
        "attn_block_tp_bwd": ("cuda", src + "csrc/attn_block_tp.cu", jsrc + "attn_block.py:1052",
                              "attn_block_tp_bwd", "mim_32"),
        "mlp_block_tp_fwd": ("cuda", src + "csrc/mlp_block.cu", jsrc + "mlp_block.py:634",
                             "mlp_block_tp_fwd", "mim_32"),
        "mlp_block_tp_bwd": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:834",
                             "mlp_block_tp_bwd", "mim_32"),
        # K2 TP's fused bf16 forward half (one launch at the ViT-S shard),
        # timed at jepa_struct's shard; its launches are phase 5l's ranks' on
        # jepa_struct, and the attn_block_tp_fwd row's are the others
        "attn_block_tp_fwd_fused": ("cuda", src + "csrc/attn_block_tp.cu",
                                    jsrc + "attn_block.py:899", "attn_block_tp_fwd_fused",
                                    "jepa_struct"),
    }
    block_f32 = {n for n in meta if n.endswith("_f32") and not n.startswith("attention")}
    kernels = []
    for name, (route, source, replaces, counter, shape) in meta.items():
        t = timings[(name, shape)]
        if "_tp_" in name:  # a form's fused launches in its own row alone
            by_path = {f"tp_{c}": r[counter] - r.get(counter + "_fused", 0)
                       for c, r in tensor_parallel["launches"].items()}
        elif name in block_f32:
            by_path = {**{f"predictor_f32_{r}": v["launches"][counter]
                          for r, v in predictor_f32["routes"].items()},
                       **{f"predictor_f32_{r}_infer": v["infer"]["launches"][counter]
                          for r, v in predictor_f32["routes"].items()},
                       **{f"training_f32_{c}": r["launches"][counter] for c, r in f32_paths.items()},
                       "training_f32_mae_tiny_remat":
                           f32_paths["mae_tiny"]["remat_run"]["launches"][counter],
                       **{f"jepa_{c}": r["launches"][counter] for c, r in jepa.items()
                          if r["geometry"]["dtype"] == "float32"},
                       "cosmos_float32": cosmos["float32"]["launches"][counter],
                       "cosmos_float32_generate": cosmos["float32"]["generate_launches"][counter]}
        elif name.endswith("_f32"):
            by_path = {"attention_module_float32": attn_launches_by_dtype["float32"][counter]}
        else:
            by_path = {f"serving_{CONFIG}": launches[counter],
                       f"retrieval_{CONFIG}": retrieval_launches[counter],
                       **{f"training_{c}": r["launches"][counter] for c, r in paths.items()},
                       f"training_{MAE[0]}_remat": paths[MAE[0]]["remat_run"]["launches"][counter],
                       **{f"predictor_{r}": v["launches"].get(counter, 0)
                          for r, v in predictor["routes"].items()},
                       "predictor_infer": predictor["infer"]["launches"].get(counter, 0),
                       "attention_module": attn_launches_by_dtype["bfloat16"][counter],
                       **{f"jepa_{c}": r["launches"][counter] for c, r in jepa.items()
                          if r["geometry"]["dtype"] == "bfloat16"},
                       "cosmos_bfloat16": cosmos["bfloat16"]["launches"][counter],
                       "cosmos_bfloat16_generate": cosmos["bfloat16"]["generate_launches"][counter],
                       **{f"prefetch_{c}": r["launches"][counter] for c, r in prefetch.items()},
                       **{f"dp_{c}": r[counter] for c, r in data_parallel["launches"].items()},
                       **{f"figures_{c}": r[counter] for c, r in figures["launches"].items()}}
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
          "f32_forms_max_rel": f32_gap, "jepa_forms_max_rel": jepa_gap,
          "kernel13_twice_bit_equal": same_bwd, "kernel13_f32_twice_bit_equal": same_bwd_f32,
          "sdpa_f32_max_rel_vs_plain": sdpa_gap})
    emit({
        "main_path": {"seconds": t_main, "encoder_calls": encoder_calls, "launches": launches,
                      "tokens_max_rel_vs_plain": tok_rel, "tokens_max_abs_vs_plain": tok_abs,
                      "top300_overlap_vs_plain": overlap},
        "encoder": {f"B={b}": v for b, v in enc.items()},
        "gemm_times": gemm_times,
        "bwd_gemm_times": bwd_gemm_times,
        "gemm_f32_times": gemm_f32_times,
        "training_paths": paths,
        "predictor": predictor,
        "predictor_f32": predictor_f32,
        "training_f32_paths": f32_paths,
        "jepa": jepa,
        "cosmos": cosmos,
        "prefetch": prefetch,
        "data_parallel": data_parallel,
        "figures_launcher_data": figures,
        "tensor_parallel": tensor_parallel,
        "checkpoints": checkpoints,
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
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--queue-worker":
        sys.exit(queue_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-worker":
        sys.exit(tp_worker(sys.argv[2]))
    sys.exit(main())
