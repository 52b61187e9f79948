#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sky_embeddings_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a). Phases, each
failing loudly (any failure exits non-zero and prints no result line):

1. device: card name and power limit; TF32 off for the plain fp32 products;
2. build: nvcc builds the CUDA kernels (attention block forward and stash
   forward, attention stash backward, MLP block forward, MLP backward) from
   the sources in the checkout, one nvcc per source, all at once; Triton
   compiles the bank scorer;
3. kernel parity, each kernel against its plain PyTorch version on the same
   inputs: the serving kernels at the serving path's shapes (ViT-B: N=65,
   D=768, H=12, F=3072 at B=64 and B=1024; a 1M x 768 bank in bf16 and fp32),
   max|a-b|/max|b| within the bars of tools/kernel_parity.py (2e-2; bank fp32
   5e-3); the training kernels at ``mim_1`` training shapes (B=64, B=512 and
   the ragged B=63), every output (out, qkv, probs; the seven gradients)
   within TOL_BWD = 3e-2 and finite;
4. the serving path, through the entry points ``similarity_search`` calls, on
   ``configs/mim_1.ini`` (SimMIM ViT-B, bf16, full depth, seeded weights) and
   synthetic cutouts with whole-band NaNs: ``extract_latents`` of 2 targets
   with 64 augmentations, streaming ``mim_simsearch`` over 32 batches of 64,
   ``build_bank`` + ``EmbeddingBank.query(exact=True)``, and
   ``weighted_bank_scores`` / ``bank_topk`` on a seeded 1M x 768 bf16 bank.
   Launch counters are zeroed just before and read just after; the kernel
   path's tokens and top-300 are compared with the plain path on the card;
5. the training path, through the entry points ``pretrain_mim`` calls:
   ``MIMPretrainer`` on ``configs/mim_1.ini`` (full ViT-B, depth 12, bf16,
   batch 64, seeded weights) on synthetic cutouts with whole-band NaNs: 20
   ``train_batch`` steps, a validation pass of 4 ``eval_batch`` calls, then
   ``save`` and ``restore`` into a fresh trainer (params and optimizer state
   bit-equal). Counters zeroed just before, read just after: each training
   kernel 12 x 20 launches, K1 12 x 24, K2 12 x 4. Then the kernel path
   against the plain path on the card from the same params and masks: one
   step's loss and per-leaf gradients, and the losses of 5 steps;
6. times with CUDA events after warm-up: per kernel, the encoder, the train
   step at B=64 and B=512, queries; torch.profiler device breakdowns.

Lines before the last: the nvidia-smi name/power line, one line per check,
JSON lines of results (``{"kernels": [...]}`` among them). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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

CONFIG = "mim_1"
DEVICE = "cuda"
N_TOK, D, H, F = 65, 768, 12, 3072
BANK_ROWS = 1 << 20
N_BATCHES, BATCH = 32, 64
N_AUG, N_SAVE = 64, 300
TRAIN_STEPS, VAL_BATCHES, TRAJ_STEPS = 20, 4, 5
TRAIN_B = (64, 512, 63)  # the config's batch, a large one, a ragged one


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
    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, build_bank
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch
    from sky_embeddings_tpu_torch.models.mim import build_mim_model
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build
    from sky_embeddings_tpu_torch.ops.kernels.attn_block import (
        attn_block_bwd_stash,
        attn_block_bwd_stash_plain,
        attn_block_fwd_stash,
        attn_block_fwd_stash_plain,
        attn_block_plain,
        fused_attn_block,
    )
    from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
        fused_mlp_block,
        mlp_block_bwd,
        mlp_block_bwd_plain,
        mlp_block_plain,
    )
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
    from sky_embeddings_tpu_torch.ops.kernels.simscore import (
        bank_topk,
        weighted_bank_scores,
        weighted_bank_scores_plain,
    )

    t_start = time.perf_counter()

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    t_nvcc = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):  # Triton compiles once per bank dtype
        small = torch.randn(100, D, generator=gen, device=dev).to(dt)
        weighted_bank_scores(small, torch.ones(D, device=dev), torch.ones(D, device=dev))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"build: nvcc {t_nvcc:.1f} s, with Triton JIT {t_build:.1f} s", flush=True)
    build_s = {"nvcc": t_nvcc, "total": t_build}

    # ---- 3. kernel parity ---------------------------------------------------
    def rel_err(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12), float((a - b).abs().max())

    def block_args(kind_, B):
        x = (torch.randn(B, N_TOK, D, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
        bias = 0.1 * torch.randn(D, generator=gen, device=dev)
        (d_in, d_mid) = (D, 3 * D) if kind_ == "attn" else (D, F)
        (e_in, e_out) = (D, D) if kind_ == "attn" else (F, D)
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

    for B in TRAIN_B:
        x, scale, bias, wq, bq, wp, bp = block_args("attn", B)
        x1, s1, b1_, w1, bb1, w2, _ = block_args("mlp", B)
        g = (torch.randn(B, N_TOK, D, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        _, qkv_p, probs_p = attn_block_fwd_stash_plain(x, scale, bias, wq, bq, wp, bp, H)
        cases = (
            ("attn_block_fwd_stash", attn_block_fwd_stash, attn_block_fwd_stash_plain,
             (x, scale, bias, wq, bq, wp, bp, H), ("out", "qkv", "probs")),
            ("attn_block_bwd_stash", attn_block_bwd_stash, attn_block_bwd_stash_plain,
             (x, scale, bias, wq, wp, qkv_p, probs_p, g, H),
             ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")),
            ("mlp_block_bwd", mlp_block_bwd, mlp_block_bwd_plain, (x1, s1, b1_, w1, bb1, w2, g),
             ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")),
        )
        bounds = train_bounds(B)
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
            if B == 63:
                continue
            iters = 20 if B == 64 else 5
            b_ms, b_by = bound_ms(*bounds[name], PEAK_BF16)
            timings[(name, B)] = {
                "max_rel_err": worst, "max_abs_err": max(a for _, a in errs.values()),
                "ms": cuda_ms(lambda: kern(*args), iters),
                "plain_ms": cuda_ms(lambda: plain(*args), max(iters // 4, 2)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            del got, want
        del x, qkv_p, probs_p, g, cases, x1
    torch.cuda.empty_cache()

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

    counters = (fused_attn_block, fused_mlp_block, weighted_bank_scores, attn_block_fwd_stash,
                attn_block_bwd_stash, mlp_block_bwd)
    for fn in counters:
        fn.launches = 0
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
    launches = {f.__name__: f.launches for f in counters}
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
    check(launches["attn_block_fwd_stash"] == launches["attn_block_bwd_stash"]
          == launches["mlp_block_bwd"] == 0, "serving launches no training kernel")
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

    # ---- 5. training path ---------------------------------------------------
    del bank
    torch.cuda.empty_cache()
    tdata = make_cutouts((TRAIN_STEPS + VAL_BATCHES) * BATCH, seed=3, **geom)
    check(bool(np.isnan(tdata["cutouts"]).any()), "training cutouts hold NaN bands")
    train_batches = as_batches(tdata, BATCH)
    trainer = MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    check(trainer.batch_size == BATCH and trainer.model.encoder.depth == 12
          and trainer.model.embed_dim == D, "mim_1 trains ViT-B at batch 64")
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    train_losses = [trainer.train_batch(b) for b in train_batches[:TRAIN_STEPS]]
    val_losses = [trainer.eval_batch(b, idx=i) for i, b in enumerate(train_batches[TRAIN_STEPS:])]
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t_train
    train_launches = {f.__name__: f.launches for f in counters}
    train_losses = [float(v) for v in train_losses]
    val_losses = [float(v) for v in val_losses]
    print(f"training path: {TRAIN_STEPS} steps + {VAL_BATCHES} val batches in {t_train:.2f} s, "
          f"launches {train_launches}", flush=True)
    print(f"train losses {[round(v, 4) for v in train_losses]}; val {[round(v, 4) for v in val_losses]}",
          flush=True)
    check(all(np.isfinite(train_losses + val_losses)), "training and validation losses finite")
    for name in ("attn_block_fwd_stash", "attn_block_bwd_stash", "mlp_block_bwd"):
        check(train_launches[name] == n_layers * TRAIN_STEPS, f"{name} launches = 12 x train steps")
    check(train_launches["fused_mlp_block"] == n_layers * (TRAIN_STEPS + VAL_BATCHES),
          "K1 launches = 12 x (train steps + val batches)")
    check(train_launches["fused_attn_block"] == n_layers * VAL_BATCHES, "K2 launches = 12 x val batches")
    check(train_launches["weighted_bank_scores"] == 0, "training launches no bank scorer")

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
    del restored
    torch.cuda.empty_cache()

    # kernel path vs plain path on the card, from the same params and masks
    pair = [MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device=dev) for _ in range(2)]
    pair[1].model.encoder.plain = True
    mgen = torch.Generator(device=dev).manual_seed(7)
    masks = [pair[0].draw_mask(BATCH, mgen) for _ in range(TRAJ_STEPS)]
    x0 = torch.as_tensor(train_batches[0]["cutouts"], device=dev).clamp_min(trainer.pixel_min)
    step_grads, step_loss = [], []
    for tr in pair:
        loss = tr.model(x0, masks[0])[0]
        loss.backward()
        step_loss.append(float(loss.detach()))
        step_grads.append({n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                           if p.grad is not None})
        tr.optimizer.zero_grad(set_to_none=True)
    grad_rel = {n: float((a - step_grads[1][n]).norm() / (step_grads[1][n].norm() + 1e-30))
                for n, a in step_grads[0].items()}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    loss_rel = abs(step_loss[0] - step_loss[1]) / abs(step_loss[1])
    traj = [[float(tr.train_batch(b, mask=m)) for b, m in zip(train_batches, masks)] for tr in pair]
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
    print(f"training kernel vs plain path (B=64, 12 layers): loss rel {loss_rel:.3e}; gradient "
          f"||a-b||/||b|| max {grad_rel[worst_leaf]:.3e} ({worst_leaf}), median "
          f"{float(np.median(list(grad_rel.values()))):.3e} over {len(grad_rel)} leaves "
          f"(bar {TOL_GRAD}); {TRAJ_STEPS}-step losses kernel {[round(v, 5) for v in traj[0]]} "
          f"plain {[round(v, 5) for v in traj[1]]}, max rel {traj_rel:.3e} (bar {TOL_LOSS})",
          flush=True)
    check(len(grad_rel) == sum(1 for n, _ in trainer.model.named_parameters() if n != "mask_token"),
          "every parameter but mask_token gets a gradient")
    check(all(np.isfinite(list(grad_rel.values()))), "gradients finite")
    check(grad_rel[worst_leaf] <= TOL_GRAD, "gradients kernel vs plain")
    check(loss_rel <= TOL_LOSS and traj_rel <= TOL_LOSS, "losses kernel vs plain")
    del pair, step_grads
    torch.cuda.empty_cache()

    # ---- 6. times -------------------------------------------------------------
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

    enc = {}
    with torch.inference_mode():
        for B, iters in ((64, 20), (1024, 5)):
            imgs = torch.as_tensor(np.concatenate([b["cutouts"] for b in batches])[:B], device=dev)
            ms = cuda_ms(lambda: model.encode(imgs), iters, warmup=2)
            enc[B] = {"ms": ms, "images_per_s": B / ms * 1e3,
                      "profile": device_breakdown(lambda: model.encode(imgs))}
    train_t = {}
    timg = np.concatenate([b["cutouts"] for b in train_batches])
    for B, iters in ((64, 10), (512, 3)):
        tb = {"cutouts": torch.as_tensor(timg[:B], device=dev)}
        ms = cuda_ms(lambda: trainer.train_batch(tb), iters, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        trainer.train_batch(tb)
        train_t[B] = {"ms": ms, "images_per_s": B / ms * 1e3,
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "profile": device_breakdown(lambda: trainer.train_batch(tb), reps=2)}
        print(f"train step B={B}: {ms:.2f} ms, {B / ms * 1e3:.0f} images/s", flush=True)
    del trainer, tb
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
                                 "attn_block_fwd_stash", 64),
        "attn_block_bwd_stash": ("cuda", src + "csrc/attn_block_bwd.cu", jsrc + "attn_block.py:988",
                                 "attn_block_bwd_stash", 64),
        "mlp_block_bwd": ("cuda", src + "csrc/mlp_block_bwd.cu", jsrc + "mlp_block.py:834",
                          "mlp_block_bwd", 64),
    }
    kernels = []
    for name, (route, source, replaces, counter, shape) in meta.items():
        t = timings[(name, shape)]
        by_path = {"serving": launches[counter], "training": train_launches[counter]}
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"kernel_times": [{"name": n, "shape": s, **v} for (n, s), v in timings.items()]})
    emit({
        "main_path": {"seconds": t_main, "encoder_calls": encoder_calls, "launches": launches,
                      "tokens_max_rel_vs_plain": tok_rel, "tokens_max_abs_vs_plain": tok_abs,
                      "top300_overlap_vs_plain": overlap},
        "encoder": {f"B={b}": v for b, v in enc.items()},
        "training_path": {
            "seconds": t_train, "steps": TRAIN_STEPS, "val_batches": VAL_BATCHES,
            "launches": train_launches, "train_losses": train_losses, "val_losses": val_losses,
            "checkpoint_mb": ckpt_mb, "loss_rel_vs_plain": loss_rel,
            "grad_rel_vs_plain_max": grad_rel[worst_leaf], "grad_rel_worst_leaf": worst_leaf,
            "grad_rel_vs_plain_median": float(np.median(list(grad_rel.values()))),
            "trajectory_kernel": traj[0], "trajectory_plain": traj[1],
            "trajectory_max_rel": traj_rel,
        },
        "train_step": {f"B={b}": v for b, v in train_t.items()},
        "bank_1M_bf16": {"query_ms_host": q_host_ms, "queries_per_s": 1e3 / q_host_ms,
                         "bank_topk_ms": topk_ms},
        "build_s": build_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_s": t_total,
    })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
