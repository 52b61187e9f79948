#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sky_embeddings_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a). Phases, each
failing loudly (any failure exits non-zero and prints no result line):

1. device: card name and power limit; TF32 off for the plain fp32 products;
2. build: nvcc builds the CUDA kernels (attention block, MLP block) from the
   sources in the checkout, all at once; Triton compiles the bank scorer;
3. kernel parity at the serving path's shapes (ViT-B: N=65, D=768, H=12,
   F=3072 at B=64 and B=1024; a 1M x 768 bank in bf16 and fp32), each kernel
   against its plain PyTorch version, max|a-b|/max|b| within the bars of
   tools/kernel_parity.py (2e-2; bank fp32 5e-3);
4. the main path, through the entry points ``similarity_search`` calls, on
   ``configs/mim_1.ini`` (SimMIM ViT-B, bf16, full depth, seeded weights) and
   synthetic cutouts with whole-band NaNs: ``extract_latents`` of 2 targets
   with 64 augmentations, streaming ``mim_simsearch`` over 32 batches of 64,
   ``build_bank`` + ``EmbeddingBank.query(exact=True)``, and
   ``weighted_bank_scores`` / ``bank_topk`` on a seeded 1M x 768 bf16 bank.
   Launch counters are zeroed just before and read just after; the kernel
   path's tokens and top-300 are compared with the plain path on the card;
5. times with CUDA events after warm-up: per kernel, the encoder and queries.

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
TOL_SCORE_F32 = 5e-3
TOL_SCORE_BF16 = 2e-2
# kernel path vs plain path, encoder tokens after 12 layers (bf16): the two
# round at the same points, so they differ only by fp32 summation order and
# erff vs torch.erf; each rounding flip is one bf16 ulp (2^-8 relative)
TOL_TOKENS = 5e-2

CONFIG = "mim_1"
DEVICE = "cuda"
N_TOK, D, H, F = 65, 768, 12, 3072
BANK_ROWS = 1 << 20
N_BATCHES, BATCH = 32, 64
N_AUG, N_SAVE = 64, 300


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
    from sky_embeddings_tpu_torch.ops.kernels.attn_block import attn_block_plain, fused_attn_block
    from sky_embeddings_tpu_torch.ops.kernels.mlp_block import fused_mlp_block, mlp_block_plain
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

    # ---- 4. main path -------------------------------------------------------
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

    for fn in (fused_attn_block, fused_mlp_block, weighted_bank_scores):
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
    launches = {f.__name__: f.launches for f in (fused_attn_block, fused_mlp_block, weighted_bank_scores)}
    print(f"main path: {t_main:.2f} s, {encoder_calls} encoder calls, launches {launches}", flush=True)
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

    # ---- 5. times -------------------------------------------------------------
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
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                by_name[e.key[:90]] = by_name.get(e.key[:90], 0.0) + t / 1e3 / reps
        busy = sum(by_name.values())
        if busy == 0:
            return {"device_ms_per_call": "not measured"}
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        return {"device_ms_per_call": busy, "busy_share": busy / (wall_ms / reps), "top_ms": top}

    enc = {}
    with torch.inference_mode():
        for B, iters in ((64, 20), (1024, 5)):
            imgs = torch.as_tensor(np.concatenate([b["cutouts"] for b in batches])[:B], device=dev)
            ms = cuda_ms(lambda: model.encode(imgs), iters, warmup=2)
            enc[B] = {"ms": ms, "images_per_s": B / ms * 1e3,
                      "profile": device_breakdown(lambda: model.encode(imgs))}
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
    meta = {
        "attn_block_fwd": ("cuda", src + "csrc/attn_block.cu",
                           "sky_embeddings_tpu/ops/kernels/attn_block.py:899", "fused_attn_block", 64),
        "mlp_block_fwd": ("cuda", src + "csrc/mlp_block.cu",
                          "sky_embeddings_tpu/ops/kernels/mlp_block.py:634", "fused_mlp_block", 64),
        "weighted_bank_scores": ("triton", src + "simscore_triton.py",
                                 "sky_embeddings_tpu/ops/kernels/simscore.py:95",
                                 "weighted_bank_scores", "bfloat16"),
    }
    kernels = []
    for name, (route, source, replaces, counter, shape) in meta.items():
        t = timings[(name, shape)]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[counter], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"kernel_times": [{"name": n, "shape": s, **v} for (n, s), v in timings.items()]})
    emit({
        "main_path": {"seconds": t_main, "encoder_calls": encoder_calls, "launches": launches,
                      "tokens_max_rel_vs_plain": tok_rel, "tokens_max_abs_vs_plain": tok_abs,
                      "top300_overlap_vs_plain": overlap},
        "encoder": {f"B={b}": v for b, v in enc.items()},
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
