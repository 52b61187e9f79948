#!/usr/bin/env python3
"""Kernels 12 and 13 in fp32 (``csrc/attention.cu``) timed beside fp32 SDPA
and their plain versions on one CUDA card, and the tensor-core design they
were weighed against, emulated on the CPU.

    python3 tools/attn_f32_variants.py [--tree DIR] [--reps N] [--save F | --compare F]
    python3 tools/attn_f32_variants.py strip
    python3 tools/attn_f32_variants.py emulate [--batch B]

On the card (TF32 off for the plain versions and SDPA): at ViT-B B=64 (N =
65, D = 768, 12 heads) and ViT-H B=32 (N = 66, D = 1280, 16 heads of 80),
fp32 qkv and dctx from a seeded normal, each of kernel 12
(``fused_attention``), kernel 13 (``fused_attention_bwd``), their plain
versions, ``F.scaled_dot_product_attention`` forward, its backward alone
and both, and kernels 12 and 13 in bf16 on the same values, timed by
``torch.profiler`` (device time, summed over ``--reps`` calls) and by CUDA
events; the kernels' and SDPA's max|a-b|/max|b| against the plain
versions, kernel 12 bit-equal to ``attention_plain`` or not, kernel 13
twice bit-equal. ``--tree`` runs the package of another checkout (an A/B in
one call: parent, change, change, parent); ``--save`` writes the SHA-256 of
kernels 12 and 13's fp32 outputs to a JSON file, ``--compare`` holds this
run's to a saved file's, bit for bit (the inputs come from one seed, so two
trees on one card see the same ones). Prints the card's name and power limit, a line per
shape and a JSON line of every number. Imports nothing of JAX.

``strip`` (card): what bounds the kernels. It builds csrc/attention.cu as
it is and with three copies of its fp32 kernels (csrc/attn_f32.cuh), each
with a part taken out (``no_loads``: nothing staged
from device memory, the products run on whatever shared memory holds;
``no_math``: no product and no softmax, only the loads; ``no_softmax``),
one nvcc each, all at once, and times kernels 12 and 13 in fp32 through
each library's C entries (CUDA events, 4 alternating rounds of 20
launches, the fastest round) at ViT-B B=64 and ViT-H B=32.

``emulate`` (CPU, no card): S = Q K^T, ctx = P V and the backward's five
products as three TF32 products per fp32 one (big = rna(x), small = rna(x -
big); small x big, big x small, big x big, each an m16n8k8 step of 8 summed
exactly and rounded into the fp32 accumulator: CUTLASS's FastF32, which
fp32 SDPA runs) against the same products as fp32 FMA chains (the plain
version's order on the card), at ViT-B and ViT-H head geometry, batch
``--batch`` (8; ViT-H half). Prints each max|a-b|/max|b| beside the fp32
bar of ``chip_smoke.py`` (TOL_CORE_F32 = 5e-7), and how far the port's
fp32 ``attention_plain`` and JAX's ``xla_attention`` (XLA on the CPU, where
JAX is installed) lie from each other and from an fp64 product on the same
inputs.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("vitb", 64, 65, 768, 12), ("vith", 32, 66, 1280, 16))
TOL_CORE_F32 = 5e-7


def _arg(args: list, name: str, default):
    if name not in args:
        return default
    at = args.index(name)
    value = args[at + 1]
    del args[at:at + 2]
    return type(default)(value)


def card(args: list) -> int:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    tree = Path(_arg(args, "--tree", str(ROOT))).resolve()
    reps = _arg(args, "--reps", 20)
    save, compare = _arg(args, "--save", ""), _arg(args, "--compare", "")
    outputs = {}
    if not torch.cuda.is_available():
        print("attn_f32_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    from sky_embeddings_tpu_torch.ops.kernels import attention as ta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, f"| tree {tree}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def events_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        t = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
        return t / 1e3 / reps

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "tree": str(tree)}
    for label, B, n, d, h in SHAPES:
        qkv = torch.randn(B, n, 3 * d, generator=gen, device="cuda")
        dctx = torch.randn(B, n, d, generator=gen, device="cuda")
        qb, gb = qkv.bfloat16(), dctx.bfloat16()
        q4, k4, v4 = qkv.view(B, n, 3, h, d // h).permute(2, 0, 3, 1, 4).unbind(0)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        g4 = dctx.view(B, n, h, d // h).transpose(1, 2)
        s_out = F.scaled_dot_product_attention(qg, kg, vg)
        s_grads = torch.autograd.grad(s_out, (qg, kg, vg), g4, retain_graph=True)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg)
            torch.autograd.grad(o, (qg, kg, vg), g4)

        calls = {
            "kernel12": lambda: ta.fused_attention(qkv, h),
            "kernel13": lambda: ta.fused_attention_bwd(qkv, dctx, h),
            "plain_fwd": lambda: ta.attention_plain(qkv, h),
            "plain_bwd": lambda: ta.attention_bwd_plain(qkv, dctx, h),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4),
            "sdpa_bwd": lambda: torch.autograd.grad(s_out, (qg, kg, vg), g4, retain_graph=True),
            "sdpa_fwd_bwd": sdpa_fwd_bwd,
            "kernel12_bf16": lambda: ta.fused_attention(qb, h),
            "kernel13_bf16": lambda: ta.fused_attention_bwd(qb, gb, h),
        }
        pf, pb = ta.attention_plain(qkv, h), ta.attention_bwd_plain(qkv, dctx, h)
        kf, kb = ta.fused_attention(qkv, h), ta.fused_attention_bwd(qkv, dctx, h)
        kb2 = ta.fused_attention_bwd(qkv, dctx, h)
        sd_b = torch.stack(s_grads, 2).permute(0, 3, 2, 1, 4).reshape(B, n, 3 * d)
        outputs[label] = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for t in (kf, kb)]
        rec = {
            "kernel12_max_rel": rel(kf, pf), "kernel12_bit_equal_plain": bool(torch.equal(kf, pf)),
            "kernel13_max_rel": rel(kb, pb), "kernel13_twice_bit_equal": bool(torch.equal(kb, kb2)),
            "finite": bool(torch.isfinite(kf).all() and torch.isfinite(kb).all()),
            "sdpa_fwd_max_rel": rel(s_out.detach().transpose(1, 2).reshape(B, n, d), pf),
            "sdpa_bwd_max_rel": rel(sd_b, pb),
        }
        if compare:
            other = json.loads(Path(compare).read_text())[label]
            rec["kernel12_bit_equal_saved"] = outputs[label][0] == other[0]
            rec["kernel13_bit_equal_saved"] = outputs[label][1] == other[1]
            print(f"{label} B={B}: against {compare}: kernel 12 bit-equal {rec['kernel12_bit_equal_saved']}, "
                  f"kernel 13 bit-equal {rec['kernel13_bit_equal_saved']}", flush=True)
        for name, fn in calls.items():
            rec[name + "_device_ms"] = device_ms(fn)
            rec[name + "_events_ms"] = events_ms(fn)
        out[f"{label} B={B}"] = rec
        print(f"{label} B={B}: kernel 12 {rec['kernel12_device_ms']:.4f} ms (events "
              f"{rec['kernel12_events_ms']:.4f}), SDPA fwd {rec['sdpa_fwd_device_ms']:.4f}, plain "
              f"{rec['plain_fwd_device_ms']:.4f}; kernel 13 {rec['kernel13_device_ms']:.4f} (events "
              f"{rec['kernel13_events_ms']:.4f}), SDPA bwd {rec['sdpa_bwd_device_ms']:.4f}, plain "
              f"{rec['plain_bwd_device_ms']:.4f}; bf16 {rec['kernel12_bf16_device_ms']:.4f} / "
              f"{rec['kernel13_bf16_device_ms']:.4f}; max-rel {rec['kernel12_max_rel']:.2e} / "
              f"{rec['kernel13_max_rel']:.2e} (SDPA {rec['sdpa_fwd_max_rel']:.2e} / "
              f"{rec['sdpa_bwd_max_rel']:.2e}), bit-equal plain {rec['kernel12_bit_equal_plain']}, "
              f"twice {rec['kernel13_twice_bit_equal']}", flush=True)
    if save:
        Path(save).write_text(json.dumps(outputs))
    print(json.dumps(out), flush=True)
    return 0


# csrc/attn_f32.cuh's lines (the fp32 kernels attention.cu launches) that
# strip's copies change, and what to
STRIPS = {
    "no_loads": [("  if (vec) {\n    for (VecWalk w(threadIdx.x, blockDim.x, pl.HD4 / 4);",
                  "  if (pl.NP > 0) return;\n  if (vec) {\n    for (VecWalk w(threadIdx.x, blockDim.x, pl.HD4 / 4);")],
    "no_math": [(f"  for (int tile = threadIdx.x; tile < {t}; tile += blockDim.x) {{",
                 f"  for (int tile = threadIdx.x + (1 << 30); tile < {t}; tile += blockDim.x) {{")
                for t in ("RG * KG", "RG * CG", "KG * CG")]
               + [("  for (int k = 0; k < rounds; ++k) {", "  for (int k = rounds; k < rounds; ++k) {")],
    "no_softmax": [("  for (int k = 0; k < rounds; ++k) {", "  for (int k = rounds; k < rounds; ++k) {")],
}


def strip(args: list) -> int:
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if not torch.cuda.is_available():
        print("attn_f32_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    csrc = cuda_build.CSRC
    source = (csrc / "attn_f32.cuh").read_text()
    work = cuda_build.BUILD_DIR / "attn_f32_strip"
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    def build(name):
        text = source
        for old, new in STRIPS.get(name, []):
            if old not in text:
                raise SystemExit(f"strip {name}: csrc/attn_f32.cuh no longer holds {old!r}")
            text = text.replace(old, new)
        # the stripped header beside a copy of attention.cu, which includes it
        # from its own directory first
        var = work / name
        var.mkdir(exist_ok=True)
        (var / "attn_f32.cuh").write_text(text)
        (var / "attention.cu").write_text((csrc / "attention.cu").read_text())
        lib = work / f"lib{name}.so"
        flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([cuda_build._nvcc(), *flags, "-I", str(csrc), "-o", str(lib), str(var / "attention.cu")],
                       check=True, capture_output=True)
        return lib

    names = ["as_shipped", *STRIPS]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    entries = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.sky_attention_fwd_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.sky_attention_bwd_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        entries[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi}
    for label, B, n, d, h in SHAPES:
        qkv = torch.randn(B, n, 3 * d, generator=gen, device="cuda")
        dctx = torch.randn(B, n, d, generator=gen, device="cuda")
        ctx, dqkv = torch.empty(B, n, d, device="cuda"), torch.empty_like(qkv)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, lib in entries.items():
            calls[(name, "kernel12")] = lambda lib=lib: lib.sky_attention_fwd_f32(
                qkv.data_ptr(), ctx.data_ptr(), B, n, d, h, stream)
            calls[(name, "kernel13")] = lambda lib=lib: lib.sky_attention_bwd_f32(
                qkv.data_ptr(), dctx.data_ptr(), dqkv.data_ptr(), B, n, d, h, stream)
        times = {key: [] for key in calls}
        for rnd in range(4):
            for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                fn = calls[key]
                if fn() != 0:
                    raise SystemExit(f"strip {key}: launch failed")
                torch.cuda.synchronize()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(20):
                    fn()
                e.record()
                e.synchronize()
                times[key].append(s.elapsed_time(e) / 20)
        rec = {f"{name} {kernel}": min(t) for (name, kernel), t in times.items()}
        out[f"{label} B={B}"] = rec
        print(f"{label} B={B}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in rec.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def emulate(args: list) -> int:
    import numpy as np
    import torch

    batch = _arg(args, "--batch", 8)
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels.attention import attention_plain

    try:  # JAX's reference, where JAX is installed (on the CPU only)
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sky_embeddings_tpu.ops.kernels.attention import xla_attention
    except ImportError:
        xla_attention = None

    def tf32(x):  # round to nearest, ties away, 10 explicit mantissa bits
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    def mm_3xtf32(a, b):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float64)
        for k0 in range(0, a.shape[-1], 8):
            ab, bb = tf32(a[..., k0:k0 + 8]), tf32(b[..., k0:k0 + 8, :])
            as_, bs = tf32(a[..., k0:k0 + 8] - ab), tf32(b[..., k0:k0 + 8, :] - bb)
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                acc = (acc + x.double() @ y.double()).float().double()
        return acc.float()

    def mm_fma(a, b):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float64)
        ad, bd = a.double(), b.double()
        for k in range(a.shape[-1]):
            acc = (acc + ad[..., :, k:k + 1] * bd[..., k:k + 1, :]).float().double()
        return acc.float()

    def attention(qkv, dctx, h, mm):
        B, n, w = qkv.shape
        q, k, v = qkv.reshape(B, n, 3, h, w // 3 // h).permute(2, 0, 3, 1, 4).unbind(0)
        dc = dctx.reshape(B, n, h, w // 3 // h).transpose(1, 2)
        scale = float(np.float32(1 / np.sqrt(np.float32(q.shape[-1]))))
        p = torch.softmax(mm(q, k.transpose(-1, -2)) * scale, -1)
        ctx = mm(p, v).transpose(1, 2).reshape(B, n, w // 3)
        dp = mm(dc, v.transpose(-1, -2))
        ds = (dp * p - p * (dp * p).sum(-1, keepdim=True)) * scale
        grads = (mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), dc))
        return ctx, torch.stack(grads, 2).permute(0, 3, 2, 1, 4).reshape(B, n, w)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    gen = torch.Generator().manual_seed(0)
    out = {}
    for label, _, n, d, h in SHAPES:
        B = batch if label == "vitb" else max(batch // 2, 1)
        qkv, dctx = torch.randn(B, n, 3 * d, generator=gen), torch.randn(B, n, d, generator=gen)
        (tf, tb), (ff, fb) = attention(qkv, dctx, h, mm_3xtf32), attention(qkv, dctx, h, mm_fma)
        rec = out[f"{label} B={B}"] = {"fwd_max_rel": rel(tf, ff), "bwd_max_rel": rel(tb, fb)}
        print(f"{label} B={B}: 3xTF32 against fp32 FMA chains, forward {rel(tf, ff):.3e}, backward "
              f"{rel(tb, fb):.3e} (bar {TOL_CORE_F32})", flush=True)
        plain = attention_plain(qkv, h)
        q, k, v = qkv.double().reshape(B, n, 3, h, d // h).permute(2, 0, 3, 1, 4).unbind(0)
        exact = (torch.softmax(q @ k.transpose(-1, -2) * (d // h) ** -0.5, -1) @ v).transpose(1, 2)
        rec["plain_vs_fp64"] = rel(plain.double(), exact.reshape(B, n, d))
        if xla_attention is not None:
            xla = torch.from_numpy(np.array(xla_attention(qkv.numpy(), h)))
            rec["plain_vs_xla"], rec["xla_vs_fp64"] = rel(plain, xla), rel(xla.double(), exact.reshape(B, n, d))
        print(f"{label} B={B}: the forward's plain version against " + ", ".join(
            f"{k.split('_vs_')[1]} {v:.3e}" for k, v in rec.items() if k.startswith("plain_vs"))
              + (f"; XLA against fp64 {rec['xla_vs_fp64']:.3e}" if "xla_vs_fp64" in rec else ""), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["emulate"]:
        sys.exit(emulate(argv[1:]))
    if argv[:1] == ["strip"]:
        sys.exit(strip(argv[1:]))
    sys.exit(card(argv))
