#!/usr/bin/env python3
"""Variants of kernel 8's first step, fc1 and dh of the MLP backward, timed
side by side on one CUDA card.

    python3 tools/mlp_bwd_variants.py [variants] [sweep] [pairs]

(all three sections when none is named).

Kernel 8 (``csrc/mlp_block_bwd.cu``) computes a = y @ W1 + b1 and dh = g @
W2ᵀ for each 128 x 128 hidden tile in one launch (the dual product of
``csrc/gemm_sm90.cuh``), whose epilogue writes da_c = bf16(dh · gelu'(a)),
h_c = bf16(gelu(a)) and db1's column sums. Each variant below is the
checked-in header with a few text substitutions (each must match once, or
the tool stops), built with the port's nvcc flags together with
``csrc/mlp_block_bwd.cu`` into its own library under
``csrc/build/variants/``:

- ``dual``: the header as checked in;
- ``dual_nomath``: the dual epilogue with GELU and GELU' replaced by the
  identity and one (what the erf-GELU math costs);
- ``dual_noepi``: no epilogue at all (the mainloop alone);
- ``two_launch``: the form the dual replaced, in two launches of the
  K-major-B group kernel: fc1 into fp32 ``a`` (M, F) (through a transposed
  copy of W1 made before the timing, no b1), then dh with an epilogue that
  reads ``a``, and writes da_c and h_c (packed into one 4-byte word per
  element, the bytes of the two bf16 arrays); db1's column sums left out;
- ``two_launch_full``: ``two_launch`` plus the two passes it leaves out,
  timed with PyTorch stand-ins: the transposed copy of W1 (or of its slab)
  it reads, made anew as each training step changes W1, and db1's column
  sums, one pass over an fp32 (M, F) array.

At ``mim_1`` B=64 and 512 (M = 65 B, D = 768, F = 3 072) and one ViT-H slab
(B=32, M = 66 B, D = 1 280, fs = 1 280) the outputs of ``dual`` and
``two_launch`` are held to the plain version (max|a-b|/max|b| <= 2e-2) and
every variant is timed with CUDA events over back-to-back launches of its C
entry on preallocated outputs. Then the sweep the group plan
(``csrc/gemm_sm90.cuh`` ``bwd_plan``) is held to, device time by
``torch.profiler``: dy through ``ops/kernels/gemm.gemm_bwd`` at every tile
width, and the weight-gradient group, dW1 and dW2 in one launch as kernels
8 and 9 run it (``ops/kernels/gemm.mlp_weight_grads``), at every tile width
and split counts 1 to 8 forced, beside the plan's own choice; at ``mim_1``
B=64 and 512, the MAE encoder (``bench_mae``: B=256 packed sequences of 68 tokens,
ViT-B) and decoder (B=1024 of 65 tokens, D = 512, F = 2 048) and a ViT-H
slab at B=32 and 256. Then, at the same shapes, the pairs: the group at
the plan's pick against each other candidate the plan weighs, in 10
alternating pairs of CUDA-event means over 20 launches, with how many
pairs the pick won. Prints one line per shape and a JSON line of every
time. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("variants", "sweep", "pairs")
PAIRS = 10

TWO_LAUNCH_EPILOGUE = '''  if (add) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (t & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (col < N && row < M) {
          uint2* at = reinterpret_cast<uint2*>(o + (size_t)row * ldo + col);
          const float2 a = *reinterpret_cast<const float2*>(at);
          float g0, g1, d0, d1;
          gelu_erf_and_grad(a.x, g0, d0);
          gelu_erf_and_grad(a.y, g1, d1);
          *at = make_uint2(pack_bf16x2(d[4 * j + 2 * h] * d0, g0),
                           pack_bf16x2(d[4 * j + 2 * h + 1] * d1, g1));
        }
      }
    }
    return;
  }'''

STORE_F32_ADD = '''  if (add) {
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
  }'''

VARIANTS = {
    "dual": [],
    "dual_nomath": [
        ("          gelu_erf_and_grad(da[4 * j + 2 * h] + b0, da[4 * j + 2 * h], grad0);\n"
         "          gelu_erf_and_grad(da[4 * j + 2 * h + 1] + b1, da[4 * j + 2 * h + 1], grad1);",
         "          da[4 * j + 2 * h] += b0;\n          da[4 * j + 2 * h + 1] += b1;\n"
         "          grad0 = 1.f;\n          grad1 = 1.f;"),
    ],
    "dual_noepi": [("      if (mw >= p.M) continue;\n", "      continue;\n")],
    "two_launch": [(STORE_F32_ADD, TWO_LAUNCH_EPILOGUE)],
}


def build(name: str) -> ctypes.CDLL:
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    src = (cuda_build.CSRC / "gemm_sm90.cuh").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: pattern not found once: {old[:60]!r}")
        src = src.replace(old, new)
    d = cuda_build.BUILD_DIR / "variants" / f"mlp_bwd_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d, ignore=shutil.ignore_patterns("build"))
    (d / "gemm_sm90.cuh").write_text(src)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
           str(d / "mlp_block_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for variant {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.sky_gemm_sm90_dual.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.sky_gemm_sm90_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.sky_gemm_sm90_dual.restype = lib.sky_gemm_sm90_bwd.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    sections = set(sys.argv[1:]) or set(SECTIONS)
    if sections - set(SECTIONS):
        print(f"sections: any of {' '.join(SECTIONS)}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import gemm as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs = {n: build(n) for n in VARIANTS} if "variants" in sections else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    out = {}
    if "variants" in sections:
        for label, M, D, F in (("mim_1 B=64", 64 * 65, 768, 3072), ("mim_1 B=512", 512 * 65, 768, 3072),
                               ("vith slab B=32", 32 * 66, 1280, 1280)):
            y = torch.randn(M, D, generator=gen, device=dev).to(bf)
            g = (0.1 * torch.randn(M, D, generator=gen, device=dev)).to(bf)
            w1 = (torch.randn(D, F, generator=gen, device=dev) * D ** -0.5).to(bf)
            w2 = (torch.randn(F, D, generator=gen, device=dev) * F ** -0.5).to(bf)
            b1 = torch.zeros(F, device=dev)  # the two-launch variant adds no b1
            w1t = w1.t().contiguous()
            want_da, want_h, _ = G.gemm_dual_plain(y, w1, b1, g, w2)
            da_c, h_c = torch.empty(M, F, dtype=bf, device=dev), torch.empty(M, F, dtype=bf, device=dev)
            part = torch.empty(-(-M // 64) * F, device=dev)
            db1 = torch.empty(F, device=dev)
            a32 = torch.empty(M, F, device=dev)
            ws = torch.empty(4, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            iters = 20 if M < 10000 else 5
            row = {}
            for name, lib in libs.items():
                if name == "two_launch":
                    fc1 = lambda: lib.sky_gemm_sm90_bwd(y.data_ptr(), w1t.data_ptr(), None, a32.data_ptr(),
                                                        ws.data_ptr(), 1, 4, M, F, D, 0, 0, 0, stream)
                    dh = lambda: lib.sky_gemm_sm90_bwd(g.data_ptr(), w2.data_ptr(), None, a32.data_ptr(),
                                                       ws.data_ptr(), 1, 9, M, F, D, 0, 0, 0, stream)
                    if fc1() or dh():
                        raise SystemExit("two_launch: launch failed")
                    torch.cuda.synchronize()
                    words = a32.view(torch.int32)  # (bf16 da, bf16 gelu) per element, low half first
                    got_da = (words << 16).view(torch.float32)
                    got_h = (words & -65536).view(torch.float32)
                    errs = (rel(got_da, want_da), rel(got_h, want_h))
                    call = lambda: (fc1(), dh())
                    row["two_launch_fc1"] = ms(fc1, iters)
                    row["two_launch_full"] = ms(lambda: (w1.t().contiguous(), fc1(), dh(), a32.sum(0)),
                                                iters)
                else:
                    call = lambda lib=lib: lib.sky_gemm_sm90_dual(
                        *(t.data_ptr() for t in (y, w1, b1, g, w2, da_c, h_c, part, db1)), M, F, D, stream)
                    if call():
                        raise SystemExit(f"{name}: launch failed")
                    torch.cuda.synchronize()
                    errs = (rel(da_c, want_da), rel(h_c, want_h)) if name == "dual" else (0.0, 0.0)
                if max(errs) > 2e-2:
                    raise SystemExit(f"{name} {label}: max-rel {max(errs):.3e} over 2e-2")
                row[name] = ms(call, iters)
            cells = (f"{n} {t:.4f} ms" for n, t in row.items())
            print(f"{label} (M={M}, D={D}, F={F}): " + " | ".join(cells), flush=True)
            out[label] = row
    sweep, pairs = {}, {}
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a trace now and then comes back without its kernels: take another
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            t = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")) / 1e3 / reps
            if t > 0:
                return t
        raise SystemExit("the profiler recorded no kernel in three traces")

    sweep_shapes = (("mim_1 B=64", 64 * 65, 768, 3072), ("mim_1 B=512", 512 * 65, 768, 3072),
                    ("mae encoder B=256", 256 * 68, 768, 3072),
                    ("mae decoder B=1024", 1024 * 65, 512, 2048),
                    ("vith slab B=32", 32 * 66, 1280, 1280), ("vith slab B=256", 256 * 66, 1280, 1280))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, M, D, F in sweep_shapes:
        y = torch.randn(M, D, generator=gen, device=dev).to(bf)
        g = torch.randn(M, D, generator=gen, device=dev).to(bf)
        da_c = torch.randn(M, F, generator=gen, device=dev).to(bf)
        h_c = torch.randn(M, F, generator=gen, device=dev).to(bf)
        w1 = torch.randn(D, F, generator=gen, device=dev).to(bf)
        dy_groups, dw_groups = G.mlp_bwd_groups(M, D, F)
        if "sweep" in sections:
            row = {}
            for bn in G.BNS:
                row[f"dy bn={bn}"] = device_ms(lambda: G.gemm_bwd(da_c, w1, "nt", "store_f32", bn=bn))
                for sp in (1, 2, 3, 4, 6, 8):  # the plan offers 1 and 2
                    row[f"dW bn={bn} s={sp}"] = device_ms(
                        lambda: G.mlp_weight_grads(y, da_c, h_c, g, bn=bn, splits=sp))
            row["dy plan"] = device_ms(lambda: G.gemm_bwd(da_c, w1, "nt", "store_f32"))
            row["dW plan"] = device_ms(lambda: G.mlp_weight_grads(y, da_c, h_c, g))
            plans = {"dy": G.bwd_plan_cuda(dy_groups, sms)[0],
                     "dW": G.bwd_plan_cuda(dw_groups, sms)[0]}
            cells = []
            for p in ("dy", "dW"):
                t, k = min((t, k) for k, t in row.items() if k.startswith(p + " bn"))
                cells.append(f"{p}: fastest {k} {t:.4f} ms, plan bn={plans[p].bn} "
                             f"s={plans[p].splits} {row[p + ' plan']:.4f} ms")
            print(f"sweep {label}: " + "; ".join(cells), flush=True)
            row["plans"] = {p: [v.bn, v.splits] for p, v in plans.items()}
            sweep[label] = row
        if "pairs" in sections:
            # the plan's pick against each other candidate it weighs, in
            # PAIRS alternating pairs of CUDA-event means over 20 launches
            plan = G.bwd_plan_cuda(dw_groups, sms)[0]
            pick = (plan.bn, plan.splits)
            res = {}
            for rival in ((bn, sp) for bn in G.BNS for sp in G.SPLIT_CANDIDATES):
                if rival == pick:
                    continue
                runs = {pick: [], rival: []}
                for i in range(PAIRS):
                    for bn, sp in ((pick, rival) if i % 2 == 0 else (rival, pick)):
                        runs[(bn, sp)].append(ms(
                            lambda: G.mlp_weight_grads(y, da_c, h_c, g, bn=bn, splits=sp), 20))
                wins = sum(a < b for a, b in zip(runs[pick], runs[rival]))
                res[f"bn={rival[0]} s={rival[1]}"] = {
                    "plan_ms": runs[pick], "rival_ms": runs[rival], "plan_wins": wins}
            print(f"pairs {label}: plan bn={pick[0]} s={pick[1]} median "
                  f"{statistics.median(next(iter(res.values()))['plan_ms']):.4f} ms; " + "; ".join(
                      f"{k} {statistics.median(v['rival_ms']):.4f} (plan faster {v['plan_wins']}/"
                      f"{PAIRS})" for k, v in res.items()), flush=True)
            pairs[label] = {"plan": list(pick), "rivals": res}
    print(json.dumps({"device": smi, "ms": out, "sweep_device_ms": sweep, "pairs_ms": pairs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
