#!/usr/bin/env python3
"""The products of kernels 3 and 4 (the attention block's backwards) at
forced tile widths and split counts, timed side by side on one CUDA card.

    python3 tools/attn_bwd_variants.py [sweep] [pairs] [cores] [--tree DIR]

(sweep and pairs when none is named).

Kernels 3 and 4 (``csrc/attn_block_bwd.cu``) run three launches of the
group kernel of ``csrc/gemm_sm90.cuh``: dctx = g @ Wprojᵀ (K-major B, bf16
out), dy = dqkv_c @ Wqkvᵀ (K-major B, fp32 out), and dWqkv = yᵀ @ dqkv_c
with dWproj = ctxᵀ @ g in one transposed-A group, K = B·N token rows split
into slices where the group plan (``bwd_plan``) says. The sweep times,
with ``torch.profiler``'s device time, dctx and dy through
``ops/kernels/gemm.gemm_bwd`` at every tile width, and the weight-gradient
group as the kernels launch it (``ops/kernels/gemm.attn_weight_grads``) at
every tile width and split counts 1 to 4 forced, beside the plan's own
choice, at ``mim_1`` B=64 and 512 (N = 65, D = 768), ``mim_32`` B=32 (N =
66, D = 1024), ViT-H B=256 (N = 66, D = 1280) and the MAE encoder's packed
B=256 (N = 68, D = 768); each group reading is first held to its plain
version (max|a-b|/max|b| <= 2e-2). The pairs: at the same shapes, the group
at the plan's pick against each other candidate the plan weighs (tile
widths 256, 192, 128 by split counts 1, 2), in 10 alternating pairs of
CUDA-event means over 20 launches, with how many pairs the pick won. The
cores: kernels 3 and 4 (``attn_block_bwd_stash``, ``attn_block_bwd``) at
``mim_1`` B=64 and 512 and ViT-H B=256 and kernel 13
(``fused_attention_bwd``) at ViT-B B=1024, each call's CUDA-event time
and its device time by kernel name, from the package in ``--tree`` (a
checkout of another commit, for an A/B in one call; the repo by default).
Prints the card's name and power limit, one line per shape and a JSON line
of every time. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("sweep", "pairs", "cores")
PAIRS = 10
SPLITS = (1, 2, 3, 4)  # the plan offers 1 and 2
SHAPES = (("mim_1 B=64", 64 * 65, 768), ("mim_1 B=512", 512 * 65, 768),
          ("mim_32 B=32", 32 * 66, 1024), ("vith B=256", 256 * 66, 1280),
          ("mae encoder B=256", 256 * 68, 768))


def main() -> int:
    import torch

    args = sys.argv[1:]
    tree = ROOT
    if "--tree" in args:
        at = args.index("--tree")
        tree = Path(args[at + 1]).resolve()
        del args[at:at + 2]
    sections = set(args) or {"sweep", "pairs"}
    if sections - set(SECTIONS):
        print(f"sections: any of {' '.join(SECTIONS)} [--tree DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    from torch.profiler import ProfilerActivity, profile

    from sky_embeddings_tpu_torch.ops.kernels import gemm as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

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

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    def by_kernel(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    cores = {}
    if "cores" in sections:
        from sky_embeddings_tpu_torch.ops.kernels import attention as T
        from sky_embeddings_tpu_torch.ops.kernels import attn_block as A

        for label, B, N, D, H in (("mim_1 B=64", 64, 65, 768, 12), ("mim_1 B=512", 512, 65, 768, 12),
                                  ("vith B=256", 256, 66, 1280, 16)):
            x = (0.5 * torch.randn(B, N, D, generator=gen, device=dev)).to(bf)
            g = (0.1 * torch.randn(B, N, D, generator=gen, device=dev)).to(bf)
            sc = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
            bi = 0.1 * torch.randn(D, generator=gen, device=dev)
            wq = (torch.randn(D, 3 * D, generator=gen, device=dev) * D ** -0.5).to(bf)
            bq = 0.01 * torch.randn(3 * D, generator=gen, device=dev)
            wp = (torch.randn(D, D, generator=gen, device=dev) * D ** -0.5).to(bf)
            bp = 0.01 * torch.randn(D, generator=gen, device=dev)
            _, qkv, probs = A.attn_block_fwd_stash(x, sc, bi, wq, bq, wp, bp, H)
            iters = 10 if B * N < 10000 else 3
            calls = {"kernel 3": lambda: A.attn_block_bwd_stash(x, sc, bi, wq, wp, qkv, probs, g, H),
                     "kernel 4": lambda: A.attn_block_bwd(x, sc, bi, wq, bq, wp, g, H)}
            for name, call in calls.items():
                rec = {"ms": ms(call, iters), "by_kernel": by_kernel(call, iters)}
                cores[f"{name} {label}"] = rec
                print(f"cores {name} {label}: {rec['ms']:.4f} ms; " + "; ".join(
                    f"{k} {v:.4f}" for k, v in sorted(rec["by_kernel"].items(), key=lambda t: -t[1])),
                    flush=True)
            del x, g, qkv, probs
        qkv = torch.randn(1024, 65, 3 * 768, generator=gen, device=dev).to(bf)
        dctx = torch.randn(1024, 65, 768, generator=gen, device=dev).to(bf)
        call = lambda: T.fused_attention_bwd(qkv, dctx, 12)
        cores["kernel 13 vitb B=1024"] = {"ms": ms(call, 20), "by_kernel": by_kernel(call, 20)}
        print(f"cores kernel 13 vitb B=1024: {cores['kernel 13 vitb B=1024']['ms']:.4f} ms", flush=True)
        del qkv, dctx

    sweep, pairs = {}, {}
    for label, M, D in (SHAPES if sections & {"sweep", "pairs"} else ()):
        y = torch.randn(M, D, generator=gen, device=dev).to(bf)
        ctx = torch.randn(M, D, generator=gen, device=dev).to(bf)
        g = (0.1 * torch.randn(M, D, generator=gen, device=dev)).to(bf)
        dq = (0.1 * torch.randn(M, 3 * D, generator=gen, device=dev)).to(bf)
        wq = (torch.randn(D, 3 * D, generator=gen, device=dev) * D ** -0.5).to(bf)
        wp = (torch.randn(D, D, generator=gen, device=dev) * D ** -0.5).to(bf)
        groups = G.attn_bwd_groups(M, D)
        plans = [G.bwd_plan_cuda(gr, sms)[0] for gr in groups]
        want = (G.gemm_bwd_plain(y, dq, "tn", "store"), G.gemm_bwd_plain(ctx, g, "tn", "store"))
        if "sweep" in sections:
            row = {}
            for bn in G.BNS:
                row[f"dctx bn={bn}"] = device_ms(lambda: G.gemm_bwd(g, wp, "nt", "store", bn=bn))
                row[f"dy bn={bn}"] = device_ms(lambda: G.gemm_bwd(dq, wq, "nt", "store_f32", bn=bn))
                for sp in SPLITS:
                    got = G.attn_weight_grads(y, dq, ctx, g, bn=bn, splits=sp)
                    err = max(rel(a, b) for a, b in zip(got, want))
                    if err > 2e-2:
                        raise SystemExit(f"dW bn={bn} s={sp} {label}: max-rel {err:.3e} over 2e-2")
                    row[f"dW bn={bn} s={sp}"] = device_ms(
                        lambda: G.attn_weight_grads(y, dq, ctx, g, bn=bn, splits=sp))
            row["dctx plan"] = device_ms(lambda: G.gemm_bwd(g, wp, "nt", "store"))
            row["dy plan"] = device_ms(lambda: G.gemm_bwd(dq, wq, "nt", "store_f32"))
            row["dW plan"] = device_ms(lambda: G.attn_weight_grads(y, dq, ctx, g))
            cells = []
            for p, plan in zip(("dctx", "dy", "dW"), plans):
                t, k = min((t, k) for k, t in row.items() if k.startswith(p + " bn"))
                cells.append(f"{p}: fastest {k} {t:.4f} ms, plan bn={plan.bn} s={plan.splits} "
                             f"{row[p + ' plan']:.4f} ms")
            print(f"sweep {label} (M={M}, D={D}): " + "; ".join(cells), flush=True)
            row["plans"] = {p: [v.bn, v.splits] for p, v in zip(("dctx", "dy", "dW"), plans)}
            sweep[label] = row
        if "pairs" in sections:
            pick = (plans[2].bn, plans[2].splits)
            res = {}
            for rival in ((bn, sp) for bn in G.BNS for sp in G.SPLIT_CANDIDATES):
                if rival == pick:
                    continue
                runs = {pick: [], rival: []}
                for i in range(PAIRS):
                    for bn, sp in ((pick, rival) if i % 2 == 0 else (rival, pick)):
                        runs[(bn, sp)].append(ms(
                            lambda: G.attn_weight_grads(y, dq, ctx, g, bn=bn, splits=sp), 20))
                wins = sum(a < b for a, b in zip(runs[pick], runs[rival]))
                res[f"bn={rival[0]} s={rival[1]}"] = {
                    "plan_ms": runs[pick], "rival_ms": runs[rival], "plan_wins": wins}
            print(f"pairs {label}: plan bn={pick[0]} s={pick[1]} median "
                  f"{statistics.median(next(iter(res.values()))['plan_ms']):.4f} ms; " + "; ".join(
                      f"{k} {statistics.median(v['rival_ms']):.4f} (plan faster {v['plan_wins']}/"
                      f"{PAIRS})" for k, v in res.items()), flush=True)
            pairs[label] = {"plan": list(pick), "rivals": res}
        del y, ctx, g, dq, wq, wp, want
    print(json.dumps({"device": smi, "tree": str(tree), "sweep_device_ms": sweep, "pairs_ms": pairs,
                      "cores_ms": cores}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
