#!/usr/bin/env python3
"""Device time of the LayerNorm backward inside kernels 3 and 8, for one
checkout of the port, on one CUDA card.

    python3 tools/ln_bwd_ab.py [TREE] [--f32]

TREE is the root of a checkout (default: this one); its
``sky_embeddings_tpu_torch`` is imported and its kernels built there. Two
checkouts are compared by running the tool once per checkout in turns
(A, B, B, A) in one call, since a card below its power limit runs slower
under load. Cases, each on random inputs from a seed:

- bf16 kernel 8 (``mlp_block_bwd``) and kernel 3 (``attn_block_bwd_stash``,
  its stash from kernel 2) at ``mim_1`` B=512 (N = 65, D = 768, F = 3 072,
  12 heads);
- with ``--f32``, their fp32 forms at ``cls_fs_1k`` B=256 (N = 66).

For each case it prints one JSON line: the device time of one call and of
its ``ln_bwd_kernel`` launches (``torch.profiler``, summed over 20 calls),
and the CUDA events' time of one call. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch


def main(argv: list[str]) -> int:
    tree = Path(next((a for a in argv if not a.startswith("--")), Path(__file__).parents[1]))
    sys.path.insert(0, str(tree.resolve()))
    from torch.profiler import ProfilerActivity, profile

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as mb

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape, dt=torch.float32, s=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * s).to(dt)

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = ln = 0.0
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                    or getattr(e, "is_user_annotation", False):
                continue
            t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            total += t
            ln += t if "ln_bwd" in e.key else 0.0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"device_ms": total / 1e3 / reps, "ln_bwd_ms": ln / 1e3 / reps,
                "events_ms": start.elapsed_time(end) / reps}

    cases = [("bf16 mim_1 B=512", torch.bfloat16, 512, 65)]
    if "--f32" in argv:
        cases.append(("fp32 cls_fs_1k B=256", torch.float32, 256, 66))
    D, F, H = 768, 3072, 12
    for label, dt, B, N in cases:
        x = rn(B, N, D, dt=dt)
        g = rn(B, N, D, dt=dt, s=0.1)
        scale, bias = 1 + rn(D, s=0.1), rn(D, s=0.1)
        w1, b1 = rn(D, F, dt=dt, s=D ** -0.5), rn(F, s=0.1)
        w2 = rn(F, D, dt=dt, s=F ** -0.5)
        wqkv, bqkv = rn(D, 3 * D, dt=dt, s=D ** -0.5), rn(3 * D, s=0.1)
        wproj, bproj = rn(D, D, dt=dt, s=D ** -0.5), rn(D, s=0.1)
        _, qkv, probs = ab.attn_block_fwd_stash(x, scale, bias, wqkv, bqkv, wproj, bproj, H)
        row = {"tree": str(tree), "case": label,
               "kernel 8": timed(lambda: mb.mlp_block_bwd(x, scale, bias, w1, b1, w2, g)),
               "kernel 3": timed(lambda: ab.attn_block_bwd_stash(x, scale, bias, wqkv, wproj,
                                                                 qkv, probs, g, H))}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
