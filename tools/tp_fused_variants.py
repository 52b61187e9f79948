#!/usr/bin/env python3
"""Variants of K2 TP's fused forward half (``attn_tp_fused_kernel`` in
``csrc/attn_block_tp.cu``), timed side by side on one CUDA card.

    python3 tools/tp_fused_variants.py [--variants as_is,no_mma,...] [--out DIR]

Each variant is the checked-in package with a few text substitutions in its
CUDA source (each must match, or the tool stops), copied under DIR
(default ``csrc/build/tp_fused_variants/``, listed in ``.gitignore``) and
built there by its own ``cuda_build`` (all variants' nvcc at once). Most
variants drop a piece of work to show what it costs, so their outputs are
wrong; they are probes of where the time goes, not candidates:

- ``as_is``: the source as checked in;
- ``no_mma`` / ``no_core``: without the qkv and proj wgmma, or without the
  attention core;
- ``same_box``: every weight box loaded from the weights' first 64 x 64
  box, which stays in L2 (the stream's bytes and latency from L2 without
  its spread over the weights).

At jepa_struct's ViT-S shard at tensor_parallel = 2 (B = 256, N = 64, D =
384, 3 local heads of 64), each variant's process times the fused half:
the kernel's device µs a launch (torch.profiler, 20 launches) and the
CUDA-event ms a call (50 back-to-back calls), and, for ``as_is``, whether
the half equals the chain bit for bit. Prints one line per variant and a
JSON line of every number, with the card's name and power limit. Needs the
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("sky_embeddings_tpu_torch", "ops", "kernels", "csrc")

# variant: [(file under csrc, old text, new text), ...]
VARIANTS = {
    "as_is": [],
    "no_mma": [("attn_block_tp.cu",
                "      wgmma_n192<0, 1>(acc, smem_desc(a + kb * RB_BOX + kk * 32, 16, 1024),\n"
                "                       smem_desc(sb + kk * 16 * 128, RB_BOX, 1024), "
                "(kb | kk) != 0);",
                "      ;")],
    "no_core": [("attn_block_tp.cu", "          if (w < nk) {", "          if (w < 0) {")],
    "same_box": [("attn_block_tp.cu",
                  "  tma_load_2d(base + s * RB_BOX, map, full + 8 * s, c0, c1);",
                  "  tma_load_2d(base + s * RB_BOX, map, full + 8 * s, 0, 0);")],
}
# B, N, D, local heads: one rank's ViT-S shard
SHAPE = (256, 64, 384, 3)


def make_tree(out: str, name: str) -> str:
    """The package with the variant's substitutions, under out/name."""
    tree = os.path.join(out, name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "sky_embeddings_tpu_torch"),
                    os.path.join(tree, "sky_embeddings_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(tree, CSRC, fname)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace in {fname} does not match once")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return tree


def one(tree: str, name: str) -> dict:
    """Times the fused half of the package at ``tree`` (this process)."""
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab

    B, N, D, Hl = SHAPE
    Dl = 64 * Hl
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dt)

    x = rnd(B, N, D, s=0.5, dt=bf)
    scale, bias = 1 + rnd(D, s=0.1), rnd(D, s=0.1)
    attn = (rnd(D, 3 * Dl, s=D ** -0.5, dt=bf), rnd(3 * Dl, s=0.01),
            rnd(Dl, D, s=D ** -0.5, dt=bf))
    fn = lambda: ab.attn_block_tp_fwd(x, scale, bias, *attn, Hl)  # noqa: E731
    got = fn()
    same = bool(torch.equal(got, ab.attn_block_tp_fwd_chain(x, scale, bias, *attn, Hl))) \
        if name == "as_is" else None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(50):
        fn()
    b.record()
    b.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.events() if "attn_tp_fused_kernel" in e.name]
    us = sum(e.time_range.elapsed_us() for e in recs) / len(recs) if recs else None
    return {"variant": name, "device_us": us, "event_ms": a.elapsed_time(b) / 50,
            "chain_bit_equal": same}


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=os.path.join(ROOT, CSRC, "build", "tp_fused_variants"))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {n: make_tree(args.out, n) for n in names}
    build = "from sky_embeddings_tpu_torch.ops.kernels import cuda_build; " \
            "cuda_build.build(['attn_block_tp'])"
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=t, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n, t in trees.items()}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}: build failed\n{log[-3000:]}")
    results = []
    for n in names:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", trees[n], n],
                              capture_output=True, text=True, cwd=trees[n])
        if proc.returncode:
            print(f"{n}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            continue
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(r)
        print(f"{n:10s} attn_block_tp_fwd: device {r['device_us']} us a launch, event "
              f"{r['event_ms']:.4f} ms a call, chain bit-equal {r['chain_bit_equal']}",
              flush=True)
    print(json.dumps({"device": smi, "shape": SHAPE, "variants": results}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
