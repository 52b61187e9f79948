#!/usr/bin/env python3
"""The tensor-parallel backward forms of kernels 4 and 8, launch by launch,
on one CUDA card.

    python3 tools/tp_bwd_breakdown.py [TREE ...]

For each tree (a checkout of the repository; the one this file lies in when
none is named), in the order given, a process of its own imports that
tree's ``sky_embeddings_tpu_torch`` and times one rank's backward call of
each form, its half and its finish (``attn_block_tp_bwd`` then
``attn_block_tp_bwd_finish``; ``mlp_block_tp_bwd`` then
``mlp_block_tp_bwd_finish``), in bf16 on a rank's shard at tensor_parallel
= 2 at the shapes ``chip_smoke.py`` times them (``TP_TIMED``): ``mim_32``
(B=32, N=66, D=1 024, 8 local heads of 64, F/2 = 2 048) and
``jepa_struct``'s ViT-S encoder (B=256, N=64, D=384, 3 local heads of 64,
F/2 = 768). For each call it prints:

- the device µs of each launch, in launch order, from ``torch.profiler``
  (the mean over 20 calls), and their sum;
- the call's CUDA-event ms (the mean over 50 back-to-back calls);
- the host µs a call takes to enqueue (the least of 5 means of 20 calls,
  no synchronisation inside);
- ``paced``: "host" where the event time is more than 1.5x the device sum,
  else "device".

Where the tree has ``gemm.gemm_bwd_group``, it also times, by device
time, the weight-gradient group of each form alone (the plan's schedule,
and the split schedule forced at 1 and 2 slices), and each of GROUPS (the
forms' ViT-S groups, ``jepa_struct``'s whole kernel 3 and 8 groups and a
group of the card sweep's, ``mim_1`` B=64's kernel 8) under the plan, the
split schedule at 1 and 2 slices, stream-K at each tile width and the
split schedule forced at 4, 6 and 8 slices at BN 128 and 192, each warm
(back to back) and cold (L2 flushed by a 128 MB fill before each launch,
the fill's time left out). Give the same tree twice, around
another, to read the spread (parent, change, change, parent). One JSON
line a tree, then a table. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (tag, B, N, D, local heads, head width, local MLP width): one rank's shard
SHAPES = (("mim_32", 32, 66, 1024, 8, 64, 2048), ("jepa_struct", 256, 64, 384, 3, 64, 768))
PACED = 1.5
# (label, [(M, N, K), ...]) weight-gradient groups timed alone
GROUPS = (("4 TP jepa_struct", [(384, 576, 16384), (192, 384, 16384)]),
          ("8 TP jepa_struct", [(384, 768, 16384), (768, 384, 16384)]),
          ("kernel 3 jepa_struct", [(384, 1152, 16384), (384, 384, 16384)]),
          ("kernel 8 jepa_struct", [(384, 1536, 16384), (1536, 384, 16384)]),
          ("kernel 8 mim_1 B=64", [(768, 3072, 4160), (3072, 768, 4160)]))


def _kernel_rows(prof, reps):
    """Device µs of each launch of one call, in launch order: the kernels
    of ``reps`` calls split into ``reps`` equal runs and averaged by
    position."""
    evs = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)]
    evs.sort(key=lambda e: e.time_range.start)
    if not evs or len(evs) % reps:
        return None
    per = len(evs) // reps
    rows = []
    for i in range(per):
        us = [evs[r * per + i].time_range.elapsed_us() for r in range(reps)]
        rows.append([evs[i].name[:90], sum(us) / reps])
    return rows


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sky_embeddings_tpu_torch.ops.kernels import attn_block as ab
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build, gemm
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as mb

    cuda_build.build(["attn_block_tp", "mlp_block_bwd"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    bf = torch.bfloat16

    def rnd(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dt)

    def events_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

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

    def by_launch(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return _kernel_rows(prof, reps)

    out = {"tree": tree, "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
           "shapes": {}}
    for tag, B, N, D, Hl, hd, Fl in SHAPES:
        Dl, M = Hl * hd, B * N
        x, g = rnd(B, N, D, s=0.5, dt=bf), rnd(B, N, D, s=0.1, dt=bf)
        scale, bias = 1 + rnd(D, s=0.1), rnd(D, s=0.1)
        attn = (rnd(D, 3 * Dl, s=D ** -0.5, dt=bf), rnd(3 * Dl, s=0.01), rnd(Dl, D, s=D ** -0.5, dt=bf))
        mlp = (rnd(D, Fl, s=D ** -0.5, dt=bf), rnd(Fl, s=0.01), rnd(Fl, D, s=Fl ** -0.5, dt=bf))
        calls = {
            "attn_block_tp_bwd": lambda: ab.attn_block_tp_bwd_finish(
                x, scale, bias, g, ab.attn_block_tp_bwd(x, scale, bias, *attn, g, Hl)[0]),
            "mlp_block_tp_bwd": lambda: mb.mlp_block_tp_bwd_finish(
                x, scale, bias, g, mb.mlp_block_tp_bwd(x, scale, bias, *mlp, g)[0]),
        }
        groups = {"attn_block_tp_bwd": [((M, D), (M, 3 * Dl)), ((M, Dl), (M, D))],
                  "mlp_block_tp_bwd": [((M, D), (M, Fl)), ((M, Fl), (M, D))]}
        res = {}
        for name, fn in calls.items():
            rows = by_launch(fn)
            dev_sum = sum(us for _, us in rows) if rows else None
            ev = events_ms(fn)
            r = {"launches": rows, "device_sum_us": dev_sum, "event_ms": ev,
                 "host_us": host_us(fn),
                 "paced": None if dev_sum is None else
                 ("host" if ev * 1e3 > PACED * dev_sum else "device")}
            if hasattr(gemm, "gemm_bwd_group"):
                ops = [(rnd(*sa, dt=bf), rnd(*sb, dt=bf)) for sa, sb in groups[name]]
                r["group"] = {}
                for label, kw in (("plan", {}), ("split 1", {"splits": 1}),
                                  ("split 2", {"splits": 2})):
                    rows_g = by_launch(lambda: gemm.gemm_bwd_group(ops, **kw))
                    r["group"][label] = {
                        "plan": str(gemm.gemm_bwd_group_plan(ops, **kw)[0]),
                        "device_us": sum(us for _, us in rows_g) if rows_g else None}
            res[name] = r
            torch.cuda.empty_cache()
        out["shapes"][tag] = res
    if hasattr(gemm, "gemm_bwd_group"):
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        out["groups"] = {}
        for label, dims in GROUPS:
            ops = [(rnd(K, M, dt=bf), rnd(K, N, dt=bf)) for M, N, K in dims]
            cases = [("plan", {}), ("split 1", {"splits": 1}), ("split 2", {"splits": 2})]
            cases += [(f"stream_k {bn}", {"bn": bn, "schedule": "stream_k"}) for bn in gemm.BNS]
            cases += [(f"split {sp} at {bn}", {"bn": bn, "splits": sp})
                      for bn in (128, 192) for sp in (4, 6, 8)]
            res = {}
            for case, kw in cases:
                rows_g = by_launch(lambda: gemm.gemm_bwd_group(ops, **kw))
                # cold: L2 flushed before each launch (a 128 MB fill); only
                # the group's own kernels summed
                rows_c = by_launch(lambda: (flush.zero_(), gemm.gemm_bwd_group(ops, **kw)))
                res[case] = {"plan": str(gemm.gemm_bwd_group_plan(ops, **kw)[0]),
                             "device_us": sum(us for _, us in rows_g) if rows_g else None,
                             "cold_device_us": sum(us for n, us in rows_c or [] if "sky::" in n)
                             or None}
            out["groups"][label] = res
            torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    results, status = [], 0
    for tree in [os.path.abspath(t) for t in argv or [HERE]]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            print(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}",
                  flush=True)
            status = 1
            continue
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print(json.dumps(res), flush=True)
    for res in results:
        for tag, forms in res["shapes"].items():
            for name, r in forms.items():
                print(f"{res['tree']} {tag} {name}: event {r['event_ms']:.4f} ms, device sum "
                      f"{r['device_sum_us']} us, host {r['host_us']:.1f} us a call, paced "
                      f"{r['paced']}", flush=True)
                for kname, us in r["launches"] or []:
                    print(f"    {us:9.2f} us  {kname}", flush=True)
                for label, gr in r.get("group", {}).items():
                    print(f"    group {label}: {gr['plan']} {gr['device_us']} us", flush=True)
        for label, cases in res.get("groups", {}).items():
            for case, gr in cases.items():
                print(f"{res['tree']} group {label} {case}: {gr['device_us']} us, cold "
                      f"{gr['cold_device_us']} us {gr['plan']}", flush=True)
    print(smi, flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
