#!/usr/bin/env python3
"""What data parallelism costs a step on one card, by DDP setting.

    python3 tools/ddp_variants.py [--turns 2] [--steps 10]

Times the ``mim_1`` trainer (bf16 ViT-B, B=64) with no process group and,
under a world-1 NCCL group (``parallel/distributed.initialize_from_env``),
wrapped in DDP four ways: as the trainers wrap it
(``find_unused_parameters``), with ``static_graph`` instead, and each with
``gradient_as_bucket_view``; then with ZeRO-1 on the trainers' wrap. Each
runs ``--steps`` steps a turn, the variants in turns (forward, then
backward order), wall ms a step with the device drained at both ends; the
profiler's device ms a step after every turn. Then the host cost of the
byte tensor that ``ZeroRedundancyOptimizer.consolidate_state_dict`` builds
from a rank's pickled state (``torch.ByteTensor`` of the pickle's
``bytearray``), for half of ``mim_1``'s moments, beside
``parallel/zero.consolidate`` at world 1. Prints one JSON line; needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "find_unused": dict(find_unused_parameters=True),
    "static_graph": dict(static_graph=True),
    "find_unused_bucket_view": dict(find_unused_parameters=True, gradient_as_bucket_view=True),
    "static_graph_bucket_view": dict(static_graph=True, gradient_as_bucket_view=True),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ddp_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.nn.parallel import DistributedDataParallel
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build
    from sky_embeddings_tpu_torch.parallel import distributed, zero

    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_build.build()
    dev = torch.device("cuda")
    batches = cs._dp_data("mim_1", args.steps, 31)

    def turn(tr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            tr.train_batch(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / args.steps

    none = cs._dp_trainer("mim_1", dev, zero_on=False)
    turn(none)
    walls = {"none": [turn(none)]}
    os.environ.update({distributed.ENV_FLAG: "1", distributed.ENV_COORD: f"127.0.0.1:{cs.free_port()}",
                       distributed.ENV_NPROC: "1", distributed.ENV_PID: "0"})
    if not distributed.initialize_from_env() or torch.distributed.get_backend() != "nccl":
        raise SystemExit("ddp_variants: a world-1 NCCL group did not start")
    trainers = {}
    wrap = distributed.data_parallel
    for name, kw in VARIANTS.items():
        sync = ("forward_sync_buffers" if "forward_sync_buffers"
                in DistributedDataParallel.__init__.__code__.co_varnames else "broadcast_buffers")
        distributed.data_parallel = lambda m, d, kw=kw: DistributedDataParallel(
            m, device_ids=[d], **{sync: False}, **kw)
        trainers[name] = cs._dp_trainer("mim_1", dev, zero_on=False)
    distributed.data_parallel = wrap
    trainers["find_unused_zero1"] = cs._dp_trainer("mim_1", dev, zero_on=True)
    for tr in trainers.values():
        turn(tr)  # warm: the first steps build DDP's buckets
    order = list(trainers)
    for t in range(args.turns):
        for name in (order if t % 2 == 0 else order[::-1]):
            walls.setdefault(name, []).append(turn(trainers[name]))
    device = {name: cs.profile_device_ms(lambda tr=tr: tr.train_batch(batches[0]), 3)
              for name, tr in trainers.items()}
    t0 = time.perf_counter()
    zero.consolidate(trainers["find_unused_zero1"].optimizer)
    consolidate_s = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    walls["none"].append(turn(none))
    device["none"] = cs.profile_device_ms(lambda: none.train_batch(batches[0]), 3)

    # the byte tensor of ZeRO's object broadcast, for half the moments
    params = list(none.model.parameters())
    half = {i: {k: none.optimizer.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq")}
            for i, p in enumerate(params[: len(params) // 2])}
    buf = io.BytesIO()
    t0 = time.perf_counter()
    torch.save(half, buf)
    pickle_s = time.perf_counter() - t0
    data = bytearray(buf.getbuffer())
    t0 = time.perf_counter()
    torch.ByteTensor(data)
    bytetensor_s = time.perf_counter() - t0
    res = {"device": smi, "steps_a_turn": args.steps, "wall_ms_per_step": walls,
           "median_wall_ms": {k: float(np.median(v)) for k, v in walls.items()},
           "device_ms_per_step": device, "zero_consolidate_world1_s": consolidate_s,
           "zero_object_broadcast": {"bytes": len(data), "pickle_s": pickle_s,
                                     "bytetensor_s": bytetensor_s}}
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
