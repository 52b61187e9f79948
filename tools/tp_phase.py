#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 5l (tensor parallelism) alone, on one card.

    python3 tools/tp_phase.py

Builds the kernels from the checkout (``ops/kernels/cuda_build.build``),
then runs ``chip_smoke.tp_phase`` with ``main``'s timing helpers: the TP
forms against the unsharded plain block at every ``TP_SHAPES`` shape, each
``TP_LEGS`` config at ``tensor_parallel = 2`` on two ``--tp-worker``
processes against one process, and the ``TP_CKPT`` saves. Prints the
``nvidia-smi`` name and power line, the phase's check and result lines,
then one JSON line of the forms' timings and the phase's results, and
exits non-zero if a check failed (``chip_smoke.check``). About three
minutes after the build; needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_phase: needs a CUDA card", file=sys.stderr)
        return 2
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    def rel_err(a, b):
        a, b = a.float(), b.float()
        d = float((a - b).abs().max())
        return d / (float(b.abs().max()) + 1e-12), d

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

    def bound_ms(flops, nbytes, peak):
        t_ops, t_bytes = flops / peak * 1e3, nbytes / cs.PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    timings: dict = {}
    t0 = time.perf_counter()
    out = cs.tp_phase(torch.device(cs.DEVICE), *cs.counter_fns(), timings, cuda_ms, rel_err,
                      bound_ms, smi)
    seconds = time.perf_counter() - t0
    print(smi, flush=True)
    cs.emit({"tp_phase_s": seconds,
             "tp_form_times": [{"name": n, "shape": s_, **v} for (n, s_), v in timings.items()],
             "tensor_parallel": out})
    return 0


if __name__ == "__main__":
    sys.exit(main())
