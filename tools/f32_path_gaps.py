#!/usr/bin/env python3
"""The fp32 predictor paths' kernel-vs-plain gaps of ``chip_smoke.py``
(phase 5d: ``lp_1``'s ``lp`` and ``cls_fs_1k``'s ``fs``), with nothing else
of that script, over ``mim_1`` checkpoints trained the way it trains one,
and the fp32 GEMM's signed error, for the checkout it runs in.

    python3 tools/f32_path_gaps.py [--data-seeds 3,1] [--large]

For each data seed, a ``mim_1`` trainer (bf16, seed 0) takes 20 steps and
4 validation batches on ``make_cutouts(24 x 64, seed)``, as
``chip_smoke.py``'s training phase does with seed 3, and saves its
checkpoint under ``models/``; then ``chip_smoke.predictor_f32_phase`` runs
``lp`` (warm-started from it) and ``fs`` and prints each route's gradient
gap (||a-b||/||b|| per leaf, its worst leaf and median) and loss gaps,
its checks logged instead of ending the run. Seed 3 reproduces
``chip_smoke.py``'s own checkpoint (the bf16 kernels that train it are
deterministic), so its lines are that script's; other seeds draw other
checkpoints of the same kind. ``--large`` then runs the large and tiny
routes of phase 5e (``cls_ft_1k_large``, ``z_ft_2``, ``z_tiny``: seeded
weights, no checkpoint) the same way. Before that, three products at ``lp_1``'s
and ``cls_fs_1k``'s widths: the kernel's signed bias against an fp64
product (the mean of the error toward the exact value's sign over its mean
magnitude), its RMS and largest error, beside fp32 ``torch.mm``'s. To
compare GEMM designs, run it from each tree (``git archive`` copies).
Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path.cwd()


def main(argv: list) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sky_embeddings_tpu_torch.configuration import load_config
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build
    from sky_embeddings_tpu_torch.ops.kernels import gemm as G
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    seeds = [3, 1]
    if "--data-seeds" in argv:
        seeds = [int(v) for v in argv[argv.index("--data-seeds") + 1].split(",")]
    if not torch.cuda.is_available():
        print("f32_path_gaps: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build()
    cs.check = lambda ok, what: None if ok else print(f"CHECK FAILED: {what}", flush=True)

    gen = torch.Generator("cuda").manual_seed(0)
    for name, M, N, K in (("qkv", 8320, 2304, 768), ("fc2", 8320, 768, 3072),
                          ("dy_mlp", 16896, 768, 3072)):
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen) * K ** -0.5
        got = G.gemm_f32(a, b, "fwd", "bias", torch.zeros(N, device="cuda"))[0].double()
        exact = a.double() @ b.double()
        mm = (a @ b).double()
        stats = []
        for e in (got - exact, mm - exact):
            stats.append((float((e * exact.sign()).mean() / exact.abs().mean()),
                          float(e.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()),
                          float(e.abs().max() / exact.abs().max())))
        print(f"{name} (M={M} N={N} K={K}): kernel bias {stats[0][0]:.3e} rms {stats[0][1]:.3e} "
              f"max {stats[0][2]:.3e}; torch.mm bias {stats[1][0]:.3e} rms {stats[1][1]:.3e} max "
              f"{stats[1][2]:.3e}", flush=True)
        del a, b, got, exact, mm

    cfg = load_config("mim_1", str(ROOT / "configs"))
    os.makedirs(ROOT / "models", exist_ok=True)
    for seed in seeds:
        ckpt = str(ROOT / "models" / f"f32_path_gaps_mim_1_seed{seed}.ckpt.pt")
        trainer = MIMPretrainer(cfg, dtype=torch.bfloat16, seed=0, device="cuda")
        m, bs = trainer.model, trainer.batch_size
        steps, val = cs.TRAIN_STEPS, cs.VAL_BATCHES
        data = make_cutouts((steps + val) * bs, seed=seed, channels=m.in_chans, img_size=m.img_size)
        rd = np.stack([data["ra"], data["dec"]], axis=1)
        batches = [{"cutouts": data["cutouts"][i:i + bs], "ra_dec": rd[i:i + bs]}
                   for i in range(0, len(rd), bs)]
        for b_ in batches[:steps]:
            trainer.train_batch(b_)
        for i, b_ in enumerate(batches[steps:]):
            trainer.eval_batch(b_, idx=i)
        trainer.save(ckpt)
        del trainer
        torch.cuda.empty_cache()
        print(f"mim_1 checkpoint, data seed {seed}:", flush=True)
        try:
            cs.predictor_f32_phase("cuda", ckpt, lambda: None, lambda: {}, lambda *a, **k: {},
                                   {"lp": cs.PRED_F32["lp"], "fs": cs.PRED_F32["fs"]})
        finally:
            os.remove(ckpt)
        torch.cuda.empty_cache()
    if "--large" in argv:
        print("large and tiny routes, seeded weights:", flush=True)
        cs.predictor_f32_phase("cuda", None, lambda: None, lambda: {}, lambda *a, **k: {},
                               cs.PRED_F32_LARGE)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
