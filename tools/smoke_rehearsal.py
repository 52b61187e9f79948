#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU at tiny sizes, without a card.

    JAX_PLATFORMS=cpu python3 tools/smoke_rehearsal.py [TREE]

Imports ``chip_smoke`` from TREE (the repo root by default) as a module,
shrinks its shapes, step counts and sets, loads the tiny configs in place of
the full-width ones (``mim_1`` as ``mim_tiny`` with 5 bands; ``mim_25_large``
and ``mim_32`` as ``mim_tiny_large``, the latter with remat and the RA/Dec
token; the predictor configs at 16 x 16 and batch 8; ``jepa_struct`` and
``jepa_1`` at 16 x 16, batch 8, predictor depth 1), cuts every model to
depth 2 (CosmicEmbeds at 16 x 16, D = 48; phase 5j at batch 8, its ranks
started as this file's ``--dp-worker``, gloo on the CPU), stubs ``torch.cuda``, the
profiler, ``nvidia-smi``, the nvcc build and the C-only helpers (the TMA encode timer, the group plan, kernel 12's
bit-equality launch), and runs ``main()`` with ``check`` logging instead of
exiting. Phase 5k runs at batch 8, its queued runs as this file's
``--queue-worker``, its data stages at 20 000 sources and a 256^2 patch;
phase 5l's TP forms at tiny shapes and ViT-S's, its legs on ``mim_tiny``,
``z_tiny``, ``mae_tiny`` (fp32) and the ``jepa_struct`` stand-in, its ranks
as this file's ``--tp-worker``.
Every wrapper takes its plain version on CPU tensors, so only the
launch-count and full-size checks fail; anything else that fails, and any
exception, is a fault of the script's own logic. About two minutes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
TREE = os.path.abspath(sys.argv[1] if len(sys.argv) == 2
                       else os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, TREE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sky_embeddings_tpu_torch import configuration as conf  # noqa: E402
from sky_embeddings_tpu_torch.models import cosmos as pc  # noqa: E402
from sky_embeddings_tpu_torch.models import jepa as pj  # noqa: E402
from sky_embeddings_tpu_torch.models import mim as pm  # noqa: E402
from sky_embeddings_tpu_torch.ops.kernels import attention as tat  # noqa: E402
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab  # noqa: E402
from sky_embeddings_tpu_torch.ops.kernels import cuda_build  # noqa: E402
from sky_embeddings_tpu_torch.ops.kernels import gemm as tg  # noqa: E402


def shrink() -> None:
    cs.DEVICE = "cpu"
    cs.N_TOK, cs.D, cs.H, cs.F = 17, 48, 12, 192
    cs.BANK_ROWS = 4096
    cs.N_BATCHES, cs.BATCH = 2, 8
    cs.N_AUG, cs.N_SAVE = 8, 10
    cs.TRAIN_STEPS, cs.VAL_BATCHES, cs.TRAJ_STEPS = 2, 1, 2
    cs.TRAIN_B = (4, 8, 3)
    cs.LARGE = ("mim_25_large", 2, 1, (4, 8, 3))
    cs.REMAT = ("mim_32", 2, 1, (4, 8, 3))
    cs.VITH = ("mim_32_vith", 2, 1, (2, 3, 1), ((4, 1),))
    cs.VITH_OVERRIDES = {"ARCHITECTURE": {"model_type": "mimhuge", "embed_dim": "64"},
                         "TRAINING": {"remat": "False"}}
    cs.MAE = ("mim_1_mae", 2, 1, (4, 8, 3), (8, 2), 2, ((16, 1),))
    cs.MAE_OVERRIDES = {"ARCHITECTURE": {"model_type": "base"}, "TRAINING": {"batch_size": "16"}}
    cs.CORE_CASES = ([("vitb", b, 17, 48, 12, "bfloat16") for b in (4, 3)]
                     + [("vith", 2, 18, 64, 4, "bfloat16"), ("mae_decoder", 4, 17, 64, 4, "bfloat16"),
                        ("n256", 2, 40, 64, 4, "bfloat16"), ("vitb", 64, 17, 48, 12, "float32"),
                        ("vith", 2, 18, 64, 4, "float32")])
    cs.CORE_TIMED = (("vitb", 4), ("vith", 2))
    cs.POOL = ("mim_1_attn_pool", 2, 1, 64, ((8, 1),))
    cs.PRED = ("mim_struct", cs.PRED[1], 8, 2, 1, 2, 1)
    cs.PRED_F32_RUN = (2, 1, 2, 1)
    cs.CKPT = cs.CKPT[:4] + (2, 32, 32)
    cs.F32_SHAPES = (("vitb", 4, 17), ("cls_fs", 8, 18))
    stash = ("mlp_block_fwd_stash_f32", "mlp_block_bwd_stash_f32")
    cs.F32_NEW = (("cls_ft_large", 8, 17, 64, 16, 256, 0, stash),
                  ("mim_25_large", 4, 17, 64, 16, 256, 0, stash),
                  ("mim_32", 4, 18, 64, 16, 256, 0, ("attn_block_bwd_f32",)),
                  ("mae", 8, 20, 48, 12, 192, 5, ("attn_block_fwd_seg_f32",
                                                   "attn_block_fwd_stash_seg_f32",
                                                   "attn_block_bwd_seg_f32")),
                  ("vith", 4, 18, 64, 16, 256, 0, ("mlp_block_bwd_stream_f32",)))
    cs.JEPA_SHAPES = (("jepa_struct_enc", 4, 16, 64, 4, 256, "bfloat16"),
                      ("jepa_struct_pred", 4, 21, 32, 2, 128, "bfloat16"),
                      ("jepa_tiny_enc", 4, 16, 48, 3, 192, "float32"),
                      ("jepa_tiny_pred", 3, 21, 24, 1, 96, "float32"))
    cs.F32_TRAIN = (("mim_tiny", 2, 1, ((16, 1),)), ("mim_tiny_large", 2, 1, ((16, 1),)),
                    ("mae_tiny", 2, 1, ((16, 1),)), ("mim_32_vith_f32", 2, 1, ((4, 1),)))
    cs.MAE_TINY_REMAT = (16, 2)
    cs.FITS_TILES, cs.FITS_SIZE, cs.N_GROUPS = 4, 128, 4  # query_multi takes 2 per group
    cs.MULTI_Q = (1, 8)
    cs.RAGGED = ((5003, 64, 9), (5003, 37, 9))
    cs.SLAB_ROWS = 1500
    for size in ("base", "large", "huge"):
        pm._SIZES[size]["depth"] = 2
    pm._SIZES["base"]["decoder_depth"] = 2
    cs.JEPA_RUNS = (("jepa_struct", 2, 1, 1), ("jepa_1", 2, 0, 1), ("jepa_tiny", 2, 1, 1))
    for size in ("small", "tiny"):
        pj._SIZES[size]["depth"] = 2
    cs.COSMOS = (8, 2, 1, 1)
    # CosmicEmbeds at 16 x 16 (patch 4), D=48, depth 2, 4 heads; 5 bands
    defaults = pc.CosmicEmbeds.__init__.__defaults__
    pc.CosmicEmbeds.__init__.__defaults__ = (16, 4, 5, 48, 2, 4) + defaults[6:]
    cs.PREFETCH = (("mim_1", 3, 4, 2), ("jepa_struct", 2, 3, 2))
    # phase 5j: its ranks run this file's worker, which shrinks and stubs too
    cs.DP = ("mim_1", 8, 2, 2)
    cs.DP_LEGS = (("z_struct_ft_512", 2), ("jepa_struct", 2))
    cs.DP_WORKER = [os.path.abspath(__file__), "--dp-worker"]
    # its bars are the card's at full width; bf16 on the CPU rounds each
    # plain product's output, so two ranks part from one process by more
    cs.TOL_DP = dict.fromkeys(cs.TOL_DP, (1e-1, 1e-1, 1e-1))
    # phase 5k: the reconstructions at batch 8, the queue's runs as this
    # file's --queue-worker (gloo on the CPU), the data stages at 20 000
    # sources and a 256^2 patch
    cs.FIG = ("mim_1", 8, 16)
    cs.QUEUE = (2, 2)
    cs.QUEUE_WORKER = [os.path.abspath(__file__), "--queue-worker"]
    cs.CATALOG = (20_000, 2_000, 200)
    cs.PATCH = (256, ("G", "R", "I", "Z"))
    # phase 5l: the TP forms at tiny shapes; its legs fp32 tiny configs (the
    # bf16 stand-ins' heads of 4 are refused under tensor parallelism), the
    # jepa_struct stand-in (bf16 heads of 64, its predictor whole) and
    # mae_tiny (its decoder whole), its ranks this file's --tp-worker
    cs.TP_SHAPES = (("mim_32", 2, 17, 48, 12, 192, 0), ("mae", 2, 20, 48, 12, 192, 5),
                    ("jepa_struct", 4, 16, 384, 6, 1536, 0))
    cs.TP_LEGS = (("mim_tiny", 2), ("z_tiny", 2), ("jepa_struct", 2), ("mae_tiny", 2))
    cs.TP_GROUPS = (("4 TP small", ((48, 72, 300), (24, 48, 300))),
                    ("8 TP small", ((48, 96, 300), (96, 48, 300))))
    cs.TP_CKPT = ("mim_tiny", "jepa_struct")
    cs.TOL_TP = dict.fromkeys(("mim_tiny", "z_tiny", "jepa_struct", "mae_tiny"),
                              (1e-1, 1e-1, 1e-1))
    cs.TOL_TP_TARGET = {"jepa_struct": 1e-1}
    cs.TP_WORKER = [os.path.abspath(__file__), "--tp-worker"]


_load = conf.load_config
_TINY_PRED = ("cls_fs_1k", "lp_1", "cls_ft_1k_large", "z_ft_2", "z_tiny")


def load_config(name, cfg_dir=None):
    """The tiny stand-ins of the full-width configs."""
    bf16 = ["TRAINING.dtype=bfloat16", "ARCHITECTURE.num_channels=5", "TRAINING.batch_size=8"]
    if name == "mim_1":
        return conf.apply_overrides(_load("mim_tiny", cfg_dir),
                                    bf16 + ["DATA.bands=['G','I','R','Y','Z']"], name)
    if name == "mim_25_large":
        return conf.apply_overrides(_load("mim_tiny_large", cfg_dir), bf16, name)
    if name == "mim_32":
        return conf.apply_overrides(_load("mim_tiny_large", cfg_dir),
                                    bf16 + ["TRAINING.remat=True", "ARCHITECTURE.ra_dec=True"], name)
    cfg = _load(name, cfg_dir)
    if name in ("jepa_struct", "jepa_1"):  # 16 x 16, as the probe sets; predictor depth 1
        over = ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4", "TRAINING.batch_size=8",
                "ARCHITECTURE.pred_depth=1"]
    elif name == "mim_struct":
        over = ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4", "ARCHITECTURE.embed_dim=48"]
    elif name.startswith("z_struct") or name in _TINY_PRED:
        over = ["ARCHITECTURE.img_size=16", "TRAINING.batch_size=8", "TRAINING.num_train=16"]
        if name == "cls_fs_1k":  # no pretraining config: its own width
            over += ["ARCHITECTURE.patch_size=4", "ARCHITECTURE.embed_dim=48"]
    else:
        return cfg
    return conf.apply_overrides(cfg, over, name)


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Profile:
    def __init__(self, *_, **__):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_):
        return False

    def key_averages(self):
        return []

    def events(self):
        return []


class _Props:
    multi_processor_count = 132


def stub() -> list:
    conf.load_config = load_config
    torch.cuda.is_available = lambda: True
    torch.cuda.Event = _Event
    torch.cuda.synchronize = lambda *_, **__: None
    torch.cuda._sleep = lambda *_: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.get_device_name = lambda *_: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.memory_allocated = lambda *_: 0
    torch.cuda.max_memory_allocated = lambda *_: 0
    torch.cuda.reset_peak_memory_stats = lambda *_: None
    torch.cuda.get_device_properties = lambda *_: _Props()
    torch.profiler.profile = _Profile
    run = subprocess.run

    def fake_run(cmd, *a, **k):
        if cmd and cmd[0] == "nvidia-smi":
            return subprocess.CompletedProcess(cmd, 0, stdout="CPU rehearsal, 0 W\n", stderr="")
        return run(cmd, *a, **k)

    cs.subprocess.run = fake_run
    cuda_build.build = lambda *_, **__: {}
    tg.gemm_encode_us = lambda *_, **__: 0.0

    def bwd_plan_cuda(shapes, sms=132, splits=0, bn=0, schedule=None):
        plan = tg.bwd_plan_forced(shapes, sms, bn, splits, schedule)
        return plan, tg.bwd_workspace(shapes, plan)

    tg.bwd_plan_cuda = bwd_plan_cuda
    tg.gemm_bwd_group_plan = lambda ops, bn=0, splits=0, schedule=None: bwd_plan_cuda(
        [(tg.KIND_TN_SPLIT, a.shape[1], b.shape[1], a.shape[0]) for a, b in ops], 132, splits, bn,
        schedule)

    def launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, H, stash=False, seg_len=0):
        out, qkv, probs = tab.attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj,
                                                         H, seg_len)
        return out, qkv, probs, tat.attention_plain(qkv, H)

    tab._launch_fwd = launch_fwd
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print("CHECK FAILED (logged):", what, flush=True)

    cs.check = check
    return failed


def main() -> int:
    torch.set_num_threads(4)
    shrink()
    failed = stub()
    rc = cs.main()
    other = [f for f in failed if "launch" not in f and "full width" not in f
             and "= 12 x encoder calls" not in f and ">= queries" not in f
             and "params" not in f and "8 deep" not in f and "cutouts a tile" not in f]
    print(f"rc {rc}; {len(failed)} checks failed, {len(other)} of them not launch counts or "
          "full-size checks:")
    for f in other:
        print("  ", f)
    return 0 if rc == 0 and not other else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":  # one rank of phase 5j
        torch.set_num_threads(2)
        shrink()
        stub()
        sys.exit(cs.dp_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--queue-worker":  # one run of phase 5k's job
        torch.set_num_threads(2)
        shrink()
        stub()
        sys.exit(cs.queue_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-worker":  # one rank of phase 5l
        torch.set_num_threads(2)
        shrink()
        stub()
        sys.exit(cs.tp_worker(sys.argv[2]))
    sys.exit(main())
