"""I-JEPA learning evidence on the structured survey (port of the repo's
``tools/jepa_validation.py``).

    python -m sky_embeddings_tpu_torch.jepa_validation [--quick] [-v 500] [--device cuda]

Pretrains ``jepa_struct`` as shipped (``configs/jepa_struct.ini``: bf16,
ViT-S context and EMA target encoders, the 4-deep 192-wide predictor, B=256,
4 000 steps) through ``train/pretrain.train_network`` with the linear probes
of the online encoder (``lp_combine = central``) after each validation pass,
every ``-v`` steps, on the class- and redshift-structured survey. The survey
is built in memory at the JAX tool's sizes and seeds
(``semantic_validation.survey_set``: 40 000 train, 3 072 val, 6 000 in each
probe set) and served from ``data/device_cache.DeviceDataset`` on the
device: train in bf16, the rest in fp32, as JAX's tool stores them. The
checkpoint is ``models/jepa_struct.ckpt.pt``, resumed when present.

Writes ``results/jepa_validation_torch.json``: the JAX tool's record
(``pretrain``: ``batch_iters``, ``train_loss``, ``val_loss``,
``val_lp_acc``, ``val_lp_r2``; the JAX run's file is
``results/jepa_validation.json``) with the steps, the seconds, the device
and each gate's outcome. The gates (probe accuracy and R² must rise by 0.05)
are reported and not forced: JAX's own TPU run missed them. ``--quick`` runs
a tiny shape for the CPU (16 x 16 cutouts, ``model_type = tiny``, B = 16, 20
steps, a few hundred rows) and writes ``jepa_validation_torch_quick.json``.
The training loop draws ``figures/<run>_progress.png`` after each validation
but the first, as the JAX tool passes ``fig_dir``; without matplotlib (the
card host) it warns and draws nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
from sky_embeddings_tpu_torch.semantic_validation import survey_set
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.pretrain import train_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path, find_checkpoint

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ("struct_train", "struct_val", "struct_probe_cls", "struct_probe_z")
QUICK = ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4", "ARCHITECTURE.model_type=tiny",
         "ARCHITECTURE.pred_emb_dim=96", "ARCHITECTURE.pred_depth=2", "TRAINING.batch_size=16",
         "TRAINING.total_batch_iters=20"]
RISE = 0.05  # the JAX tool's gate: each probe metric must rise by this much


def run_pretrain(survey: dict, verbose_iters: int, quick: bool, device) -> dict:
    config = apply_overrides(load_config("jepa_struct", os.path.join(REPO_DIR, "configs")),
                             QUICK if quick else [], "jepa_struct")
    trainer = JEPATrainer(config, device=device)
    name = "jepa_struct_quick" if quick else "jepa_struct"
    model_filename = checkpoint_path(os.path.join(REPO_DIR, "models"), name)
    os.makedirs(os.path.dirname(model_filename), exist_ok=True)
    resume = find_checkpoint(os.path.dirname(model_filename), name)
    if resume and trainer.restore(resume):
        print(f"Resumed {name} from {resume} at iteration {trainer.cur_iter}.")
    bs, img_size = trainer.batch_size, trainer.model.img_size
    data = dict(img_size=img_size, device=trainer.device)
    train_ds = DeviceDataset.from_arrays(survey["struct_train"], bs, shuffle=True,
                                         dtype=torch.bfloat16, **data)
    val_ds = DeviceDataset.from_arrays(survey["struct_val"], bs, shuffle=False, **data)
    probes = [DeviceDataset.from_arrays(survey[key], 256, label_keys=[label], shuffle=False,
                                        drop_remainder=False, **data)
              for key, label in (("struct_probe_cls", "class"), ("struct_probe_z", "zspec"))]
    fig_dir = os.path.join(REPO_DIR, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    train_network(trainer, train_ds.forever(), val_ds, trainer.total_batch_iters, verbose_iters,
                  cp_time_minutes=15.0, model_filename=model_filename, fig_dir=fig_dir,
                  lp_class_data_file=probes[0], lp_regress_data_file=probes[1],
                  lp_combine="central")
    return {k: [float(x) for x in v] for k, v in trainer.losses.items()}


def gates(pre: dict) -> dict:
    """Whether each probe metric rose by ``RISE`` (None without a record)."""
    out = {}
    for key in ("val_lp_acc", "val_lp_r2"):
        vals = pre.get(key, [])
        out[key] = {"first": vals[0], "max": max(vals), "rose": max(vals) >= vals[0] + RISE} \
            if vals else None
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny shape for the CPU")
    ap.add_argument("-v", "--verbose_iters", type=int, default=500)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    fname = "jepa_validation_torch_quick.json" if args.quick else "jepa_validation_torch.json"
    results_path = os.path.join(REPO_DIR, "results", fname)
    os.makedirs(os.path.dirname(results_path), exist_ok=True)

    t0 = time.perf_counter()
    survey = {name: survey_set(name, args.quick) for name in SETS}
    seconds = {"survey": time.perf_counter() - t0}
    print(f"Survey made in {seconds['survey']:.1f} s: "
          + ", ".join(f"{k} {len(v['cutouts'])}" for k, v in survey.items()), flush=True)
    t0 = time.perf_counter()
    losses = run_pretrain(survey, args.verbose_iters, args.quick, args.device)
    seconds["pretrain"] = time.perf_counter() - t0
    pre = {k: losses.get(k, []) for k in ("batch_iters", "train_loss", "val_loss", "val_lp_acc",
                                          "val_lp_r2")}
    record = {"pretrain": pre, "steps": int(pre["batch_iters"][-1]) if pre["batch_iters"] else 0,
              "seconds": seconds, "gates": gates(pre),
              "device": (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                         else args.device)}
    with open(results_path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"\nWrote {results_path}")
    for key, g in record["gates"].items():
        if g is None:
            print(f"{key}: no probe metrics recorded")
        else:
            print(f"{key}: {g['first']:.3f} -> {g['max']:.3f} (max), "
                  f"{'rose' if g['rose'] else 'did not rise'} by {RISE} "
                  f"({'gate met' if g['rose'] else 'gate missed'}; reported, not forced)")
    return record


if __name__ == "__main__":
    main()
