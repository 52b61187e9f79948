"""Semantic validation on the structured synthetic survey (port of the repo's
``tools/semantic_validation.py``).

    python -m sky_embeddings_tpu_torch.semantic_validation [--quick]
        [--stage all|pretrain|finetune|simsearch] [-v 500] [--device cuda]

Proves that the port learns, not just that its loss falls, by the JAX
tool's protocol on the class/redshift-structured survey
(``data/synthetic.make_structured_cutouts``):

1. ``pretrain``: SimMIM ViT-B (``configs/mim_struct.ini``: bf16, B=256, 6 000
   steps) with the linear probes (``lp_combine = central``) at each
   validation; probe accuracy and redshift R² must rise;
2. ``finetune``: a redshift head fine-tuned from the pretrained backbone
   (``z_struct_ft_512``) against the same head trained from scratch
   (``z_struct_fs_512``), 512 labels each; the fine-tuned MAD must be lower;
3. ``simsearch``: 12 targets of each class (16 TTA views each, no band
   dropped) against the central-pooled bank of the embedded val survey;
   precision@30 of same-class retrieval must be at least twice chance for
   every class.

The survey is built in memory at ``ensure_datasets``' sizes and seeds (40 000
train, 3 072 val, 6 000 in each probe set, 12 000 and 2 560 in the z sets;
the arrays ``write_structured_h5`` would write) and served from
``data/device_cache.DeviceDataset`` on the device: train in bf16, the rest
in fp32, as JAX stores them. Checkpoints go to ``models/`` (``mim_struct``,
``z_struct_{ft,fs}_512``), so a stage reruns from the previous one's.
``--seeds N`` also trains both finetune configs at seeds 1..N-1 (fresh
weights and augmentation draws), the spread of the MAD gate, which reads
seed 0 as JAX's tool does.
Writes ``results/semantic_validation_torch.json`` (the JAX run's record,
``results/semantic_validation.json``, stays as it is) with each stage's
seconds, and exits non-zero if a gate fails. ``--quick`` runs a tiny shape
for the CPU (D = 48, 16 x 16 cutouts, a few steps and rows; no gates) and
writes ``semantic_validation_torch_quick.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
from sky_embeddings_tpu_torch.data.synthetic import structured_survey
from sky_embeddings_tpu_torch.eval.bank import build_bank
from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents, predictor_infer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, train_predictor_network
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path, find_checkpoint
from sky_embeddings_tpu_torch.utils.plotting import photoz_prediction_metrics

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIRDS = (1 / 3, 1 / 3, 1 / 3)
Z_FRACS = (0.5, 0.5, 0.0)  # galaxies and QSOs; stars have z = 0
# set: (rows, class fractions, seed), as tools/semantic_validation.ensure_datasets
SURVEY = {
    "struct_train": (40000, THIRDS, 10),
    "struct_val": (3072, THIRDS, 11),
    "struct_probe_cls": (6000, THIRDS, 12),
    "struct_probe_z": (6000, Z_FRACS, 13),
    "struct_z_train": (12000, Z_FRACS, 14),
    "struct_z_val": (2560, Z_FRACS, 15),
}
QUICK_ROWS = {"struct_train": 128, "struct_val": 64, "struct_probe_cls": 96,
              "struct_probe_z": 96, "struct_z_train": 128, "struct_z_val": 64}
QUICK_ARCH = ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4", "ARCHITECTURE.embed_dim=48",
              "TRAINING.batch_size=16"]
QUICK_MIM = QUICK_ARCH + ["TRAINING.total_batch_iters=20"]
QUICK_PRED = ["ARCHITECTURE.img_size=16", "TRAINING.batch_size=16", "TRAINING.total_batch_iters=10",
              "TRAINING.num_train=64"]
FINETUNE = ("z_struct_ft_512", "z_struct_fs_512")
K = 30  # precision@30 of the 3 072-image val survey (1%)


def survey_set(name: str, quick: bool = False) -> dict:
    """One set of the survey as arrays (``structured_survey``)."""
    n, fracs, seed = SURVEY[name]
    return structured_survey(QUICK_ROWS[name] if quick else n, channels=5,
                             img_size=16 if quick else 64, class_fracs=fracs, seed=seed)


def make_survey(quick: bool) -> dict:
    """Every set of the survey as arrays."""
    return {name: survey_set(name, quick) for name in SURVEY}


def mim_config(quick: bool):
    cfg = load_config("mim_struct", os.path.join(REPO_DIR, "configs"))
    return apply_overrides(cfg, QUICK_MIM if quick else [], "mim_struct")


def fig_dir() -> str:
    """``figures/``, where the training loops draw, as the JAX tool's do
    (where matplotlib is installed)."""
    path = os.path.join(REPO_DIR, "figures")
    os.makedirs(path, exist_ok=True)
    return path


def run_pretrain(survey: dict, verbose_iters: int, quick: bool, device) -> dict:
    pretrainer = MIMPretrainer(mim_config(quick), device=device)
    name = "mim_struct_quick" if quick else "mim_struct"
    model_filename = checkpoint_path(os.path.join(REPO_DIR, "models"), name)
    os.makedirs(os.path.dirname(model_filename), exist_ok=True)
    resume = find_checkpoint(os.path.dirname(model_filename), name)
    if resume and pretrainer.restore(resume):
        print(f"Resumed mim_struct from {resume} at iteration {pretrainer.cur_iter}.")
    bs, img_size = pretrainer.batch_size, pretrainer.model.img_size
    # bf16 storage halves the train set; val stays fp32, as JAX keeps them
    data = dict(img_size=img_size, device=pretrainer.device)
    train_ds = DeviceDataset.from_arrays(survey["struct_train"], bs, shuffle=True,
                                         dtype=torch.bfloat16, **data)
    val_ds = DeviceDataset.from_arrays(survey["struct_val"], bs, shuffle=False, **data)
    probes = [DeviceDataset.from_arrays(survey[name], 256, label_keys=[key], shuffle=False,
                                        drop_remainder=False, **data)
              for name, key in (("struct_probe_cls", "class"), ("struct_probe_z", "zspec"))]
    train_network(pretrainer, train_ds.forever(), val_ds, pretrainer.total_batch_iters,
                  verbose_iters, cp_time_minutes=15.0, model_filename=model_filename,
                  fig_dir=fig_dir(), lp_class_data_file=probes[0], lp_regress_data_file=probes[1],
                  lp_combine="central")
    return {k: [float(x) for x in v] for k, v in pretrainer.losses.items()}


def run_name(name: str, quick: bool = False, seed: int = 0) -> str:
    """The checkpoint name of config ``name``'s run at ``seed``."""
    return name + ("_quick" if quick else "") + (f"_seed{seed}" if seed else "")


def run_finetune(name: str, survey: dict, verbose_iters: int, quick: bool, device,
                 seed: int = 0, overrides=(), run_dir=None) -> dict:
    """Train one predictor config; returns photo-z metrics on the z-val set.
    ``seed`` draws the fresh weights (all of them from scratch, the pool and
    head when warm-started) and the augmentations; seed 0 is the gated run.
    ``overrides`` (``--set`` items) follow the ``--quick`` ones. The run's
    checkpoints go to ``run_dir`` (default ``models/``, where the
    ``mim_struct`` warm start is read)."""
    config_dir, model_dir = os.path.join(REPO_DIR, "configs"), os.path.join(REPO_DIR, "models")
    config = apply_overrides(load_config(name, config_dir),
                             (QUICK_PRED if quick else []) + list(overrides), name)
    trainer = PredictorTrainer(config, mim_config(quick), seed=seed, device=device)
    suffix = "_quick" if quick else ""
    run = run_name(name, quick, seed)
    model_filename = checkpoint_path(run_dir or model_dir, run)
    best_filename = checkpoint_path(run_dir or model_dir, run, best=True)
    # ft fine-tunes the pretrained backbone, lp freezes it: both start from
    # the MIM weights (reference train_predictor.py warm-starts whenever
    # pretained_mae is set); fs trains from scratch
    if os.path.exists(best_filename) and trainer.restore(best_filename):
        print(f"Resumed {name} from best checkpoint at {trainer.cur_iter}.")
    elif config.training.str("train_method") in ("ft", "lp"):
        mim = find_checkpoint(model_dir, "mim_struct" + suffix)
        if mim is None or not trainer.warm_start(mim):
            raise SystemExit("mim_struct checkpoint missing — run pretrain first")
        print(f"Warm-started {name} from mim_struct.")
    bs, img_size = trainer.batch_size, trainer.model.img_size
    num_train = config.training.int("num_train", -1)
    data = dict(img_size=img_size, label_keys=["zspec"], device=trainer.device)
    train_ds = DeviceDataset.from_arrays(
        survey["struct_z_train"], bs, shuffle=True,
        indices=list(range(num_train)) if num_train > -1 else None, **data)
    val_ds = DeviceDataset.from_arrays(survey["struct_z_val"], bs, shuffle=False, **data)
    train_predictor_network(trainer, train_ds.forever(), val_ds, verbose_iters,
                            cp_time_minutes=15.0, model_filename=model_filename,
                            fig_dir=fig_dir())
    trainer.restore(best_filename)  # evaluate the best checkpoint on the val set
    infer_ds = DeviceDataset.from_arrays(survey["struct_z_val"], bs, shuffle=False,
                                         drop_remainder=False, **data)
    targets, preds = predictor_infer(trainer.model, infer_ds)
    z_true, z_pred = targets[:, 0], preds[:, 0]
    bias, mad, frac_out = photoz_prediction_metrics(z_pred, z_true, threshold=0.15)
    ss_res = float(np.sum((z_pred - z_true) ** 2))
    ss_tot = float(np.sum((z_true - z_true.mean()) ** 2))
    return {"bias": bias, "mad": mad, "frac_out": frac_out, "r2": 1.0 - ss_res / ss_tot,
            "mse": float(np.mean((z_pred - z_true) ** 2)), "iteration": trainer.cur_iter,
            "val_loss": trainer.losses.get("val_loss", [])}


def run_simsearch(survey: dict, quick: bool, device) -> dict:
    """Same-class retrieval precision over the embedded val survey."""
    pretrainer = MIMPretrainer(mim_config(quick), device=device)
    path = find_checkpoint(os.path.join(REPO_DIR, "models"),
                           "mim_struct_quick" if quick else "mim_struct")
    if path is None or not pretrainer.restore(path):
        raise SystemExit("mim_struct checkpoint missing — run pretrain first")
    model = pretrainer.model.eval()
    val = survey["struct_val"]
    classes = val["class"]
    data = dict(img_size=model.img_size, shuffle=False, drop_remainder=False,
                device=pretrainer.device)
    # central pooling: the probe's feature space, where the classes separate
    bank = build_bank(model, DeviceDataset.from_arrays(val, 256, **data), pool="central")
    classes = classes[:bank.features.shape[0]]
    out: dict = {}
    for cls, label in ((1, "qso"), (0, "galaxy"), (2, "star")):
        tgt_rows = np.where(classes == cls)[0][:12]
        tgt_latent = extract_latents(
            model, DeviceDataset.from_arrays(val, 64, indices=tgt_rows, **data),
            remove_prefix=False, apply_augmentations=True, num_augmentations=16,
            generator=torch.Generator(device=pretrainer.device).manual_seed(cls),
            # every band kept in the targets' views: the scoring weights are
            # the group's inverse variance over the colours that split the
            # classes
            augment_params=dict(nan_channels=0))
        _, rows = bank.query(tgt_latent, k=K + len(tgt_rows))
        rows = np.asarray(rows)
        hit_rows = rows[~np.isin(rows, tgt_rows)][:K]  # the targets excluded
        out[f"precision_at_{K}_{label}"] = float(np.mean(classes[hit_rows] == cls))
    out["chance"] = {label: float(np.mean(classes == cls))
                     for cls, label in ((1, "qso"), (0, "galaxy"), (2, "star"))}
    return out


def gates(results: dict) -> list[str]:
    """The JAX tool's semantic gates; the failures, as text."""
    failures = []
    pre = results.get("pretrain", {})
    acc, r2 = pre.get("val_lp_acc", []), pre.get("val_lp_r2", [])
    if acc and max(acc) < acc[0] + 0.05:
        failures.append(f"probe accuracy did not rise: {acc[0]:.3f} -> {max(acc):.3f}")
    if r2 and max(r2) < r2[0] + 0.05:
        failures.append(f"probe R2 did not rise: {r2[0]:.3f} -> {max(r2):.3f}")
    ftfs = results.get("finetune", {})
    if ftfs and ftfs["ft"]["mad"] >= ftfs["fs"]["mad"]:
        failures.append(f"fine-tune MAD {ftfs['ft']['mad']:.4f} does not beat from-scratch "
                        f"{ftfs['fs']['mad']:.4f}")
    sim = results.get("simsearch", {})
    for label in ("qso", "galaxy", "star") if sim else ():
        p, chance = sim[f"precision_at_{K}_{label}"], sim["chance"][label]
        if p < 2 * chance:
            failures.append(f"simsearch precision@{K} for {label} = {p:.3f} < 2x chance "
                            f"({chance:.3f})")
    return failures


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny shape for the CPU, no gates")
    ap.add_argument("--stage", default="all", choices=["all", "pretrain", "finetune", "simsearch"])
    ap.add_argument("-v", "--verbose_iters", type=int, default=500)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seeds", type=int, default=1,
                    help="finetune: also train both configs at seeds 1..N-1 (the spread of "
                         "the MAD gate, which reads seed 0)")
    args = ap.parse_args(argv)
    fname = "semantic_validation_torch_quick.json" if args.quick else "semantic_validation_torch.json"
    results_path = os.path.join(REPO_DIR, "results", fname)
    os.makedirs(os.path.dirname(results_path), exist_ok=True)
    results: dict = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    seconds = results.setdefault("seconds", {})

    t0 = time.perf_counter()
    survey = make_survey(args.quick)
    seconds["survey"] = time.perf_counter() - t0
    print(f"Survey made in {seconds['survey']:.1f} s: "
          + ", ".join(f"{k} {len(v['cutouts'])}" for k, v in survey.items()), flush=True)
    if args.stage in ("all", "pretrain"):
        t0 = time.perf_counter()
        losses = run_pretrain(survey, args.verbose_iters, args.quick, args.device)
        seconds["pretrain"] = time.perf_counter() - t0
        results["pretrain"] = {k: losses.get(k, []) for k in (
            "batch_iters", "train_loss", "val_loss", "val_lp_acc", "val_lp_r2")}
    if args.stage in ("all", "finetune"):
        results["finetune"] = {}
        for name, key in zip(FINETUNE, ("ft", "fs")):
            t0 = time.perf_counter()
            results["finetune"][key] = run_finetune(name, survey, args.verbose_iters, args.quick,
                                                    args.device)
            seconds[f"finetune_{key}"] = time.perf_counter() - t0
        if args.seeds > 1:
            t0 = time.perf_counter()
            results["finetune_seeds"] = [
                {"seed": seed, **{key: run_finetune(name, survey, args.verbose_iters, args.quick,
                                                    args.device, seed=seed)
                                  for name, key in zip(FINETUNE, ("ft", "fs"))}}
                for seed in range(1, args.seeds)]
            seconds["finetune_seeds"] = time.perf_counter() - t0
    if args.stage in ("all", "simsearch"):
        t0 = time.perf_counter()
        results["simsearch"] = run_simsearch(survey, args.quick, args.device)
        seconds["simsearch"] = time.perf_counter() - t0
    results["device"] = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                         else args.device)

    failures = [] if args.quick else gates(results)
    results["gates_failed"] = failures
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nWrote {results_path}")
    pre = results.get("pretrain", {})
    if pre.get("val_lp_acc") and pre.get("val_lp_r2"):
        acc, r2 = pre["val_lp_acc"], pre["val_lp_r2"]
        print(f"probe acc: {acc[0]:.3f} -> {max(acc):.3f}  probe R2: {r2[0]:.3f} -> {max(r2):.3f}")
    for key, m in results.get("finetune", {}).items():
        print(f"photo-z {key}: {m}")
    for r in results.get("finetune_seeds", []):
        print(f"seed {r['seed']}: MAD ft {r['ft']['mad']:.4f}, fs {r['fs']['mad']:.4f}")
    if results.get("simsearch"):
        print(f"simsearch: {results['simsearch']}")
    if failures:
        print("\nSEMANTIC GATES FAILED:")
        for f_ in failures:
            print(f"  - {f_}")
        sys.exit(1)
    print("\nNo gates at --quick." if args.quick else "\nAll semantic gates passed.")
    return results


if __name__ == "__main__":
    main()
