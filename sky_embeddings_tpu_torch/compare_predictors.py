"""Compare predictor families across training-set sizes (port of the repo's
``compare_predictors.py``, reference ``compare_predictors.py``).

    python -m sky_embeddings_tpu_torch.compare_predictors -f z_struct_ft z_struct_fs
        [-dd data_dir | --structured] [-o name] [--json] [--device cuda]

Each family ``F`` matches configs named ``configs/F_*.ini`` (``family_configs``);
every matching config with a checkpoint in ``models/`` (the port's
``.ckpt.pt`` or the JAX package's ``.ckpt.msgpack``, ``_best`` first) is
scored on its validation set: the accuracy for a crossentropy head, the
photo-z bias, MAD and outlier fraction for an mse head. The validation set
is the config's ``val_data_file`` under ``data_dir`` (h5py), or with
``--structured`` the structured survey's ``struct_z_val`` built in memory
(the rows ``write_structured_h5`` would write; the card host has no h5py).
``--json`` writes ``results/<name>.json`` as ``{family: [{"num_train": n,
...metrics}]}``, sorted by ``num_train``, the JAX tool's shape. The figure
(metric against ``num_train``) goes to ``figures/<name>.png`` where
matplotlib imports; elsewhere one line says it was skipped.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import numpy as np

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.utils.checkpoint import find_checkpoint
from sky_embeddings_tpu_torch.utils.plotting import photoz_prediction_metrics

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("Compare predictors.")
    p.add_argument("-f", "--families", nargs="+", required=True,
                   help="config-name prefixes, e.g. cls_fs cls_ft cls_ap")
    p.add_argument("-dd", "--data_dir", type=str, default=None)
    p.add_argument("-o", "--out_name", type=str, default="compare_predictors_torch")
    p.add_argument("--json", action="store_true",
                   help="also write results/<out_name>.json with the metric-vs-num_train rows")
    p.add_argument("--structured", action="store_true",
                   help="score on the structured survey's struct_z_val, built in memory")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def evaluate_model(model_name, config_dir, model_dir, data_dir=None, *, run=None, val=None,
                   train_rows=None, overrides=(), mae_overrides=(), device="cuda"):
    """``(num_train, metrics)`` of the checkpoint ``run`` (default
    ``model_name``) of config ``model_name``, or None without a checkpoint
    (JAX ``compare_predictors.evaluate_model``). ``val``, when given, is the
    validation set's arrays (else the config's ``val_data_file`` under
    ``data_dir``); ``train_rows`` the training set's row count, which
    ``num_train = -1`` reports (else the ``train_data_file``'s length).
    ``overrides`` / ``mae_overrides`` are ``--set`` items for the predictor's
    and its pretraining config."""
    config = apply_overrides(load_config(model_name, config_dir), overrides, model_name)
    mae_name = config.pretrained_mae_name()
    mae_config = (apply_overrides(load_config(mae_name, config_dir), mae_overrides, mae_name)
                  if mae_name else config)
    trainer = PredictorTrainer(config, mae_config, device=device)
    run = run or model_name
    path = find_checkpoint(model_dir, run, best=True) or find_checkpoint(model_dir, run)
    if path is None or not trainer.restore(path):
        return None

    data, training = config.data, config.training
    batch = dict(batch_size=training.int("batch_size"),
                 img_size=config.architecture.int("img_size"),
                 label_keys=data.list("label_keys"), shuffle=False, drop_remainder=False)
    if val is None:
        batcher = build_h5_batcher(os.path.join(data_dir, data.str("val_data_file")), **batch)
    else:
        batcher = DeviceDataset.from_arrays(val, device=trainer.device, **batch)
    targets, preds = predictor_infer(trainer.model.eval(), batcher,
                                     use_label_errs=training.bool("use_label_errs", False))
    num_train = training.int("num_train", -1)
    if num_train < 0:  # the whole training set: its size is the x-axis
        if train_rows is None:
            import h5py

            with h5py.File(os.path.join(data_dir, data.str("train_data_file")), "r") as f:
                train_rows = len(f["cutouts"])
        num_train = int(train_rows)
    if "crossentropy" in training.str("loss_fn").lower():
        acc = float((np.argmax(preds, axis=1) == targets.reshape(-1)).mean())
        return num_train, {"accuracy": acc}
    bias, mad, fout = photoz_prediction_metrics(preds[:, 0], targets[:, 0])
    return num_train, {"bias": bias, "mad": mad, "outlier_frac": fout}


def family_configs(config_dir: str, family: str) -> list:
    """Config names in a sweep family (JAX ``compare_predictors.family_configs``).

    ``cls_ft`` matches ``cls_ft_<size>`` (the bare size token only, so the
    suffix families stay out of the base sweep); ``cls_ft_wide`` /
    ``cls_ft_large`` match ``cls_ft_<size>_wide`` / ``_large``, the
    reference's 'Fine-tuning (Wide)' and '(Wide+Large)' categories.
    """
    names = [os.path.splitext(os.path.basename(p))[0]
             for p in sorted(glob.glob(os.path.join(config_dir, "*.ini")))]
    out = []
    base, _, suffix = family.rpartition("_")
    for name in names:
        if name.startswith(family + "_") and "_" not in name[len(family) + 1:]:
            out.append(name)  # cls_ft -> cls_ft_1k
        elif base and name.startswith(base + "_") and name.endswith("_" + suffix):
            size = name[len(base) + 1: -(len(suffix) + 1)]
            if size and "_" not in size:
                out.append(name)  # cls_ft_wide -> cls_ft_1k_wide
    return out


def json_rows(results: dict) -> dict:
    """``{family: [(num_train, metrics), ...]}`` -> the JAX tool's ``--json``
    form, ``{family: [{"num_train": n, **metrics}]}`` sorted by ``num_train``."""
    return {fam: [{"num_train": n, **m} for n, m in sorted(rows, key=lambda r: r[0])]
            for fam, rows in results.items()}


def write_json(results: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(json_rows(results), f, indent=2)
    print(f"Saved {path}")


def plot_results(results: dict, out_png: str) -> bool:
    """One panel per metric, each family's metric against ``num_train``
    (log 2), as the JAX tool draws it; False, with a line saying so, where
    matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("Figure skipped: matplotlib is not installed.")
        return False
    metric_names = sorted({k for rows in results.values() for _, m in rows for k in m})
    fig, axes = plt.subplots(1, len(metric_names), figsize=(5 * len(metric_names), 4),
                             squeeze=False)
    for j, mname in enumerate(metric_names):
        ax = axes[0, j]
        for family, rows in results.items():
            rows = sorted((r for r in rows if mname in r[1]), key=lambda r: r[0])
            if rows:
                ax.plot([r[0] for r in rows], [r[1][mname] for r in rows], "o-", label=family)
        ax.set_xscale("log", base=2)
        ax.set_xlabel("num_train")
        ax.set_ylabel(mname)
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    print(f"Saved {out_png}")
    return True


def main(argv=None) -> dict:
    args = parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    val = train_rows = None
    if args.structured:
        from sky_embeddings_tpu_torch.semantic_validation import SURVEY, survey_set

        val, train_rows = survey_set("struct_z_val"), SURVEY["struct_z_train"][0]

    results: dict = defaultdict(list)  # family -> [(num_train, metrics)]
    for family in args.families:
        for name in family_configs(config_dir, family):
            try:
                out = evaluate_model(name, config_dir, model_dir, data_dir, val=val,
                                     train_rows=train_rows, device=args.device)
            except Exception as e:  # one broken config does not stop the sweep's figure
                print(f"{name}: evaluation failed: {e}")
                continue
            if out is None:
                print(f"{name}: no checkpoint, skipping")
                continue
            num_train, metrics = out
            results[family].append((num_train, metrics))
            print(f"{name}: num_train={num_train} {metrics}")
    if not any(results.values()):
        print("No evaluable checkpoints found.")
        return {}
    if args.json:
        write_json(results, os.path.join(REPO_DIR, "results", f"{args.out_name}.json"))
    plot_results(results, os.path.join(REPO_DIR, "figures", f"{args.out_name}.png"))
    return dict(results)


if __name__ == "__main__":
    main()
