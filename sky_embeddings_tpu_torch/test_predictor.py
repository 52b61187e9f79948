"""Predictor evaluation CLI (port of the repo's ``test_predictor.py``).

    python -m sky_embeddings_tpu_torch.test_predictor <model_name> [-dd data_dir]
        [--device cuda] [--set SECTION.key=value ...] [--run_name name]

Restores the ``_best`` checkpoint (else the latest) that ``train_predictor``
wrote, runs ``predictor_infer`` over the validation file, keeps the samples
with S/N > 5 in every band (of the first five), then computes the metrics:
for an ``mse`` predictor the photo-z bias, MAD and outlier fraction, overall
and in 8 redshift bins over [0.2, 1.6]; for a classifier the accuracy and
the confusion matrix. It prints them and writes them as JSON to
``results/<run>_test_metrics.json``. The figures that JAX draws there wait
for the plots' port (ROADMAP: figures); the CLI says they are skipped.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.train_predictor import add_twin_args, load_configs
from sky_embeddings_tpu_torch.utils.checkpoint import find_checkpoint
from sky_embeddings_tpu_torch.utils.misc import build_train_argparser, h5_snr
from sky_embeddings_tpu_torch.utils.plotting import evaluate_z, photoz_prediction_metrics

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    parser = build_train_argparser("Predictor evaluation")
    add_twin_args(parser)
    args = parser.parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    results_dir = os.path.join(REPO_DIR, "results")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(results_dir, exist_ok=True)

    config, mae_config, _ = load_configs(args, config_dir)
    trainer = PredictorTrainer(config, mae_config, device=args.device)
    run = args.run_name or args.model_name
    path = find_checkpoint(model_dir, run, best=True) or find_checkpoint(model_dir, run)
    if path is None or not trainer.restore(path):
        raise SystemExit(f"No checkpoint found for {run} in {model_dir}")
    print(f"Evaluating {run} at iteration {trainer.cur_iter}.")

    data = config.data
    val_file = os.path.join(data_dir, data.str("val_data_file"))
    batcher = build_h5_batcher(
        val_file, batch_size=config.training.int("batch_size"),
        img_size=config.architecture.int("img_size"), label_keys=data.list("label_keys"),
        shuffle=False, drop_remainder=False)
    targets, preds = predictor_infer(
        trainer.model, batcher, use_label_errs=config.training.bool("use_label_errs", False))

    # S/N > 5 filter (reference test_predictor.py:90-99)
    snr = h5_snr(val_file, n_central_pix=8)
    snr_min = np.nanmin(snr[:, : min(5, snr.shape[1])], axis=1)[: len(targets)]
    keep = snr_min > 5
    print(f"Keeping {keep.sum()}/{len(keep)} samples with S/N > 5.")
    targets, preds = targets[keep], preds[keep]

    metrics: dict = {"model": run, "iteration": trainer.cur_iter, "n_eval": int(keep.sum()),
                     "n_val": int(len(keep))}
    if "mse" in config.training.str("loss_fn").lower():
        z_true, z_pred = targets[:, 0], preds[:, 0]
        bias, mad, fout = photoz_prediction_metrics(z_pred, z_true, threshold=0.15)
        centers, b_bias, b_mad, b_fout = evaluate_z(z_pred, z_true, n_bins=8, z_range=(0.2, 1.6),
                                                    threshold=0.1)
        print(f"bias={bias:.4f}  MAD={mad:.4f}  outlier_frac={fout:.4f}")
        metrics.update(bias=bias, mad=mad, outlier_frac=fout, bins={
            "z_center": centers.tolist(), "bias": b_bias.tolist(), "mad": b_mad.tolist(),
            "outlier_frac": b_fout.tolist()})
    else:
        y_pred = np.argmax(preds, axis=1)
        y_true = targets.reshape(-1).astype(np.int64)
        acc = float((y_pred == y_true).mean()) if len(y_true) else float("nan")
        n_cls = preds.shape[1]
        conf = np.zeros((n_cls, n_cls), np.int64)
        np.add.at(conf, (y_true, y_pred), 1)
        print(f"accuracy={acc:.4f}")
        metrics.update(accuracy=acc, confusion_matrix=conf.tolist())
    print("Figures skipped: the plots are not ported yet (ROADMAP: figures).")
    out = os.path.join(results_dir, f"{run}_test_metrics.json")
    with open(out, "w") as f:
        json.dump(metrics, f, indent=2)
    print(f"Wrote {out}")
    return metrics


if __name__ == "__main__":
    main()
