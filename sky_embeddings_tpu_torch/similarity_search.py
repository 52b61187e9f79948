"""Embedding similarity search CLI (port of the repo's ``similarity_search.py``).

    python -m sky_embeddings_tpu_torch.similarity_search <model_name> [-tgt_fn F] ... [--device cuda]

Builds the MIM model (SimMIM or MAE) from ``configs/<model_name>.ini`` with the params of
the pretraining checkpoint that ``pretrain_mim`` writes
(``models/<model_name>_best.ckpt.pt``, else ``models/<model_name>.ckpt.pt``,
each else the JAX package's ``.ckpt.msgpack`` of the name;
without one it warns and uses fresh seeded weights), or, for a predictor
config, the predictor with the checkpoint ``train_predictor`` writes, S/N-filters the test
set, embeds the target set with 64 augmentations, then either streams the
test set through the encoder (``mim_simsearch``) or answers from an
embedding bank (``-bank``), and saves
``results/<model>_<target>_simsearch_results_f.npz`` with the JAX CLI's keys.

Not ported yet: the PNG figures (ROADMAP: figures).
"""

from __future__ import annotations

import argparse
import ast
import os

import numpy as np
import torch

from sky_embeddings_tpu_torch.configuration import load_config, str2bool
from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher, central_crop
from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, build_bank
from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch
from sky_embeddings_tpu_torch.models.mim import build_mim_model
from sky_embeddings_tpu_torch.models.weights import load_jax_params
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.utils.checkpoint import (find_checkpoint, is_jax_checkpoint,
                                                       load_checkpoint)
from sky_embeddings_tpu_torch.utils.misc import h5_snr

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("Similarity searching.", add_help=False)
    p.add_argument("model_name", type=str)
    p.add_argument("-tgt_fn", "--target_fn", type=str,
                   default="HSC_dud_dwarf_galaxy_calexp_GIRYZ7610_64.h5")
    p.add_argument("-tst_fn", "--test_fn", type=str,
                   default="HSC_dud_unknown_calexp_GIRYZ7610_64.h5")
    p.add_argument("-tgt_i", "--target_indices", default="[1,2]")
    p.add_argument("-aug", "--augment_targets", type=str, default="True")
    p.add_argument("-mp", "--max_pool", type=str, default="True")
    p.add_argument("-ct", "--cls_token", type=str, default="False")
    p.add_argument("-snr", "--snr_range", default="[2,7]")
    p.add_argument("-bs", "--batch_size", type=int, default=64)
    p.add_argument("-m", "--metric", type=str, default="cosine")
    p.add_argument("-c", "--combine", type=str, default="min")
    p.add_argument("-dc", "--display_channel", type=int, default=2)
    p.add_argument("-np", "--n_plot", type=int, default=36)
    p.add_argument("-ns", "--n_save", type=int, default=300)
    p.add_argument("-dd", "--data_dir", type=str, default=None)
    p.add_argument("-bank", "--bank", type=str, default=None,
                   help="embedding-bank file under results/: reuse if it exists, "
                        "else embed the test set once and save it.")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_model_from_config(config_dir, model_dir, model_name, device):
    """The model with the params of its checkpoint (``best``, then the
    latest; fresh seeded weights without one), and its config: a MIM model
    (SimMIM or MAE; an MAE model is served unmasked) or, for a predictor
    config (one naming ``pretained_mae``), the predictor (JAX
    ``similarity_search.py:62-80``), whose tokens are ``SkyViT.encode``'s."""
    config = load_config(model_name, config_dir)
    if "TRAINING" in config and (
        "pretained_mae" in config.training or "pretrained_mae" in config.training
    ):
        mae_name = config.pretrained_mae_name()
        mae_config = load_config(mae_name, config_dir) if mae_name else config
        trainer = PredictorTrainer(config, mae_config, device=device)
        path = (find_checkpoint(model_dir, model_name, best=True)
                or find_checkpoint(model_dir, model_name))
        if path is None or not trainer.restore(path):
            print(f"WARNING: no checkpoint for {model_name}; using fresh weights.")
        return trainer.model.eval(), config
    dtype = torch.bfloat16 if config.training.str("dtype", "float32") == "bfloat16" else torch.float32
    model = build_mim_model(config, dtype=dtype, device=device)
    path = (find_checkpoint(model_dir, model_name, best=True)
            or find_checkpoint(model_dir, model_name))
    if path is None:
        print(f"WARNING: no checkpoint for {model_name}; using fresh weights.")
    elif is_jax_checkpoint(path):
        load_jax_params(model, load_checkpoint(path)["params"])
    else:
        model.load_state_dict(load_checkpoint(path)["params"])
    return model, config


def bank_search(model, target_latent, test_batcher, test_path, test_indices, bank_path, args):
    """Precomputed-bank retrieval: embed the survey once, answer from the bank."""
    import h5py

    pool = "cls" if str2bool(args.cls_token) else ("max" if str2bool(args.max_pool) else "mean")
    device = model.cls_token.device
    if os.path.exists(bank_path):
        bank = EmbeddingBank.load(bank_path, device=device)
        print(f"Loaded embedding bank {bank_path} "
              f"({bank.features.shape[0]} rows, pool={bank.pool}).")
        if bank.features.shape[0] != len(test_indices):
            raise ValueError(
                f"bank {bank_path} has {bank.features.shape[0]} rows but the current "
                f"S/N filter selects {len(test_indices)} test rows; delete it (or pass "
                "a different --bank name) to rebuild"
            )
    else:
        print("Building embedding bank (one-time encoder sweep)...")
        bank = build_bank(model, test_batcher, pool=pool)
        bank.save(bank_path)
        print(f"Saved embedding bank to {bank_path}.")

    scores, rows = bank.query(target_latent, k=args.n_save)
    sel = np.asarray(test_indices)[rows]  # bank row -> h5 row (build order)
    order = np.argsort(sel, kind="stable")  # h5 wants sorted indices
    with h5py.File(test_path, "r") as f:
        sorted_imgs = f["cutouts"][sel[order]]
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    images = sorted_imgs[inv].astype(np.float32)
    np.maximum(images, -3.0, out=images)  # the batcher's host transforms
    if images.shape[-1] > model.img_size or images.shape[-2] > model.img_size:
        images = np.ascontiguousarray(central_crop(images, model.img_size))
    latent = extract_latents(
        model, [{"cutouts": images, "ra_dec": bank.ra_decs[rows]}], remove_prefix=False
    )
    return images, latent, bank.ra_decs[rows], scores


def main(argv=None):
    args = parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    results_dir = os.path.join(REPO_DIR, "results")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(results_dir, exist_ok=True)

    model, config = build_model_from_config(config_dir, model_dir, args.model_name, args.device)
    img_size = config.architecture.int("img_size")
    target_indices = (
        ast.literal_eval(args.target_indices) if args.target_indices != "None" else None
    )
    snr_range = ast.literal_eval(args.snr_range)

    print("Estimating S/N for test dataset images...")
    test_path = os.path.join(data_dir, args.test_fn)
    snr = h5_snr(test_path, n_central_pix=8, batch_size=5000)
    snr_min = np.nanmin(snr[:, : min(5, snr.shape[1])], axis=1)
    test_indices = np.where((snr_min > snr_range[0]) & (snr_min < snr_range[1]))[0]
    print(f"{len(test_indices)} test samples in S/N range {snr_range}.")

    target_batcher = build_h5_batcher(
        os.path.join(data_dir, args.target_fn), batch_size=args.batch_size,
        img_size=img_size, shuffle=False, indices=target_indices, drop_remainder=False,
    )
    test_batcher = build_h5_batcher(
        test_path, batch_size=args.batch_size, img_size=img_size,
        shuffle=False, indices=test_indices, drop_remainder=False,
    )
    target_latent, target_images = extract_latents(
        model, target_batcher, remove_prefix=False,
        apply_augmentations=str2bool(args.augment_targets), num_augmentations=64,
        generator=torch.Generator().manual_seed(0), return_images=True,
    )

    if args.bank and args.bank != "None":
        test_images, test_latent, test_ra_decs, test_scores = bank_search(
            model, target_latent, test_batcher, test_path, test_indices,
            os.path.join(results_dir, args.bank), args,
        )
    else:
        test_images, test_latent, test_ra_decs, test_scores = mim_simsearch(
            model, target_latent, test_batcher,
            n_save=args.n_save, metric=args.metric, combine=args.combine,
            use_weights=True, max_pool=str2bool(args.max_pool),
            cls_token=str2bool(args.cls_token),
        )

    out = os.path.join(
        results_dir, f"{args.model_name}_{args.target_fn[:-3]}_simsearch_results_f.npz"
    )
    np.savez(
        out,
        test_ra_decs=test_ra_decs,
        test_scores=test_scores,
        target_images=target_images,
        target_features=target_latent,
        test_images=test_images,
        test_features=test_latent,
    )
    print(f"Saved results to {out}")
    return out


if __name__ == "__main__":
    main()
