"""Sky-wide similarity search over survey FITS tiles (port of the repo's
``sky_sim_search.py``).

    python -m sky_embeddings_tpu_torch.sky_sim_search <model_name> [-fits "['dir', ...]"] ... [--device cuda]

Like ``similarity_search`` but the test set is the overlapping-cutout grid of
FITS tile directories (``data/fits_loader.FitsTileBatcher``). Target groups
come from rows of the target HDF5 file, each embedded with 64 augmentations;
``-tgt_i`` as a list of lists (``[[1,2],[5,6]]``) searches every group in
the same survey pass: one shared encoder sweep (``mim_simsearch_multi``) or,
with ``-bank``, one shared pass over an embedding bank (``query_multi``),
built once from the FITS sweep and reused by later runs (rebuilt when its
pooling does not match the run's). Saves
``results/<model>_<target>[_g<i>]_skysearch_results.npz`` with the JAX CLI's
keys (bank mode: no survey images). Outside bank mode it draws the first
``-np`` results of each group (band ``-dc``) as
``figures/<model>_<target>[_g<i>]_skysearch_results.png`` where matplotlib
is installed, as the JAX CLI does; without it each figure is skipped with a
warning.
"""

from __future__ import annotations

import argparse
import ast
import os

import numpy as np
import torch

from sky_embeddings_tpu_torch.configuration import str2bool
from sky_embeddings_tpu_torch.data.fits_loader import build_fits_batcher
from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, build_bank
from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch, mim_simsearch_multi
from sky_embeddings_tpu_torch.similarity_search import REPO_DIR, build_model_from_config
from sky_embeddings_tpu_torch.utils.plotting import display_images, normalize_images


def parse_args(argv=None):
    p = argparse.ArgumentParser("Sky-wide similarity searching.", add_help=False)
    p.add_argument("model_name", type=str)
    p.add_argument("-tgt_fn", "--target_fn", type=str,
                   default="HSC_dud_dwarf_galaxy_calexp_GIRYZ7610_64.h5")
    p.add_argument("-fits", "--fits_paths", type=str, default="[]",
                   help="Python list of FITS tile directories (defaults to the config's train_data_paths).")
    p.add_argument("-tgt_i", "--target_indices", default="[1,2]",
                   help="target rows in the target h5; a list of lists (e.g. [[1,2],[5,6]]) "
                        "searches every group in ONE survey pass")
    p.add_argument("-aug", "--augment_targets", type=str, default="True")
    p.add_argument("-mp", "--max_pool", type=str, default="True")
    p.add_argument("-ct", "--cls_token", type=str, default="False")
    p.add_argument("-ov", "--overlap", type=float, default=0.4)
    p.add_argument("-bs", "--batch_size", type=int, default=64)
    p.add_argument("-m", "--metric", type=str, default="cosine")
    p.add_argument("-c", "--combine", type=str, default="min")
    p.add_argument("-dc", "--display_channel", type=int, default=2)
    p.add_argument("-np", "--n_plot", type=int, default=36)
    p.add_argument("-ns", "--n_save", type=int, default=300)
    p.add_argument("-dd", "--data_dir", type=str, default=None)
    p.add_argument("-bank", "--bank", type=str, default=None,
                   help="embedding-bank file under results/: reuse if it exists, else embed "
                        "the FITS survey once and save it. Bank mode scores pooled per-cutout "
                        "features and returns ra/dec + scores (no image grid).")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _parse_target_groups(raw):
    """Returns (groups, multi): groups is a list of index lists."""
    if raw == "None":
        return [None], False
    val = ast.literal_eval(raw)
    if val and isinstance(val[0], (list, tuple)):
        return [list(g) for g in val], True
    return [val], False


def _extract_group_latents(model, path, groups, img_size, args):
    """Per-group target latents and target images, each group's augmentations
    drawn from its own seed (its index), so every saved npz pairs a group's
    targets with its own retrievals."""
    latents, group_images = [], []
    for g, idx in enumerate(groups):
        batcher = build_h5_batcher(
            path, batch_size=args.batch_size, img_size=img_size,
            shuffle=False, indices=idx, drop_remainder=False,
        )
        latent, images = extract_latents(
            model, batcher, remove_prefix=False,
            apply_augmentations=str2bool(args.augment_targets), num_augmentations=64,
            generator=torch.Generator().manual_seed(g), return_images=True,
        )
        latents.append(latent)
        group_images.append(images)
    return latents, group_images


def bank_sky_search(model, target_latents, test_batcher, bank_path, args):
    """FITS-survey bank retrieval: one encoder sweep builds the bank, every
    query (this run's and later runs') is a bank pass. Returns per-group
    (ra_decs, scores, features)."""
    pool = "cls" if str2bool(args.cls_token) else ("max" if str2bool(args.max_pool) else "mean")
    device = next(model.parameters()).device
    if os.path.exists(bank_path):
        bank = EmbeddingBank.load(bank_path, device=device)
        if bank.pool != pool:
            # a bank built under another pooling would score mismatched features
            print(f"Embedding bank {bank_path} was built with pool={bank.pool!r} but this run "
                  f"requests {pool!r}; rebuilding.")
            bank = build_bank(model, test_batcher, pool=pool)
            bank.save(bank_path)
        else:
            print(f"Loaded embedding bank {bank_path} "
                  f"({bank.features.shape[0]} rows, pool={bank.pool}).")
    else:
        print("Building embedding bank (one-time FITS survey sweep)...")
        bank = build_bank(model, test_batcher, pool=pool)
        bank.save(bank_path)
        print(f"Saved embedding bank to {bank_path} ({bank.features.shape[0]} rows).")

    k = min(args.n_save, bank.features.shape[0])
    if len(target_latents) > 1:
        scores, rows = bank.query_multi(target_latents, k=k)
    else:
        s, r = bank.query(target_latents[0], k=k)
        scores, rows = s[None], r[None]
    return [
        (bank.ra_decs[rows[g]], scores[g], bank.features[torch.as_tensor(rows[g])].float().numpy())
        for g in range(len(target_latents))
    ]


def main(argv=None):
    """Runs the search; returns the paths of the saved ``.npz`` files."""
    args = parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    results_dir = os.path.join(REPO_DIR, "results")
    fig_dir = os.path.join(REPO_DIR, "figures")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(results_dir, exist_ok=True)
    os.makedirs(fig_dir, exist_ok=True)

    model, config = build_model_from_config(config_dir, model_dir, args.model_name, args.device)
    img_size = config.architecture.int("img_size")
    fits_paths = ast.literal_eval(args.fits_paths) or config.data.list("train_data_paths")

    groups, multi = _parse_target_groups(args.target_indices)
    target_latents, target_group_images = _extract_group_latents(
        model, os.path.join(data_dir, args.target_fn), groups, img_size, args,
    )
    test_batcher = build_fits_batcher(
        fits_paths,
        bands=config.data.list("bands", ["G", "R", "I", "Z", "Y"]),
        min_bands=config.data.int("min_bands", 2),
        batch_size=args.batch_size,
        img_size=img_size,
        use_calexp=config.data.bool("use_calexp", True),
        shuffle=False,
        use_overlap=True,
        overlap=args.overlap,
    )
    print(f"Searching {len(test_batcher)} sky tiles with overlap {args.overlap}"
          f" for {len(groups)} target group(s)...")
    base = f"{args.model_name}_{args.target_fn[:-3]}"
    outs = []

    if args.bank and args.bank != "None":
        results = bank_sky_search(model, target_latents, test_batcher,
                                  os.path.join(results_dir, args.bank), args)
        for g, (ra_decs, scores, feats) in enumerate(results):
            out = os.path.join(results_dir, f"{base}{f'_g{g}' if multi else ''}_skysearch_results.npz")
            np.savez(out, test_ra_decs=ra_decs, test_scores=scores,
                     target_images=target_group_images[g], target_features=target_latents[g],
                     test_features=feats)
            print(f"Saved results to {out}")
            outs.append(out)
        return outs

    kw = dict(n_save=args.n_save, metric=args.metric, combine=args.combine, use_weights=True,
              max_pool=str2bool(args.max_pool), cls_token=str2bool(args.cls_token))
    if multi:
        results = mim_simsearch_multi(model, target_latents, test_batcher, **kw)
    else:
        results = [mim_simsearch(model, target_latents[0], test_batcher, **kw)]

    for g, (test_images, test_latent, test_ra_decs, test_scores) in enumerate(results):
        tag = f"_g{g}" if multi else ""
        display_images(normalize_images(test_images[: args.n_plot, args.display_channel]),
                       savename=os.path.join(fig_dir, f"{base}{tag}_skysearch_results.png"))
        out = os.path.join(results_dir, f"{base}{tag}_skysearch_results.npz")
        np.savez(out, test_ra_decs=test_ra_decs, test_scores=test_scores,
                 target_images=target_group_images[g], target_features=target_latents[g],
                 test_images=test_images, test_features=test_latent)
        print(f"Saved results to {out}")
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
