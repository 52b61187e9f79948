"""Masked-image-modelling pretraining CLI (port of the repo's ``pretrain_mim.py``).

    python -m sky_embeddings_tpu_torch.pretrain_mim <model_name> [-v verbose_iters]
        [-ct cp_minutes] [-dd data_dir] [--device cuda]

``<model_name>`` keys ``configs/<model_name>.ini`` and the checkpoint
``models/<model_name>.ckpt.pt`` (resumed when present). Training and
validation batches stream from the h5 files the config names
(``train_data_file``, ``val_data_file``) through ``H5Batcher``, with the
pixel clip applied on the device inside the step. ``--device cpu`` runs it
on the CPU.

Not ported yet: FITS tile training data (``train_data_paths``, ROADMAP 1.6),
the device-resident data cache, multi-process runs, and the linear probes
and figures (``train_network`` says so when the config names them).
"""

from __future__ import annotations

import os

import torch

from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path
from sky_embeddings_tpu_torch.utils.misc import build_train_argparser

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    parser = build_train_argparser("Masked image modelling pretraining")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(model_dir, exist_ok=True)
    print(f"Using torch {torch.__version__} on {args.device}")

    model_name = args.model_name
    config = load_config(model_name, config_dir)
    print(f"\nCreating model: {model_name}\n\nConfiguration:")
    print(config.describe())

    pretrainer = MIMPretrainer(config, device=args.device)
    model_filename = checkpoint_path(model_dir, model_name)
    if pretrainer.restore(model_filename):
        print(f"\nResumed from {model_filename} at iteration {pretrainer.cur_iter}.")
    else:
        print("\nStarting fresh model to train...")

    data = config.data
    if "train_data_file" not in data:
        raise NotImplementedError(
            "FITS tile training data (train_data_paths) is not ported yet (ROADMAP 1.6)")
    img_size = config.architecture.int("img_size")
    # the pixel clip runs on the device inside the step
    batcher = dict(batch_size=pretrainer.batch_size, img_size=img_size, shuffle=True,
                   pixel_min=None, pixel_max=None)
    train_batcher = build_h5_batcher(os.path.join(data_dir, data.str("train_data_file")),
                                     num_workers=data.int("num_workers", 0), **batcher)
    print(f"The training set consists of {train_batcher.num_samples} cutouts.")
    val_batcher = build_h5_batcher(os.path.join(data_dir, data.str("val_data_file")), **batcher)

    lp = {key: os.path.join(data_dir, data.str(key)) if key in data else None
          for key in ("lp_class_data_file", "lp_regress_data_file")}
    train_network(
        pretrainer, train_batcher.forever(), val_batcher, pretrainer.total_batch_iters,
        args.verbose_iters, args.cp_time, model_filename, **lp,
    )
    return model_filename


if __name__ == "__main__":
    main()
    print("\nTraining complete.")
