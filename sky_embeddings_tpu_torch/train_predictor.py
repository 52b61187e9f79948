"""Predictor training CLI (port of the repo's ``train_predictor.py``).

    python -m sky_embeddings_tpu_torch.train_predictor <model_name> [-v N] [-ct M]
        [-dd data_dir] [--device cuda] [--set SECTION.key=value ...] [--run_name name]

``<model_name>`` keys ``configs/<model_name>.ini``; the config names its
pretraining config under ``pretained_mae`` (the reference's spelling;
``pretrained_mae`` too), whose architecture the predictor takes. The run
resumes from ``models/<run>_best.ckpt.pt``, else ``models/<run>.ckpt.pt``,
else warm-starts from the pretraining checkpoint
``models/<pretained_mae>.ckpt.pt`` (``pretrain_mim``'s), else starts fresh;
each file may be the JAX package's ``.ckpt.msgpack`` of the name instead
(``utils/checkpoint.find_checkpoint``), and the run writes the port's;
``<run>`` is ``--run_name`` or ``<model_name>``. ``[TRAINING] num_train``
takes a subset of the training file: for ``crossentropy`` the first rows of
each class in proportion (``utils/misc.select_training_indices``), else the
first ``num_train`` rows. Both sets are served by
``data/device_cache.build_cached_or_streaming_batcher`` (``[DATA]
device_cache``); the pixel clip and the augmentations run on the device.
``--device cpu`` runs it on the CPU.

Not ported yet: multi-process runs and the progress figures.
"""

from __future__ import annotations

import os

import torch

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, train_predictor_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path, find_checkpoint
from sky_embeddings_tpu_torch.utils.misc import build_train_argparser, select_training_indices

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def add_twin_args(parser) -> None:
    """The twins' own flags beside the reference's."""
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="SECTION.key=value", help="Override one config value.")
    parser.add_argument("--run_name", type=str, default=None,
                        help="Name of the checkpoint (defaults to model_name).")


def load_configs(args, config_dir: str):
    """(predictor config with the ``--set`` overrides, pretraining config,
    pretraining config's name or None)."""
    config = apply_overrides(load_config(args.model_name, config_dir), args.overrides,
                             args.model_name)
    mae_name = config.pretrained_mae_name()
    mae_config = config if mae_name is None else load_config(mae_name, config_dir)
    return config, mae_config, mae_name


def main(argv=None) -> str:
    parser = build_train_argparser("Predictor training")
    add_twin_args(parser)
    args = parser.parse_args(argv)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(model_dir, exist_ok=True)
    print(f"Using torch {torch.__version__} on {args.device}")

    config, mae_config, mae_name = load_configs(args, config_dir)
    print(f"\nCreating model: {args.model_name}\n\nConfiguration:")
    print(config.describe())

    trainer = PredictorTrainer(config, mae_config, device=args.device)
    run = args.run_name or args.model_name
    model_filename = checkpoint_path(model_dir, run)  # written as the port's file
    best_filename = find_checkpoint(model_dir, run, best=True)
    resume_filename = find_checkpoint(model_dir, run)
    mae_filename = find_checkpoint(model_dir, mae_name) if mae_name else None
    if best_filename and trainer.restore(best_filename):
        print(f"\nResumed from {best_filename} at iteration {trainer.cur_iter}.")
    elif resume_filename and trainer.restore(resume_filename):
        print(f"\nResumed from {resume_filename} at iteration {trainer.cur_iter}.")
    elif mae_filename and trainer.warm_start(mae_filename):
        print(f"\nWarm-started from pretrained MIM checkpoint {mae_filename}.")
    else:
        print("\nStarting fresh model to train...")

    training, data = config.training, config.data
    img_size = config.architecture.int("img_size")
    train_file = os.path.join(data_dir, data.str("train_data_file"))
    num_train = training.int("num_train", -1)
    indices = None
    if num_train > -1:
        if "crossentropy" in training.str("loss_fn").lower():
            indices = select_training_indices(train_file, num_train, balanced=False)
        else:
            indices = list(range(num_train))
    batcher = dict(batch_size=trainer.batch_size, img_size=img_size,
                   label_keys=data.list("label_keys"), device=trainer.device)
    train_batcher = build_cached_or_streaming_batcher(
        data, train_file, shuffle=True, indices=indices, num_workers=data.int("num_workers", 0),
        **batcher)
    print(f"The training set consists of {train_batcher.num_samples} cutouts.")
    val_batcher = build_cached_or_streaming_batcher(
        data, os.path.join(data_dir, data.str("val_data_file")), shuffle=True, **batcher)

    train_predictor_network(trainer, train_batcher.forever(), val_batcher, args.verbose_iters,
                            args.cp_time, model_filename)
    return model_filename


if __name__ == "__main__":
    main()
    print("\nTraining complete.")
