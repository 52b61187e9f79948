"""I-JEPA pretraining CLI (port of the repo's ``pretrain_jepa.py``).

    python -m sky_embeddings_tpu_torch.pretrain_jepa <model_name> [-v verbose_iters]
        [-ct cp_minutes] [-dd data_dir] [--device cuda]
        [--set SECTION.key=value ...] [--run_name name]

``<model_name>`` keys ``configs/<model_name>.ini`` (``jepa_tiny``,
``jepa_struct``, ``jepa_1``) and the checkpoint ``models/<model_name>.ckpt.pt``
(resumed when present, else a JAX run's ``.ckpt.msgpack`` of the name; ``--run_name`` keys it instead when ``--set``
overrides make a configuration no file holds). The loop is the MIM twin's
(``train/pretrain.train_network``) over ``train/jepa.JEPATrainer``:
training batches from the h5 file the config names (``train_data_file``)
or, when it names none (``jepa_1``), from the FITS tiles under
``train_data_paths`` through ``FitsTileBatcher``; validation batches from
``val_data_file``; h5 sets whole on the device when ``[DATA] device_cache``
allows (``data/device_cache.py``). When the config names probe sets
(``lp_class_data_file``, ``lp_regress_data_file``) the linear probes of the
online encoder run after each validation pass with ``lp_combine`` pooling.
``--device cpu`` runs it on the CPU.

Several processes, one per GPU, train as the MIM twin's do when the
launcher sets ``SKY_DISTRIBUTED=1``, ``SKY_COORDINATOR_ADDRESS``,
``SKY_NUM_PROCESSES`` and ``SKY_PROCESS_ID`` for each
(``parallel/distributed.initialize_from_env``): each data index reads its
own shard of the h5 sets with ``batch_size // data shards`` rows a batch,
and only process 0 logs and writes the checkpoint. ``[TRAINING]
zero_optimizer = True`` shards the AdamW moments over the data axis, and
``--set TRAINING.tensor_parallel=2`` splits the encoder's blocks over pairs
of consecutive processes (``train/jepa.JEPATrainer``; the predictor's
narrow blocks run whole on both), which then read the same rows. It draws
``figures/<run>_progress.png`` at each validation after the first, where
matplotlib is installed, as JAX's does (an I-JEPA model draws no
reconstruction).
"""

from __future__ import annotations

import os

import torch

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
from sky_embeddings_tpu_torch.data.fits_loader import build_fits_batcher
from sky_embeddings_tpu_torch.parallel import distributed, mesh
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.pretrain import train_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path, find_checkpoint
from sky_embeddings_tpu_torch.utils.misc import build_train_argparser

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    parser = build_train_argparser("I-JEPA pretraining")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="SECTION.key=value", help="Override one config value.")
    parser.add_argument("--run_name", type=str, default=None,
                        help="Name of the checkpoint (defaults to model_name).")
    args = parser.parse_args(argv)
    # several processes (one per GPU): opt-in through SKY_DISTRIBUTED=1
    distributed.initialize_from_env(device=args.device)
    n_proc = distributed.process_count()
    log = distributed.main_only(print)
    device = distributed.rank_device(args.device)
    config_dir = os.path.join(REPO_DIR, "configs")
    model_dir = os.path.join(REPO_DIR, "models")
    fig_dir = os.path.join(REPO_DIR, "figures")
    data_dir = args.data_dir or os.path.join(REPO_DIR, "data")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(fig_dir, exist_ok=True)
    log(f"Using torch {torch.__version__} on {device} ({n_proc} processes)")

    model_name = args.model_name
    config = apply_overrides(load_config(model_name, config_dir), args.overrides, model_name)
    log(f"\nCreating model: {model_name}\n\nConfiguration:")
    log(config.describe())

    trainer = JEPATrainer(config, device=device)
    # the loaders shard over the data axis: under tensor_parallel the ranks
    # of one model group read the same rows
    n_data, data_id = mesh.data_count(), mesh.data_index()
    model_filename = checkpoint_path(model_dir, args.run_name or model_name)  # the port's file
    resume = find_checkpoint(model_dir, args.run_name or model_name)
    if resume and trainer.restore(resume):  # on every process
        log(f"\nResumed from {resume} at iteration {trainer.cur_iter}.")
    else:
        log("\nStarting fresh model to train...")

    data = config.data
    img_size = config.architecture.int("img_size")
    if trainer.batch_size % n_data:
        raise SystemExit(f"batch_size {trainer.batch_size} not divisible by {n_data} "
                         "data shards")
    cached = dict(batch_size=trainer.batch_size // n_data, img_size=img_size, shuffle=True,
                  device=trainer.device, process_count=n_data, process_index=data_id,
                  log_fn=log)
    if "train_data_file" in data:
        train_batcher = build_cached_or_streaming_batcher(
            data, os.path.join(data_dir, data.str("train_data_file")),
            num_workers=data.int("num_workers", 0), **cached)
        log(f"The training set consists of {train_batcher.num_samples} cutouts.")
    else:
        train_batcher = build_fits_batcher(
            data.list("train_data_paths"), bands=data.list("bands"),
            min_bands=data.int("min_bands", 2), batch_size=trainer.batch_size,
            img_size=img_size, cutouts_per_tile=data.int("cutouts_per_tile", 1024),
            use_calexp=data.bool("use_calexp", True), shuffle=True)
        log(f"The training set consists of {len(train_batcher)} sky tiles.")
    val_batcher = build_cached_or_streaming_batcher(
        data, os.path.join(data_dir, data.str("val_data_file")), **cached)

    lp = {key: os.path.join(data_dir, data.str(key)) if key in data else None
          for key in ("lp_class_data_file", "lp_regress_data_file")}
    train_network(
        trainer, train_batcher.forever(), val_batcher, trainer.total_batch_iters,
        args.verbose_iters, args.cp_time, model_filename, fig_dir=fig_dir, **lp,
        lp_combine=data.str("lp_combine", "central"), log_fn=log,
    )
    return model_filename


if __name__ == "__main__":
    main()
    distributed.main_only(print)("\nTraining complete.")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
