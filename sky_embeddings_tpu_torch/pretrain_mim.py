"""Masked-image-modelling pretraining CLI (port of the repo's ``pretrain_mim.py``).

    python -m sky_embeddings_tpu_torch.pretrain_mim <model_name> [-v verbose_iters]
        [-ct cp_minutes] [-dd data_dir] [--device cuda]
        [--set SECTION.key=value ...] [--run_name name]

``<model_name>`` keys ``configs/<model_name>.ini`` and the checkpoint
``models/<model_name>.ckpt.pt`` (resumed when present; else a JAX run's
``models/<model_name>.ckpt.msgpack`` is resumed, its AdamW moments too, and
the run goes on in the port's file). ``--set`` overrides
config values, so a configuration that no file holds runs from one that
does: ViT-H (``bench.py`` ``bench_vit_h``) is ``mim_32 --set
ARCHITECTURE.model_type=mimhuge --set ARCHITECTURE.embed_dim=1280 --set
TRAINING.remat=False --run_name mim_32_huge``, and MAE at ViT-B
(``bench_mae``) is ``mim_1 --set ARCHITECTURE.model_type=base --set
TRAINING.batch_size=1024 --run_name mae_base``; ``--run_name`` then keys the
checkpoint instead of ``<model_name>``. Training batches come from the h5
file the config names (``train_data_file``) or, when it names none, stream
from the FITS tiles under ``train_data_paths`` (the
production configs' source: HSC ``calexp-HSC-<band>-<tract>-<patch>.fits``
files, ``cutouts_per_tile`` random windows a tile) through
``FitsTileBatcher``, as the JAX twin does; validation batches from
``val_data_file``. ``[DATA] device_cache = True | False | auto`` (default
auto: under ``device_cache_bytes``, 2 GiB) keeps an h5 set whole on the
device and serves each batch as a gather there (``data/device_cache.py``),
else ``H5Batcher`` streams it, as JAX ``pretrain_mim.py:68-78`` does. The
pixel clip runs on the device inside the step. ``--device cpu`` runs it on
the CPU. When the config names probe sets
(``lp_class_data_file``, ``lp_regress_data_file``, h5 files under the data
directory), the linear probes run after each validation pass with
``lp_combine`` pooling (default ``central``); an ``attn_pool`` model (``--set
ARCHITECTURE.attn_pool=True``) probes its one pooled token.

Several processes, one per GPU, train data-parallel when the launcher
sets ``SKY_DISTRIBUTED=1``, ``SKY_COORDINATOR_ADDRESS=<host>:<port>``,
``SKY_NUM_PROCESSES`` and ``SKY_PROCESS_ID`` for each
(``parallel/distributed.initialize_from_env``; rank r on ``cuda:<r % GPUs
a host>``): each process reads its own shard of the h5 sets with
``batch_size // processes`` rows a batch (an error unless they divide),
streams instead of device-caching, and only process 0 logs and writes the
checkpoint. FITS training data is read as JAX reads it across processes:
every process builds the same ``FitsTileBatcher`` with the global
``batch_size``, so each process's rows repeat the others' images (under
their own masks) and the global batch is ``processes x batch_size`` rows
(ROADMAP). ``[TRAINING] zero_optimizer = True`` shards the AdamW moments
over the processes. ``--set TRAINING.tensor_parallel=2`` splits every block
over pairs of consecutive processes (``train/pretrain.py``): the h5 shards,
the batch rows and ZeRO-1 then run over the data axis (processes / 2), and
both processes of a pair read the same rows.

Like JAX's script it draws its figures under ``figures/`` (``train_network``'s
``fig_dir``: the training curves, and each validation's reconstruction as
``<run>_<step>iters[_tiled].png``) on process 0, where matplotlib is
installed; without it each figure is skipped with a warning.
"""

from __future__ import annotations

import os

import torch

from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
from sky_embeddings_tpu_torch.data.fits_loader import build_fits_batcher
from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
from sky_embeddings_tpu_torch.parallel import distributed, mesh
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path, find_checkpoint
from sky_embeddings_tpu_torch.utils.misc import build_train_argparser

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    parser = build_train_argparser("Masked image modelling pretraining")
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

    pretrainer = MIMPretrainer(config, device=device)
    # the loaders shard over the data axis: under tensor_parallel the ranks
    # of one model group read the same rows
    n_data, data_id = mesh.data_count(), mesh.data_index()
    model_filename = checkpoint_path(model_dir, args.run_name or model_name)  # the port's file
    resume = find_checkpoint(model_dir, args.run_name or model_name)
    if resume and pretrainer.restore(resume):  # on every process
        log(f"\nResumed from {resume} at iteration {pretrainer.cur_iter}.")
    else:
        log("\nStarting fresh model to train...")

    data = config.data
    img_size = config.architecture.int("img_size")
    if pretrainer.batch_size % n_data:
        raise SystemExit(f"batch_size {pretrainer.batch_size} not divisible by {n_data} "
                         "data shards")
    # each process feeds its shard; the pixel clip runs on the device inside the step
    cached = dict(batch_size=pretrainer.batch_size // n_data, img_size=img_size, shuffle=True,
                  device=pretrainer.device, process_count=n_data, process_index=data_id,
                  log_fn=log)
    if "train_data_file" in data:
        # [DATA] device_cache picks a device-resident set or the stream
        train_batcher = build_cached_or_streaming_batcher(
            data, os.path.join(data_dir, data.str("train_data_file")),
            num_workers=data.int("num_workers", 0), **cached)
        log(f"The training set consists of {train_batcher.num_samples} cutouts.")
    else:
        # the global batch_size, unsplit, on every process: JAX's multi-process runs read so
        train_batcher = build_fits_batcher(
            data.list("train_data_paths"), bands=data.list("bands"),
            min_bands=data.int("min_bands", 2), batch_size=pretrainer.batch_size,
            img_size=img_size, cutouts_per_tile=data.int("cutouts_per_tile", 1024),
            use_calexp=data.bool("use_calexp", True), shuffle=True)
        log(f"The training set consists of {len(train_batcher)} sky tiles.")
    val_batcher = build_cached_or_streaming_batcher(
        data, os.path.join(data_dir, data.str("val_data_file")), **cached)

    lp = {key: os.path.join(data_dir, data.str(key)) if key in data else None
          for key in ("lp_class_data_file", "lp_regress_data_file")}
    train_network(
        pretrainer, train_batcher.forever(), val_batcher, pretrainer.total_batch_iters,
        args.verbose_iters, args.cp_time, model_filename, fig_dir=fig_dir, **lp,
        lp_combine=data.str("lp_combine", "central"), log_fn=log,
    )
    return model_filename


if __name__ == "__main__":
    main()
    distributed.main_only(print)("\nTraining complete.")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
