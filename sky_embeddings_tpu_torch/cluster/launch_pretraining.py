"""Generate a pretraining config + submit a chained training job (port of
``sky_embeddings_tpu/cluster/launch_pretraining.py``, reference
``cc/launch_pretraining.py``).

    python -m sky_embeddings_tpu_torch.cluster.launch_pretraining <model_name> -vdf <val.h5>
        [-tdf <train.h5> | -tdp "['<tile dir>']"] ... [--backend local|slurm|gcloud]
        [--accelerator h100-1|h100-2|h100-4|h100-8] [--num_runs N] [--dry_run]

Writes ``configs/<model_name>.ini`` from the arguments (config-as-artifact;
the same INI text as the JAX launcher for the same arguments), builds the
job script (the ``pretrain_mim`` twin, ``python -m
sky_embeddings_tpu_torch.pretrain_mim``, one process per GPU of the
accelerator through the ``SKY_*`` contract) and submits ``num_runs``
chained allocations through ``queue_gpu.JobQueue``; each run resumes from
the last checkpoint.
"""

from __future__ import annotations

import argparse
import os

from sky_embeddings_tpu_torch.cluster.queue_gpu import ACCELERATORS, JobQueue, JobSpec
from sky_embeddings_tpu_torch.configuration import Config

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser("Launch MIM pretraining", add_help=True)
    p.add_argument("model_name", type=str)
    # DATA
    p.add_argument("-tdf", "--train_data_file", type=str, default=None,
                   help="h5 training file (omit to train from FITS paths)")
    p.add_argument("-tdp", "--train_data_paths", type=str, default="[]")
    p.add_argument("-bands", "--bands", type=str, default="['G','R','I','Z','Y']")
    p.add_argument("-mb", "--min_bands", type=int, default=5)
    p.add_argument("-cpt", "--cutouts_per_tile", type=int, default=1024)
    p.add_argument("-vdf", "--val_data_file", type=str, required=True)
    p.add_argument("-lpc", "--lp_class_data_file", type=str, default=None)
    p.add_argument("-lpr", "--lp_regress_data_file", type=str, default=None)
    p.add_argument("-lpcmb", "--lp_combine", type=str, default="central")
    p.add_argument("-uc", "--use_calexp", type=str, default="True")
    # TRAINING
    p.add_argument("-bs", "--batch_size", type=int, default=64)
    p.add_argument("-ti", "--total_batch_iters", type=float, default=1_000_000)
    p.add_argument("-mmr", "--max_mask_ratio", type=float, default=0.9)
    p.add_argument("-mr", "--mask_ratio", type=float, default=0.75)
    p.add_argument("-npl", "--norm_pix_loss", type=str, default="True")
    p.add_argument("-wd", "--weight_decay", type=float, default=0.05)
    p.add_argument("-lr", "--init_lr", type=float, default=1e-4)
    p.add_argument("-flf", "--final_lr_factor", type=float, default=1e7)
    p.add_argument("-loss", "--loss_fn", type=str, default="L1")
    # ARCHITECTURE
    p.add_argument("-is", "--img_size", type=int, default=64)
    p.add_argument("-nc", "--num_channels", type=int, default=5)
    p.add_argument("-ed", "--embed_dim", type=int, default=768)
    p.add_argument("-ps", "--patch_size", type=int, default=8)
    p.add_argument("-mt", "--model_type", type=str, default="simmim")
    p.add_argument("-ap", "--attn_pool", type=str, default="False")
    p.add_argument("-rd", "--ra_dec", type=str, default="False")
    p.add_argument("-cmt", "--comment", type=str, default="")
    # Cluster
    p.add_argument("-acc", "--accelerator", type=str, default="h100-8", choices=sorted(ACCELERATORS))
    p.add_argument("-nr", "--num_runs", type=int, default=7)
    p.add_argument("-tl", "--time_limit", type=str, default="03:00:00")
    p.add_argument("-be", "--backend", type=str, default="local",
                   choices=["local", "slurm", "gcloud"])
    p.add_argument("-dd", "--data_dir", type=str, default=None)
    p.add_argument("--dry_run", action="store_true")
    return p.parse_args(argv)


def build_config(args) -> Config:
    data: dict = {"val_data_file": args.val_data_file}
    if args.train_data_file:
        data["train_data_file"] = args.train_data_file
    else:
        data.update(
            train_data_paths=args.train_data_paths,
            bands=args.bands,
            min_bands=args.min_bands,
            cutouts_per_tile=args.cutouts_per_tile,
            use_calexp=args.use_calexp,
        )
    if args.lp_class_data_file:
        data["lp_class_data_file"] = args.lp_class_data_file
    if args.lp_regress_data_file:
        data["lp_regress_data_file"] = args.lp_regress_data_file
    data["lp_combine"] = args.lp_combine

    training = dict(
        batch_size=args.batch_size,
        total_batch_iters=args.total_batch_iters,
        norm_pix_loss=args.norm_pix_loss,
        weight_decay=args.weight_decay,
        init_lr=args.init_lr,
        final_lr_factor=args.final_lr_factor,
        loss_fn=args.loss_fn,
    )
    if "mim" in args.model_type:
        training["max_mask_ratio"] = args.max_mask_ratio
    else:
        training["mask_ratio"] = args.mask_ratio

    architecture = dict(
        img_size=args.img_size,
        num_channels=args.num_channels,
        pixel_mean=0.0,
        pixel_std=1.0,
        embed_dim=args.embed_dim,
        patch_size=args.patch_size,
        model_type=args.model_type,
        attn_pool=args.attn_pool,
        ra_dec=args.ra_dec,
    )
    return Config.from_dict(
        {"DATA": data, "TRAINING": training, "ARCHITECTURE": architecture,
         "Notes": {"comment": args.comment or "generated by launch_pretraining"}},
        name=args.model_name,
    )


def main(argv=None) -> list[str]:
    args = parse_args(argv)
    config_path = os.path.join(REPO_DIR, "configs", f"{args.model_name}.ini")
    if os.path.exists(config_path) and not args.dry_run:
        print(f"Config {config_path} exists; overwriting.")
    build_config(args).to_ini(config_path)
    print(f"Wrote {config_path}")

    data_flag = f" -dd {args.data_dir}" if args.data_dir else ""
    command = (f"cd {REPO_DIR} && python -m sky_embeddings_tpu_torch.pretrain_mim "
               f"{args.model_name} -v 10000 -ct 15{data_flag}")
    queue = JobQueue(os.path.join(REPO_DIR, "scripts"), backend=args.backend)
    spec = JobSpec(
        name=args.model_name,
        command=command,
        accelerator=args.accelerator,
        time_limit=args.time_limit,
        num_runs=args.num_runs,
    )
    submitted = queue.submit(spec, dry_run=args.dry_run)
    print(f"Submitted ({args.backend}): {submitted}")
    return submitted


if __name__ == "__main__":
    main()
