"""Generate a predictor config + submit a chained training (+ eval) job (port
of ``sky_embeddings_tpu/cluster/launch_predictor.py``, reference
``cc/launch_predictor.py``).

    python -m sky_embeddings_tpu_torch.cluster.launch_predictor <model_name> -mae <mim config>
        -tdf <train.h5> -vdf <val.h5> ... [--backend local|slurm|gcloud]
        [--accelerator h100-1|h100-2|h100-4|h100-8] [--run_eval] [--dry_run]

Writes ``configs/<model_name>.ini`` (the same INI text as the JAX launcher
for the same arguments) and submits the ``train_predictor`` twin, one
process per GPU through the ``SKY_*`` contract, as ``num_runs`` chained
allocations through ``queue_gpu.JobQueue``. ``--run_eval`` appends the
``test_predictor`` twin, which rank 0 alone runs once training has ended.
"""

from __future__ import annotations

import argparse
import os

from sky_embeddings_tpu_torch.cluster.queue_gpu import ACCELERATORS, JobQueue, JobSpec
from sky_embeddings_tpu_torch.configuration import Config

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser("Launch predictor training", add_help=True)
    p.add_argument("model_name", type=str)
    # DATA
    p.add_argument("-tdf", "--train_data_file", type=str, required=True)
    p.add_argument("-vdf", "--val_data_file", type=str, required=True)
    p.add_argument("-lk", "--label_keys", type=str, default="['zspec']")
    p.add_argument("-ncl", "--num_classes", type=int, default=None)
    p.add_argument("-lm", "--label_means", type=str, default="[0.64]")
    p.add_argument("-ls", "--label_stds", type=str, default="[0.64]")
    # TRAINING
    p.add_argument("-tm", "--train_method", type=str, default="ft",
                   choices=["ft", "lp", "fs"])
    p.add_argument("-mae", "--pretrained_mae", type=str, required=True)
    p.add_argument("-nt", "--num_train", type=int, default=-1)
    p.add_argument("-bs", "--batch_size", type=int, default=128)
    p.add_argument("-ti", "--total_batch_iters", type=float, default=30_000)
    p.add_argument("-ld", "--layer_decay", type=float, default=0.5)
    p.add_argument("-wd", "--weight_decay", type=float, default=0.01)
    p.add_argument("-lr", "--init_lr", type=float, default=1e-6)
    p.add_argument("-flf", "--final_lr_factor", type=float, default=1e3)
    p.add_argument("-aug", "--augment", type=str, default="True")
    p.add_argument("-br", "--brightness", type=float, default=0.8)
    p.add_argument("-no", "--noise", type=float, default=0.1)
    p.add_argument("-nch", "--nan_channels", type=int, default=5)
    p.add_argument("-ule", "--use_label_errs", type=str, default="False")
    p.add_argument("-loss", "--loss_fn", type=str, default="mse")
    # ARCHITECTURE
    p.add_argument("-is", "--img_size", type=int, default=64)
    p.add_argument("-gp", "--global_pool", type=str, default="map")
    p.add_argument("-do", "--dropout", type=float, default=0.0)
    p.add_argument("-cmt", "--comment", type=str, default="")
    # Cluster
    p.add_argument("-acc", "--accelerator", type=str, default="h100-8", choices=sorted(ACCELERATORS))
    p.add_argument("-nr", "--num_runs", type=int, default=3)
    p.add_argument("-tl", "--time_limit", type=str, default="03:00:00")
    p.add_argument("-be", "--backend", type=str, default="local",
                   choices=["local", "slurm", "gcloud"])
    p.add_argument("-dd", "--data_dir", type=str, default=None)
    p.add_argument("--run_eval", action="store_true",
                   help="append a test_predictor run (on rank 0) after training")
    p.add_argument("--dry_run", action="store_true")
    return p.parse_args(argv)


def build_config(args) -> Config:
    data = dict(
        train_data_file=args.train_data_file,
        val_data_file=args.val_data_file,
        label_keys=args.label_keys,
        label_means=args.label_means,
        label_stds=args.label_stds,
    )
    if args.num_classes is not None:
        data["num_classes"] = args.num_classes
    training = dict(
        train_method=args.train_method,
        pretained_mae=args.pretrained_mae,  # reference key spelling preserved
        num_train=args.num_train,
        batch_size=args.batch_size,
        total_batch_iters=args.total_batch_iters,
        layer_decay=args.layer_decay,
        weight_decay=args.weight_decay,
        init_lr=args.init_lr,
        final_lr_factor=args.final_lr_factor,
        augment=args.augment,
        brightness=args.brightness,
        noise=args.noise,
        nan_channels=args.nan_channels,
        use_label_errs=args.use_label_errs,
        loss_fn=args.loss_fn,
    )
    architecture = dict(
        img_size=args.img_size, global_pool=args.global_pool, dropout=args.dropout
    )
    return Config.from_dict(
        {"DATA": data, "TRAINING": training, "ARCHITECTURE": architecture,
         "Notes": {"comment": args.comment or "generated by launch_predictor"}},
        name=args.model_name,
    )


def main(argv=None) -> list[str]:
    args = parse_args(argv)
    config_path = os.path.join(REPO_DIR, "configs", f"{args.model_name}.ini")
    build_config(args).to_ini(config_path)
    print(f"Wrote {config_path}")

    data_flag = f" -dd {args.data_dir}" if args.data_dir else ""
    command = (f"cd {REPO_DIR} && python -m sky_embeddings_tpu_torch.train_predictor "
               f"{args.model_name} -v 1000 -ct 15{data_flag}")
    if args.run_eval:  # once, on rank 0
        command += (f' && if [ "$SKY_PROCESS_ID" = 0 ]; then python -m '
                    f"sky_embeddings_tpu_torch.test_predictor {args.model_name}{data_flag}; fi")
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
