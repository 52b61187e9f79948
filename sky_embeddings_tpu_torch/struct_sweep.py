"""Predictor size sweep on the structured synthetic survey (port of the repo's
``tools/struct_sweep.py``).

    python -m sky_embeddings_tpu_torch.struct_sweep [-f ft fs ap]
        [-s 128 512 2048 8192 12k] [--seeds N] [-v 250] [--quick] [--device cuda]

The reference's claim is a curve: fine-tuning a pretrained backbone beats
training from scratch when labels are few, and the gap closes as they grow.
This trains the ``z_struct_{ft,fs,ap}_<N>`` config families on the survey's
redshift task through ``semantic_validation.run_finetune`` (the survey built
in memory and served from ``DeviceDataset``), each config at seeds
0..N-1, and scores each run's best checkpoint, as soon as it is trained,
through the compare twin's ``evaluate_model`` on ``struct_z_val``. ``ft`` and ``ap`` warm-start from
the ``mim_struct`` checkpoint in ``models/``, the port's or the JAX
package's; without one, ``semantic_validation``'s pretrain stage trains it
first. Runs checkpoint and resume, so an interrupted sweep can be relaunched.
A ViT-B run writes about 1 GB at each improved validation: ``--run_dir``
puts the runs' checkpoints elsewhere (a RAM disk) and ``--prune`` deletes
each run's once it is scored.

Writes ``results/compare_predictors_struct_torch.json``: under each family
the JAX tool's rows (``num_train``, ``bias``, ``mad``, ``outlier_frac``) with
a ``seed`` each, sorted by size; ``by_size``, each family's mean, standard
deviation, minimum and maximum of every metric over the seeds; ``ft_below_fs``,
the seeds at which ``ft``'s MAD is below ``fs``'s at each size; each run's
training seconds. Rows of seeds and families that this run does not train
are kept from the file's earlier contents, so a sweep can be split across
runs (``--first_seed``). The JAX run's ``results/compare_predictors_struct.json``
stays as it is. The figure of the means goes to
``figures/compare_predictors_struct_torch.png`` where matplotlib imports.
``--quick`` runs a tiny shape for the CPU (``num_train`` an eighth of each
size) and writes ``..._quick`` files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sky_embeddings_tpu_torch.compare_predictors import evaluate_model, plot_results
from sky_embeddings_tpu_torch.semantic_validation import (
    QUICK_MIM, QUICK_PRED, REPO_DIR, make_survey, run_finetune, run_name, run_pretrain,
    survey_set)
from sky_embeddings_tpu_torch.utils.checkpoint import find_checkpoint

METRICS = ("bias", "mad", "outlier_frac")


def quick_overrides(size: str, quick: bool) -> list:
    """``--quick`` scales each size's ``num_train`` by 1/8 onto the quick
    survey's 128 training rows (128 -> 16, 512 -> 64; the full set from
    1024 up), so that the sizes stay apart."""
    if not quick:
        return []
    n = int(float(size[:-1]) * 1000) if size.endswith("k") else int(size)
    return [f"TRAINING.num_train={n // 8 if n // 8 < 128 else -1}"]


def summarize(rows: list) -> list:
    """Per ``num_train``: the seeds and each metric's mean, std, min, max."""
    out = []
    for n in sorted({r["num_train"] for r in rows}):
        at = [r for r in rows if r["num_train"] == n]
        s = {"num_train": n, "seeds": len(at)}
        for m in METRICS:
            v = np.array([r[m] for r in at], np.float64)
            s.update({f"{m}_mean": float(v.mean()), f"{m}_std": float(v.std()),
                      f"{m}_min": float(v.min()), f"{m}_max": float(v.max())})
        out.append(s)
    return out


def ft_below_fs(rows: dict) -> list:
    """Per size, the seeds at which ``ft``'s MAD is below ``fs``'s."""
    ft = {(r["num_train"], r["seed"]): r["mad"] for r in rows.get("z_struct_ft", [])}
    fs = {(r["num_train"], r["seed"]): r["mad"] for r in rows.get("z_struct_fs", [])}
    both = sorted(set(ft) & set(fs))
    return [{"num_train": n, "seeds": sum(1 for k in both if k[0] == n),
             "ft_below_fs": sum(1 for k in both if k[0] == n and ft[k] < fs[k])}
            for n in sorted({k[0] for k in both})]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--families", nargs="+", default=["ft", "fs", "ap"])
    ap.add_argument("-s", "--sizes", nargs="+", default=["128", "512", "2048", "8192", "12k"])
    ap.add_argument("--seeds", type=int, default=1, help="train each config at seeds 0..N-1")
    ap.add_argument("--first_seed", type=int, default=0,
                    help="skip the seeds below this one (a sweep split across runs)")
    ap.add_argument("-v", "--verbose_iters", type=int, default=250)
    ap.add_argument("--quick", action="store_true", help="tiny shape for the CPU")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--run_dir", type=str, default=None,
                    help="where the runs' checkpoints go (default models/)")
    ap.add_argument("--prune", action="store_true",
                    help="delete each run's checkpoints once it is scored")
    args = ap.parse_args(argv)
    config_dir, model_dir = os.path.join(REPO_DIR, "configs"), os.path.join(REPO_DIR, "models")
    tag = "_quick" if args.quick else ""

    t0 = time.perf_counter()
    mim = find_checkpoint(model_dir, "mim_struct" + tag)
    pretrain = mim is None and any(f in ("ft", "ap") for f in args.families)
    if pretrain:
        survey = make_survey(args.quick)
    else:
        survey = {name: survey_set(name, args.quick) for name in ("struct_z_train", "struct_z_val")}
    seconds: dict = {"survey": time.perf_counter() - t0}
    print(f"Survey made in {seconds['survey']:.1f} s.", flush=True)
    if pretrain:
        print("No mim_struct checkpoint: pretraining it first.", flush=True)
        t0 = time.perf_counter()
        run_pretrain(survey, 500, args.quick, args.device)
        seconds["pretrain"] = time.perf_counter() - t0
    else:
        print(f"Warm starts read {mim}.", flush=True)

    # sizes outermost, so an interrupted sweep still has every family at the
    # smallest sizes; each run is scored as soon as it is trained
    run_dir = args.run_dir or model_dir
    train_rows = len(survey["struct_z_train"]["cutouts"])
    rows: dict = {f"z_struct_{fam}": [] for fam in args.families}
    for size in args.sizes:
        for fam in args.families:
            name = f"z_struct_{fam}_{size}"
            over = quick_overrides(size, args.quick)
            for seed in range(args.first_seed, args.seeds):
                run = run_name(name, args.quick, seed)
                print(f"\n=== {name} seed {seed} ===", flush=True)
                t0 = time.perf_counter()
                run_finetune(name, survey, args.verbose_iters, args.quick, args.device, seed=seed,
                             overrides=over, run_dir=run_dir)
                seconds[run] = time.perf_counter() - t0
                out = evaluate_model(
                    name, config_dir, run_dir, run=run, val=survey["struct_z_val"],
                    train_rows=train_rows, overrides=(QUICK_PRED if args.quick else []) + over,
                    mae_overrides=QUICK_MIM if args.quick else (), device=args.device)
                if out is None:
                    raise SystemExit(f"{name} seed {seed}: no checkpoint to score")
                rows[f"z_struct_{fam}"].append({"num_train": out[0], "seed": seed, **out[1]})
                print(f"{name} seed {seed}: MAD {out[1]['mad']:.4f}, trained in "
                      f"{seconds[run]:.1f} s", flush=True)
                if args.prune:
                    for best in (True, False):
                        path = find_checkpoint(run_dir, run, best=best)
                        if path:
                            os.remove(path)
    out_name = "compare_predictors_struct_torch" + tag
    path = os.path.join(REPO_DIR, "results", out_name + ".json")
    if os.path.exists(path):  # an earlier part of the sweep: keep its other rows
        with open(path) as f:
            old = json.load(f)
        for family in rows:
            done = {(r["num_train"], r["seed"]) for r in rows[family]}
            rows[family] += [r for r in old.get(family, [])
                             if (r["num_train"], r["seed"]) not in done]
        seconds = {**old.get("seconds", {}), **seconds}
    for family in rows:
        rows[family].sort(key=lambda r: (r["num_train"], r["seed"]))

    results = dict(rows)
    results["by_size"] = {fam: summarize(r) for fam, r in rows.items()}
    results["ft_below_fs"] = ft_below_fs(rows)
    results["seconds"] = seconds
    results["device"] = (torch.cuda.get_device_name(0)
                         if torch.device(args.device).type == "cuda" else args.device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nWrote {path}")
    for fam, summary in results["by_size"].items():
        for s in summary:
            print(f"{fam} {s['num_train']:>6}: MAD {s['mad_mean']:.4f} "
                  f"[{s['mad_min']:.4f}, {s['mad_max']:.4f}] over {s['seeds']} seeds")
    for r in results["ft_below_fs"]:
        print(f"ft < fs at {r['num_train']}: {r['ft_below_fs']} of {r['seeds']} seeds")
    means = {fam: [(s["num_train"], {m: s[f"{m}_mean"] for m in METRICS}) for s in summary]
             for fam, summary in results["by_size"].items()}
    plot_results(means, os.path.join(REPO_DIR, "figures", out_name + ".png"))
    return results


if __name__ == "__main__":
    main()
