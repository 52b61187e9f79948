"""Two real processes through the ``SKY_*`` contract (twin of
``tools/distributed_smoke.py`` and of the data-parallel and ZeRO legs of
``__graft_entry__.dryrun_multichip``).

    python -m sky_embeddings_tpu_torch.parallel.smoke [--device cpu] [--backend gloo] [--h5 PATH]

The launcher writes a synthetic h5 file (unless ``--h5`` names one) and
starts two processes with ``SKY_DISTRIBUTED=1``, a localhost coordinator,
``SKY_NUM_PROCESSES=2`` and ``SKY_PROCESS_ID`` 0 and 1. Each process:

    ``initialize_from_env``                       (parallel/distributed.py)
      -> its disjoint ``H5Batcher`` shard (process_count / process_index)
        -> ``device_prefetch(sharding=batch_sharding(create_mesh()))``
          -> a ``mim_tiny`` ``MIMPretrainer`` (DDP) takes STEPS steps,
             then a second one with ``[TRAINING] zero_optimizer = True``

and prints each leg's losses and a digest of its parameters. The launcher
asserts that both ranks agree bit for bit, and that each leg agrees with
one process trained on the two shards' batches concatenated in rank order
(the global batch), within ``TOL`` (parameters, absolute; losses,
relative), but for the key third of each qkv bias (:func:`param_gaps`).
The h5 reader needs ``h5py``, so it runs where that is installed (not on
the card host of this repository's chip runs, which has none).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PROCESSES = 2
LOCAL_BATCH = 8
STEPS = 2
TOL = 2e-6
LEGS = ("ddp", "zero")


def _config(zero: bool):
    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config

    cfg = load_config("mim_tiny", os.path.join(REPO, "configs"))
    return apply_overrides(cfg, [f"TRAINING.zero_optimizer={zero}",
                                 f"TRAINING.batch_size={LOCAL_BATCH * N_PROCESSES}"], "mim_tiny")


def _batches(h5path: str, index: int, count: int = N_PROCESSES):
    from sky_embeddings_tpu_torch.data.h5_loader import H5Batcher

    batcher = H5Batcher(h5path, batch_size=LOCAL_BATCH, img_size=16, shuffle=True,
                        shuffle_mode="chunk", seed=5, process_count=count, process_index=index)
    it = batcher.forever()
    return [next(it) for _ in range(STEPS)]


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def param_gaps(got: dict, want: dict) -> tuple[float, float]:
    """``(max |got - want| over every parameter but the key biases, max
    over those)``: the key third of each qkv bias and the key half of a
    cross-attention's kv bias. Softmax is invariant to the key bias (q ·
    b_k shifts a row's logits alike), so its gradient is rounding noise,
    which the order of a sum changes and Adam normalises into a step of up
    to lr: those are held to the steps' summed lr instead."""
    rest = keys = 0.0
    for name, w in want.items():
        d = (got[name].double() - w.double()).abs()
        for suffix, parts, key in (("qkv.bias", 3, 1), ("kv.bias", 2, 0)):
            if name.endswith(suffix):
                d = d.reshape(parts, -1)
                keys = max(keys, float(d[key].max()))
                d = d[[i for i in range(parts) if i != key]]
                break
        rest = max(rest, float(d.max()))
    return rest, keys


def _train(trainer, batches) -> list[float]:
    return [float(trainer.train_batch(b)) for b in batches]


def worker(h5path: str, device: str, backend: str, out_dir: str) -> None:
    """Body of one of the two processes (its ``SKY_*`` variables set by
    the launcher)."""
    import torch

    from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
    from sky_embeddings_tpu_torch.parallel import distributed
    from sky_embeddings_tpu_torch.parallel.mesh import batch_sharding, create_mesh
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    torch.set_num_threads(1)
    if not distributed.initialize_from_env(backend=backend or None, device=device):
        raise SystemExit(f"{distributed.ENV_FLAG} not set: the launcher starts this process")
    rank = distributed.process_index()
    dev = distributed.rank_device(device)
    mesh = create_mesh(device_type=dev.type)
    sharding = batch_sharding(mesh)
    if distributed.process_count() != N_PROCESSES or sharding.count != N_PROCESSES:
        raise SystemExit(f"{distributed.process_count()} processes, mesh {mesh}")
    local = list(device_prefetch(_batches(h5path, rank), size=2, sharding=sharding))
    out = {}
    for leg in LEGS:
        trainer = MIMPretrainer(_config(leg == "zero"), seed=0, device=dev)
        out[leg] = {"losses": _train(trainer, local), "digest": _digest(trainer.model),
                    "params": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print(f"SMOKE {rank} " + json.dumps({k: {"losses": v["losses"], "digest": v["digest"]}
                                         for k, v in out.items()}), flush=True)
    torch.distributed.destroy_process_group()


def oracle(h5path: str, device: str) -> dict:
    """One process over the shards' batches concatenated in rank order."""
    import numpy as np

    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    shards = [_batches(h5path, r) for r in range(N_PROCESSES)]
    batches = [{k: np.concatenate([s[i][k] for s in shards]) for k in ("cutouts", "ra_dec")}
               for i in range(STEPS)]
    out = {}
    for leg in LEGS:
        trainer = MIMPretrainer(_config(leg == "zero"), seed=0, device=device)
        out[leg] = {"losses": _train(trainer, batches),
                    "params": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}
    return out


def run_two_process_smoke(h5path: str, device: str = "cuda", backend: str = "",
                          timeout: float = 300.0) -> dict:
    """Start the two processes, check them against each other and against
    :func:`oracle`; returns ``{"per_process": {rank: {leg: ...}}, "oracle":
    {leg: ...}, "max_param_err": {leg: (rest, key biases)}}``. Raises on
    any disagreement."""
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        procs = []
        for pid in range(N_PROCESSES):
            env = dict(os.environ, SKY_DISTRIBUTED="1", SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       SKY_NUM_PROCESSES=str(N_PROCESSES), SKY_PROCESS_ID=str(pid),
                       PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sky_embeddings_tpu_torch.parallel.smoke", "--worker",
                 "--h5", h5path, "--device", device, "--backend", backend, "--out", out_dir],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise RuntimeError(f"worker exited {p.returncode}:\n{out[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = {r: torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(N_PROCESSES)}
    want = oracle(h5path, device)
    lr_sum = STEPS * _config(False).training.float("init_lr")
    errs = {}
    for leg in LEGS:
        a, b = ranks[0][leg], ranks[1][leg]
        if a["digest"] != b["digest"] or a["losses"] != b["losses"]:
            raise RuntimeError(f"{leg}: the ranks disagree: {a['losses']} {b['losses']}")
        errs[leg] = param_gaps(a["params"], want[leg]["params"])
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], want[leg]["losses"]))
        if errs[leg][0] > TOL or errs[leg][1] > lr_sum or loss_err > TOL:
            raise RuntimeError(f"{leg}: two processes against one: parameters {errs[leg][0]:.3e} "
                               f"(bar {TOL}), key biases {errs[leg][1]:.3e} (bar {lr_sum}), "
                               f"losses {loss_err:.3e} (bar {TOL})")
    return {"per_process": {r: {leg: {k: v[k] for k in ("losses", "digest")} for leg, v in d.items()}
                            for r, d in ranks.items()},
            "oracle": {leg: v["losses"] for leg, v in want.items()}, "max_param_err": errs}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default="", help="nccl for CUDA, gloo for the CPU by default")
    parser.add_argument("--h5", default=None)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args.h5, args.device, args.backend, args.out)
        return
    with tempfile.TemporaryDirectory() as td:
        h5 = args.h5
        if h5 is None:
            from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

            h5 = write_synthetic_h5(os.path.join(td, "smoke.h5"), n=128, channels=3, img_size=16,
                                    seed=3)
        print(json.dumps(run_two_process_smoke(h5, args.device, args.backend)))


if __name__ == "__main__":
    main()
