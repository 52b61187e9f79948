"""Two gloo ranks on the CPU for the port's data-parallel tests
(``test_torch_zero.py``, ``test_torch_parallel.py``).

:func:`run_ranks` spawns the ranks with ``torch.multiprocessing``; each
sets the ``SKY_*`` variables, calls ``parallel/distributed.initialize_from_env``
and runs one job of this module on a payload the test wrote, and the test
reads each rank's result. This module imports neither JAX nor the JAX
package, so that a spawned rank starts quickly: the tests compute their
JAX references in their own process.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch

N_RANKS = 2


def run_ranks(job, payload: dict, n: int = N_RANKS, timeout: float = 240.0) -> list:
    """``job(rank, payload)`` on ``n`` spawned ranks of one gloo group;
    the ranks' results in rank order. A rank that fails raises here."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        payload = dict(payload, out_dir=payload.get("out_dir", out))
        torch.save(payload, os.path.join(out, "payload.pt"))
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(job, port, n, out), nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{job.__name__} did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(n)]


def _entry(rank: int, job, port: int, n: int, out: str) -> None:
    os.environ.update(SKY_DISTRIBUTED="1", SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      SKY_NUM_PROCESSES=str(n), SKY_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from sky_embeddings_tpu_torch.parallel import distributed

    assert distributed.initialize_from_env(log_fn=lambda m: None, device="cpu")
    assert (distributed.process_count(), distributed.process_index()) == (n, rank)
    payload = torch.load(os.path.join(out, "payload.pt"), weights_only=False)
    result = job(rank, payload)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# -- helpers the tests share ----------------------------------------------------

def local_rows(x, rank: int, n: int = N_RANKS):
    """This rank's rows of a global array or batch dict."""
    if isinstance(x, dict):
        return {k: local_rows(v, rank, n) for k, v in x.items()}
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def grads(model) -> dict:
    return {n: (None if p.grad is None else p.grad.detach().clone())
            for n, p in model.named_parameters()}


def mim_config(d: dict, **training):
    from sky_embeddings_tpu_torch.configuration import Config

    d = {sec: dict(kv) for sec, kv in d.items()}
    d["TRAINING"].update({k: str(v) for k, v in training.items()})
    return Config.from_dict(d)


def _patch_depth(depth: dict) -> None:
    """The port's size tables cut as the test cut them in its process."""
    from sky_embeddings_tpu_torch.models import jepa, mim

    for size, over in depth.get("mim", {}).items():
        mim._SIZES[size].update(over)
    for size, over in depth.get("jepa", {}).items():
        jepa._SIZES[size].update(over)


def _local_states(optimizer) -> dict:
    from sky_embeddings_tpu_torch.parallel import zero

    return {id(p): {k: v.clone() for k, v in s.items()} for p, s in zero.local(optimizer).state.items()}


# -- jobs -------------------------------------------------------------------------

def mim_job(rank: int, p: dict) -> dict:
    """The SimMIM checks of ``test_torch_zero.py`` on one rank: the mesh,
    the sharded prefetch, the global loss denominator, remat under DDP,
    three ZeRO-1 steps beside three unsharded DDP steps, the checkpoint in
    both formats and the steps restored from each."""
    from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
    from sky_embeddings_tpu_torch.models.mim import build_mim_model
    from sky_embeddings_tpu_torch.parallel import distributed, zero
    from sky_embeddings_tpu_torch.parallel.mesh import batch_sharding, create_mesh, replicated
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    _patch_depth(p["depth"])
    out: dict = {}
    mesh = create_mesh(device_type="cpu")
    out["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    out["batch_sharding"] = batch_sharding(mesh)
    out["replicated"] = replicated(mesh)
    b0 = local_rows(p["batches"][0], rank)
    got = next(device_prefetch([b0], sharding=out["batch_sharding"]))
    def same(a, v):  # NaN bands included
        return torch.allclose(a, torch.as_tensor(v), rtol=0, atol=0, equal_nan=True)

    out["prefetch_equal"] = all(same(got[k], v) for k, v in b0.items())
    out["put_global_equal"] = all(
        same(t, b0[k]) for k, t in distributed.put_global(b0, out["batch_sharding"]).items())

    # the loss denominator: one forward and backward through DDP
    cfg = mim_config(p["cfg"])
    x, m = (torch.from_numpy(local_rows(a, rank)) for a in (p["nan_cutouts"], p["nan_mask"]))
    for remat in (False, True):
        model = build_mim_model(cfg, device="cpu", remat=remat)
        model.load_state_dict(p["params"])
        ddp = distributed.data_parallel(model, torch.device("cpu"))
        loss = ddp(x, m)[0]
        loss.backward()
        out["remat" if remat else "stored"] = {"loss": loss.detach(), "grads": grads(model)}

    # three steps, ZeRO-1 and unsharded, from the same params and masks
    runs = {}
    for zero_on in (True, False):
        tr = MIMPretrainer(mim_config(p["cfg"], zero_optimizer=zero_on), dtype=torch.float32,
                           device="cpu")
        tr.model.load_state_dict(p["params"])
        losses = [float(tr.train_batch(local_rows(b, rank), mask=torch.from_numpy(local_rows(mk, rank))))
                  for b, mk in zip(p["batches"][:3], p["masks"][:3])]
        runs[zero_on] = tr
        out["zero" if zero_on else "ddp"] = {"losses": losses, "params": state(tr.model),
                                             "sharded": zero.is_sharded(tr.optimizer),
                                             "moment_bytes": zero.moment_bytes(tr.optimizer)}
    tr = runs[True]
    names = {id(q): n for n, q in tr.model.named_parameters()}
    out["zero"]["local_state_names"] = sorted(names[id(q)] for q in zero.local(tr.optimizer).state)
    out["zero"]["all_names"] = sorted(names.values())
    before = _local_states(tr.optimizer)
    paths = {fmt: os.path.join(p["out_dir"], "zero" + fmt) for fmt in (".ckpt.pt", ".ckpt.msgpack")}
    for path in paths.values():
        tr.save(path)  # every rank: the moments collected, rank 0 writes
    if rank == 0:
        states = zero.param_states(tr.optimizer)
        plain = runs[False].optimizer
        out["consolidated_equal_unsharded"] = all(
            torch.equal(states[q_z][k], plain.state[q_p][k])
            for q_z, q_p in zip(tr.model.parameters(), runs[False].model.parameters())
            for k in ("exp_avg", "exp_avg_sq", "step"))
    torch.distributed.barrier()
    next_batch = local_rows(p["batches"][3], rank)
    next_mask = torch.from_numpy(local_rows(p["masks"][3], rank))
    tr.train_batch(next_batch, mask=next_mask)
    uninterrupted = state(tr.model)
    out["restored"] = {}
    for fmt, path in paths.items():
        fresh = MIMPretrainer(mim_config(p["cfg"], zero_optimizer=True), dtype=torch.float32,
                              device="cpu")
        fresh_names = {id(q): n for n, q in fresh.model.named_parameters()}
        assert fresh.restore(path) and fresh.cur_iter == 3
        restored = _local_states(fresh.optimizer)
        by_name = {fresh_names[k]: v for k, v in restored.items()}
        want = {names[k]: v for k, v in before.items()}
        same_state = set(by_name) == set(want) and all(
            torch.equal(by_name[n][k], want[n][k]) for n in want for k in want[n])
        fresh.train_batch(next_batch, mask=next_mask)
        out["restored"][fmt] = {"state_equal": same_state, "step_bit_equal": all(
            torch.equal(v, uninterrupted[k]) for k, v in state(fresh.model).items())}
    return out


def predictor_jepa_job(rank: int, p: dict) -> dict:
    """Three ZeRO-1 steps of the predictor (``ft``) and of I-JEPA on this
    rank's rows of the global batches; the ``lp`` regime's optimizer."""
    from sky_embeddings_tpu_torch.configuration import Config
    from sky_embeddings_tpu_torch.parallel import zero
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer

    _patch_depth(p["depth"])
    out: dict = {}
    mim = Config.from_dict(p["mim_cfg"])
    pred = PredictorTrainer(Config.from_dict(p["pred_cfg"]), mim, dtype=torch.float32, seed=2,
                            device="cpu")
    pred.model.load_state_dict(p["pred_params"])
    losses = [[float(v) for v in pred.train_batch(local_rows(b, rank))] for b in p["pred_batches"]]
    val = [float(v) for v in pred.eval_batch(local_rows(p["pred_batches"][0], rank))]
    out["predictor"] = {"losses": losses, "val": val, "params": state(pred.model),
                        "sharded": zero.is_sharded(pred.optimizer)}
    lp = PredictorTrainer(Config.from_dict({**p["pred_cfg"], "TRAINING": {
        **p["pred_cfg"]["TRAINING"], "train_method": "lp"}}), mim, dtype=torch.float32,
        device="cpu")
    out["lp_sharded"] = zero.is_sharded(lp.optimizer)

    jepa = JEPATrainer(Config.from_dict(p["jepa_cfg"]), seed=4, device="cpu")
    losses = [float(jepa.train_batch({"cutouts": local_rows(b, rank)})) for b in p["jepa_batches"]]
    out["jepa"] = {"losses": losses, "val": float(jepa.eval_batch(
        {"cutouts": local_rows(p["jepa_batches"][0], rank)})), "params": state(jepa.model),
        "target": state(jepa.target), "sharded": zero.is_sharded(jepa.optimizer)}
    # the MIM and predictor trainers at tensor_parallel = 2: the mesh, the
    # groups and this rank's shapes
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    out["tp_built"] = {}
    for name, tr in (("mim", MIMPretrainer(mim_config(p["mim_cfg"], tensor_parallel=2),
                                           device="cpu")),
                     ("predictor", PredictorTrainer(mim_config(p["pred_cfg"], tensor_parallel=2),
                                                    mim, device="cpu"))):
        blk = tr.model.encoder.block0
        out["tp_built"][name] = {
            "mesh": (tr.mesh.shape, tr.mesh.data_index, tr.mesh.model_index),
            "model_group": torch.distributed.get_process_group_ranks(tr.mesh.model_group),
            "qkv": tuple(blk.attn.qkv.kernel.shape), "fc2": tuple(blk.ffn.fc2_kernel.shape),
            "patch": tuple(tr.model.patch_embed.proj.kernel.shape)}
    return out



def _tp_steps(tr, p: dict, key: str, rank_rows) -> dict:
    """Three steps of a MIM trainer on this rank's rows of ``p[key]``'s
    batches and maskings (SimMIM masks or MAE noise), then its losses, the
    whole parameters (gathered over the model group) and the replicated
    ones as this rank holds them."""
    from sky_embeddings_tpu_torch.parallel.sharding import gather_to_main, shard_of

    losses = []
    for b, mk in zip(p[key]["batches"][:3], p[key]["maskings"][:3]):
        m = torch.from_numpy(rank_rows(mk))
        kw = {"mask": m} if tr.model.simmim else {"noise": m}
        losses.append(float(tr.train_batch(rank_rows(b), **kw)))
    local = state(tr.model)
    return {"losses": losses, "params": gather_to_main(local, tr.mesh),
            "replicated": {k: v for k, v in local.items() if shard_of(k) is None}}


def tp_job(rank: int, p: dict) -> dict:
    """The tensor-parallel checks of ``test_torch_tp.py`` on one rank of
    ``tensor_parallel = 2`` (data 1 x model 2): the mesh and its groups;
    three SimMIM and three MAE steps from the whole params, every rank on
    the whole batch; the checkpoint in both formats, written by rank 0,
    restored on both ranks (the next step bit-equal to the uninterrupted
    one); three predictor ``ft`` steps and an ``lp`` evaluation."""
    from sky_embeddings_tpu_torch.configuration import Config
    from sky_embeddings_tpu_torch.parallel import distributed
    from sky_embeddings_tpu_torch.parallel.sharding import gather_to_main, shard_state
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    _patch_depth(p["depth"])
    out: dict = {}
    whole = lambda x: x  # noqa: E731  (one data index: every rank takes the whole batch)
    for key in ("simmim", "mae"):
        tr = MIMPretrainer(mim_config(p[key]["cfg"], tensor_parallel=2), dtype=torch.float32,
                           device="cpu")
        m = tr.mesh
        out.setdefault("mesh", (m.shape, m.data_index, m.model_index, distributed.batch_rows(8),
                                tr.forward is tr.model))
        tr.model.load_state_dict(shard_state(p[key]["params"], m.model_index, m.tp))
        out[key] = _tp_steps(tr, p, key, whole)
        if key == "simmim":
            paths = {fmt: os.path.join(p["out_dir"], "tp" + fmt)
                     for fmt in (".ckpt.pt", ".ckpt.msgpack")}
            for path in paths.values():
                tr.save(path)
            torch.distributed.barrier()
            b, mk = p[key]["batches"][3], torch.from_numpy(p[key]["maskings"][3])
            tr.train_batch(b, mask=mk)
            uninterrupted = state(tr.model)
            out["restored"] = {}
            for fmt, path in paths.items():
                fresh = MIMPretrainer(mim_config(p[key]["cfg"], tensor_parallel=2),
                                      dtype=torch.float32, device="cpu")
                assert fresh.restore(path) and fresh.cur_iter == 3
                fresh.train_batch(b, mask=mk)
                out["restored"][fmt] = all(torch.equal(v, uninterrupted[k])
                                           for k, v in state(fresh.model).items())
            # files written by one process (the port's and JAX's) restore cut
            # to this rank's shard
            out["from_one"] = {}
            for fmt, (path, want) in p["one_files"].items():
                fresh = MIMPretrainer(mim_config(p[key]["cfg"], tensor_parallel=2),
                                      dtype=torch.float32, device="cpu")
                assert fresh.restore(path)
                mine = shard_state(want, m.model_index, m.tp)
                out["from_one"][fmt] = all(torch.equal(v, mine[k])
                                           for k, v in state(fresh.model).items())
    mim = Config.from_dict(p["pred"]["mim_cfg"])
    pred = PredictorTrainer(mim_config(p["pred"]["cfg"], tensor_parallel=2), mim,
                            dtype=torch.float32, seed=2, device="cpu")
    pred.model.load_state_dict(shard_state(p["pred"]["params"], pred.mesh.model_index, 2))
    losses = [[float(v) for v in pred.train_batch(b)] for b in p["pred"]["batches"]]
    val = [float(v) for v in pred.eval_batch(p["pred"]["batches"][0])]
    local = state(pred.model)
    out["pred"] = {"losses": losses, "val": val, "params": gather_to_main(local, pred.mesh)}
    lp = PredictorTrainer(mim_config(p["pred"]["cfg"], tensor_parallel=2, train_method="lp"), mim,
                          dtype=torch.float32, seed=2, device="cpu")
    lp.model.load_state_dict(shard_state(p["pred"]["params"], lp.mesh.model_index, 2))
    out["lp"] = [float(v) for v in lp.train_batch(p["pred"]["batches"][0])]
    return out


def tp_zero_job(rank: int, p: dict) -> dict:
    """Three SimMIM steps at ``tensor_parallel = 2`` on four ranks (data 2 x
    model 2) with ``zero_optimizer``: each data index on its rows of the
    global batches; the moments sharded over the data group; a save in the
    port's format."""
    from sky_embeddings_tpu_torch.parallel import zero
    from sky_embeddings_tpu_torch.parallel.sharding import shard_state
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    _patch_depth(p["depth"])
    tr = MIMPretrainer(mim_config(p["simmim"]["cfg"], tensor_parallel=2, zero_optimizer=True),
                       dtype=torch.float32, device="cpu")
    m = tr.mesh
    tr.model.load_state_dict(shard_state(p["simmim"]["params"], m.model_index, m.tp))
    out = _tp_steps(tr, p, "simmim", lambda x: local_rows(x, m.data_index, m.shape[0]))
    out.update(mesh=(m.shape, m.data_index, m.model_index), sharded=zero.is_sharded(tr.optimizer),
               ddp=tr.forward is not tr.model)
    tr.save(os.path.join(p["out_dir"], "tp_zero.ckpt.pt"))
    return out
