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
from typing import Optional

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
    out["tp_built"]["jepa"] = jepa_layout(
        JEPATrainer(mim_config(p["jepa_cfg"], tensor_parallel=2), device="cpu"))
    return out


def jepa_layout(tr) -> dict:
    """An I-JEPA trainer's tensor-parallel layout on this rank: the mesh, the
    split blocks of the model and of the EMA target, the shapes of the first
    encoder and predictor blocks, and whether every whole block takes the
    recompute forms and the target's blocks share the model's mesh."""
    from sky_embeddings_tpu_torch.models.layers import Block
    from sky_embeddings_tpu_torch.parallel.sharding import split_of

    m = tr.model
    whole = [b for b in (*m.modules(), *tr.target.modules())
             if isinstance(b, Block) and b.tp is None]
    return {
        "mesh": (tr.mesh.shape, tr.mesh.data_index, tr.mesh.model_index),
        "model_group": torch.distributed.get_process_group_ranks(tr.mesh.model_group),
        "split": sorted(split_of(m)), "target_split": sorted(split_of(tr.target)),
        "enc_qkv": tuple(m.encoder.encoder.block0.attn.qkv.kernel.shape),
        "enc_fc2": tuple(m.encoder.encoder.block0.ffn.fc2_kernel.shape),
        "pred_qkv": tuple(m.predictor.blocks.block0.attn.qkv.kernel.shape),
        "pred_fc2": tuple(m.predictor.blocks.block0.ffn.fc2_kernel.shape),
        "target_qkv": tuple(tr.target.encoder.block0.attn.qkv.kernel.shape),
        "whole_recompute": bool(whole) and all(not b.stash and not b.ffn.stash and b.ffn.tp is None
                                               for b in whole),
        "target_shares_mesh": tr.target.encoder.block0.tp is tr.mesh}



def _gathered(module, mesh) -> tuple[Optional[dict], dict]:
    """A sharded module's whole state dict (on the model group's first
    rank, None on the others) and the leaves this rank holds whole."""
    from sky_embeddings_tpu_torch.parallel.sharding import gather_to_main, shard_of, split_of

    split, local = split_of(module), state(module)
    return (gather_to_main(local, mesh, split),
            {k: v for k, v in local.items() if shard_of(k, split) is None})


def _tp_steps(tr, p: dict, key: str, rank_rows) -> dict:
    """Three steps of a MIM trainer on this rank's rows of ``p[key]``'s
    batches and maskings (SimMIM masks or MAE noise), then its losses, the
    whole parameters (gathered over the model group) and the replicated
    ones as this rank holds them."""
    losses = []
    for b, mk in zip(p[key]["batches"][:3], p[key]["maskings"][:3]):
        m = torch.from_numpy(rank_rows(mk))
        kw = {"mask": m} if tr.model.simmim else {"noise": m}
        losses.append(float(tr.train_batch(rank_rows(b), **kw)))
    params, replicated = _gathered(tr.model, tr.mesh)
    return {"losses": losses, "params": params, "replicated": replicated}


def _jepa_masks(m, rows):
    from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks

    return BlockMasks(*(rows(t) for t in m))


def _jepa_trainer(p: dict, **training):
    """An I-JEPA trainer of ``p["jepa"]``'s config with ``training``
    overrides, from the payload's whole params and EMA target cut to this
    rank's shards."""
    from sky_embeddings_tpu_torch.parallel.sharding import shard_state, split_of
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer

    tr = JEPATrainer(mim_config(p["jepa"]["cfg"], **training), device="cpu")
    m = tr.mesh
    for module, key in ((tr.model, "params"), (tr.target, "target")):
        module.load_state_dict(shard_state(p["jepa"][key], m.model_index, m.tp, split_of(module)))
    return tr


def _jepa_steps(tr, p: dict, rank_rows) -> dict:
    """Three I-JEPA steps on this rank's rows of the payload's batches and
    block masks: the losses, the whole parameters and EMA target (gathered
    over the model group) and the leaves this rank holds whole."""
    losses = [float(tr.train_batch({"cutouts": rank_rows(b)}, masks=_jepa_masks(m, rank_rows)))
              for b, m in zip(p["jepa"]["batches"][:3], p["jepa"]["masks"][:3])]
    params, replicated = _gathered(tr.model, tr.mesh)
    target, target_replicated = _gathered(tr.target, tr.mesh)
    return {"losses": losses, "params": params, "target": target, "replicated": replicated,
            "target_replicated": target_replicated}


def tp_job(rank: int, p: dict) -> dict:
    """The tensor-parallel checks of ``test_torch_tp.py`` on one rank of
    ``tensor_parallel = 2`` (data 1 x model 2): the mesh and its groups;
    three SimMIM, three MAE and three ``maesimple`` steps (its one-head
    decoder whole on both ranks) from the whole params, every rank on the
    whole batch; the checkpoint in both formats, written by rank 0,
    restored on both ranks (the next step bit-equal to the uninterrupted
    one); three predictor ``ft`` steps and an ``lp`` evaluation; three
    I-JEPA steps without and with ``zero_optimizer`` (:func:`jepa_tp_job`)."""
    from sky_embeddings_tpu_torch.configuration import Config
    from sky_embeddings_tpu_torch.parallel import distributed
    from sky_embeddings_tpu_torch.parallel.sharding import shard_state, split_of
    from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    _patch_depth(p["depth"])
    out: dict = {}
    whole = lambda x: x  # noqa: E731  (one data index: every rank takes the whole batch)
    for key in ("simmim", "mae", "mae_simple"):
        tr = MIMPretrainer(mim_config(p[key]["cfg"], tensor_parallel=2), dtype=torch.float32,
                           device="cpu")
        m = tr.mesh
        split = split_of(tr.model)
        out.setdefault("mesh", (m.shape, m.data_index, m.model_index, distributed.batch_rows(8),
                                tr.forward is tr.model))
        tr.model.load_state_dict(shard_state(p[key]["params"], m.model_index, m.tp, split))
        out[key] = _tp_steps(tr, p, key, whole)
        out[key]["split"] = sorted(split)
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
                mine = shard_state(want, m.model_index, m.tp, split)
                out["from_one"][fmt] = all(torch.equal(v, mine[k])
                                           for k, v in state(fresh.model).items())
    mim = Config.from_dict(p["pred"]["mim_cfg"])
    pred = PredictorTrainer(mim_config(p["pred"]["cfg"], tensor_parallel=2), mim,
                            dtype=torch.float32, seed=2, device="cpu")
    pred.model.load_state_dict(shard_state(p["pred"]["params"], pred.mesh.model_index, 2,
                                           split_of(pred.model)))
    losses = [[float(v) for v in pred.train_batch(b)] for b in p["pred"]["batches"]]
    val = [float(v) for v in pred.eval_batch(p["pred"]["batches"][0])]
    out["pred"] = {"losses": losses, "val": val, "params": _gathered(pred.model, pred.mesh)[0]}
    lp = PredictorTrainer(mim_config(p["pred"]["cfg"], tensor_parallel=2, train_method="lp"), mim,
                          dtype=torch.float32, seed=2, device="cpu")
    lp.model.load_state_dict(shard_state(p["pred"]["params"], lp.mesh.model_index, 2,
                                         split_of(lp.model)))
    out["lp"] = [float(v) for v in lp.train_batch(p["pred"]["batches"][0])]
    out["jepa"] = jepa_tp_job(p)
    return out


def jepa_tp_job(p: dict) -> dict:
    """I-JEPA at ``tensor_parallel = 2`` on this rank (one data index):
    three steps from the payload's whole params and EMA target without and
    with ``zero_optimizer``; the ZeRO run saved in both formats by rank 0,
    restored on both ranks (the next step and the EMA target bit-equal to
    the uninterrupted run's); JAX's one-device file restored cut to this
    rank's shards."""
    from sky_embeddings_tpu_torch.parallel.sharding import shard_state, split_of
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer

    out: dict = {}
    whole = lambda x: x  # noqa: E731
    for zero_on in (False, True):
        tr = _jepa_trainer(p, tensor_parallel=2, zero_optimizer=zero_on)
        out[zero_on] = _jepa_steps(tr, p, whole)
    out["layout"] = jepa_layout(tr)
    paths = {fmt: os.path.join(p["out_dir"], "tp_jepa" + fmt) for fmt in (".ckpt.pt", ".ckpt.msgpack")}
    for path in paths.values():
        tr.save(path)
    torch.distributed.barrier()
    nxt = ({"cutouts": p["jepa"]["batches"][3]}, _jepa_masks(p["jepa"]["masks"][3], whole))
    tr.train_batch(*nxt)
    after = (state(tr.model), state(tr.target))
    out["restored"] = {}
    cfg = mim_config(p["jepa"]["cfg"], tensor_parallel=2, zero_optimizer=True)
    for fmt, path in paths.items():
        fresh = JEPATrainer(cfg, device="cpu")
        assert fresh.restore(path) and fresh.cur_iter == 3
        fresh.train_batch(*nxt)
        out["restored"][fmt] = all(torch.equal(v, want[k]) for got, want in zip(
            (state(fresh.model), state(fresh.target)), after) for k, v in got.items())
    fresh = JEPATrainer(cfg, device="cpu")
    assert fresh.restore(p["jepa"]["jax_file"]) and fresh.cur_iter == 0
    m = fresh.mesh
    out["from_jax"] = all(
        torch.equal(v, shard_state(p["jepa"][key], m.model_index, m.tp, split_of(module))[k])
        for module, key in ((fresh.model, "params"), (fresh.target, "target"))
        for k, v in state(module).items())
    # jepa_tiny's own widths (D = 192, 3 heads; its predictor 96 wide, one
    # head), cut to depth 2: no block splits at tp = 2, so the ranks run
    # one process's arithmetic
    from sky_embeddings_tpu_torch.models import jepa

    cut = jepa._SIZES["tiny"]
    jepa._SIZES["tiny"] = dict(embed_dim=192, depth=2, num_heads=3)
    try:
        tiny = JEPATrainer(mim_config(p["jepa"]["cfg"], tensor_parallel=2), device="cpu")
    finally:
        jepa._SIZES["tiny"] = cut
    loss = float(tiny.train_batch({"cutouts": p["jepa"]["batches"][0]},
                                  masks=_jepa_masks(p["jepa"]["masks"][0], whole)))
    out["tiny"] = {"split": sorted(split_of(tiny.model) | split_of(tiny.target)), "loss": loss,
                   "params": state(tiny.model), "target": state(tiny.target)}
    return out


def tp_zero_job(rank: int, p: dict) -> dict:
    """Three SimMIM and three I-JEPA steps at ``tensor_parallel = 2`` on
    four ranks (data 2 x model 2) with ``zero_optimizer``: each data index
    on its rows of the global batches (and block masks); the moments
    sharded over the data group; a SimMIM save in the port's format."""
    from sky_embeddings_tpu_torch.parallel import zero
    from sky_embeddings_tpu_torch.parallel.sharding import shard_state, split_of
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    _patch_depth(p["depth"])
    tr = MIMPretrainer(mim_config(p["simmim"]["cfg"], tensor_parallel=2, zero_optimizer=True),
                       dtype=torch.float32, device="cpu")
    m = tr.mesh
    tr.model.load_state_dict(shard_state(p["simmim"]["params"], m.model_index, m.tp,
                                         split_of(tr.model)))
    rows = lambda x: local_rows(x, m.data_index, m.shape[0])  # noqa: E731
    out = _tp_steps(tr, p, "simmim", rows)
    out.update(mesh=(m.shape, m.data_index, m.model_index), sharded=zero.is_sharded(tr.optimizer),
               ddp=tr.forward is not tr.model)
    tr.save(os.path.join(p["out_dir"], "tp_zero.ckpt.pt"))
    jt = _jepa_trainer(p, tensor_parallel=2, zero_optimizer=True)
    out["jepa"] = _jepa_steps(jt, p, rows)
    out["jepa"].update(sharded=zero.is_sharded(jt.optimizer), ddp=jt.forward is not jt.model)
    return out
