"""The port's ``parallel/`` package on the CPU: the ``SKY_*`` contract, the
mesh's shapes and errors, the one-process arithmetic left bit for bit, the
``zero_optimizer`` and ``tensor_parallel`` knobs, the device cache across
processes; then two gloo ranks of the predictor (``ft``, ZeRO-1) and of
I-JEPA (ZeRO-1) against one process over the global batch (one spawn of
``torch_parallel_workers.predictor_jepa_job``), the ``pretrain_mim`` twin
run by two real processes under ``SKY_DISTRIBUTED=1`` (the twin of
``tests/test_distributed_real.py``) against one process over the two
shards, and the two-process smoke module (``parallel/smoke.py``). Models
are cut to depth 2 (D = 48, or 64 for I-JEPA).

Bars: losses 1e-6 relative; ranks bit-equal; parameters against one
process 2e-3 of the steps' summed lr (``z_tiny``'s ``ft`` runs at about
1e-2 a step, SimMIM and I-JEPA at 1e-3 or less): two processes sum a
gradient in another order, and Adam turns that rounding into a step error
in proportion to lr (measured: 1.1e-4 of the summed lr for the predictor,
``pool.xattn.kv.kernel``; 8.9e-4 for the twin's 4 SimMIM steps). The key
biases, whose gradient is rounding noise, are held to the summed lr
(``parallel/smoke.param_gaps``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_workers as tpw
from sky_embeddings_tpu_torch.configuration import Config, apply_overrides, load_config
from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
from sky_embeddings_tpu_torch.data.synthetic import (make_cutouts, make_structured_cutouts,
                                                     write_structured_h5, write_synthetic_h5)
from sky_embeddings_tpu_torch.models import jepa as port_jepa
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.parallel import distributed
from sky_embeddings_tpu_torch.parallel.mesh import Sharding, create_mesh
from sky_embeddings_tpu_torch.parallel.smoke import param_gaps, run_two_process_smoke
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
B = 16  # global batch: 8 rows a rank
DEPTH = {"mim": {"base": {"depth": 2}}, "jepa": {"tiny": {"embed_dim": 64, "depth": 2, "num_heads": 2}}}
ENV = (distributed.ENV_FLAG, distributed.ENV_COORD, distributed.ENV_NPROC, distributed.ENV_PID)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    for size, over in DEPTH["mim"].items():
        for k, v in over.items():
            monkeypatch.setitem(port_mim._SIZES[size], k, v)
    monkeypatch.setitem(port_jepa._SIZES, "tiny", dict(DEPTH["jepa"]["tiny"]))


def _dict(cfg) -> dict:
    return {sec: dict(cfg[sec].items()) for sec in cfg.sections()}


# -- one process -----------------------------------------------------------------

def test_initialize_from_env_without_the_variables(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env() is False
    assert (distributed.process_count(), distributed.process_index(), distributed.is_main()) == (1, 0, True)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.batch_rows(8) is None


def test_initialize_from_env_names_what_is_missing(monkeypatch):
    monkeypatch.setenv(distributed.ENV_FLAG, "1")
    monkeypatch.setenv(distributed.ENV_NPROC, "2")
    for k in (distributed.ENV_COORD, distributed.ENV_PID):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="SKY_COORDINATOR_ADDRESS, SKY_PROCESS_ID"):
        distributed.initialize_from_env(device="cpu")


@pytest.mark.parametrize("data, model, err", [
    (3, 1, "data\\(3\\) \\* model\\(1\\) != device count \\(2\\)"),
    (None, 3, "2 devices not divisible by model=3"),
])
def test_create_mesh_divisibility_errors(data, model, err):
    with pytest.raises(ValueError, match=err):
        create_mesh(data, model, devices=[0, 1], device_type="cpu")


@pytest.mark.parametrize("data", [None, 1])
def test_create_mesh_builds_the_tensor_parallel_layout(data):
    """``model = 2`` over two ranks: one data index, the model axis the
    consecutive ranks; without a process group the mesh is rank 0's view
    and makes no groups (the groups under one: ``test_torch_tp.py``)."""
    mesh = create_mesh(data, 2, devices=[0, 1], device_type="cpu")
    assert (mesh.shape, mesh.mesh_dim_names, mesh.tp) == ((1, 2), ("data", "model"), 2)
    assert (mesh.data_index, mesh.model_index, mesh.get_local_rank("data")) == (0, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    four = create_mesh(None if data is None else 2 * data, 2, devices=[0, 1, 2, 3],
                       device_type="cpu")
    assert four.shape == (2, 2) and four.devices.tolist() == [[0, 1], [2, 3]]


@pytest.mark.parametrize("trainer", ["mim", "predictor", "jepa"])
def test_tensor_parallel_builds_or_raises_with_the_reason(trainer, ranks):
    """``[TRAINING] tensor_parallel = 2`` on two ranks builds each trainer
    over a (1, 2) mesh (the ``ranks`` spawn): the MIM and predictor ones
    with this rank's half of every block; I-JEPA (``jepa_tiny`` at D = 64,
    2 heads) with this rank's half of each encoder block, and of the EMA
    target's, which shares the mesh, while the 96-wide one-head
    predictor's blocks stay whole, on the recompute forms. In one process
    the I-JEPA trainer raises with JAX's divisibility error, as the others
    do: two model ranks need two processes."""
    if trainer == "jepa":
        over = ["TRAINING.tensor_parallel=2"]
        with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
            JEPATrainer(apply_overrides(load_config("jepa_tiny", CONFIGS), over), device="cpu")
        enc = [f"encoder.encoder.block{i}" for i in range(2)]
        for rank, r in enumerate(ranks["ranks"]):
            built = r["tp_built"]["jepa"]
            assert built["mesh"] == ((1, 2), 0, rank) and built["model_group"] == [0, 1]
            assert built["split"] == enc and built["target_split"] == [b[8:] for b in enc]
            assert built["enc_qkv"] == built["target_qkv"] == (64, 96)
            assert built["enc_fc2"] == (128, 64)
            assert built["pred_qkv"] == (96, 288) and built["pred_fc2"] == (384, 96)
            assert built["whole_recompute"] and built["target_shares_mesh"]
        return
    for rank, r in enumerate(ranks["ranks"]):
        built = r["tp_built"][trainer]
        assert built["mesh"] == ((1, 2), 0, rank) and built["model_group"] == [0, 1]
        assert built["qkv"] == (48, 72) and built["fc2"] == (96, 48) and built["patch"] == (48, 48)


def test_one_process_arithmetic_is_unchanged():
    """With no process group the loss helpers are the plain expressions bit
    for bit (value and gradient), the layout changes nothing, and a save
    decision is the local clock's."""
    g = torch.Generator().manual_seed(0)
    num = (torch.rand(100, generator=g) * 3).requires_grad_()
    den = torch.tensor(37.0)
    a = distributed.global_ratio(num.sum(), den, 1e-5)
    b = num.sum() / (den + 1e-5)
    assert torch.equal(a, b)
    ga, = torch.autograd.grad(a, num)
    gb, = torch.autograd.grad(b, num)
    assert torch.equal(ga, gb)
    loss, metric = num.mean(), num.detach().max()
    assert distributed.global_mean((loss, metric), 100) == (loss, metric)
    assert distributed.checkpoint_due(0.0, 1.0, False) and not distributed.checkpoint_due(
        float("inf"), 1.0, True)
    batches = [{"cutouts": np.arange(6.0).reshape(2, 3), "meta": "x"}]
    laid = list(device_prefetch(batches, sharding=Sharding(torch.device("cpu"))))
    plain = list(device_prefetch(batches, device="cpu"))
    assert torch.equal(laid[0]["cutouts"], plain[0]["cutouts"]) and laid[0]["meta"] == "x"
    assert torch.equal(distributed.put_global(batches[0], Sharding(torch.device("cpu")))["cutouts"],
                       plain[0]["cutouts"])


def test_zero_optimizer_alone_is_plain_adamw(small):
    """One process has nothing to shard (JAX's ``zero_spec`` at dp = 1):
    ``zero_optimizer = True`` trains bit-equal to the knob off."""
    cfg = load_config("mim_tiny", CONFIGS)
    x = make_cutouts(8, channels=3, img_size=16, seed=3)["cutouts"]
    runs = []
    for on in (False, True):
        tr = MIMPretrainer(apply_overrides(cfg, [f"TRAINING.zero_optimizer={on}"]), device="cpu")
        assert type(tr.optimizer) is torch.optim.AdamW and tr.forward is tr.model
        runs.append([float(tr.train_batch({"cutouts": x})) for _ in range(2)] + [tpw.state(tr.model)])
    assert runs[0][:2] == runs[1][:2]
    assert all(torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())


def test_device_cache_streams_across_processes(tmp_path):
    from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset, build_cached_or_streaming_batcher
    from sky_embeddings_tpu_torch.data.h5_loader import H5Batcher

    path = write_synthetic_h5(str(tmp_path / "s.h5"), n=32, channels=3, img_size=16, seed=1)
    data = Config.from_dict({"DATA": {"device_cache": "True"}}).data
    logs = []
    streamed = build_cached_or_streaming_batcher(data, path, 4, img_size=16, process_count=2,
                                                 process_index=1, log_fn=logs.append, device="cpu")
    assert isinstance(streamed, H5Batcher) and streamed.process_index == 1
    assert logs == ["device_cache requested but multi-process run — streaming instead."]
    cached = build_cached_or_streaming_batcher(data, path, 4, img_size=16, log_fn=logs.append,
                                               device="cpu")
    assert isinstance(cached, DeviceDataset)


# -- two ranks --------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    """The predictor (``ft`` from z_tiny over mim_tiny, augmentations on)
    and I-JEPA (jepa_tiny) with ``zero_optimizer = True``: 3 steps on two
    ranks and on one process over the global batch."""
    with pytest.MonkeyPatch.context() as mp:
        for size, over in DEPTH["mim"].items():
            for k, v in over.items():
                mp.setitem(port_mim._SIZES[size], k, v)
        mp.setitem(port_jepa._SIZES, "tiny", dict(DEPTH["jepa"]["tiny"]))
        zero = [f"TRAINING.batch_size={B}", "TRAINING.zero_optimizer=True"]
        mim = load_config("mim_tiny", CONFIGS)
        pred_cfg = apply_overrides(load_config("z_tiny", CONFIGS), zero)
        jepa_cfg = apply_overrides(load_config("jepa_tiny", CONFIGS), zero)
        assert pred_cfg.training.bool("augment")
        data = make_structured_cutouts(3 * B, channels=3, img_size=16, seed=5)
        rd = np.stack([data["ra"], data["dec"]], 1)
        pred_batches = [{"cutouts": data["cutouts"][B * i:B * (i + 1)], "ra_dec": rd[B * i:B * (i + 1)],
                         "labels": data["zspec"][B * i:B * (i + 1), None]} for i in range(3)]
        jepa_batches = [b["cutouts"] for b in pred_batches]

        one = PredictorTrainer(pred_cfg, mim, dtype=torch.float32, seed=2, device="cpu")
        start = tpw.state(one.model)
        pred_losses = [[float(v) for v in one.train_batch(b)] for b in pred_batches]
        pred_val = [float(v) for v in one.eval_batch(pred_batches[0])]
        jt = JEPATrainer(jepa_cfg, seed=4, device="cpu")
        jepa_losses = [float(jt.train_batch({"cutouts": b})) for b in jepa_batches]
        jepa_val = float(jt.eval_batch({"cutouts": jepa_batches[0]}))
        res = tpw.run_ranks(tpw.predictor_jepa_job, {
            "depth": DEPTH, "mim_cfg": _dict(mim), "pred_cfg": _dict(pred_cfg),
            "jepa_cfg": _dict(jepa_cfg), "pred_params": start, "pred_batches": pred_batches,
            "jepa_batches": jepa_batches})
    return dict(ranks=res, pred=(pred_losses, pred_val, tpw.state(one.model)),
                jepa=(jepa_losses, jepa_val, tpw.state(jt.model), tpw.state(jt.target)),
                pred_lr_sum=sum(one.schedule(t) for t in range(3)),
                jepa_lr_sum=sum(jt.lr_schedule(t) for t in range(3)))


def _same_ranks(a: dict, b: dict) -> bool:
    return all(torch.equal(v, b[k]) for k, v in a.items())


def test_predictor_ft_two_ranks_match_one_process(ranks):
    losses, val, params = ranks["pred"]
    r0, r1 = (r["predictor"] for r in ranks["ranks"])
    assert r0["sharded"] and r0["losses"] == r1["losses"] and _same_ranks(r0["params"], r1["params"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(r0["val"], val, rtol=1e-6)
    assert r0["val"] == r1["val"]  # every rank reports the global validation loss
    rest, keys = param_gaps(r0["params"], params)
    assert rest <= 2e-3 * ranks["pred_lr_sum"] and keys <= ranks["pred_lr_sum"], (rest, keys)


def test_jepa_two_ranks_match_one_process(ranks):
    losses, val, params, target = ranks["jepa"]
    r0, r1 = (r["jepa"] for r in ranks["ranks"])
    assert r0["sharded"] and r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
    assert _same_ranks(r0["params"], r1["params"]) and _same_ranks(r0["target"], r1["target"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(r0["val"], val, rtol=1e-6)
    for got, want in ((r0["params"], params), (r0["target"], target)):
        rest, keys = param_gaps(got, want)
        assert rest <= 2e-3 * ranks["jepa_lr_sum"] and keys <= ranks["jepa_lr_sum"], (rest, keys)


def test_lp_regime_stays_unsharded(ranks):
    assert not any(r["lp_sharded"] for r in ranks["ranks"])


# -- real processes ---------------------------------------------------------------

TWIN = ("import sys; from sky_embeddings_tpu_torch.models import mim; "
        "mim._SIZES['base']['depth'] = 2; import torch; "
        "from sky_embeddings_tpu_torch import pretrain_mim as t; t.REPO_DIR = sys.argv[1]; "
        "t.main(sys.argv[2:]); torch.distributed.destroy_process_group()")


def test_pretrain_mim_twin_on_two_processes(tmp_path, small):
    """``pretrain_mim mim_tiny`` (depth 2, 4 steps, validation and the
    probes at step 2 and 4) as two processes under ``SKY_DISTRIBUTED=1``:
    each reads its own shard of the h5 sets with 8 rows a batch, process 0
    alone logs and writes the checkpoint; its parameters against one
    process trained on the two shards' batches concatenated, with the
    twin's own generator masks."""
    import socket

    from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
    from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path

    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    write_structured_h5(str(data / "tiny_probe.h5"), 96, channels=3, img_size=16, seed=3)
    steps = ["--set", "TRAINING.total_batch_iters=4"]
    argv = ["mim_tiny", "-v", "2", "-ct", "100", "-dd", str(data), "--device", "cpu", *steps]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, SKY_DISTRIBUTED="1", SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   SKY_NUM_PROCESSES="2", SKY_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", TWIN, str(tmp_path), *argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
            assert p.returncode == 0, outs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "Batch Iterations: 4/4" in outs[0] and "val loss" in outs[0] and "lp acc" in outs[0]
    assert "Batch Iterations" not in outs[1]  # process 1 logs nothing
    assert "(2 processes)" in outs[0]

    cfg = apply_overrides(load_config("mim_tiny", CONFIGS), ["TRAINING.total_batch_iters=4"])
    shards = [build_cached_or_streaming_batcher(
        cfg.data, str(data / "tiny_train.h5"), 8, img_size=16, shuffle=True, process_count=2,
        process_index=r, log_fn=lambda m: None, device="cpu").forever() for r in range(2)]
    one = MIMPretrainer(cfg, device="cpu")
    for _ in range(4):
        parts = [next(s) for s in shards]
        one.train_batch({k: np.concatenate([p[k] for p in parts]) for k in ("cutouts", "ra_dec")})
    two = MIMPretrainer(cfg, device="cpu")
    assert two.restore(checkpoint_path(str(tmp_path / "models"), "mim_tiny")) and two.cur_iter == 4
    assert len(two.losses["val_loss"]) == 2 and len(two.losses["val_lp_acc"]) == 2
    lr_sum = sum(one.schedule(t) for t in range(4))
    rest, keys = param_gaps(tpw.state(two.model), tpw.state(one.model))
    assert rest <= 2e-3 * lr_sum and keys <= lr_sum, (rest, keys)


def test_two_process_smoke_module(tmp_path):
    """``python -m sky_embeddings_tpu_torch.parallel.smoke --device cpu``:
    DDP and ZeRO-1 legs, the ranks bit-equal and within 2e-6 of one
    process (the module raises otherwise)."""
    path = write_synthetic_h5(str(tmp_path / "smoke.h5"), n=128, channels=3, img_size=16, seed=3)
    res = run_two_process_smoke(path, device="cpu")
    assert set(res["max_param_err"]) == {"ddp", "zero"}
    for leg, (rest, keys) in res["max_param_err"].items():
        assert rest <= 2e-6, (leg, rest)
    assert res["per_process"][0]["ddp"] == res["per_process"][1]["ddp"]
    assert res["per_process"][0]["ddp"]["digest"] == res["per_process"][0]["zero"]["digest"]
