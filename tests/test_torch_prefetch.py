"""The port's host-to-device prefetch (``data/prefetch.device_prefetch``) on
the CPU, and the training loops that stream through it: the order kept and
the source read at most ``size`` items ahead (a counting iterator), short and
empty iterators drained, dict and nested batches, tensors passed through,
the CUDA device refused where there is none; ``train_network`` (MIM) and
``train_predictor_network`` over numpy batches bit-equal, loss by loss and
parameter by parameter, to the same batches fed to ``train_batch``
directly. Also the ``jepa_validation`` twin at ``--quick`` (its encoder
and predictor cut to depth 2, D = 64), writing the JAX tool's keys. The
copy on a side stream is held on the card by ``tests/test_torch_cuda.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data import prefetch
from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
from sky_embeddings_tpu_torch.models import jepa as port_jepa
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.parallel.mesh import Sharding
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, train_predictor_network
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


class Counting:
    """An iterator over ``items`` that counts how many were taken."""

    def __init__(self, items):
        self.items, self.taken = list(items), 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.taken == len(self.items):
            raise StopIteration
        self.taken += 1
        return self.items[self.taken - 1]


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_order_kept_and_source_read_at_most_size_ahead(n, size):
    src = Counting({"x": np.full((2, 3), i, np.float32)} for i in range(n))
    got = []
    for item in device_prefetch(src, size=size, device="cpu"):
        assert src.taken <= len(got) + 1 + size  # what is yielded, and size more
        got.append(int(item["x"][0, 0]))
    assert got == list(range(n)) and src.taken == n


def test_batches_become_tensors_and_tensors_pass_through():
    t = torch.arange(6.0).reshape(2, 3)
    batch = {"cutouts": np.ones((2, 3, 4, 4), np.float32), "ra_dec": np.zeros((2, 2), np.float32),
             "labels": t, "nested": [np.int32(7) * np.ones(2, np.int32), {"deep": np.arange(3)}],
             "name": "tile-0", "count": 3}
    (out,) = list(device_prefetch([batch], device="cpu"))
    assert out.keys() == batch.keys()
    assert out["labels"] is t  # a tensor already on the device: no copy
    for key in ("cutouts", "ra_dec"):
        assert torch.is_tensor(out[key]) and np.array_equal(out[key].numpy(), batch[key])
    assert out["nested"][0].dtype == torch.int32 and out["nested"][1]["deep"].tolist() == [0, 1, 2]
    assert out["name"] == "tile-0" and out["count"] == 3
    tup = list(device_prefetch([(np.zeros(2), np.ones(2))], device="cpu"))[0]
    assert isinstance(tup, tuple) and all(torch.is_tensor(x) for x in tup)


def test_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch([{"x": np.zeros(2)}]))


def test_train_network_streams_through_prefetch_bit_equal(tmp_path, monkeypatch):
    """MIM pretraining (mim_tiny, depth 2): ``train_network`` over numpy
    batches (through the prefetch, which it reads two ahead) against
    ``train_batch`` on the same batches, two trainers from one seed: each
    step's loss and every parameter bit-equal."""
    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    cfg = load_config("mim_tiny", CONFIGS)
    x = make_cutouts(4 * 16, channels=3, img_size=16, seed=4)
    batches = [{"cutouts": x["cutouts"][i * 16:(i + 1) * 16]} for i in range(4)]
    pair = [MIMPretrainer(cfg, dtype=torch.float32, seed=1, device="cpu") for _ in range(2)]
    seen, losses = [], []
    step = pair[0].train_batch
    monkeypatch.setattr(pair[0], "train_batch", lambda b: seen.append(b) or losses.append(step(b))
                        or losses[-1])
    calls = []
    monkeypatch.setattr("sky_embeddings_tpu_torch.train.pretrain.device_prefetch",
                        lambda *a, **k: calls.append(k) or prefetch.device_prefetch(*a, **k))
    src = Counting(batches)
    train_network(pair[0], src, None, 4, 4, 100.0, str(tmp_path / "m.ckpt.pt"), log_fn=lambda m: None)
    # the layout of a data-only mesh over every process: one process here
    assert calls == [{"size": 2, "sharding": pair[0].batch_shard}] and src.taken == 4
    assert pair[0].batch_shard == Sharding(pair[0].device, True, 0, 1)
    assert all(torch.is_tensor(b["cutouts"]) for b in seen)
    ref = [pair[1].train_batch(b) for b in batches]
    assert len(losses) == 4 and all(torch.equal(a, b) for a, b in zip(losses, ref))
    for (name, a), b in zip(pair[0].model.state_dict().items(), pair[1].model.state_dict().values()):
        assert torch.equal(a, b), name


def _predictor_configs():
    mim = Config.from_dict({"DATA": {}, "TRAINING": dict(
        batch_size=8, total_batch_iters=5, weight_decay=0.05, init_lr=1e-3, final_lr_factor=1e4,
        loss_fn="L1"), "ARCHITECTURE": dict(img_size=16, num_channels=3, pixel_mean=0.05,
                                           pixel_std=1.2, embed_dim=48, patch_size=4,
                                           model_type="simmim")})
    pred = Config.from_dict({"DATA": dict(label_keys="['zspec']", label_means="[0.64]",
                                          label_stds="[0.5]"),
                             "TRAINING": dict(train_method="ft", pretained_mae="mim_t", num_train=-1,
                                              batch_size=8, total_batch_iters=4, layer_decay=0.75,
                                              weight_decay=1e-3, init_lr=2e-3, final_lr_factor=10.0,
                                              augment=True, use_label_errs=False, loss_fn="mse"),
                             "ARCHITECTURE": dict(img_size=16, global_pool="map", dropout=0.1)})
    return pred, mim


def test_predictor_loop_streams_through_prefetch_bit_equal(tmp_path, monkeypatch):
    """``train_predictor_network`` (``ft``, augmentation and dropout drawing
    from the trainer's generator) over numpy batches against
    ``train_batch`` on the same batches: each step's loss and metric, and
    every parameter, bit-equal."""
    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    s = make_structured_cutouts(5 * 8, channels=3, img_size=16, seed=6)
    batches = [{"cutouts": s["cutouts"][i:i + 8], "labels": s["zspec"][i:i + 8, None]}
               for i in range(0, 40, 8)]
    pair = [PredictorTrainer(*_predictor_configs(), seed=2, device="cpu") for _ in range(2)]
    got = []
    step = pair[0].train_batch
    monkeypatch.setattr(pair[0], "train_batch", lambda b: got.append(step(b)) or got[-1])
    train_predictor_network(pair[0], iter(batches[:4]), batches[4:], 4, 100.0,
                            str(tmp_path / "p.ckpt.pt"), log_fn=lambda m: None)
    ref = [pair[1].train_batch(b) for b in batches[:4]]
    assert len(got) == 4
    for (la, ma), (lb, mb) in zip(got, ref):
        assert torch.equal(torch.as_tensor(la), torch.as_tensor(lb))
        assert torch.equal(torch.as_tensor(ma), torch.as_tensor(mb))
    for (name, a), b in zip(pair[0].model.state_dict().items(), pair[1].model.state_dict().values()):
        assert torch.equal(a, b), name


def test_jepa_validation_quick(tmp_path, monkeypatch):
    """``jepa_validation --quick --device cpu`` (encoder and predictor cut
    to depth 2, D = 64): 20 steps with the probes every 10, the JAX tool's
    keys in its JSON, the gates reported and not forced."""
    from sky_embeddings_tpu_torch import jepa_validation as jv

    monkeypatch.setitem(port_jepa._SIZES, "tiny", dict(embed_dim=64, depth=2, num_heads=2))
    (tmp_path / "configs").symlink_to(CONFIGS)
    monkeypatch.setattr(jv, "REPO_DIR", str(tmp_path))
    rec = jv.main(["--quick", "-v", "10", "--device", "cpu"])
    with open(tmp_path / "results" / "jepa_validation_torch_quick.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    pre = rec["pretrain"]
    assert set(pre) == {"batch_iters", "train_loss", "val_loss", "val_lp_acc", "val_lp_r2"}
    assert pre["batch_iters"] == [10, 20] and rec["steps"] == 20 and rec["device"] == "cpu"
    assert all(len(pre[k]) == 2 and np.isfinite(pre[k]).all() for k in pre)
    for key in ("val_lp_acc", "val_lp_r2"):
        g = rec["gates"][key]
        assert g["first"] == pre[key][0] and g["rose"] == (g["max"] >= g["first"] + jv.RISE)
    assert (tmp_path / "models" / "jepa_struct_quick.ckpt.pt").exists()
