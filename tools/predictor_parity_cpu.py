#!/usr/bin/env python
"""The predictor's training held against JAX's over many steps on the CPU.

    JAX_PLATFORMS=cpu python tools/predictor_parity_cpu.py [--steps 100] [--batch 32]

The recipe of ``configs/z_struct_ft_512.ini`` and ``z_struct_fs_512.ini``
(layer decay 0.75 and PARITY #1's learning rate for ``ft``; AdamW, the
linear schedule over ``--steps``, bf16 off: fp32 in both) on a cut-down
model (``mim_struct``'s architecture at depth 2, D = 48, 16 x 16 cutouts)
and a structured z survey built once (``structured_survey``): the JAX
package's ``make_predictor_step`` + optax against the port's
``PredictorTrainer.train_batch``, from the same initial params and the
same batches in the same order (both ``DeviceDataset`` s over one h5
file, one seed), augmentation off (the two frameworks draw it from
different generators). Prints, per regime, the largest relative gap of the
step losses, the largest parameter gap at the end, and the photo-z MAD and
R² of both on the validation set (``predictor_infer``), as one JSON line.
"""

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sky_embeddings_tpu.configuration import Config as JaxConfig  # noqa: E402
from sky_embeddings_tpu.data.device_cache import DeviceDataset as JaxDeviceDataset  # noqa: E402
from sky_embeddings_tpu.eval.eval_fns import predictor_infer as jax_infer  # noqa: E402
from sky_embeddings_tpu.models import mim as jax_mim  # noqa: E402
from sky_embeddings_tpu.models.predictor import build_predictor_model  # noqa: E402
from sky_embeddings_tpu.train import optim as jax_optim  # noqa: E402
from sky_embeddings_tpu.train.predictor import make_predictor_step  # noqa: E402
from sky_embeddings_tpu.train.schedules import linear_lr as jax_linear_lr  # noqa: E402
from sky_embeddings_tpu.train.state import TrainState  # noqa: E402
from sky_embeddings_tpu_torch.configuration import Config, load_config  # noqa: E402
from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset  # noqa: E402
from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5  # noqa: E402
from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer  # noqa: E402
from sky_embeddings_tpu_torch.models import mim as port_mim  # noqa: E402
from sky_embeddings_tpu_torch.models.weights import params_from_jax  # noqa: E402
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer  # noqa: E402
from sky_embeddings_tpu_torch.utils.plotting import photoz_prediction_metrics  # noqa: E402

CONFIGS = os.path.join(REPO, "configs")


def _configs(name, steps, batch):
    d = {s: dict(load_config(name, CONFIGS)[s].items()) for s in ("DATA", "TRAINING", "ARCHITECTURE")}
    d["TRAINING"].update(total_batch_iters=str(steps), batch_size=str(batch), augment="False",
                         dtype="float32")
    d["ARCHITECTURE"]["img_size"] = "16"
    m = {s: dict(load_config("mim_struct", CONFIGS)[s].items()) for s in ("DATA", "TRAINING",
                                                                          "ARCHITECTURE")}
    m["ARCHITECTURE"].update(img_size="16", patch_size="4", embed_dim="48")
    return (JaxConfig.from_dict(d), JaxConfig.from_dict(m)), (Config.from_dict(d), Config.from_dict(m))


def _metrics(targets, preds):
    z, zp = targets[:, 0], preds[:, 0].astype(np.float64)
    bias, mad, fout = photoz_prediction_metrics(zp, z, threshold=0.15)
    r2 = 1.0 - float(np.sum((zp - z) ** 2)) / float(np.sum((z - z.mean()) ** 2))
    return {"mad": mad, "bias": bias, "frac_out": fout, "r2": r2}


def run(name, train_h5, val_h5, steps, batch):
    (jcfg, jmae), (cfg, mae) = _configs(name, steps, batch)
    jmodel = build_predictor_model(jcfg, jmae)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((2, 5, 16, 16)))["params"]
    training = jcfg.training
    lr0, wd = training.float("init_lr"), training.float("weight_decay")
    sched = lambda lr: jax_linear_lr(lr, steps, training.float("final_lr_factor"))
    if training.str("train_method") == "ft":
        tx = jax_optim.finetune_optimizer(params, sched, jmodel.depth,
                                          training.float("layer_decay"), lr0, wd)
    else:
        tx = jax_optim.supervised_optimizer(params, sched(lr0), wd)
    jstep = jax.jit(make_predictor_step(jmodel, tx, "mse", False, False, {}, True, pixel_min=-3.0))
    state = TrainState.create(params, tx, jax.random.PRNGKey(1))
    trainer = PredictorTrainer(cfg, mae, dtype=torch.float32, device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    kw = dict(batch_size=batch, img_size=16, label_keys=["zspec"], shuffle=True,
              indices=list(range(training.int("num_train"))))
    jds, tds = JaxDeviceDataset(train_h5, **kw).forever(), DeviceDataset(train_h5, device="cpu",
                                                                          **kw).forever()
    gaps = []
    for _ in range(steps):
        jb, tb = next(jds), next(tds)
        state, jloss, _ = jstep(state, jb["cutouts"], jb["ra_dec"], jb["labels"])
        tloss, _ = trainer.train_batch(tb)
        gaps.append(abs(float(tloss) - float(jloss)) / abs(float(jloss)))
    want = jax.tree_util.tree_map(np.asarray, state.params)
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    flat = {k: v.numpy() for k, v in params_from_jax(want).items()}
    param_gap = max(float(np.abs(got[k] - flat[k]).max()) for k in flat)
    vkw = dict(batch_size=batch, img_size=16, label_keys=["zspec"], shuffle=False,
               drop_remainder=False)
    jt, jp = jax_infer(jmodel, {"params": state.params}, JaxDeviceDataset(val_h5, **vkw))
    tt, tp = predictor_infer(trainer.model, DeviceDataset(val_h5, device="cpu", **vkw))
    return {"steps": steps, "loss_max_rel_gap": max(gaps), "loss_gap_last": gaps[-1],
            "param_max_abs_gap": param_gap, "jax": _metrics(jt, np.asarray(jp)),
            "port": _metrics(tt, tp)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    for mod in (jax_mim, port_mim):
        mod._SIZES["base"]["depth"] = 2
    with tempfile.TemporaryDirectory() as d:
        train_h5 = write_structured_h5(os.path.join(d, "z_train.h5"), 1024, 5, 16,
                                       class_fracs=(0.5, 0.5, 0.0), seed=14)
        val_h5 = write_structured_h5(os.path.join(d, "z_val.h5"), 512, 5, 16,
                                     class_fracs=(0.5, 0.5, 0.0), seed=15)
        out = {name: run(name, train_h5, val_h5, args.steps, args.batch)
               for name in ("z_struct_ft_512", "z_struct_fs_512")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
