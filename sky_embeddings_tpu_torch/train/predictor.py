"""Predictor training: fine-tuning, linear probing and training from scratch
(port of ``sky_embeddings_tpu/train/predictor.py``, reference
``train_predictor.py`` + ``vit.build_model`` +
``predictor_training_fns.run_iter``).

- Dual-config build (``models/predictor.build_predictor_model``): the
  architecture from the pretraining config, head and pooling from the
  predictor config.
- Warm start from a MIM checkpoint (:func:`warm_start_from_mim`): every
  tensor whose name and shape match is copied, after
  ``utils/checkpoint.adapt_block_layout``; the head stays fresh
  (reference ``vit.py:224-249``).
- The three regimes of ``train/optim.py`` under the ``linear_lr`` schedule
  (``vit.py:182-185``): ``ft`` (layer decay, PARITY #1), ``lp`` and ``fs``.
- Losses: cross-entropy with accuracy for ``class`` (in fp32), or MSE with
  MAE on normalised labels, optionally weighted by ``1 / (err + 1e-5)``
  under ``use_label_errs`` (``predictor_training_fns.py``).
- The pixel clip runs on the device; train-time augmentation (flips and
  crop always, brightness / noise / band NaNs per config, reference
  ``train_predictor.py:85-98``) and head dropout draw from the trainer's
  ``torch.Generator``; dropout only while training.
- The loop (:func:`train_predictor_network`): full validation passes, the
  ``_best`` sidecar, early stopping after ``early_stop_evals`` stale
  evaluations, periodic saves, resuming from ``.ckpt.pt``.

The ``lp`` regime: JAX wraps the frozen subtrees in ``stop_gradient``, so
XLA removes the whole backbone backward. Here the frozen parameters do not
require grad and the backbone runs with autograd off, so every block takes
the inference kernels (K2, K1), which write no stash, and no backward kernel
launches; only the final norm, the pool and the head run under autograd.
``ft`` and ``fs`` run the training kernels of the encoder's blocks.

Not ported yet (ROADMAP): tensor parallelism and ZeRO (they raise), the
progress figures.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sky_embeddings_tpu_torch.data.augment import augment_batch
from sky_embeddings_tpu_torch.eval.eval_fns import batch_images, batch_ra_dec
from sky_embeddings_tpu_torch.models.predictor import SkyViT, build_predictor_model
from sky_embeddings_tpu_torch.train import optim
from sky_embeddings_tpu_torch.train.schedules import linear_lr
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt
from sky_embeddings_tpu_torch.utils.device import DTYPES, resolve_device

def warm_start_from_mim(predictor_params: dict, mim_params: dict, log_fn=print):
    """Copy name+shape-matching tensors of a MIM params tree into a predictor
    tree (both nested dicts, as ``utils/checkpoint.nest`` makes them); the
    ``head`` subtree and every unmatched leaf keep their fresh values.
    Returns ``(merged, copied, kept_fresh)``, the last two the '/'-joined
    paths, counted as JAX counts them (the head subtree once)."""
    copied, skipped = [], []

    def walk(dst, src, path=()):
        out = {}
        for k, v in dst.items():
            if k == "head":
                out[k] = v  # fresh head (trunc_normal 2e-5), ref vit.py:246
                skipped.append("/".join(path + (k,)))
                continue
            if isinstance(v, dict):
                out[k] = walk(v, src.get(k, {}) if isinstance(src, dict) else {}, path + (k,))
            else:
                s = src.get(k) if isinstance(src, dict) else None
                if s is not None and tuple(np.shape(s)) == tuple(np.shape(v)):
                    out[k] = s
                    copied.append("/".join(path + (k,)))
                else:
                    out[k] = v
                    skipped.append("/".join(path + (k,)))
        return out

    result = walk(predictor_params, mim_params)
    log_fn(f"Warm start: copied {len(copied)} tensors, kept fresh {len(skipped)}.")
    return result, copied, skipped


def make_predictor_step(
    model: SkyViT,
    optimizer: Optional[torch.optim.Optimizer],
    schedule: Optional[Callable[[int], float]],
    loss_fn_name: str,
    use_label_errs: bool,
    augment: bool,
    augment_params: dict,
    train: bool,
    frozen_backbone: bool = False,
    pixel_min: Optional[float] = None,
    pixel_max: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
):
    """The step function ``(cutouts, ra_dec, labels, step) -> (loss, metric)``,
    0-d device tensors: when training the forward, ``backward()`` and an
    AdamW step at ``lr = schedule(step)`` times each group's scale; in eval
    the forward alone, without grad. ``frozen_backbone`` runs the backbone
    with autograd off (the ``lp`` regime); ``generator`` draws the
    augmentations and the head dropout of a training step."""
    is_ce = "crossentropy" in loss_fn_name.lower()

    def compute(cutouts, ra_dec, labels):
        if pixel_min is not None:
            cutouts = cutouts.clamp_min(pixel_min)
        if pixel_max is not None:
            cutouts = cutouts.clamp_max(pixel_max)
        cutouts = cutouts.float()
        if train and augment:
            cutouts = augment_batch(generator, cutouts, **augment_params)
        label_errs = None
        if use_label_errs and not is_ce:
            n = labels.shape[1] // 2
            labels, label_errs = labels[:, :n], labels[:, n:]
        rd = ra_dec if model.ra_dec else None
        drop = generator if train else None
        if frozen_backbone:
            with torch.no_grad():
                tokens = model.backbone(cutouts, rd)
            out = model.forward_head(model.final_norm(tokens), drop)
        else:
            out = model(cutouts, ra_dec=rd, dropout_generator=drop)
        out = out.float()
        if is_ce:
            tgt = labels.reshape(-1).long()
            loss = F.cross_entropy(out, tgt)
            metric = (out.argmax(dim=1) == tgt).float().mean()
        else:
            tgt = model.normalize_labels(labels.float())
            per = (out - tgt) ** 2
            loss = (per / (label_errs.float() + 1e-5)).mean() if label_errs is not None else per.mean()
            metric = (out - tgt).abs().mean()
        return loss, metric

    if not train:
        def eval_step(cutouts, ra_dec, labels, step: int = 0):
            with torch.no_grad():
                return compute(cutouts, ra_dec, labels)

        return eval_step

    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(cutouts, ra_dec, labels, step: int):
        loss, metric = compute(cutouts, ra_dec, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:  # JAX's zero gradient: Adam's moments and the decay still act
                p.grad = torch.zeros_like(p)
        optim.set_lr(optimizer, schedule(step))
        optimizer.step()
        return loss.detach(), metric.detach()

    return train_step


class PredictorTrainer:
    """Owns the model, optimizer, step count and generator of one predictor
    run, on ``device``."""

    def __init__(self, config, mae_config, dtype: Optional[torch.dtype] = None, seed: int = 0,
                 compat_ft_lr: bool = True, device: str | torch.device = "cuda"):
        self.config = config
        self.mae_config = mae_config
        self.device = resolve_device(device)
        training = config.training
        if training.int("tensor_parallel", 1) > 1 or training.bool("zero_optimizer", False):
            raise NotImplementedError(
                "tensor_parallel / zero_optimizer are not ported yet (ROADMAP: parallel/)")
        if dtype is None:
            dtype = DTYPES[training.str("dtype", "float32")]
        self.model = build_predictor_model(
            config, mae_config, dtype=dtype, device=self.device,
            generator=torch.Generator().manual_seed(seed),
            remat=training.bool("remat", False)).train()

        self.total_batch_iters = training.int("total_batch_iters")
        self.batch_size = training.int("batch_size")
        self.loss_fn_name = training.str("loss_fn", "mse")
        self.use_label_errs = training.bool("use_label_errs", False)
        self.train_method = training.str("train_method", "fs").lower()
        init_lr = training.float("init_lr")
        final_lr_factor = training.float("final_lr_factor")
        weight_decay = training.float("weight_decay", 0.0)
        layer_decay = training.float("layer_decay", 0.75)
        self.augment = training.bool("augment", False)
        self.augment_params = dict(
            brightness=training.float("brightness", 0.8),
            noise=training.float("noise", 0.01),
            nan_channels=training.int("nan_channels", 2),
        )

        self.frozen_backbone = self.train_method in ("lp", "linearprobe")
        if self.train_method in ("ft", "finetune"):
            self.optimizer, base_lr = optim.finetune_optimizer(
                self.model, self.model.depth, layer_decay, init_lr, weight_decay,
                compat_ft_lr=compat_ft_lr)
        elif self.frozen_backbone:
            base_lr = init_lr
            self.optimizer = optim.linear_probe_optimizer(self.model, init_lr, weight_decay,
                                                          self.model.global_pool)
            mask = optim.trainable_mask(self.model.named_parameters(), self.train_method,
                                        self.model.global_pool)
            for name, p in self.model.named_parameters():
                p.requires_grad_(mask[name])
        else:
            base_lr = init_lr
            self.optimizer = optim.supervised_optimizer(self.model, init_lr, weight_decay)
        self.schedule = linear_lr(base_lr, self.total_batch_iters, final_lr_factor)

        self.seed = seed
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.losses: dict = defaultdict(list)
        self.pixel_min = config.data.float("pixel_min", -3.0)
        pm = config.data.str("pixel_max", "")
        self.pixel_max = float(pm) if pm else None
        common = dict(
            model=self.model, loss_fn_name=self.loss_fn_name,
            use_label_errs=self.use_label_errs, augment=self.augment,
            augment_params=self.augment_params, frozen_backbone=self.frozen_backbone,
            pixel_min=self.pixel_min, pixel_max=self.pixel_max,
        )
        self._train_step = make_predictor_step(
            optimizer=self.optimizer, schedule=self.schedule, train=True,
            generator=self.generator, **common)
        self._eval_step = make_predictor_step(optimizer=None, schedule=None, train=False, **common)

    @property
    def cur_iter(self) -> int:
        return self.step

    def _inputs(self, batch: dict):
        labels = batch["labels"]
        labels = (labels.to(self.device) if torch.is_tensor(labels)
                  else torch.as_tensor(np.asarray(labels), device=self.device))
        ra_dec = batch_ra_dec(batch, self.device) if self.model.ra_dec else None
        return batch_images(batch, self.device), ra_dec, labels

    def train_batch(self, batch: dict):
        """One optimizer step on ``batch``: ``(loss, metric)``."""
        loss, metric = self._train_step(*self._inputs(batch), self.step)
        self.step += 1
        return loss, metric

    def eval_batch(self, batch: dict):
        """``(loss, metric)`` of ``batch`` without dropout or augmentation."""
        return self._eval_step(*self._inputs(batch))

    # ------------------------------------------------------------------
    def warm_start(self, mim_checkpoint_path: str, log_fn=print) -> bool:
        """Copy the matching tensors of a MIM checkpoint, the port's or the
        JAX package's, into the model."""
        payload = ckpt.load_checkpoint(mim_checkpoint_path)
        if payload is None:
            return False
        current = ckpt.nest(self.model.state_dict())
        mim = payload["params"]
        if not ckpt.is_jax_checkpoint(mim_checkpoint_path):
            mim = ckpt.nest(mim)
        mim = ckpt.adapt_block_layout(mim, current)
        merged, _, _ = warm_start_from_mim(current, mim, log_fn=log_fn)
        self.model.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                                    for k, v in ckpt.flatten(merged).items()})
        return True

    def save(self, path: str) -> None:
        """The trainer's state at ``path``: the port's file, or for a
        ``.ckpt.msgpack`` path the JAX package's (optax-form moments)."""
        if ckpt.is_jax_checkpoint(path):
            regime = ("lp" if self.frozen_backbone else
                      "ft" if self.train_method in ("ft", "finetune") else "fs")
            ckpt.save_checkpoint(path, optim.jax_payload(self.model, self.optimizer, regime,
                                                         self.step, self.seed, self.losses))
            return
        ckpt.save_checkpoint(path, {
            "step": self.step,
            "params": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
            "losses": {k: [float(x) for x in v] for k, v in self.losses.items()},
        })

    def restore(self, path: str) -> bool:
        """Resume from the port's checkpoint or the JAX package's
        (``optim.restore_state``); False without a file."""
        out = optim.restore_state(path, self.model, self.optimizer, self.generator, self.seed)
        if out is None:
            return False
        _, self.step, losses = out
        self.losses = defaultdict(list, losses)
        return True


def train_predictor_network(
    trainer: PredictorTrainer,
    train_batches,
    val_batcher,
    verbose_iters: int,
    cp_time_minutes: float,
    model_filename: str,
    early_stop_evals: int = 50,
    log_fn: Callable[[str], None] = print,
) -> None:
    """The predictor loop (reference ``train_predictor.train_network``):
    every ``verbose_iters`` a full validation pass, the best model saved to
    the ``_best`` sidecar, early stopping after ``early_stop_evals`` stale
    evaluations; saves every ``cp_time_minutes`` and at the end."""
    losses = trainer.losses
    total = trainer.total_batch_iters
    is_ce = "crossentropy" in trainer.loss_fn_name.lower()
    metric_name = "acc" if is_ce else "mae"
    best_val = min(losses["val_loss"]) if losses.get("val_loss") else np.inf
    stale = 0
    losses_cp: dict = defaultdict(list)
    cp_start = time.time()
    best_filename = model_filename.replace(ckpt.CKPT_SUFFIX, "_best" + ckpt.CKPT_SUFFIX)

    if trainer.cur_iter >= total:
        log_fn("Training already complete for this config; nothing to do.")
        return

    for batch in train_batches:
        loss, metric = trainer.train_batch(batch)
        losses_cp["train_loss"].append(loss)
        losses_cp[f"train_{metric_name}"].append(metric)
        cur_iter = trainer.cur_iter

        if cur_iter % verbose_iters == 0:
            for vbatch in val_batcher:
                vloss, vmetric = trainer.eval_batch(vbatch)
                losses_cp["val_loss"].append(vloss)
                losses_cp[f"val_{metric_name}"].append(vmetric)
            for k in losses_cp:
                losses[k].append(float(np.mean([float(x) for x in losses_cp[k]])))
            losses["batch_iters"].append(cur_iter)
            losses_cp = defaultdict(list)
            log_fn(f"Batch Iterations: {cur_iter}/{total} | "
                   f"train loss {losses['train_loss'][-1]:.3e} | "
                   f"val loss {losses['val_loss'][-1]:.3e} | "
                   f"val {metric_name} {losses[f'val_{metric_name}'][-1]:.4f}")
            if losses["val_loss"][-1] < best_val:
                best_val = losses["val_loss"][-1]
                log_fn("Saving network (best)...")
                trainer.losses = losses
                trainer.save(best_filename)
                stale = 0
            else:
                stale += 1
                if stale >= early_stop_evals:
                    log_fn(f"Early stopping after {stale} stale evaluations.")
                    trainer.losses = losses
                    trainer.save(model_filename)
                    return

        if (time.time() - cp_start) >= cp_time_minutes * 60:
            log_fn("Saving network...")
            trainer.losses = losses
            trainer.save(model_filename)
            cp_start = time.time()

        if cur_iter >= total:
            log_fn("Saving network...")
            trainer.losses = losses
            trainer.save(model_filename)
            break
