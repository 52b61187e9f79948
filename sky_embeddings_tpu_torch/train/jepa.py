"""I-JEPA pretraining: EMA target encoder, scheduled weight decay,
warmup-cosine learning rate (port of ``sky_embeddings_tpu/train/jepa.py``).

The hyperparameters follow ``configs/jepa_1.ini``: ``ema = [m0, m1]`` (the
momentum ramps linearly from m0 to m1 over training), ``weight_decay ->
final_weight_decay`` (a cosine ramp) and ``start_lr / ref_lr / final_lr``
(linear warmup to ``ref_lr`` over 10% of training, cosine decay to
``final_lr``); ``[MASK]`` sets the block masks. One step, as JAX's
``_make_step``:

1. the masks, from the trainer's ``torch.Generator`` on the device unless
   the caller passes them;
2. the EMA target encoder encodes the full grid under ``no_grad``, with the
   parameters from before the update;
3. the loss (``models/jepa.SkyJEPA``: the context encoder over the gathered
   context tokens, ``num_pred`` predictor passes) and ``backward()``; a
   parameter that took no gradient (``patch_mask_values`` when no pixel is
   NaN) gets JAX's zero gradient, which is still decayed;
4. AdamW at ``lr(t)`` with the decayed groups' ``weight_decay`` at
   ``wd(t)`` (``train/optim.supervised_optimizer``), t the step count;
5. the EMA ``target · m + online · (1 - m)`` over the encoder's parameters,
   m at the step count before the increment.

Blocks take the kernels as ``models/jepa.py`` says. Validation masks come
from a generator seeded by (seed, step, idx), so they differ across val
batches and across eval passes without touching the training stream, as
``MIMPretrainer.eval_batch``'s do. The pixel clip of the loaders
(``[DATA] pixel_min``, default -3, and ``pixel_max``) runs on the device
inside the step; it is idempotent with a host clip.

``tensor_parallel`` and ``zero_optimizer`` raise, as in the MIM trainer.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.models.jepa import build_jepa_model
from sky_embeddings_tpu_torch.models.weights import load_jax_params, params_to_jax
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks, sample_block_masks
from sky_embeddings_tpu_torch.train.optim import (decay_mask, jax_payload, restore_state, set_lr,
                                                  supervised_optimizer)
from sky_embeddings_tpu_torch.train.schedules import cosine_ramp, linear_ramp, warmup_cosine_decay
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt
from sky_embeddings_tpu_torch.utils.device import DTYPES, resolve_device


def mask_params(config) -> dict:
    """``sample_block_masks``' keyword arguments from the ``[MASK]`` section
    (JAX's defaults where the config has none)."""
    m = config["MASK"] if "MASK" in config else None

    def get(kind, key, default):
        return default if m is None else getattr(m, kind)(key, default)

    return dict(
        num_pred=get("int", "num_pred_masks", 4),
        pred_mask_scale=tuple(get("list", "pred_mask_scale", [0.15, 0.2])),
        enc_mask_scale=tuple(get("list", "enc_mask_scale", [0.85, 1.0])),
        aspect_ratio=tuple(get("list", "aspect_ratio", [0.75, 1.5])),
        min_keep=get("int", "min_keep", 5),
    )


class JEPATrainer:
    """Owns the context encoder and predictor (``model``), the EMA target
    encoder (``target``), the optimizer, the step count and the mask
    generator of one I-JEPA run, on ``device``."""

    def __init__(self, config, seed: int = 0, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        training = config.training
        if training.int("tensor_parallel", 1) > 1 or training.bool("zero_optimizer", False):
            raise NotImplementedError(
                "tensor_parallel / zero_optimizer are not ported yet (ROADMAP: parallel/)")
        dtype = DTYPES[training.str("dtype", "float32")]
        self.model = build_jepa_model(config, dtype=dtype, device=self.device,
                                      generator=torch.Generator().manual_seed(seed)).train()
        self.target = copy.deepcopy(self.model.encoder).requires_grad_(False)
        self.total_batch_iters = training.int("total_batch_iters")
        self.batch_size = training.int("batch_size")
        self.mask_params = mask_params(config)
        ema = training.list("ema", [0.996, 1.0])
        T = self.total_batch_iters
        self.lr_schedule = warmup_cosine_decay(training.float("start_lr", 2e-4),
                                               training.float("ref_lr", 1e-3), T,
                                               training.float("final_lr", 1e-6))
        wd0 = training.float("weight_decay", 0.04)
        self.wd_schedule = cosine_ramp(wd0, training.float("final_weight_decay", wd0), T)
        self.ema_schedule = linear_ramp(float(ema[0]), float(ema[1]), T)
        self.optimizer = supervised_optimizer(self.model, self.lr_schedule(0), self.wd_schedule(0))
        self.decays = decay_mask(self.model.named_parameters())
        self.pixel_min = config.data.float("pixel_min", -3.0)
        pm = config.data.str("pixel_max", "")
        self.pixel_max = float(pm) if pm else None
        self.seed = seed
        self.step = 0
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.losses: dict = defaultdict(list)

    @property
    def cur_iter(self) -> int:
        return self.step

    @property
    def plain(self) -> bool:
        """Whether every block (context and target encoders, predictor) takes
        the kernels' plain versions."""
        return self.model.plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self.model.plain = value
        self.target.encoder.plain = value

    def target_variables(self) -> dict:
        """The EMA encoder's parameters as JAX's tree (``{"params":
        {"encoder": ...}}``, numpy): the representation used downstream."""
        return {"params": {"encoder": params_to_jax(self.target.state_dict())}}

    def draw_masks(self, batch_size: int, generator: torch.Generator) -> BlockMasks:
        return sample_block_masks(generator, batch_size, self.model.grid_size, **self.mask_params)

    def _cutouts(self, batch: dict) -> torch.Tensor:
        x = torch.as_tensor(batch["cutouts"], device=self.device).float()
        if self.pixel_min is not None:
            x = x.clamp_min(self.pixel_min)
        if self.pixel_max is not None:
            x = x.clamp_max(self.pixel_max)
        return x

    def loss(self, imgs: torch.Tensor, masks: BlockMasks,
             mark: Callable[[str], None] = lambda part: None) -> torch.Tensor:
        """The loss of clipped ``imgs`` under ``masks`` against the EMA
        target's encoding (taken under no grad); ``mark("target")`` is
        called once that encoding is queued."""
        with torch.no_grad():
            target_repr = self.target(imgs)
        mark("target")
        return self.model(imgs, masks, target_repr)

    def train_batch(self, batch: dict, masks: Optional[BlockMasks] = None,
                    mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
        """One optimizer step and EMA update on ``batch``; the masks are drawn
        from the trainer's generator unless given. Returns the 0-d loss.
        ``mark(part)``, when given, is called as each part of the step has
        been queued (``inputs``, ``masks``, ``target``, ``forward``,
        ``backward``, ``adamw``, ``ema``): a hook that times the parts."""
        mark = mark or (lambda part: None)
        imgs = self._cutouts(batch)
        mark("inputs")
        if masks is None:
            masks = self.draw_masks(imgs.shape[0], self.mask_gen)
        mark("masks")
        loss = self.loss(imgs, masks, mark)
        mark("forward")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # unused (no NaN pixel): JAX's zero gradient, still decayed
                    p.grad = torch.zeros_like(p)
        set_lr(self.optimizer, self.lr_schedule(self.step))
        for group in self.optimizer.param_groups:  # looked up anew: restore replaces the groups
            if self.decays[group["names"][0]]:
                group["weight_decay"] = self.wd_schedule(self.step)
        self.optimizer.step()
        mark("adamw")
        m = np.float32(self.ema_schedule(self.step))
        with torch.no_grad():
            tgt, src = list(self.target.parameters()), list(self.model.encoder.parameters())
            torch._foreach_mul_(tgt, float(m))
            torch._foreach_add_(tgt, torch._foreach_mul(src, float(np.float32(1) - m)))
        mark("ema")
        self.step += 1
        return loss.detach()

    def eval_batch(self, batch: dict, idx: int = 0) -> torch.Tensor:
        """Validation loss of ``batch``; its masks come from a generator
        seeded by (seed, step, idx)."""
        imgs = self._cutouts(batch)
        seed = int(np.random.SeedSequence([self.seed, self.step, idx]).generate_state(1)[0])
        masks = self.draw_masks(imgs.shape[0], torch.Generator(device=self.device).manual_seed(seed))
        with torch.no_grad():
            return self.loss(imgs, masks)

    def save(self, path: str) -> None:
        """The trainer's state at ``path``: the port's file, or for a
        ``.ckpt.msgpack`` path the JAX package's (optax-form moments)."""
        if ckpt.is_jax_checkpoint(path):
            ckpt.save_checkpoint(path, jax_payload(
                self.model, self.optimizer, "jepa", self.step, self.seed, self.losses,
                target_params=params_to_jax(self.target.state_dict())))
            return
        ckpt.save_checkpoint(path, {
            "step": self.step,
            "params": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "target_params": {k: v.detach().cpu() for k, v in self.target.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.mask_gen.get_state(),
            "losses": {k: [float(x) for x in v] for k, v in self.losses.items()},
        })

    def restore(self, path: str) -> bool:
        """Resume from the port's checkpoint or the JAX package's, the EMA
        ``target_params`` too (``optim.restore_state``); False without a
        file."""
        out = restore_state(path, self.model, self.optimizer, self.mask_gen, self.seed)
        if out is None:
            return False
        payload, self.step, losses = out
        if ckpt.is_jax_checkpoint(path):
            load_jax_params(self.target, payload["target_params"])
        else:
            self.target.load_state_dict(payload["target_params"])
        self.losses = defaultdict(list, losses)
        return True
