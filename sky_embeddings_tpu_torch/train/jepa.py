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

Under a process group, as the MIM trainer (``train/pretrain.py``): the
model (context encoder and predictor) in DDP, the block masks drawn for
the global batch and sliced to this rank's rows, the loss's count summed
over the ranks (``models/jepa``); the EMA target stays outside DDP and is
updated alike on every rank from the same parameters.
``[TRAINING] zero_optimizer = True`` shards the AdamW moments
(``parallel/zero``).

``[TRAINING] tensor_parallel = tp > 1`` (JAX ``train/jepa.py:62-72``)
lays the ranks out as a (data, tp) mesh (``parallel/mesh``), draws the
whole model from the seed and keeps this rank's shard of every block that
tp splits (``parallel/sharding``: the encoder's at ViT-S and up); the
blocks tp does not divide (the predictor's, ``jepa_tiny``'s encoder) run
whole on every rank. The EMA target is the online encoder's copy, sharded
exactly alike and sharing its mesh, so the EMA stays an elementwise pass
over matching shards and its no-grad forward runs the tensor-parallel
forms, as JAX splits the target like its encoder (``:140-152``). DDP,
ZeRO-1, the global batch's rows and mask draws and the loss's sums run
over the data group, so the ranks of one model group draw the same masks.
A save gathers every shard, the target's too, on rank 0, which writes
whole arrays in either format; a restore cuts them, so a checkpoint
moves between layouts and frameworks.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.models.jepa import build_jepa_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks, sample_block_masks
from sky_embeddings_tpu_torch.parallel import distributed, zero
from sky_embeddings_tpu_torch.parallel.mesh import local_sharding, tensor_parallel_mesh
from sky_embeddings_tpu_torch.parallel.sharding import gather_to_main, shard_state, split_of
from sky_embeddings_tpu_torch.train.optim import (decay_mask, jax_payload, restore_state, set_lr,
                                                  supervised_optimizer, whole_state)
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
        # [TRAINING] tensor_parallel: the blocks' weights sharded over the model axis
        self.mesh = tensor_parallel_mesh(training.int("tensor_parallel", 1), self.device)
        self.zero_optimizer = training.bool("zero_optimizer", False)
        dtype = DTYPES[training.str("dtype", "float32")]
        self.model = build_jepa_model(config, dtype=dtype, device=self.device,
                                      generator=torch.Generator().manual_seed(seed),
                                      mesh=self.mesh).train()
        # the online encoder's copy, its shards and their layout; the blocks
        # share the mesh (its process groups cannot be copied)
        memo = {} if self.mesh is None else {id(self.mesh): self.mesh}
        self.target = copy.deepcopy(self.model.encoder, memo).requires_grad_(False)
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
        if self.zero_optimizer:
            self.optimizer = zero.shard_optimizer(self.optimizer)
        self.forward = distributed.data_parallel(self.model, self.device)
        self.batch_shard = local_sharding(self.device)
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

    def _whole_target(self) -> Optional[dict]:
        """The EMA target's whole state dict on the CPU; under tensor
        parallelism gathered on the model group's first rank of data index
        0 (None on the others; every rank calls it)."""
        if self.mesh is None:
            return {k: v.detach().cpu() for k, v in self.target.state_dict().items()}
        if self.mesh.data_index != 0:
            return None
        return gather_to_main(self.target.state_dict(), self.mesh, split_of(self.target))

    def target_variables(self) -> Optional[dict]:
        """The EMA encoder's parameters as JAX's tree (``{"params":
        {"encoder": ...}}``, numpy, whole): the representation used
        downstream. Under tensor parallelism every rank calls it, and the
        ranks but the first of data index 0 get None."""
        target = self._whole_target()
        return None if target is None else {"params": {"encoder": params_to_jax(target)}}

    def draw_masks(self, batch_size: int, generator: torch.Generator) -> BlockMasks:
        """The block masks of ``batch_size`` rows; under a process group,
        this rank's rows of the global batch's."""
        rows = distributed.batch_rows(batch_size)
        n = batch_size if rows is None else rows[1]
        masks = sample_block_masks(generator, n, self.model.grid_size, **self.mask_params)
        return masks if rows is None else BlockMasks(*(t[rows[0]] for t in masks))

    def _cutouts(self, batch: dict) -> torch.Tensor:
        x = torch.as_tensor(batch["cutouts"], device=self.device).float()
        if self.pixel_min is not None:
            x = x.clamp_min(self.pixel_min)
        if self.pixel_max is not None:
            x = x.clamp_max(self.pixel_max)
        return x

    def loss(self, imgs: torch.Tensor, masks: BlockMasks,
             mark: Callable[[str], None] = lambda part: None, forward=None) -> torch.Tensor:
        """The loss of clipped ``imgs`` under ``masks`` against the EMA
        target's encoding (taken under no grad), through ``forward`` (the
        model by default); ``mark("target")`` is called once that encoding
        is queued."""
        with torch.no_grad():
            target_repr = self.target(imgs)
        mark("target")
        return (forward or self.model)(imgs, masks, target_repr)

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
        loss = self.loss(imgs, masks, mark, self.forward)
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
        ``.ckpt.msgpack`` path the JAX package's (optax-form moments).
        Every rank calls it; rank 0 writes, with ZeRO's moments collected
        and, under tensor parallelism, every shard of the model, its
        moments and the EMA target gathered (``optim.whole_state``)."""
        zero.consolidate(self.optimizer)
        jax_file = ckpt.is_jax_checkpoint(path)
        # one process writes JAX's format from its own model and optimizer
        whole = (whole_state(self.model, self.optimizer, self.mesh)
                 if self.mesh is not None or not jax_file else None)
        target = self._whole_target()
        if not distributed.is_main():
            return
        if jax_file:
            ckpt.save_checkpoint(path, jax_payload(
                self.model, self.optimizer, "jepa", self.step, self.seed, self.losses, whole=whole,
                target_params=params_to_jax(target)))
            return
        params, opt_state = whole
        ckpt.save_checkpoint(path, {
            "step": self.step,
            "params": params,
            "target_params": target,
            "opt_state": opt_state,
            "rng": self.mask_gen.get_state(),
            "losses": {k: [float(x) for x in v] for k, v in self.losses.items()},
        })

    def restore(self, path: str) -> bool:
        """Resume from the port's checkpoint or the JAX package's, the EMA
        ``target_params`` too (``optim.restore_state``), the whole arrays cut
        to this rank's shards under tensor parallelism; False without a
        file."""
        out = restore_state(path, self.model, self.optimizer, self.mask_gen, self.seed,
                            mesh=self.mesh)
        if out is None:
            return False
        payload, self.step, losses = out
        target = payload["target_params"]
        if ckpt.is_jax_checkpoint(path):
            target = params_from_jax(ckpt.adapt_block_layout(
                target, ckpt.nest(self.target.state_dict())))
        if self.mesh is not None:
            target = shard_state(target, self.mesh.model_index, self.mesh.tp,
                                 split_of(self.target))
        self.target.load_state_dict(target)
        self.losses = defaultdict(list, losses)
        return True
