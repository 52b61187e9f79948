"""SimMIM pretraining: step, trainer and host loop (port of
``sky_embeddings_tpu/train/pretrain.py``).

One training step clips the pixels, takes a (B, C, H, W) SimMIM mask, runs
the forward and ``loss.backward()`` through the encoder's kernels (the
attention stash forward/backward and the MLP recompute backward, see
``models/layers.py``), and an AdamW step whose learning rate follows the
cosine schedule with optax's step indexing. The step takes the mask as an
argument: :class:`MIMPretrainer` draws it from its own ``torch.Generator`` on
the device, and tests hand the same numpy mask to this port and to JAX.
Validation masks vary across val batches and across eval passes, as the JAX
step makes them by folding the batch index and the step into its key.

Not ported yet (ROADMAP): remat, tensor parallelism and ZeRO (they raise),
and the linear probes and figures of ``train_network`` (skipped with a
message).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.models.mim import SkyMIM, build_mim_model
from sky_embeddings_tpu_torch.ops.masking import simmim_batch_mask
from sky_embeddings_tpu_torch.train.optim import pretrain_optimizer
from sky_embeddings_tpu_torch.train.schedules import cosine_annealing
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt
from sky_embeddings_tpu_torch.utils.device import resolve_device
from sky_embeddings_tpu_torch.utils.profiling import StepTimer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_mim_step(
    model: SkyMIM,
    optimizer: Optional[torch.optim.Optimizer],
    schedule: Optional[Callable[[int], float]],
    train: bool,
    pixel_min: Optional[float] = None,
    pixel_max: Optional[float] = None,
):
    """The step function: ``(cutouts, mask, step) -> loss`` when training
    (forward, backward, AdamW step at ``lr = schedule(step)``), ``(cutouts,
    mask) -> loss`` in eval (forward only). ``pixel_min``/``pixel_max`` apply
    the loader's pixel clip on the device. The loss is a 0-d device tensor."""

    def prep(cutouts: torch.Tensor) -> torch.Tensor:
        if pixel_min is not None:
            cutouts = cutouts.clamp_min(pixel_min)
        if pixel_max is not None:
            cutouts = cutouts.clamp_max(pixel_max)
        return cutouts.float()

    if not train:
        def eval_step(cutouts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return model(prep(cutouts), mask)[0]

        return eval_step

    def train_step(cutouts: torch.Tensor, mask: torch.Tensor, step: int) -> torch.Tensor:
        loss = model(prep(cutouts), mask)[0]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # unused (mask_token): JAX's zero gradient, still decayed
                    p.grad = torch.zeros_like(p)
        lr = schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss.detach()

    return train_step


class MIMPretrainer:
    """Owns the model, optimizer, step count and mask generator of one
    SimMIM pretraining run, on ``device``."""

    def __init__(self, config, dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        training = config.training
        if training.bool("remat", False):
            raise NotImplementedError("remat is not ported yet (ROADMAP 1.12: scan layout and remat)")
        if training.int("tensor_parallel", 1) > 1 or training.bool("zero_optimizer", False):
            raise NotImplementedError(
                "tensor_parallel / zero_optimizer are not ported yet (ROADMAP 1.12: parallel/)")
        if dtype is None:
            dtype = _DTYPES[training.str("dtype", "float32")]
        self.model = build_mim_model(config, dtype=dtype, device=self.device,
                                     generator=torch.Generator().manual_seed(seed)).train()
        self.total_batch_iters = training.int("total_batch_iters")
        self.batch_size = training.int("batch_size")
        self.max_mask_ratio = training.float("max_mask_ratio", 0.9)
        self.pixel_min = config.data.float("pixel_min", -3.0)
        pm = config.data.str("pixel_max", "")
        self.pixel_max = float(pm) if pm else None
        self.schedule = cosine_annealing(training.float("init_lr"), self.total_batch_iters,
                                         training.float("final_lr_factor"))
        self.optimizer = pretrain_optimizer(self.model, self.schedule(0),
                                            training.float("weight_decay"))
        self.seed = seed
        self.step = 0
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.losses: dict = defaultdict(list)
        clip = dict(pixel_min=self.pixel_min, pixel_max=self.pixel_max)
        self._train_step = make_mim_step(self.model, self.optimizer, self.schedule, True, **clip)
        self._eval_step = make_mim_step(self.model, None, None, False, **clip)

    @property
    def cur_iter(self) -> int:
        return self.step

    def draw_mask(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        m = self.model
        return simmim_batch_mask(generator, batch_size, m.in_chans, m.img_size, m.patch_size,
                                 self.max_mask_ratio)

    def _cutouts(self, batch: dict) -> torch.Tensor:
        return torch.as_tensor(batch["cutouts"], device=self.device)

    def train_batch(self, batch: dict, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on ``batch``; the mask is drawn from the
        trainer's generator unless given."""
        cutouts = self._cutouts(batch)
        if mask is None:
            mask = self.draw_mask(cutouts.shape[0], self.mask_gen)
        loss = self._train_step(cutouts, mask, self.step)
        self.step += 1
        return loss

    def eval_batch(self, batch: dict, idx: int = 0, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Validation loss of ``batch``; its mask comes from a generator
        seeded by (seed, step, idx), so it differs across val batches and
        across eval passes without touching the training stream."""
        cutouts = self._cutouts(batch)
        if mask is None:
            seed = int(np.random.SeedSequence([self.seed, self.step, idx]).generate_state(1)[0])
            mask = self.draw_mask(cutouts.shape[0], torch.Generator(device=self.device).manual_seed(seed))
        return self._eval_step(cutouts, mask)

    def save(self, path: str) -> None:
        ckpt.save_checkpoint(path, {
            "step": self.step,
            "params": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.mask_gen.get_state(),
            "losses": {k: [float(x) for x in v] for k, v in self.losses.items()},
        })

    def restore(self, path: str) -> bool:
        payload = ckpt.load_checkpoint(path)
        if payload is None:
            return False
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
        self.mask_gen.set_state(payload["rng"])
        self.losses = defaultdict(list, {k: list(v) for k, v in payload["losses"].items()})
        return True


def train_network(
    pretrainer: MIMPretrainer,
    train_batches,
    val_batcher,
    total_batch_iters: int,
    verbose_iters: int,
    cp_time_minutes: float,
    model_filename: str,
    lp_class_data_file: Optional[str] = None,
    lp_regress_data_file: Optional[str] = None,
    max_val_batches: int = 200,
    log_fn: Callable[[str], None] = print,
) -> None:
    """The pretraining loop (JAX ``train_network``): train steps, a
    validation pass of at most ``max_val_batches`` every ``verbose_iters``,
    checkpoints every ``cp_time_minutes`` and at the end."""
    losses = pretrainer.losses
    losses_cp: dict = defaultdict(list)
    cp_start = time.time()

    if pretrainer.cur_iter >= total_batch_iters:
        log_fn("Training already complete for this config; nothing to do.")
        return
    if lp_class_data_file or lp_regress_data_file:
        log_fn("Linear probes (ROADMAP 1.12) and progress figures (ROADMAP 1.8) are not "
               "ported yet; skipping them.")

    timer = StepTimer(batch_size=pretrainer.batch_size, device=pretrainer.device)
    for batch in train_batches:
        loss = pretrainer.train_batch(batch)
        losses_cp["train_loss"].append(loss)
        timer.step()
        cur_iter = pretrainer.cur_iter

        if cur_iter % verbose_iters == 0:
            perf = timer.lap()  # close the timing window before eval work
            if val_batcher is not None:
                for i, vbatch in enumerate(val_batcher.take(max_val_batches)):
                    losses_cp["val_loss"].append(pretrainer.eval_batch(vbatch, idx=i))
            for k in losses_cp:
                losses[k].append(float(np.mean([float(x) for x in losses_cp[k]])))
            losses["batch_iters"].append(cur_iter)
            losses_cp = defaultdict(list)

            msg = [f"Batch Iterations: {cur_iter}/{total_batch_iters}",
                   f"  train loss {losses['train_loss'][-1]:.4f}",
                   f"  {perf['img_per_sec']:.0f} img/s"]
            if losses.get("val_loss"):
                msg.append(f"  val loss {losses['val_loss'][-1]:.4f}")
            log_fn(" |".join(msg))

        if (time.time() - cp_start) >= cp_time_minutes * 60 or cur_iter >= total_batch_iters:
            log_fn("Saving network...")
            pretrainer.losses = losses
            pretrainer.save(model_filename)
            cp_start = time.time()
        if cur_iter >= total_batch_iters:
            break
