"""MIM pretraining, SimMIM and MAE: step, trainer and host loop (port of
``sky_embeddings_tpu/train/pretrain.py``).

One training step clips the pixels, takes the step's masking (a (B, C, H, W)
SimMIM pixel mask, or the (B, L) noise that picks the tokens an MAE model
drops), runs the forward and ``loss.backward()`` through the encoder's (and
the MAE decoder's) kernels (see ``models/layers.py``: the attention stash
with the MLP recompute backward at ViT-B, both stashes at ViT-L, both
recompute backwards under ``[TRAINING] remat``; the packed MAE encoder with
the ``seg_len`` mask), and an AdamW step whose learning rate follows the
cosine schedule with optax's step indexing. An ``ra_dec`` model also reads
the batch's ``ra_dec``. The step takes the masking as an argument:
:class:`MIMPretrainer` draws it from its own ``torch.Generator`` on the
device, and tests hand the same numpy mask or noise to this port and to
JAX. Validation masking varies across val batches and across eval passes,
as the JAX step makes it by folding the batch index and the step into its
key; an MAE model masks its validation batches too, as JAX's eval step
does.

``train_network`` runs the linear probes (``eval/linear_probe``) after each
validation pass when the config names probe sets, and keeps their metrics
beside the losses, as JAX's does. It drives the I-JEPA trainer
(``train/jepa.JEPATrainer``) the same way, as JAX's ``pretrain_jepa.py``
does; its probes read the online encoder, which is what JAX's
``pretrainer.variables()`` holds.

Data parallelism across processes (``parallel/``): under a process group
the trainer wraps its model in DDP (``self.model`` stays the module, which
``linear_probe``, ``save`` and the plain-path switch reach), draws each
step's SimMIM mask or MAE noise for the global batch (every rank's rows)
from the generator every rank seeds alike and keeps its own rows, as JAX
draws them from a replicated key, and the loss's sums run over the global
batch (``ops/losses``). ``[TRAINING] zero_optimizer = True`` shards the
AdamW moments over the ranks (``parallel/zero``); only rank 0 writes a
checkpoint, after collecting them, and every rank restores.

``[TRAINING] tensor_parallel = tp > 1`` (JAX ``train/pretrain.py:124-133``)
lays the process group out as a (data, tp) mesh (``parallel/mesh``: the
model axis consecutive ranks), builds the whole model from the seed and
keeps this rank's shard of every block that the model axis splits
(``parallel/sharding``: the encoder's and the MAE decoder's), whose kernels
run their tensor-parallel forms with the all-reduces over the model group;
a block whose heads or MLP width tp does not divide (``maesimple``'s
one-head decoder) runs whole on every rank through the recompute kernels; DDP, ZeRO-1, the global
batch's rows and draws and the loss's sums then run over the data group.
A save gathers every shard on rank 0, which writes whole arrays in either
format; a restore cuts them to the rank's shard, so a checkpoint moves
between layouts and frameworks.

With ``fig_dir`` ``train_network`` draws JAX's figures on the main process
at each validation after the first: the training curves and, for a
``SkyMIM``, a reconstruction of the first validation batch
(``eval/eval_fns.mim_reconstruct``, its mask from a generator seeded by the
step) as one-band and all-band triptychs. They read the trainer and touch
none of its state or generators, so a run draws them or not to the same
bits; without matplotlib (the card host) each figure warns and the
reconstruction still runs.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.data.prefetch import device_prefetch
from sky_embeddings_tpu_torch.eval.eval_fns import batch_ra_dec, mim_reconstruct
from sky_embeddings_tpu_torch.eval.linear_probe import linear_probe
from sky_embeddings_tpu_torch.models.mim import SkyMIM, build_mim_model
from sky_embeddings_tpu_torch.ops.masking import simmim_batch_mask
from sky_embeddings_tpu_torch.parallel import distributed, zero
from sky_embeddings_tpu_torch.parallel.mesh import local_sharding, tensor_parallel_mesh
from sky_embeddings_tpu_torch.train.optim import pretrain_optimizer, restore_state, save_state
from sky_embeddings_tpu_torch.train.schedules import cosine_annealing
from sky_embeddings_tpu_torch.utils.device import DTYPES, resolve_device
from sky_embeddings_tpu_torch.utils.plotting import plot_batch, plot_batch_tiled, plot_progress
from sky_embeddings_tpu_torch.utils.profiling import StepTimer

def make_mim_step(
    model: SkyMIM,
    optimizer: Optional[torch.optim.Optimizer],
    schedule: Optional[Callable[[int], float]],
    train: bool,
    pixel_min: Optional[float] = None,
    pixel_max: Optional[float] = None,
    forward: Optional[Callable] = None,
):
    """The step function: ``(cutouts, masking, step, ra_dec) -> loss`` when
    training (forward, backward, AdamW step at ``lr = schedule(step)``),
    ``(cutouts, masking, ra_dec) -> loss`` in eval (forward only).
    ``masking`` is the SimMIM pixel mask or the MAE token noise; ``ra_dec``
    is read only by an ``ra_dec`` model, as in JAX. ``pixel_min``/``pixel_max``
    apply the loader's pixel clip on the device. ``forward`` (``model`` by
    default; its DDP wrap under a process group) runs the training forward.
    The loss is a 0-d device tensor."""
    forward = forward or model

    def loss_of(cutouts: torch.Tensor, masking: torch.Tensor, ra_dec, fwd=model) -> torch.Tensor:
        if pixel_min is not None:
            cutouts = cutouts.clamp_min(pixel_min)
        if pixel_max is not None:
            cutouts = cutouts.clamp_max(pixel_max)
        rd = ra_dec if model.ra_dec else None
        if model.simmim:
            return fwd(cutouts.float(), masking, ra_dec=rd)[0]
        return fwd(cutouts.float(), ra_dec=rd, mae_noise=masking)[0]

    if not train:
        def eval_step(cutouts: torch.Tensor, masking: torch.Tensor, ra_dec=None) -> torch.Tensor:
            with torch.no_grad():
                return loss_of(cutouts, masking, ra_dec)

        return eval_step

    def train_step(cutouts: torch.Tensor, masking: torch.Tensor, step: int, ra_dec=None) -> torch.Tensor:
        loss = loss_of(cutouts, masking, ra_dec, forward)
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
    SimMIM or MAE pretraining run, on ``device``."""

    def __init__(self, config, dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        training = config.training
        # [TRAINING] tensor_parallel: the blocks' weights sharded over the model axis
        self.mesh = tensor_parallel_mesh(training.int("tensor_parallel", 1), self.device)
        # [TRAINING] zero_optimizer: the AdamW moments sharded over the ranks
        self.zero_optimizer = training.bool("zero_optimizer", False)
        if dtype is None:
            dtype = DTYPES[training.str("dtype", "float32")]
        # [TRAINING] remat: checkpoint each block (one extra forward for
        # O(depth) less live memory), as the JAX trainer reads it
        self.model = build_mim_model(config, dtype=dtype, device=self.device,
                                     generator=torch.Generator().manual_seed(seed),
                                     remat=training.bool("remat", False), mesh=self.mesh).train()
        self.total_batch_iters = training.int("total_batch_iters")
        self.batch_size = training.int("batch_size")
        # MAE reads its keep count from mask_ratio (build_mim_model), not this
        self.max_mask_ratio = (training.float("max_mask_ratio", 0.9) if self.model.simmim
                               else None)
        self.pixel_min = config.data.float("pixel_min", -3.0)
        pm = config.data.str("pixel_max", "")
        self.pixel_max = float(pm) if pm else None
        self.schedule = cosine_annealing(training.float("init_lr"), self.total_batch_iters,
                                         training.float("final_lr_factor"))
        self.optimizer = pretrain_optimizer(self.model, self.schedule(0),
                                            training.float("weight_decay"))
        if self.zero_optimizer:
            self.optimizer = zero.shard_optimizer(self.optimizer)
        # the DDP wrap under a process group (the model itself without one);
        # batches come as this rank's rows (device_prefetch's layout)
        self.forward = distributed.data_parallel(self.model, self.device)
        self.batch_shard = local_sharding(self.device)
        self.seed = seed
        self.step = 0
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.losses: dict = defaultdict(list)
        clip = dict(pixel_min=self.pixel_min, pixel_max=self.pixel_max)
        self._train_step = make_mim_step(self.model, self.optimizer, self.schedule, True, **clip,
                                         forward=self.forward)
        self._eval_step = make_mim_step(self.model, None, None, False, **clip)

    @property
    def cur_iter(self) -> int:
        return self.step

    def draw_mask(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """A SimMIM model's (B, C, H, W) pixel mask."""
        m = self.model
        return simmim_batch_mask(generator, batch_size, m.in_chans, m.img_size, m.patch_size,
                                 self.max_mask_ratio)

    def draw_noise(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """An MAE model's (B, L) token noise: each sample keeps the tokens
        of smallest noise."""
        return torch.rand(batch_size, self.model.grid_size ** 2, generator=generator,
                          device=generator.device)

    def _draw(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """The masking of ``batch_size`` rows; under a process group, this
        rank's rows of the global batch's."""
        draw = self.draw_mask if self.model.simmim else self.draw_noise
        rows = distributed.batch_rows(batch_size)
        if rows is None:
            return draw(batch_size, generator)
        return draw(rows[1], generator)[rows[0]]

    def _cutouts(self, batch: dict) -> torch.Tensor:
        return torch.as_tensor(batch["cutouts"], device=self.device)

    def _ra_dec(self, batch: dict) -> Optional[torch.Tensor]:
        return batch_ra_dec(batch, self.device) if self.model.ra_dec else None

    def train_batch(self, batch: dict, mask: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on ``batch``; the SimMIM mask (or the MAE
        noise) is drawn from the trainer's generator unless given."""
        cutouts = self._cutouts(batch)
        masking = mask if self.model.simmim else noise
        if masking is None:
            masking = self._draw(cutouts.shape[0], self.mask_gen)
        loss = self._train_step(cutouts, masking, self.step, self._ra_dec(batch))
        self.step += 1
        return loss

    def eval_batch(self, batch: dict, idx: int = 0, mask: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Validation loss of ``batch``; unless given, its mask (or noise)
        comes from a generator seeded by (seed, step, idx), so it differs
        across val batches and across eval passes without touching the
        training stream."""
        cutouts = self._cutouts(batch)
        masking = mask if self.model.simmim else noise
        if masking is None:
            seed = int(np.random.SeedSequence([self.seed, self.step, idx]).generate_state(1)[0])
            masking = self._draw(cutouts.shape[0], torch.Generator(device=self.device).manual_seed(seed))
        return self._eval_step(cutouts, masking, self._ra_dec(batch))

    def save(self, path: str) -> None:
        """The trainer's state at ``path``: the port's file, or for a
        ``.ckpt.msgpack`` path the JAX package's (optax-form moments).
        Every rank calls it; rank 0 writes, with ZeRO's moments collected
        and, under tensor parallelism, every shard gathered
        (``optim.save_state``)."""
        save_state(path, self.model, self.optimizer, "pretrain", self.step, self.seed,
                   self.losses, self.mask_gen.get_state(), self.mesh)

    def restore(self, path: str) -> bool:
        """Resume from the port's checkpoint or the JAX package's
        (``optim.restore_state``); False without a file."""
        out = restore_state(path, self.model, self.optimizer, self.mask_gen, self.seed,
                            mesh=self.mesh)
        if out is None:
            return False
        _, self.step, losses = out
        self.losses = defaultdict(list, losses)
        return True


def train_network(
    pretrainer,
    train_batches,
    val_batcher,
    total_batch_iters: int,
    verbose_iters: int,
    cp_time_minutes: float,
    model_filename: str,
    fig_dir: Optional[str] = None,
    lp_class_data_file=None,
    lp_regress_data_file=None,
    lp_combine: str = "central",
    max_val_batches: int = 200,
    log_fn: Callable[[str], None] = print,
) -> None:
    """The pretraining loop (JAX ``train_network``) of a
    :class:`MIMPretrainer` or a ``train/jepa.JEPATrainer``: train steps on
    ``train_batches`` streamed through ``data/prefetch.device_prefetch``
    (two batches in flight, as JAX streams them); every
    ``verbose_iters`` a validation pass of at most ``max_val_batches`` and,
    when probe sets are given (h5 paths, or lists of labelled batches), the
    linear probes with ``lp_combine`` pooling, their metrics appended to
    the losses; checkpoints every ``cp_time_minutes`` and at the end. Under
    a process group each rank streams its own rows
    (``pretrainer.batch_shard``), the probes run on every rank over the
    whole probe sets, as JAX's processes run them, only rank 0 logs, and
    the save clock is read at validation steps
    (``parallel/distributed.checkpoint_due``). With ``fig_dir`` the main
    process draws the figures of :func:`draw_figures` at each validation
    after the first."""
    log_fn = distributed.main_only(log_fn)
    losses = pretrainer.losses
    losses_cp: dict = defaultdict(list)
    cp_start = time.time()
    model_name = os.path.basename(model_filename).split(".")[0]

    if pretrainer.cur_iter >= total_batch_iters:
        log_fn("Training already complete for this config; nothing to do.")
        return

    timer = StepTimer(batch_size=pretrainer.batch_size, device=pretrainer.device)
    for batch in device_prefetch(train_batches, size=2, sharding=pretrainer.batch_shard):
        loss = pretrainer.train_batch(batch)
        losses_cp["train_loss"].append(loss)
        timer.step()
        cur_iter = pretrainer.cur_iter
        validated = cur_iter % verbose_iters == 0

        if validated:
            perf = timer.lap()  # close the timing window before eval work
            if val_batcher is not None:
                for i, vbatch in enumerate(val_batcher.take(max_val_batches)):
                    losses_cp["val_loss"].append(pretrainer.eval_batch(vbatch, idx=i))
            if lp_class_data_file or lp_regress_data_file:
                probe = linear_probe(pretrainer.model, lp_class_data_file, lp_regress_data_file,
                                     combine=lp_combine, img_size=pretrainer.model.img_size)
                for k, v in probe.items():
                    losses_cp[k].append(v)
            for k in losses_cp:
                losses[k].append(float(np.mean([float(x) for x in losses_cp[k]])))
            losses["batch_iters"].append(cur_iter)
            losses_cp = defaultdict(list)

            msg = [f"Batch Iterations: {cur_iter}/{total_batch_iters}",
                   f"  train loss {losses['train_loss'][-1]:.4f}",
                   f"  {perf['img_per_sec']:.0f} img/s"]
            if losses.get("val_loss"):
                msg.append(f"  val loss {losses['val_loss'][-1]:.4f}")
            if losses.get("val_lp_acc"):
                msg.append(f"  lp acc {losses['val_lp_acc'][-1]:.3f}")
            if losses.get("val_lp_r2"):
                msg.append(f"  lp r2 {losses['val_lp_r2'][-1]:.3f}")
            log_fn(" |".join(msg))
            tp = getattr(pretrainer, "mesh", None) is not None  # every rank reconstructs
            if fig_dir is not None and len(losses["batch_iters"]) > 1 and (
                    tp or distributed.is_main()):
                draw_figures(pretrainer, val_batcher, fig_dir, model_name)

        due = distributed.checkpoint_due(cp_start, cp_time_minutes, validated)
        if due or cur_iter >= total_batch_iters:
            log_fn("Saving network...")
            pretrainer.losses = losses
            pretrainer.save(model_filename)
            cp_start = time.time()
        if cur_iter >= total_batch_iters:
            break


def draw_figures(pretrainer, val_batcher, fig_dir: str, model_name: str) -> None:
    """JAX ``train_network``'s figures (JAX ``train/pretrain.py:360-389``):
    ``<model_name>_progress.png`` from the losses and, for a ``SkyMIM`` with
    validation data, the reconstruction of the first validation batch at
    the current step, ``<model_name>_<step>iters.png`` (the first band) and,
    with more than one band, ``..._tiled.png`` (all bands). Under tensor
    parallelism every rank calls it (the reconstruction's blocks all-reduce
    over the model group) and the main process alone draws."""
    recon = None
    if val_batcher is not None and isinstance(pretrainer.model, SkyMIM):
        first = next(iter(val_batcher.take(1)))
        gen = torch.Generator(device=pretrainer.device).manual_seed(pretrainer.cur_iter)
        recon = mim_reconstruct(pretrainer.model, first, gen,
                                max_mask_ratio=pretrainer.max_mask_ratio)
    if not distributed.is_main():
        return
    plot_progress(pretrainer.losses, savename=os.path.join(fig_dir, f"{model_name}_progress.png"))
    if recon is None:
        return
    pred, masked, orig = recon
    stem = os.path.join(fig_dir, f"{model_name}_{pretrainer.cur_iter}iters")
    plot_batch(orig, masked, pred, n_samples=5, savename=stem + ".png")
    if orig.shape[-1] > 1:  # all-band mosaic (reference plot_batch_tiled)
        plot_batch_tiled(orig, masked, pred, n_samples=5, savename=stem + "_tiled.png")
