"""Embedding extraction (port of ``make_encoder`` / ``extract_latents`` from
``sky_embeddings_tpu/eval/eval_fns.py``, reference ``mae_latent``).

The model holds its weights, so where the JAX functions take ``(model,
variables)`` these take the model alone; batches are dicts of numpy arrays
(``cutouts`` (B, C, H, W), ``ra_dec`` (B, 2)) moved to the model's device.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.data.augment import augment_batch


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_encoder(model):
    """An ``(imgs, ra_dec) -> tokens`` closure for repeated extraction;
    ``ra_dec`` is read only by an ``ra_dec = True`` model."""

    @torch.inference_mode()
    def encode(imgs, ra_dec=None):
        return model.encode(imgs, ra_dec=ra_dec if model.ra_dec else None)[0]

    return encode


def batch_ra_dec(batch: dict, device) -> torch.Tensor:
    """A batch's (B, 2) RA/Dec degrees as fp32 on ``device``."""
    return torch.as_tensor(np.asarray(batch["ra_dec"], np.float32), device=device)


def extract_latents(
    model,
    batches: Iterable[dict],
    remove_prefix: bool = True,
    apply_augmentations: bool = False,
    num_augmentations: int = 16,
    generator: Optional[torch.Generator] = None,
    return_images: bool = False,
    batch_transform=None,
    augment_params: Optional[dict] = None,
    to_host: bool = True,
):
    """Batched encoder-only embeddings, as a numpy array (or, with
    ``to_host=False``, a tensor on the model's device, as the on-device probe
    takes them).

    With ``apply_augmentations`` each sample contributes 1 original +
    ``num_augmentations`` augmented copies, interleaved so the copies of one
    sample are adjacent (``(1+A, B, ...) -> (B·(1+A), ...)``, as
    ``eval_fns.py:173-176``), each copy with its sample's RA/Dec;
    ``generator`` (seed 0 when None) draws the augmentations and
    ``augment_params`` overrides ``augment_batch``'s defaults (e.g.
    ``nan_channels=0`` keeps every band). ``remove_prefix`` strips the cls
    (and RA/Dec) tokens, unless the model attention-pools (one pooled token,
    JAX ``eval_fns.py:147-149``). ``batch_transform`` (tokens -> tensor) is
    applied per batch before accumulation.
    """
    if getattr(model, "pooled", False):
        remove_prefix = False
    aug_kw = dict(augment_params or {})
    encode = make_encoder(model)
    device = model_device(model)
    if apply_augmentations and generator is None:
        generator = torch.Generator().manual_seed(0)

    latents, images = [], []
    for batch in batches:
        imgs = torch.as_tensor(np.asarray(batch["cutouts"]), device=device)
        ra_dec = batch_ra_dec(batch, device) if model.ra_dec else None
        if apply_augmentations:
            reps = [imgs] + [augment_batch(generator, imgs, **aug_kw)
                             for _ in range(num_augmentations)]
            imgs = torch.stack(reps, dim=1).reshape(-1, *imgs.shape[1:])
            if ra_dec is not None:
                ra_dec = ra_dec.repeat_interleave(1 + num_augmentations, dim=0)
        tokens = encode(imgs, ra_dec)
        if remove_prefix:
            tokens = tokens[:, model.num_extra_tokens:]
        if batch_transform is not None:
            tokens = batch_transform(tokens)
        latents.append(tokens.float().cpu().numpy() if to_host else tokens)
        if return_images:
            images.append(imgs.cpu().numpy())
    latents = np.concatenate(latents) if to_host else torch.cat(latents)
    if return_images:
        return latents, np.concatenate(images)
    return latents
