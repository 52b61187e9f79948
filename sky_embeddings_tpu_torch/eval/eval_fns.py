"""Embedding extraction and predictor inference (port of ``make_encoder``,
``extract_latents`` and ``predictor_infer`` from
``sky_embeddings_tpu/eval/eval_fns.py``, reference ``mae_latent`` and
``ft_predict``).

The model holds its weights, so where the JAX functions take ``(model,
variables)`` these take the model alone; batches are dicts of numpy arrays
or tensors (``cutouts`` (B, C, H, W), ``ra_dec`` (B, 2)[, ``labels``]), as
``H5Batcher`` and ``data/device_cache.DeviceDataset`` serve them, moved to
the model's device.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.data.augment import augment_batch


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def host_array(x, dtype=None) -> np.ndarray:
    """A batch entry (numpy array or tensor on any device) as numpy; bf16
    tensors widen to fp32."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def batch_images(batch: dict, device) -> torch.Tensor:
    """A batch's cutouts as a tensor on ``device`` (in their dtype)."""
    x = batch["cutouts"]
    return x.to(device) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=device)


def make_encoder(model):
    """An ``(imgs, ra_dec) -> tokens`` closure for repeated extraction;
    ``ra_dec`` is read only by an ``ra_dec = True`` model. A MIM model's
    ``encode`` returns ``(tokens, mask, ids_restore)``, a predictor's and an
    I-JEPA model's (``models/jepa.SkyJEPA``: its online encoder over the
    full grid) the tokens alone (JAX ``_encode_fn``)."""

    @torch.inference_mode()
    def encode(imgs, ra_dec=None):
        out = model.encode(imgs, ra_dec=ra_dec) if model.ra_dec else model.encode(imgs)
        return out[0] if isinstance(out, tuple) else out

    return encode


def batch_ra_dec(batch: dict, device) -> torch.Tensor:
    """A batch's (B, 2) RA/Dec degrees as fp32 on ``device``."""
    rd = batch["ra_dec"]
    if torch.is_tensor(rd):
        return rd.to(device, torch.float32)
    return torch.as_tensor(np.asarray(rd, np.float32), device=device)


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
        imgs = batch_images(batch, device)
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
            images.append(host_array(imgs))
    latents = np.concatenate(latents) if to_host else torch.cat(latents)
    if return_images:
        return latents, np.concatenate(images)
    return latents


@torch.inference_mode()
def predictor_infer(model, batches: Iterable[dict], n_batches: Optional[int] = None,
                    use_label_errs: bool = False, return_images: bool = False):
    """Predictor inference with denormalised outputs (JAX ``predictor_infer``,
    reference ``ft_predict``): ``(targets, preds[, images])`` as numpy. The
    outputs are denormalised in the head's dtype, as JAX does (a bf16 head's
    in bf16), then widened to fp32. With ``use_label_errs`` the labels'
    second half (the errors) is dropped from the targets."""
    device = model_device(model)
    targets, preds, images = [], [], []
    for i, batch in enumerate(batches):
        if n_batches is not None and i >= n_batches:
            break
        labels = host_array(batch["labels"])
        if use_label_errs:
            labels = labels[:, : labels.shape[1] // 2]
        imgs = batch_images(batch, device)
        ra_dec = batch_ra_dec(batch, device) if model.ra_dec else None
        out = model.denormalize_labels(model(imgs.float(), ra_dec=ra_dec))
        targets.append(labels)
        preds.append(host_array(out))
        if return_images:
            images.append(host_array(batch["cutouts"]))
    targets, preds = np.concatenate(targets), np.concatenate(preds)
    if return_images:
        return targets, preds, np.concatenate(images)
    return targets, preds
