"""Reconstruction preview, embedding extraction and predictor inference
(port of ``sky_embeddings_tpu/eval/eval_fns.py``, reference ``mae_predict``,
``mae_latent`` and ``ft_predict``).

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
from sky_embeddings_tpu_torch.models.layers import patchify, unpatchify
from sky_embeddings_tpu_torch.ops.losses import denormalize_patches
from sky_embeddings_tpu_torch.ops.masking import simmim_batch_mask, upsample_patch_mask


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


def mim_reconstruct(model, batch: dict, generator: Optional[torch.Generator] = None,
                    max_mask_ratio: Optional[float] = None, mask=None):
    """One-batch reconstruction preview of a ``SkyMIM`` (JAX
    ``mim_reconstruct``, reference ``mae_predict``), on the model's device
    under ``torch.no_grad``: the encoder's blocks take the inference kernels
    (K2, K1; the masked K2 in MAE's packed encoder).

    SimMIM draws its (B, C, H, W) pixel mask from ``generator`` at ratio
    ``max_mask_ratio`` (0.9 when None); MAE drops the tokens of its own
    masking step, its (B, L) noise drawn from ``generator``. ``mask`` gives
    the draw instead (numpy or tensor): SimMIM's pixel mask, or MAE's (B, L)
    token mask (1 removed), whose kept tokens enter the encoder in image
    order. ``generator`` defaults to one seeded 0 on the model's device.

    Returns ``(pred, masked, orig)`` as (B, H, W, C) numpy arrays: the
    prediction (per-patch denormalised under ``norm_pix_loss``, then out of
    the pixel normalisation) composited over the masked region only, and
    the input with its masked pixels set to NaN for display. It computes
    no loss, so under a process group one rank may call it alone (the
    loss's sums are collectives)."""
    dev = model_device(model)
    imgs = batch_images(batch, dev).float()
    ra_dec = batch_ra_dec(batch, dev) if model.ra_dec else None
    B, C = imgs.shape[:2]
    p = model.patch_size
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        if model.simmim:
            if mask is None:
                ratio = max_mask_ratio if max_mask_ratio is not None else 0.9
                mask = simmim_batch_mask(generator, B, C, model.img_size, p, ratio)
            pix_mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
            pred = model.decode(model.encode(imgs, ra_dec=ra_dec, mask=pix_mask)[0])
        else:
            L = model.grid_size ** 2
            if mask is None:
                noise = torch.rand(B, L, generator=generator, device=dev)
            else:
                # the stable sort keeps the zeros (kept tokens) in image order
                noise = torch.as_tensor(mask, dtype=torch.float32, device=dev)
                removed = L - int(L * (1.0 - model.mask_ratio))
                if not bool((noise.sum(1) == removed).all()):
                    raise ValueError(f"an MAE token mask removes {removed} of {L} tokens a sample")
            tokens, tok_mask, ids_restore = model.encode(imgs, ra_dec=ra_dec, apply_mae_masking=True,
                                                         mae_noise=noise)
            pred = model.decode(tokens, ids_restore)
            if model.norm_pix_loss:
                target = patchify((imgs - model.pixel_mean) / model.pixel_std, p)
                pred = denormalize_patches(pred, target)
            pred = unpatchify(pred, p, C)
            g = model.grid_size
            pix_mask = upsample_patch_mask(tok_mask.reshape(B, g, g), p)[:, None].expand_as(imgs)
        if model.simmim and model.norm_pix_loss:
            target = patchify((imgs - model.pixel_mean) / model.pixel_std, p)
            pred = unpatchify(denormalize_patches(patchify(pred, p), target), p, C)
        pred = pred * model.pixel_std + model.pixel_mean

    pred_np = host_array(pred).transpose(0, 2, 3, 1)
    mask_np = host_array(pix_mask).transpose(0, 2, 3, 1)
    orig_np = host_array(imgs).transpose(0, 2, 3, 1)
    pred_np = np.where(mask_np == 0, orig_np, pred_np)
    masked_inputs = orig_np.copy()
    masked_inputs[mask_np == 1] = np.nan
    return pred_np, masked_inputs, orig_np


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
