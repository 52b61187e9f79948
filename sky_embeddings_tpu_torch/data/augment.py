"""Batch test-time augmentations (port of ``sky_embeddings_tpu/data/augment.py``).

Same distributions and composition order as the JAX pipeline (reference
``dataloaders.py:14-106``): H/V flips, random resized crop, multiplicative
brightness, additive gaussian noise, whole-band NaN dropout. Each transform is
split into a ``draw_*`` step, which takes the random values from a
``torch.Generator``, and an ``apply_*`` step, which takes them as tensors, so
that a test can feed ``apply_*`` the values ``jax.random`` draws.

Draws happen on the generator's device and move to the batch's device.
Images are (B, C, H, W).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


# -- flips -------------------------------------------------------------------

def draw_flips(gen: torch.Generator, batch: int):
    """Per-sample (do_h, do_v) booleans, p = 0.5 each."""
    return _uniform(gen, (batch,)) < 0.5, _uniform(gen, (batch,)) < 0.5


def apply_flips(imgs: torch.Tensor, do_h: torch.Tensor, do_v: torch.Tensor) -> torch.Tensor:
    imgs = torch.where(do_h.to(imgs.device)[:, None, None, None], imgs.flip(-1), imgs)
    return torch.where(do_v.to(imgs.device)[:, None, None, None], imgs.flip(-2), imgs)


# -- random resized crop -------------------------------------------------------

def draw_resized_crop(gen: torch.Generator, batch: int, scale=(0.8, 1.0), ratio=(0.9, 1.1)):
    """Per-sample (area fraction, log aspect ratio, y and x origin fractions)."""
    area = _uniform(gen, (batch,), scale[0], scale[1])
    log_r = _uniform(gen, (batch,), math.log(ratio[0]), math.log(ratio[1]))
    return area, log_r, _uniform(gen, (batch,)), _uniform(gen, (batch,))


def _axis_linear_sample(imgs: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable linear interpolation along axis -2 (rows) or -1 (cols);
    ``coords`` (B, S) are fractional source coordinates."""
    B, C, H, W = imgs.shape
    size = imgs.shape[axis]
    lo = torch.clamp(torch.floor(coords), 0, size - 1)
    hi = torch.clamp(lo + 1, 0, size - 1)
    w_hi = torch.clamp(coords - lo, 0.0, 1.0)
    lo, hi = lo.long(), hi.long()
    S = coords.shape[1]
    if axis == -1:
        take = lambda idx: torch.gather(imgs, -1, idx[:, None, None, :].expand(B, C, H, S))
        w = w_hi[:, None, None, :]
    else:
        take = lambda idx: torch.gather(imgs, -2, idx[:, None, :, None].expand(B, C, S, W))
        w = w_hi[:, None, :, None]
    return take(lo) * (1.0 - w) + take(hi) * w


def apply_resized_crop(imgs, area, log_r, y_u, x_u, out_size: Optional[int] = None):
    """Crop of area ``area·H·W`` and aspect ``exp(log_r)`` at origin fractions
    (y_u, x_u), clamped to the image, bilinearly resized to ``out_size``."""
    B, C, H, W = imgs.shape
    S = out_size or H
    area, log_r, y_u, x_u = (t.to(imgs.device, torch.float32) for t in (area, log_r, y_u, x_u))
    area = area * (H * W)
    r = torch.exp(log_r)
    crop_w = torch.clamp(torch.sqrt(area * r), max=W)
    crop_h = torch.clamp(torch.sqrt(area / r), max=H)
    y0 = y_u * (H - crop_h)
    x0 = x_u * (W - crop_w)
    # torch-style coordinate mapping: src = (dst + 0.5) * (crop/S) - 0.5 + origin
    grid = (torch.arange(S, dtype=torch.float32, device=imgs.device) + 0.5) / S
    ys = y0[:, None] + grid[None, :] * crop_h[:, None] - 0.5
    xs = x0[:, None] + grid[None, :] * crop_w[:, None] - 0.5
    imgs = _axis_linear_sample(imgs, ys, axis=-2)
    return _axis_linear_sample(imgs, xs, axis=-1)


# -- brightness, noise, band dropout -------------------------------------------

def draw_brightness(gen: torch.Generator, batch: int, brightness: float = 0.8):
    return _uniform(gen, (batch,), brightness, 1.0 / brightness)


def apply_brightness(imgs: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return imgs * factor.to(imgs.device)[:, None, None, None]


def draw_noise(gen: torch.Generator, shape, noise: float = 0.01):
    """Per-sample sigma ~ U(0, noise) and standard-normal eps of ``shape``."""
    sigma = _uniform(gen, (shape[0],), 0.0, noise)
    return sigma, torch.randn(shape, generator=gen, device=gen.device)


def apply_noise(imgs: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return imgs + eps.to(imgs.device, imgs.dtype) * sigma.to(imgs.device)[:, None, None, None]


def draw_channel_nan(gen: torch.Generator, batch: int, channels: int, max_channels: int = 1):
    """Per-sample drop count n ~ uniform{0..max_channels} and (B, C) uniforms."""
    n_drop = torch.randint(0, max_channels + 1, (batch,), generator=gen, device=gen.device)
    return n_drop, _uniform(gen, (batch, channels))


def apply_channel_nan(imgs: torch.Tensor, n_drop: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """NaN the ``n_drop`` bands with the smallest ``noise`` (rank trick: n
    distinct channels chosen uniformly, static shapes)."""
    rank = torch.argsort(torch.argsort(noise.to(imgs.device), dim=-1, stable=True), dim=-1, stable=True)
    drop = rank < n_drop.to(imgs.device)[:, None]
    return torch.where(drop[:, :, None, None], torch.full_like(imgs, float("nan")), imgs)


def augment_batch(
    gen: torch.Generator,
    imgs: torch.Tensor,
    flip: bool = True,
    crop: bool = True,
    brightness: Optional[float] = 0.8,
    noise: Optional[float] = 0.01,
    nan_channels: Optional[int] = 2,
    rows: Optional[tuple[slice, int]] = None,
) -> torch.Tensor:
    """Full pipeline in the reference's composition order. ``rows`` (a
    slice and the global batch size, ``parallel/distributed.batch_rows``):
    each draw is made for the global batch and these rows of it kept, so
    that every rank's images take the draws one process would give them."""
    B, C = imgs.shape[:2]
    n = B if rows is None else rows[1]

    def mine(*draws):
        return draws if rows is None else tuple(d[rows[0]] for d in draws)

    if flip:
        imgs = apply_flips(imgs, *mine(*draw_flips(gen, n)))
    if crop:
        imgs = apply_resized_crop(imgs, *mine(*draw_resized_crop(gen, n)))
    if brightness is not None:
        imgs = apply_brightness(imgs, *mine(draw_brightness(gen, n, brightness)))
    if noise is not None:
        imgs = apply_noise(imgs, *mine(*draw_noise(gen, (n,) + tuple(imgs.shape[1:]), noise)))
    if nan_channels is not None and nan_channels > 0:
        imgs = apply_channel_nan(imgs, *mine(*draw_channel_nan(gen, n, C, nan_channels)))
    return imgs
