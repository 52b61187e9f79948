"""NaN-aware masked reconstruction losses (port of
``sky_embeddings_tpu/ops/losses.py``, reference ``mim_vit.py:473-521,614-627``).

Sky-survey cutouts carry NaN pixels for missing bands; the loss scores only
masked-out, valid pixels, with the reference's guarded reductions.
"""

from __future__ import annotations

import torch


def patch_mean_and_var(patches: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-patch mean/variance over the last axis, ignoring NaN entries; an
    all-NaN patch yields 0/0 = NaN, which downstream masking removes."""
    valid = ~torch.isnan(patches)
    count = valid.sum(dim=-1, keepdim=True)
    mean = torch.where(valid, patches, 0.0).sum(dim=-1, keepdim=True) / count
    sq = torch.where(valid, patches - mean, 0.0) ** 2
    return mean, sq.sum(dim=-1, keepdim=True) / count


def normalize_patches(patches: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-patch standardization used by ``norm_pix_loss``."""
    mean, var = patch_mean_and_var(patches)
    return (patches - mean) / torch.sqrt(var + eps)


def masked_recon_loss(target: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                      loss_fn: str = "l1") -> torch.Tensor:
    """Masked, NaN-guarded mean of per-element L1/MSE:
    ``sum(loss * mask) / (sum(mask) + 1e-5)`` over the finite elements.

    ``mask`` may have one fewer trailing dim than ``target`` (it then
    broadcasts). NaN differences are zeroed before the L1/MSE, which leaves
    the value unchanged and keeps their gradient at zero (the gradient of
    ``abs`` at NaN would be NaN times the zero that the mask gives it).
    """
    diff = target - pred
    finite = ~torch.isnan(diff)
    diff = torch.where(finite, diff, 0.0)
    per_elem = diff ** 2 if loss_fn.lower() in ("mse", "l2") else diff.abs()
    if mask.dim() == per_elem.dim() - 1:
        mask = mask[..., None]
    mask = torch.where(finite, mask.expand_as(per_elem), 0.0)
    return (per_elem * mask).sum() / (mask.sum() + 1e-5)
