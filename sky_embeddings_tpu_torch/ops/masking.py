"""SimMIM mask generation on the device (port of ``sky_embeddings_tpu/ops/masking.py``).

Per sample a masking ratio is drawn uniformly from (0, max_mask_ratio);
``ceil(ratio · G²)`` patches are masked, independently per channel (the same
count in every channel); the patch mask is upsampled to pixels. The draws
come from an explicit ``torch.Generator`` on the mask's device, so they are
not JAX's bits: tests hand the same numpy mask to both frameworks.
"""

from __future__ import annotations

import torch


def upsample_patch_mask(mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(..., G, G) patch-level mask -> (..., G·p, G·p) pixel-level mask."""
    *lead, gh, gw = mask.shape
    p = patch_size
    out = mask[..., :, None, :, None].expand(*lead, gh, p, gw, p)
    return out.reshape(*lead, gh * p, gw * p)


def simmim_batch_mask(generator: torch.Generator, batch_size: int, channels: int,
                      img_size: int, patch_size: int, max_mask_ratio: float) -> torch.Tensor:
    """A batch of channel-wise SimMIM pixel masks: (B, C, H, W) float32 in
    {0, 1}, on ``generator``'s device. Rank trick: the ``count`` patches of
    smallest rank in a uniform random permutation are masked."""
    g = img_size // patch_size
    n_tokens = g * g
    dev = generator.device
    ratio = torch.rand(batch_size, generator=generator, device=dev) * max_mask_ratio
    count = torch.ceil(n_tokens * ratio)
    noise = torch.rand(batch_size, channels, n_tokens, generator=generator, device=dev)
    rank = noise.argsort(dim=-1).argsort(dim=-1)
    mask = (rank < count[:, None, None]).float().reshape(batch_size, channels, g, g)
    return upsample_patch_mask(mask, patch_size)
