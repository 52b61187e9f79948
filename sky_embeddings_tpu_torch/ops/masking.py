"""Masking on the device (port of ``sky_embeddings_tpu/ops/masking.py``).

SimMIM: per sample a masking ratio is drawn uniformly from (0,
max_mask_ratio); ``ceil(ratio · G²)`` patches are masked, independently per
channel (the same count in every channel); the patch mask is upsampled to
pixels. MAE: per-sample shuffle-and-keep of a static number of tokens, and
the inverse scatter that puts the decoder's kept tokens back in image order
beside the learned mask token. The draws come from an explicit
``torch.Generator`` on the device, so they are not JAX's bits: tests hand
the same numpy mask or noise to both frameworks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


class MaeMasking(NamedTuple):
    """Result of MAE-style random masking."""

    tokens_kept: torch.Tensor  # (B, len_keep, D)
    mask: torch.Tensor         # (B, L) fp32: 0 kept, 1 removed
    ids_restore: torch.Tensor  # (B, L) the inverse shuffle permutation


def mae_random_masking(tokens: torch.Tensor, mask_ratio: float,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> MaeMasking:
    """Keep ``len_keep = int(L · (1 - mask_ratio))`` tokens of each sample, a
    Python int, those of smallest ``noise`` (B, L); without ``noise`` it is
    drawn uniform from ``generator`` on the tokens' device. Stable sorts, as
    ``jnp.argsort``, so the same noise keeps the same tokens in both
    frameworks."""
    B, L, D = tokens.shape
    len_keep = int(L * (1.0 - mask_ratio))
    if noise is None:
        noise = torch.rand(B, L, generator=generator, device=tokens.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(tokens, 1, ids_keep[:, :, None].expand(B, len_keep, D))
    # token i is masked iff its shuffled rank is >= len_keep
    return MaeMasking(kept, (ids_restore >= len_keep).float(), ids_restore)


def mae_unshuffle(decoder_tokens: torch.Tensor, mask_token: torch.Tensor,
                  ids_restore: torch.Tensor) -> torch.Tensor:
    """(B, len_keep, Dd) kept grid tokens (no prefix tokens) -> (B, L, Dd) in
    image order, the removed positions filled with ``mask_token``."""
    B, len_keep, Dd = decoder_tokens.shape
    L = ids_restore.shape[1]
    fill = mask_token.reshape(1, 1, Dd).to(decoder_tokens.dtype).expand(B, L - len_keep, Dd)
    full = torch.cat([decoder_tokens, fill], dim=1)
    return torch.gather(full, 1, ids_restore[:, :, None].expand(B, L, Dd))
