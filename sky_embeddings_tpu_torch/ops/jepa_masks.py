"""I-JEPA multi-block mask sampling on the device (port of
``sky_embeddings_tpu/ops/jepa_masks.py``).

The published I-JEPA strategy (Assran et al. 2023) in fixed shapes:

* ``num_pred`` rectangular *target* blocks per sample, area scale ~
  U(pred_mask_scale), aspect ratio log-U(aspect_ratio);
* one rectangular *context* block, scale ~ U(enc_mask_scale), unit aspect,
  minus the union of the target blocks; a sample left with fewer than
  ``min_keep`` context tokens keeps its whole context rectangle;
* every set comes back as a fixed-length index set with validity flags.

Selection uses the rank trick: order the tokens by (membership, random
tiebreak), take the first K, flag the ranks beyond the member count invalid
and point them at the first member, so gathers stay in bounds.

Every draw comes from one ``torch.Generator`` on the device that holds the
masks; the JAX package draws the same distribution from split keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class BlockMasks(NamedTuple):
    ctx_idx: torch.Tensor     # (B, K_ctx) int64 token indices
    ctx_valid: torch.Tensor   # (B, K_ctx) bool
    tgt_idx: torch.Tensor     # (B, num_pred, K_tgt) int64
    tgt_valid: torch.Tensor   # (B, num_pred, K_tgt) bool


def mask_budgets(grid: int, pred_mask_scale=(0.15, 0.2), enc_mask_scale=(0.85, 1.0),
                 min_keep: int = 5) -> tuple[int, int]:
    """(K_ctx, K_tgt): the fixed slot counts of the context and target sets
    on a ``grid`` x ``grid`` token grid."""
    L = grid * grid
    k_tgt = max(int(math.ceil(pred_mask_scale[1] * L)), min_keep)
    k_ctx = max(int(math.ceil(enc_mask_scale[1] * L)), min_keep)
    return k_ctx, k_tgt


def _uniform(gen: torch.Generator, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (high - low) + low


def _rect_mask(gen: torch.Generator, batch: int, grid: int, scale_range, ratio_range) -> torch.Tensor:
    """(B, G, G) boolean rectangles with sampled area and aspect."""
    L = grid * grid
    s = _uniform(gen, (batch,), scale_range[0], scale_range[1])
    r = torch.exp(_uniform(gen, (batch,), math.log(ratio_range[0]), math.log(ratio_range[1])))
    h = torch.round(torch.sqrt(s * L * r)).clamp(1, grid)
    w = torch.round(torch.sqrt(s * L / r)).clamp(1, grid)
    y0 = torch.floor(_uniform(gen, (batch,)) * (grid - h + 1))
    x0 = torch.floor(_uniform(gen, (batch,)) * (grid - w + 1))
    coords = torch.arange(grid, device=gen.device, dtype=torch.float32)
    ys, xs = coords[None, :, None], coords[None, None, :]
    y0, x0, h, w = (t[:, None, None] for t in (y0, x0, h, w))
    return (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)


def _select(gen: torch.Generator, member: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) bool membership -> (idx (B, k) int64, valid (B, k) bool):
    members first in random order; surplus slots point at the first member
    and are flagged invalid."""
    B, L = member.shape
    score = member.float() * 2.0 + _uniform(gen, (B, L))
    idx = score.topk(k, dim=-1).indices  # members first, shuffled
    counts = member.sum(-1, keepdim=True)
    valid = torch.arange(k, device=member.device)[None, :] < counts
    return torch.where(valid, idx, idx[:, :1]), valid


def sample_block_masks(
    gen: torch.Generator,
    batch: int,
    grid: int,
    num_pred: int = 4,
    pred_mask_scale=(0.15, 0.2),
    enc_mask_scale=(0.85, 1.0),
    aspect_ratio=(0.75, 1.5),
    min_keep: int = 5,
) -> BlockMasks:
    """Draw I-JEPA context and target index sets for a batch from ``gen``,
    on its device."""
    L = grid * grid
    k_ctx, k_tgt = mask_budgets(grid, pred_mask_scale, enc_mask_scale, min_keep)
    tgt_rects = [_rect_mask(gen, batch, grid, pred_mask_scale, aspect_ratio)
                 for _ in range(num_pred)]
    tgt_union = torch.zeros_like(tgt_rects[0])
    for m in tgt_rects:
        tgt_union |= m
    ctx_rect = _rect_mask(gen, batch, grid, enc_mask_scale, (1.0, 1.0)).reshape(batch, L)
    ctx_member = ctx_rect & ~tgt_union.reshape(batch, L)
    # at least min_keep context tokens: too few left, the raw rectangle
    too_few = ctx_member.sum(-1, keepdim=True) < min_keep
    ctx_member = torch.where(too_few, ctx_rect, ctx_member)
    ctx_idx, ctx_valid = _select(gen, ctx_member, k_ctx)
    tgt = [_select(gen, m.reshape(batch, L), k_tgt) for m in tgt_rects]
    return BlockMasks(ctx_idx, ctx_valid, torch.stack([t[0] for t in tgt], 1),
                      torch.stack([t[1] for t in tgt], 1))
