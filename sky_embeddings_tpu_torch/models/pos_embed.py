"""Frozen sine-cosine positional embeddings (numpy) and grid transfers
(torch), a port of ``sky_embeddings_tpu/models/pos_embed.py`` (reference
``utils/pos_embed.py``).

The tables: half the channels encode the column (fast) coordinate, half the
row coordinate; each half is [sin | cos] of ``pos / 10000^(2i/d)``; prefix
tokens get all-zero rows. Computed in float64 and returned as float32.

Cross-geometry checkpoint transfer of a (1+extra+G², D) table, or a batch
(B, 1+extra+G², D) of them, prefix rows passed through:
:func:`interpolate_grid` resizes the G x G grid bicubically as
``jax.image.resize(..., "bicubic")`` does: Keys' cubic with a = -0.5 on
half-pixel centres, antialiased when it shrinks (the kernel widened by
old / new). ``F.interpolate(mode="bicubic", align_corners=False,
antialias=True)`` computes that (its antialiased path takes a = -0.5); its
default, ``antialias=False``, takes a = -0.75 and matches JAX neither way.
:func:`central_crop_grid` keeps the central tokens.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) with [sin | cos] halves."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    half = embed_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) / half))
    angles = np.outer(positions.reshape(-1).astype(np.float64), freqs)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def sincos_pos_embed_1d(embed_dim: int, length: int, n_prefix_tokens: int = 0) -> np.ndarray:
    """1-D table: (n_prefix_tokens + length, embed_dim), prefix rows zero."""
    table = _sincos_1d(embed_dim, np.arange(length, dtype=np.float64))
    if n_prefix_tokens:
        table = np.concatenate([np.zeros((n_prefix_tokens, embed_dim)), table], axis=0)
    return table.astype(np.float32)


def sincos_pos_embed_2d(embed_dim: int, grid_size: int, n_prefix_tokens: int = 0) -> np.ndarray:
    """(n_prefix_tokens + grid_size**2, embed_dim) table, row-major tokens."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    coords = np.arange(grid_size, dtype=np.float64)
    col = np.tile(coords, grid_size)      # c varies fastest
    row = np.repeat(coords, grid_size)    # r varies slowest
    table = np.concatenate(
        [_sincos_1d(embed_dim // 2, col), _sincos_1d(embed_dim // 2, row)], axis=1
    )
    if n_prefix_tokens:
        table = np.concatenate([np.zeros((n_prefix_tokens, embed_dim)), table], axis=0)
    return table.astype(np.float32)


def _split_grid(pos_embed, n_prefix_tokens: int):
    """(squeeze, prefix, grid, old side) of a (T, D) or (B, T, D) table."""
    pos_embed = torch.as_tensor(pos_embed)
    squeeze = pos_embed.dim() == 2
    if squeeze:
        pos_embed = pos_embed[None]
    prefix, grid = pos_embed[:, :n_prefix_tokens], pos_embed[:, n_prefix_tokens:]
    old = int(round(grid.shape[1] ** 0.5))
    if old * old != grid.shape[1]:
        raise ValueError(f"pos embed grid is not square: {grid.shape[1]} tokens")
    return squeeze, prefix, grid, old


def interpolate_grid(pos_embed, new_grid_size: int, n_prefix_tokens: int) -> torch.Tensor:
    """Bicubically resize the grid part of a (1+extra+G², D) table (or a batch
    of them) to ``new_grid_size``² tokens (the DeiT recipe, reference
    ``pos_embed.py:123-144``), as JAX's does; prefix rows pass through."""
    squeeze, prefix, grid, old = _split_grid(pos_embed, n_prefix_tokens)
    if old != new_grid_size:
        d = grid.shape[-1]
        g = grid.reshape(-1, old, old, d).permute(0, 3, 1, 2)
        g = F.interpolate(g, size=(new_grid_size, new_grid_size), mode="bicubic",
                          align_corners=False, antialias=True)
        grid = g.permute(0, 2, 3, 1).reshape(-1, new_grid_size * new_grid_size, d)
    out = torch.cat([prefix, grid], dim=1)
    return out[0] if squeeze else out


def central_crop_grid(pos_embed, new_grid_size: int, n_prefix_tokens: int) -> torch.Tensor:
    """The central ``new_grid_size``² tokens of the grid part (reference
    ``crop_pos_embed``, ``pos_embed.py:89-115``); prefix rows pass through."""
    squeeze, prefix, grid, old = _split_grid(pos_embed, n_prefix_tokens)
    if old != new_grid_size:
        if new_grid_size > old:
            raise ValueError("cannot crop to a larger grid")
        start = (old - new_grid_size) // 2
        d = grid.shape[-1]
        g = grid.reshape(-1, old, old, d)[:, start:start + new_grid_size, start:start + new_grid_size]
        grid = g.reshape(-1, new_grid_size * new_grid_size, d)
    out = torch.cat([prefix, grid], dim=1)
    return out[0] if squeeze else out
