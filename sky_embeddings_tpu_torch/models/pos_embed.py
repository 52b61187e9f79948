"""Frozen 2-D sine-cosine positional embeddings (numpy).

Copy of ``sincos_pos_embed_2d`` from ``sky_embeddings_tpu/models/pos_embed.py``
(reference ``utils/pos_embed.py``): half the channels encode the column
(fast) coordinate, half the row coordinate; each half is [sin | cos] of
``pos / 10000^(2i/d)``; prefix tokens get all-zero rows. Computed in float64
and returned as float32.
"""

from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) with [sin | cos] halves."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    half = embed_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) / half))
    angles = np.outer(positions.reshape(-1).astype(np.float64), freqs)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


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
