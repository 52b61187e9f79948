"""Host-side SimMIM mask generator (port of
``sky_embeddings_tpu/data/mask_generator.py``, numpy only).

Training draws masks on the device (``ops/masking.simmim_batch_mask``); this
numpy twin serves host-side workflows and tools that expect the reference's
dataloader-mask contract (``utils/dataloaders.py:155-219``): per call, ratio
~ U(0, max_mask_ratio), ``ceil(ratio·n_patches²)`` patches masked
independently per channel (the same count each), upsampled to pixels. The
draws come from ``rng``, a ``np.random.Generator``, in JAX's order, so the
same generator state gives the same masks bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class MaskGenerator:
    def __init__(
        self,
        input_size: int = 192,
        patch_size: int = 4,
        max_mask_ratio: float = 0.9,
        num_mask_chans: int = 1,
        rng: Optional[np.random.Generator] = None,
    ):
        self.input_size = input_size
        self.patch_size = patch_size
        self.max_mask_ratio = max_mask_ratio
        self.num_mask_chans = num_mask_chans
        self.n_patches = input_size // patch_size
        self.token_count = self.n_patches ** 2
        self.rng = rng or np.random.default_rng()

    def __call__(self) -> np.ndarray:
        """(C, H, W) float32 binary mask, 1 = hidden ((H, W) when
        num_mask_chans == 1)."""
        ratio = self.rng.random() * self.max_mask_ratio
        count = int(math.ceil(self.token_count * ratio))
        masks = np.zeros((self.num_mask_chans, self.token_count), dtype=np.float32)
        for c in range(self.num_mask_chans):
            idx = self.rng.permutation(self.token_count)[:count]
            masks[c, idx] = 1.0
        masks = masks.reshape(self.num_mask_chans, self.n_patches, self.n_patches)
        masks = np.repeat(np.repeat(masks, self.patch_size, axis=1), self.patch_size, axis=2)
        if self.num_mask_chans == 1:
            return masks[0]
        return masks
