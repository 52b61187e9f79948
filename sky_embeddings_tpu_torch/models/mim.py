"""SimMIM ViT, encoder forward (port of ``sky_embeddings_tpu/models/mim.py``).

``SkyMIM.encode`` mirrors the JAX ``SkyMIM.encode`` for ``simmim=True``:
NaN pixels (and optionally masked pixels) take the trainable
``patch_mask_values``, then patch embed, the frozen sin-cos pos-embed, the
cls token, the encoder and the final LayerNorm. The decoder parameters
(``decoder_pred``, ``mask_token``) are held so that weights round-trip with
the JAX tree; decoding, the loss and training come with the training slice.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP): the MAE model
types, ``ra_dec = True`` and ``attn_pool = True``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sky_embeddings_tpu_torch.models.layers import Encoder, LayerNorm, Linear, PatchEmbed
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.utils.device import resolve_device


class SkyMIM(nn.Module):
    """SimMIM ViT over multi-band sky cutouts (encoder forward)."""

    def __init__(
        self,
        img_size: int = 64,
        patch_size: int = 8,
        in_chans: int = 5,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        pixel_mean: float = 0.0,
        pixel_std: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_pos_embed_2d(embed_dim, self.grid_size, self.num_extra_tokens)),
            persistent=False,
        )
        self.encoder = Encoder(depth, embed_dim, num_heads, mlp_ratio, dtype)
        self.norm = LayerNorm(embed_dim)
        self.patch_mask_values = nn.Parameter(torch.zeros(in_chans, patch_size, patch_size))
        # SimMIM linear decoder: one Dense per token predicting its patch
        self.decoder_pred = Linear(embed_dim, patch_size ** 2 * in_chans)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, 1))

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_extra_tokens(self) -> int:
        return 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator``: xavier-uniform
        kernels, zero biases, unit LN scales, N(0, 0.02) tokens, zero fill."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.mask_token.normal_(0.0, 0.02, generator=generator)
            self.patch_mask_values.zero_()

    def _fill_values(self, batch: int) -> torch.Tensor:
        """Tile the (C, p, p) fill values over the full image."""
        g = self.grid_size
        tiled = self.patch_mask_values.tile(1, g, g)
        return tiled.expand(batch, self.in_chans, self.img_size, self.img_size)

    def encode(self, imgs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """(B, C, H, W) images -> ``(tokens, None, None)``, tokens (B, 1 + L, D)
        in ``dtype`` with the cls token first (the JAX return layout; the MAE
        mask and restore indices are None in SimMIM mode)."""
        B = imgs.shape[0]
        x = (imgs - self.pixel_mean) / self.pixel_std
        fill = self._fill_values(B).to(x.dtype)
        x = torch.where(torch.isnan(x), fill, x)
        if mask is not None:
            x = x * (1.0 - mask) + fill * mask
        tokens = self.patch_embed(x, self.dtype)
        tokens = tokens + self.pos_embed[1:].to(tokens.dtype)
        cls = (self.cls_token + self.pos_embed[:1]).to(tokens.dtype)
        tokens = torch.cat([cls.expand(B, 1, self.embed_dim), tokens], dim=1)
        tokens = self.encoder(tokens)
        return self.norm(tokens, self.dtype), None, None


_SIZES = {
    "base": dict(depth=12, num_heads=12),
    "large": dict(depth=24, num_heads=16),
    "huge": dict(depth=32, num_heads=16),
}

# model_type -> (size key, simmim flag), as in the JAX zoo
MODEL_TYPES = {
    "base": ("base", False),
    "large": ("large", False),
    "huge": ("huge", False),
    "simmim": ("base", True),
    "mimlarge": ("large", True),
    "mimhuge": ("huge", True),
    "maesimple": ("base", False),
}


def build_mim_model(
    config,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> SkyMIM:
    """Construct a :class:`SkyMIM` from an INI config (JAX ``build_mim_model``)
    with weights drawn from ``generator`` (seed 0 when None), on ``device``."""
    dev = resolve_device(device)
    arch = config["ARCHITECTURE"]
    model_type = arch.str("model_type")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}; options: {sorted(MODEL_TYPES)}")
    size_key, simmim = MODEL_TYPES[model_type]
    if not simmim:
        raise NotImplementedError(
            f"model_type={model_type!r} is MAE mode (ROADMAP: MAE mode with the seg_len mask)"
        )
    if arch.bool("ra_dec", False):
        raise NotImplementedError("ra_dec = True is not ported yet (ROADMAP: ra_dec/attn_pool)")
    if arch.bool("attn_pool", False):
        raise NotImplementedError("attn_pool = True is not ported yet (ROADMAP: ra_dec/attn_pool)")
    extra = dict(_SIZES[size_key])
    embed_dim = arch.int("embed_dim")
    if embed_dim % extra["num_heads"]:
        raise ValueError(
            f"embed_dim={embed_dim} must be divisible by num_heads="
            f"{extra['num_heads']} for model_type={model_type!r}"
        )
    if arch.int("img_size") % arch.int("patch_size"):
        raise ValueError(
            f"img_size={arch.int('img_size')} must be divisible by "
            f"patch_size={arch.int('patch_size')}"
        )
    model = SkyMIM(
        img_size=arch.int("img_size"),
        patch_size=arch.int("patch_size"),
        in_chans=arch.int("num_channels"),
        embed_dim=embed_dim,
        pixel_mean=arch.float("pixel_mean", 0.0),
        pixel_std=arch.float("pixel_std", 1.0),
        dtype=dtype,
        **extra,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(dev).eval()
