"""CosmicEmbeds: coordinate-conditioned generative model (port of
``sky_embeddings_tpu/models/cosmos.py``, a prototype, as there).

A conditional ViT that predicts a (B, C, H, W) cutout from its sky position
and band wavelengths, optionally given part of the image:

* conditioning tokens: one sky-location token (the spherical-harmonics SIREN
  over RA/Dec, ``models/location.LocationEncoder``, fp32) and one token per
  band (sin-cos features of log10(λ) at 32 frequencies scaled by 100, through
  the ``wave_mlp`` Linear);
* grid queries: the learned ``mask_token`` plus the frozen 2-D sin-cos
  positions; with a context image its patches are embedded instead
  (``patch_embed``), and with a ``context_mask`` (1 = hidden) a patch stays
  a query only when every pixel of every band is hidden;
* the ``encoder`` (``layers.Encoder`` with JAX's defaults: the attention
  stash on, the MLP stash off, no remat), the final ``norm``, and ``pred``, a
  Linear to p²·C pixels per grid token, unpatchified in fp32 and
  de-normalised;
* ``loss``: the NaN-aware masked L1 / MSE (``ops/losses.masked_recon_loss``)
  of the normalised prediction against the normalised target, over the
  hidden pixels (all of them without a mask). ``forward`` is ``loss``.

Parameters keep the flax tree's names (``patch_embed/proj``,
``loc_encoder/SirenNet_0/...``, ``wave_mlp``, ``mask_token`` at (1, 1, D),
``encoder/block*``, ``norm``, ``pred`` at (D, p²·C)), so
``models/weights.py`` maps a JAX tree by renaming paths. They are fp32;
``dtype`` is the compute dtype (fp32 as JAX's default, bf16 allowed): the
blocks run the port's kernels in it (``models/layers.py``), so training
launches kernels 2, 3, 8 and K1 once per block and step, and ``generate``
under no grad K2 and K1. The model always holds ``patch_embed`` (JAX creates
it at init even when the first trace has no context). The sin-cos grid
table is a non-persistent buffer (a constant in JAX); JAX's ``wave_table``
is a constant that nothing reads and is not kept. No trainer or CLI: JAX has
neither; the model trains through ``loss``, as ``tests/test_cosmos.py``
trains JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sky_embeddings_tpu_torch.models.layers import Encoder, LayerNorm, Linear, PatchEmbed, unpatchify
from sky_embeddings_tpu_torch.models.location import LocationEncoder
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.ops.losses import masked_recon_loss

WAVE_FREQS = 32  # sin and cos of log10(λ) at each: the 64 features wave_mlp reads


class CosmicEmbeds(nn.Module):
    def __init__(self, img_size: int = 64, patch_size: int = 8, in_chans: int = 5,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, pixel_mean: float = 0.0, pixel_std: float = 1.0,
                 loss_fn: str = "l1", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.loss_fn = loss_fn
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_pos_embed_2d(embed_dim, self.grid_size, 0)), persistent=False)
        self.loc_encoder = LocationEncoder(out_dim=embed_dim)
        self.wave_mlp = Linear(2 * WAVE_FREQS, embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.encoder = Encoder(depth, embed_dim, num_heads, mlp_ratio, dtype)
        self.norm = LayerNorm(embed_dim)
        self.pred = Linear(embed_dim, patch_size ** 2 * in_chans)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def plain(self) -> bool:
        """Whether the blocks take the kernels' plain versions."""
        return self.encoder.plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self.encoder.plain = value

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator``: xavier-uniform
        kernels, zero biases, unit LN scales, the SIREN's uniform bounds,
        N(0, 0.02) mask token."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.mask_token.normal_(0.0, 0.02, generator=generator)

    def _wave_tokens(self, wavelengths: torch.Tensor) -> torch.Tensor:
        """(B, C) wavelengths in nm -> (B, C, D) band tokens (features in fp32,
        as JAX computes them)."""
        logw = torch.log10(torch.clamp_min(wavelengths.float(), 1.0))[..., None]
        steps = torch.arange(WAVE_FREQS, dtype=torch.float32, device=wavelengths.device)
        freqs = 1.0 / (10000.0 ** (steps / WAVE_FREQS))
        ang = logw * freqs * 100.0
        return self.wave_mlp(torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1), self.dtype)

    def generate(self, ra_dec: torch.Tensor, wavelengths: torch.Tensor,
                 context: Optional[torch.Tensor] = None,
                 context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A (B, C, H, W) fp32 image from (B, 2) RA/Dec degrees and (B, C)
        wavelengths in nm, given an optional (B, C, H, W) ``context`` image
        and its ``context_mask`` (1 = hidden)."""
        B, L, dt = ra_dec.shape[0], self.grid_size ** 2, self.dtype
        loc = self.loc_encoder(ra_dec.float()).to(dt)[:, None, :]
        waves = self._wave_tokens(wavelengths)
        pos = self.pos_embed.to(dt)
        queries = self.mask_token.to(dt).expand(B, L, self.embed_dim) + pos
        if context is not None:
            x = torch.nan_to_num((context - self.pixel_mean) / self.pixel_std)
            if context_mask is not None:
                x = x * (1.0 - context_mask)
            ctx_tokens = self.patch_embed(x, dt) + pos
            if context_mask is not None:
                g, p = self.grid_size, self.patch_size
                hidden = context_mask.reshape(B, self.in_chans, g, p, g, p).amin(dim=(1, 3, 5))
                queries = torch.where(hidden.reshape(B, L, 1) > 0.5, queries, ctx_tokens)
            else:
                queries = ctx_tokens
        tokens = self.norm(self.encoder(torch.cat([loc, waves, queries], dim=1)), dt)
        patches = self.pred(tokens[:, 1 + waves.shape[1]:], dt)
        img = unpatchify(patches.float(), self.patch_size, self.in_chans)
        return img * self.pixel_std + self.pixel_mean

    def loss(self, target: torch.Tensor, ra_dec: torch.Tensor, wavelengths: torch.Tensor,
             context: Optional[torch.Tensor] = None,
             context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NaN-aware reconstruction loss (0-d fp32) over the hidden part of
        the image (all of it without ``context_mask``)."""
        pred = self.generate(ra_dec, wavelengths, context, context_mask)
        norm_t = (target - self.pixel_mean) / self.pixel_std
        norm_p = (pred - self.pixel_mean) / self.pixel_std
        mask = context_mask if context_mask is not None else torch.ones_like(target)
        return masked_recon_loss(norm_t, norm_p, mask, self.loss_fn)

    def forward(self, target, ra_dec, wavelengths, context=None, context_mask=None) -> torch.Tensor:
        return self.loss(target, ra_dec, wavelengths, context, context_mask)
