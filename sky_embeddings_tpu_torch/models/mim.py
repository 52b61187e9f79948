"""Masked-image-modelling ViT, SimMIM and MAE modes (port of
``sky_embeddings_tpu/models/mim.py``).

``SkyMIM.encode`` mirrors the JAX ``SkyMIM.encode``: NaN pixels (and, in
SimMIM mode, masked pixels) take the trainable ``patch_mask_values``, then
patch embed, the frozen sin-cos pos-embed, in MAE mode with
``apply_mae_masking`` the per-sample token drop (``ops/masking``), the cls
token (and, with ``ra_dec``, the RA/Dec token of
``models/location.LocationEncoder`` after it), the encoder and the final
LayerNorm. ``loss`` is the NaN-guarded masked L1/MSE on normalized
(optionally per-patch normalized) targets, and ``forward`` returns ``(loss,
pred, mask)`` as the JAX ``__call__`` does.

- SimMIM (``simmim=True``): ``forward(imgs, mask, ra_dec=...)`` with the
  (B, C, H, W) pixel mask; ``decode`` is the linear decoder (one Dense per
  token predicting its patch, upsample = ``patch_size``). ``mask_token`` is
  held so that weights round-trip with the JAX tree (SimMIM does not use
  it). With ``attn_pool`` the encoder's tokens are pooled by
  ``layers.AttentionPoolLatent`` (``pool``) into one token before the final
  LayerNorm, and the decoder predicts the whole image from it (upsample =
  ``img_size``: one Dense to img_size² x C). MAE ignores ``attn_pool``, as
  JAX does.
- MAE (``simmim=False``): ``forward(imgs, ra_dec=..., mae_noise=...)`` drops
  ``1 - mask_ratio`` of the tokens by the (B, L) noise (the trainer draws
  it from its generator) and returns the (B, L) token mask;
  ``decode`` embeds the kept tokens to the decoder width, scatters them back
  beside the learned ``mask_token``, adds the frozen decoder pos-embed and
  runs the transformer decoder (``stash_decoder`` picks its attention
  backward), its LayerNorm and the patch prediction; the loss is taken in
  patch space on the removed tokens. With ``pack_tokens > 1`` the masked
  encoder packs that many samples into one sequence when the batch divides
  and the packed sequence stays within 128 tokens, its attention masked to
  each sample (``seg_len``): the same function, on longer sequences.
  Serving (``encode`` without ``apply_mae_masking``) neither masks nor
  packs.

``remat`` checkpoints each encoder block (``models/layers.Encoder``), not
the decoder's, as in JAX. ``plain = True`` sends every block, the
decoder's too, through the kernels' plain versions.

``scan_blocks = True`` (the JAX scan layout, default at ``huge`` in the
predictor) builds the loop layout: the port's blocks run one after another
either way, and weights in the stacked ``encoder.blocks.block.*`` form load
into it (``models/layers.Encoder``, ``models/weights.params_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sky_embeddings_tpu_torch.models.layers import (
    AttentionPoolLatent,
    Encoder,
    LayerNorm,
    Linear,
    PatchEmbed,
    patchify,
    unpatchify,
)
from sky_embeddings_tpu_torch.models.location import LocationEncoder
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.ops.losses import masked_recon_loss, normalize_patches
from sky_embeddings_tpu_torch.ops.masking import mae_random_masking, mae_unshuffle
from sky_embeddings_tpu_torch.utils.device import resolve_device


class SkyMIM(nn.Module):
    """Masked autoencoder / SimMIM ViT over multi-band sky cutouts."""

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
        norm_pix_loss: bool = False,
        loss_fn: str = "l1",
        dtype: torch.dtype = torch.float32,
        stash: bool = True,
        stash_mlp: bool = False,
        ra_dec: bool = False,
        remat: bool = False,
        simmim: bool = True,
        decoder_embed_dim: int = 512,
        decoder_depth: int = 8,
        decoder_num_heads: int = 16,
        mask_ratio: float = 0.75,
        stash_decoder: bool = True,
        pack_tokens: int = 1,
        attn_pool: bool = False,
    ):
        super().__init__()
        self.simmim = simmim
        self.attn_pool = attn_pool
        self.mask_ratio = mask_ratio
        self.pack_tokens = pack_tokens
        self.ra_dec = ra_dec
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.norm_pix_loss = norm_pix_loss
        self.loss_fn = loss_fn
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_pos_embed_2d(embed_dim, self.grid_size, self.num_extra_tokens)),
            persistent=False,
        )
        if ra_dec:
            self.ra_dec_embed = LocationEncoder(out_dim=embed_dim)
        self.encoder = Encoder(depth, embed_dim, num_heads, mlp_ratio, dtype, stash, stash_mlp,
                               remat)
        self.norm = LayerNorm(embed_dim)
        self.patch_mask_values = nn.Parameter(torch.zeros(in_chans, patch_size, patch_size))
        if simmim:
            # SimMIM linear decoder: one Dense per token predicting its
            # dec_upsample^2 x C tile (its patch, or the whole image from
            # the pooled token)
            if attn_pool:
                self.pool = AttentionPoolLatent(embed_dim, num_heads, mlp_ratio, dtype)
            self.dec_upsample = img_size if attn_pool else patch_size
            self.decoder_pred = Linear(embed_dim, self.dec_upsample ** 2 * in_chans)
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1))
        else:
            # MAE transformer decoder over the restored sequence (JAX
            # mim.py:158-176: no remat, no MLP stash)
            self.decoder_embed = Linear(embed_dim, decoder_embed_dim)
            self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
            self.register_buffer(
                "decoder_pos_embed",
                torch.from_numpy(sincos_pos_embed_2d(decoder_embed_dim, self.grid_size,
                                                     self.num_extra_tokens)),
                persistent=False,
            )
            self.decoder = Encoder(decoder_depth, decoder_embed_dim, decoder_num_heads, mlp_ratio,
                                   dtype, stash_decoder)
            self.decoder_norm = LayerNorm(decoder_embed_dim)
            self.decoder_pred = Linear(decoder_embed_dim, patch_size ** 2 * in_chans)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_extra_tokens(self) -> int:
        return 2 if self.ra_dec else 1

    @property
    def pooled(self) -> bool:
        """Whether ``encode`` collapses the sequence to one pooled token."""
        return self.simmim and self.attn_pool

    @property
    def plain(self) -> bool:
        """Whether the blocks take the kernels' plain versions (the reference
        path a check on the card holds the kernel path against)."""
        return self.encoder.plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self.encoder.plain = value
        if not self.simmim:
            self.decoder.plain = value

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

    def encode(self, imgs: torch.Tensor, ra_dec: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, apply_mae_masking: bool = False,
               mae_noise: Optional[torch.Tensor] = None):
        """(B, C, H, W) images (and (B, 2) RA/Dec degrees on an ``ra_dec``
        model) -> ``(tokens, mae_mask, ids_restore)``, tokens (B, extra + n,
        D) in ``dtype`` ordered [cls, ra_dec, patches] (the JAX return
        layout), or the one pooled token (B, 1, D) with ``attn_pool``.
        ``mask`` is SimMIM's pixel mask. In MAE mode with
        ``apply_mae_masking`` only the kept n of L patches stay, chosen by
        ``mae_noise`` (B, L) (torch's default generator draws it when None),
        and the (B, L) token mask and restore indices come back; otherwise
        both are None."""
        B = imgs.shape[0]
        x = (imgs - self.pixel_mean) / self.pixel_std
        fill = self._fill_values(B).to(x.dtype)
        x = torch.where(torch.isnan(x), fill, x)
        if self.simmim and mask is not None:
            x = x * (1.0 - mask) + fill * mask
        tokens = self.patch_embed(x, self.dtype)
        tokens = tokens + self.pos_embed[self.num_extra_tokens:].to(tokens.dtype)
        mae_mask = ids_restore = None
        masked = not self.simmim and apply_mae_masking
        if masked:
            tokens, mae_mask, ids_restore = mae_random_masking(tokens, self.mask_ratio, mae_noise)
        prefix = [(self.cls_token + self.pos_embed[:1]).to(tokens.dtype).expand(B, 1, self.embed_dim)]
        if self.ra_dec:
            if ra_dec is None:
                raise ValueError("model was built with ra_dec=True but got ra_dec=None")
            loc = self.ra_dec_embed(ra_dec.float()).to(tokens.dtype)
            prefix.append((loc + self.pos_embed[1].to(tokens.dtype))[:, None, :])
        tokens = torch.cat(prefix + [tokens], dim=1)
        pack, n = self.pack_tokens, tokens.shape[1]
        if masked and pack > 1 and B % pack == 0 and pack * n <= 128:
            # (B, n, D) -> (B / pack, pack * n, D) is a free row-major
            # reshape; attention is masked to each sample's n tokens, so the
            # packed encoder computes the unpacked one's function
            tokens = self.encoder(tokens.reshape(B // pack, pack * n, self.embed_dim), seg_len=n)
            tokens = tokens.reshape(B, n, self.embed_dim)
        else:
            tokens = self.encoder(tokens)
        if self.pooled:
            tokens = self.pool(tokens)[:, None, :]
        return self.norm(tokens, self.dtype), mae_mask, ids_restore

    def decode(self, tokens: torch.Tensor, ids_restore: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reconstruct from encoder tokens (JAX ``decode``). SimMIM: (B, 1 + L,
        D) -> (B, C, H, W), each grid token predicting its own
        patch_size² x C tile; with ``attn_pool`` the one pooled token
        (B, 1, D) predicts the whole image. MAE: the kept tokens (B, extra + n, D) and
        ``ids_restore`` -> (B, L, p²·C) patch predictions."""
        if not self.simmim:
            n_extra = self.num_extra_tokens
            x = self.decoder_embed(tokens, self.dtype)
            grid = mae_unshuffle(x[:, n_extra:], self.mask_token, ids_restore)
            x = torch.cat([x[:, :n_extra], grid], dim=1)
            x = self.decoder(x + self.decoder_pos_embed.to(x.dtype))
            x = self.decoder_pred(self.decoder_norm(x, self.dtype), self.dtype)
            return x[:, n_extra:]  # drop the cls (and RA/Dec) predictions
        grid = tokens if self.pooled else tokens[:, self.num_extra_tokens:]
        B, L, _ = grid.shape
        h = w = int(round(L ** 0.5))
        S = self.dec_upsample
        pred = self.decoder_pred(grid, self.dtype)
        pred = pred.reshape(B, h, w, self.in_chans, S, S).permute(0, 3, 1, 4, 2, 5)
        return pred.reshape(B, self.in_chans, h * S, w * S)

    def loss(self, imgs: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked NaN-guarded reconstruction loss on normalized targets; in
        MAE mode on patches, ``mask`` the (B, L) token mask."""
        target = (imgs - self.pixel_mean) / self.pixel_std
        if not self.simmim:
            target = patchify(target, self.patch_size)
            if self.norm_pix_loss:
                target = normalize_patches(target)
            return masked_recon_loss(target, pred.float(), mask, self.loss_fn)
        eff_mask = (~torch.isnan(target)).to(target.dtype) * mask
        if self.norm_pix_loss:
            patches = patchify(target, self.patch_size)
            target = unpatchify(normalize_patches(patches), self.patch_size, self.in_chans)
        return masked_recon_loss(target, pred.float(), eff_mask, self.loss_fn)

    def forward(self, imgs: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ra_dec: Optional[torch.Tensor] = None, mae_noise: Optional[torch.Tensor] = None):
        """Full forward: ``(loss, pred, mask)``; ``ra_dec`` is the (B, 2)
        RA/Dec degrees that an ``ra_dec`` model reads. SimMIM: ``mask`` is the
        (B, C, H, W) pixel mask (zeros when None). MAE: ``mask`` is ignored;
        the tokens are dropped by ``mae_noise`` (B, L) and the (B, L) token
        mask comes back."""
        if not self.simmim:
            tokens, mae_mask, ids_restore = self.encode(
                imgs, ra_dec=ra_dec, apply_mae_masking=True, mae_noise=mae_noise)
            pred = self.decode(tokens, ids_restore)
            return self.loss(imgs, pred, mae_mask), pred, mae_mask
        tokens, _, _ = self.encode(imgs, ra_dec=ra_dec, mask=mask)
        pred = self.decode(tokens)
        if mask is None:
            mask = torch.zeros_like(imgs)
        return self.loss(imgs, pred, mask), pred, mask


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
    remat: bool = False,
    mesh=None,
) -> SkyMIM:
    """Construct a :class:`SkyMIM` from an INI config (JAX ``build_mim_model``)
    with weights drawn from ``generator`` (seed 0 when None), on ``device``;
    ``remat`` checkpoints each encoder block. With a ``mesh`` of model axis
    > 1 (``parallel/mesh``) the whole model is drawn as one process draws
    it and then cut to this rank's shard (``parallel/sharding.shard_module``:
    the encoder's and the MAE decoder's blocks by the same rules; a block
    the model axis cannot split, such as ``maesimple``'s one-head decoder,
    stays whole)."""
    dev = resolve_device(device)
    arch = config["ARCHITECTURE"]
    training = config["TRAINING"]
    model_type = arch.str("model_type")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}; options: {sorted(MODEL_TYPES)}")
    size_key, simmim = MODEL_TYPES[model_type]
    extra: dict = dict(_SIZES[size_key])
    if model_type == "maesimple":
        extra.update(decoder_depth=1, decoder_num_heads=1)
    mask_ratio = 0.75
    if not simmim and "mask_ratio" in training:
        mask_ratio = training.float("mask_ratio")
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
        norm_pix_loss=training.bool("norm_pix_loss", False),
        loss_fn=training.str("loss_fn", "L1").lower(),
        dtype=dtype,
        # the JAX defaults: attention stash except at ViT-H, MLP stash at ViT-L
        stash=arch.bool("stash", size_key != "huge"),
        stash_mlp=arch.bool("stash_mlp", size_key == "large"),
        ra_dec=arch.bool("ra_dec", False),
        remat=remat,
        simmim=simmim,
        mask_ratio=mask_ratio,
        # MAE: the decoder's attention stash on unless the config turns it
        # off; four samples packed per encoder sequence by default
        stash_decoder=arch.bool("stash_decoder", True),
        pack_tokens=arch.int("pack_tokens", 1 if simmim else 4),
        attn_pool=arch.bool("attn_pool", False),
        **extra,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    if mesh is not None and mesh.tp > 1:
        from sky_embeddings_tpu_torch.parallel.sharding import shard_module

        shard_module(model, mesh)
    return model.to(dev).eval()
