"""Downstream predictor ViT, classification and regression heads (port of
``sky_embeddings_tpu/models/predictor.py``, reference ``utils/vit.py:258-393``).

The token pipeline is SkyMIM's encoder: NaN pixels take the trainable
``patch_mask_values``, then patch embed, the frozen sin-cos pos-embed (zeros
with ``zero_pos_embed``, PARITY #3), with ``ra_dec`` the RA/Dec token of
``models/location.LocationEncoder`` after the cls token, and the encoder's
blocks (``models/layers.Encoder``, so its kernels). Then a pooling head:

- ``map``: ``norm`` (LayerNorm) on every token, then
  ``layers.AttentionPoolLatent`` with 2 heads (head dim 384 at D = 768);
- ``avg``: the mean over the grid tokens, then ``fc_norm`` (timm's split,
  JAX ``predictor.py:154-171``);
- ``token``: ``norm``, then the cls token;

then head dropout (training only, drawn from a generator) and the ``head``
Linear over the (optionally normalised) labels, truncated-normal init with
std 2e-5. ``forward`` accepts ``mask`` and ignores it (PARITY #2).

Parameters keep the JAX tree's names (``models/weights.py``). JAX's
predictor leaves its encoder at the ``Encoder`` defaults (attention stash
on, MLP stash off); the port picks the stashes as pretraining does (the
attention stash except at ViT-H, the MLP stash at ViT-L, kernel 9 at ViT-H's
width), which compute the same function. ``scan_blocks`` (JAX's default at
``huge``) is a naming layer: the loop layout is built and stacked weights
load into it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sky_embeddings_tpu_torch.models.layers import (
    AttentionPoolLatent,
    Encoder,
    LayerNorm,
    Linear,
    PatchEmbed,
)
from sky_embeddings_tpu_torch.models.location import LocationEncoder
from sky_embeddings_tpu_torch.models.mim import MODEL_TYPES, _SIZES
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.utils.device import resolve_device

HEAD_STD = 2e-5


def truncated_normal_(t: torch.Tensor, stddev: float, generator: torch.Generator) -> None:
    """flax ``truncated_normal(stddev)``: N(0, 1) cut at ±2, scaled by
    stddev / 0.87962566 (the std of the cut distribution), so the result
    has std ``stddev``."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(stddev / 0.87962566103423978)


class SkyViT(nn.Module):
    """ViT encoder + pooling + linear prediction head."""

    def __init__(
        self,
        img_size: int = 64,
        patch_size: int = 8,
        in_chans: int = 5,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_labels: int = 1,
        global_pool: str = "map",
        label_means: Sequence[float] = (0.0,),
        label_stds: Sequence[float] = (1.0,),
        pixel_mean: float = 0.0,
        pixel_std: float = 1.0,
        dropout: float = 0.0,
        ra_dec: bool = False,
        zero_pos_embed: bool = False,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        stash: bool = True,
        stash_mlp: bool = False,
    ):
        super().__init__()
        if global_pool not in ("map", "avg", "token"):
            raise ValueError(f"global_pool must be map, avg or token, got {global_pool!r}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_labels = num_labels
        self.global_pool = global_pool
        self.label_means = tuple(float(v) for v in label_means)
        self.label_stds = tuple(float(v) for v in label_stds)
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.dropout = dropout
        self.ra_dec = ra_dec
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        n_tok = self.grid_size ** 2 + self.num_extra_tokens
        pos = (torch.zeros(n_tok, embed_dim) if zero_pos_embed else
               torch.from_numpy(sincos_pos_embed_2d(embed_dim, self.grid_size, self.num_extra_tokens)))
        self.register_buffer("pos_embed", pos, persistent=False)
        if ra_dec:
            self.ra_dec_embed = LocationEncoder(out_dim=embed_dim)
        self.encoder = Encoder(depth, embed_dim, num_heads, mlp_ratio, dtype, stash, stash_mlp, remat)
        if global_pool == "avg":
            self.fc_norm = LayerNorm(embed_dim)
        else:
            self.norm = LayerNorm(embed_dim)
        self.patch_mask_values = nn.Parameter(torch.zeros(in_chans, patch_size, patch_size))
        if global_pool == "map":
            # num_heads=2 matches the reference override (vit.py:303-308)
            self.pool = AttentionPoolLatent(embed_dim, 2, mlp_ratio, dtype)
        self.head = Linear(embed_dim, num_labels)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_extra_tokens(self) -> int:
        return 2 if self.ra_dec else 1

    @property
    def plain(self) -> bool:
        """Whether the blocks take the kernels' plain versions (the reference
        path a check on the card holds the kernel path against)."""
        return self.encoder.plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self.encoder.plain = value

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator``: xavier-uniform
        kernels, zero biases, unit LN scales, N(0, 0.02) cls token, zero
        fill, the pool latent N(0, D^-1/2), the head truncated-normal std
        2e-5."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.patch_mask_values.zero_()
            truncated_normal_(self.head.kernel, HEAD_STD, generator)

    # ------------------------------------------------------------------
    def normalize_labels(self, labels: torch.Tensor) -> torch.Tensor:
        means = torch.tensor(self.label_means, dtype=labels.dtype, device=labels.device)
        stds = torch.tensor(self.label_stds, dtype=labels.dtype, device=labels.device)
        return (labels - means) / stds

    def denormalize_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """In ``labels``' dtype, as JAX computes it (a bf16 head's outputs
        are denormalised in bf16)."""
        means = torch.tensor(self.label_means, dtype=labels.dtype, device=labels.device)
        stds = torch.tensor(self.label_stds, dtype=labels.dtype, device=labels.device)
        return labels * stds + means

    # ------------------------------------------------------------------
    def backbone(self, imgs: torch.Tensor, ra_dec: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The token pipeline and the encoder's blocks: (B, C, H, W) images
        (and (B, 2) RA/Dec degrees on an ``ra_dec`` model) -> (B, extra + L,
        D) in ``dtype``, ordered [cls, ra_dec, patches], before the final
        norm. The ``lp`` regime runs this part with autograd off."""
        B = imgs.shape[0]
        x = (imgs - self.pixel_mean) / self.pixel_std
        g = self.grid_size
        fill = self.patch_mask_values.tile(1, g, g).expand(B, self.in_chans, self.img_size,
                                                           self.img_size).to(x.dtype)
        x = torch.where(torch.isnan(x), fill, x)
        tokens = self.patch_embed(x, self.dtype)
        tokens = tokens + self.pos_embed[self.num_extra_tokens:].to(tokens.dtype)
        prefix = [(self.cls_token + self.pos_embed[:1]).to(tokens.dtype).expand(B, 1, self.embed_dim)]
        if self.ra_dec:
            if ra_dec is None:
                raise ValueError("model was built with ra_dec=True but got ra_dec=None")
            loc = self.ra_dec_embed(ra_dec.float()).to(tokens.dtype)
            prefix.append((loc + self.pos_embed[1].to(tokens.dtype))[:, None, :])
        return self.encoder(torch.cat(prefix + [tokens], dim=1))

    def final_norm(self, tokens: torch.Tensor) -> torch.Tensor:
        """``norm`` on every token for ``map`` and ``token`` pooling; ``avg``
        normalises after pooling (``fc_norm``), so its tokens pass through."""
        return tokens if self.global_pool == "avg" else self.norm(tokens, self.dtype)

    def encode(self, imgs: torch.Tensor, ra_dec: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full (B, extra + L, D) token sequence (JAX ``SkyViT.encode``);
        with ``avg`` pooling not LayerNormed (timm fc_norm semantics)."""
        return self.final_norm(self.backbone(imgs, ra_dec))

    def forward_head(self, tokens: torch.Tensor,
                     dropout_generator: Optional[torch.Generator] = None,
                     dropout_rows: Optional[tuple[slice, int]] = None) -> torch.Tensor:
        """Pool, head dropout (only when ``dropout_generator`` is given:
        training), head. (B, N, D) -> (B, num_labels) in ``dtype``.
        ``dropout_rows`` (``parallel/distributed.batch_rows``): draw the
        dropout for the global batch and keep these rows."""
        if self.global_pool == "map":
            x = self.pool(tokens)
        elif self.global_pool == "avg":
            x = tokens[:, self.num_extra_tokens:].float().mean(1).to(tokens.dtype)
            x = self.fc_norm(x, self.dtype)
        else:
            x = tokens[:, 0]
        if dropout_generator is not None and self.dropout > 0:
            # flax Dropout: keep with probability 1 - rate, scale by its inverse
            shape = x.shape if dropout_rows is None else (dropout_rows[1],) + x.shape[1:]
            keep = torch.rand(shape, generator=dropout_generator, device=dropout_generator.device)
            if dropout_rows is not None:
                keep = keep[dropout_rows[0]]
            keep = keep.to(x.device) >= self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        return self.head(x, self.dtype)

    def forward(self, imgs: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ra_dec: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None,
                frozen_backbone: bool = False,
                dropout_rows: Optional[tuple[slice, int]] = None) -> torch.Tensor:
        """(B, C, H, W) -> (B, num_labels) normalised predictions (logits for
        a classifier). ``mask`` is accepted and ignored (reference
        ``vit.py:390-393``). ``frozen_backbone`` runs :meth:`backbone` with
        autograd off (the ``lp`` regime): one call, so that a DDP wrap
        sees the whole forward."""
        del mask
        if frozen_backbone:
            with torch.no_grad():
                tokens = self.backbone(imgs, ra_dec)
            return self.forward_head(self.final_norm(tokens), dropout_generator, dropout_rows)
        return self.forward_head(self.encode(imgs, ra_dec), dropout_generator, dropout_rows)


def build_predictor_model(
    config,
    mae_config,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    mesh=None,
) -> SkyViT:
    """Construct a :class:`SkyViT` from predictor + pretraining configs (JAX
    ``build_predictor_model``, reference ``vit.build_model``): the
    architecture comes from the pretraining config, head and pooling from
    the predictor config. Weights are drawn from ``generator`` (seed 0 when
    None) on ``device``; ``device="meta"`` builds the shapes alone. With a
    ``mesh`` of model axis > 1 the whole model is drawn, then cut to this
    rank's shard (``parallel/sharding.shard_module``)."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    arch = mae_config["ARCHITECTURE"]
    p_arch = config["ARCHITECTURE"]
    data = config["DATA"]
    training = config["TRAINING"]

    model_type = arch.str("model_type")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}; options: {sorted(MODEL_TYPES)}")
    size_key, _ = MODEL_TYPES[model_type]
    size = _SIZES[size_key]

    if "num_classes" in data:
        num_labels = data.int("num_classes")
    else:
        num_labels = len(data.list("label_keys"))
        if training.bool("use_label_errs", False):
            num_labels //= 2

    kwargs = dict(
        img_size=p_arch.int("img_size"),
        patch_size=arch.int("patch_size"),
        in_chans=arch.int("num_channels"),
        embed_dim=arch.int("embed_dim"),
        depth=size["depth"],
        num_heads=size["num_heads"],
        num_labels=num_labels,
        global_pool=p_arch.str("global_pool", "map"),
        label_means=tuple(float(x) for x in data.list("label_means")),
        label_stds=tuple(float(x) for x in data.list("label_stds")),
        pixel_mean=arch.float("pixel_mean", 0.0),
        pixel_std=arch.float("pixel_std", 1.0),
        dropout=float(p_arch.float("dropout", 0.0)),
        ra_dec=arch.bool("ra_dec", False),
        dtype=dtype,
        remat=remat,
        stash=arch.bool("stash", size_key != "huge"),
        stash_mlp=arch.bool("stash_mlp", size_key == "large"),
    )
    if dev.type == "meta":
        with torch.device("meta"):
            return SkyViT(**kwargs).eval()
    model = SkyViT(**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    if mesh is not None and mesh.tp > 1:
        from sky_embeddings_tpu_torch.parallel.sharding import shard_module

        shard_module(model, mesh)
    return model.to(dev).eval()
