"""I-JEPA: latent-prediction pretraining (port of
``sky_embeddings_tpu/models/jepa.py``; Assran et al. 2023).

* :class:`JEPAEncoder`: NaN pixels take the trainable ``patch_mask_values``,
  then the patch embedding, the frozen sin-cos ``pos_embed`` (a
  non-persistent buffer, a constant in JAX, so the state dict holds the
  JAX tree's leaves and no more), optionally the gather of a fixed-budget
  set of context tokens, the ViT blocks and the final LayerNorm. The
  trainer's EMA target encoder is a second :class:`JEPAEncoder`.
* :class:`JEPAPredictor`: a narrow transformer (heads of 64, at least one)
  fed the encoded context projected to its width plus mask queries, each
  the learned ``mask_token`` plus its target position's sin-cos embedding;
  the norm of the query slots, projected back to the encoder's width.
* :class:`SkyJEPA`: the context encoder and the predictor; its forward is
  the loss: mean L2 (or smooth-L1) between the predictions and the
  standardised target representations over the valid target slots of each
  of the ``num_pred`` target blocks, ``total / (count + 1e-6)``.

Every block runs the port's ``layers.Encoder`` with JAX's defaults: the
attention stash on, the MLP stash off, no remat; so training launches
kernels 2 and 3 and K1 with kernel 8, and inference K2 and K1, at the
encoder's width and at the predictor's (192 at ``small``). ``plain = True``
sends every block through the kernels' plain versions.

Under tensor parallelism (``build_jepa_model(..., mesh=)``) the whole
seeded model is drawn as one process draws it and then cut to the rank's
shard by ``parallel/sharding.shard_module``'s rule: the encoder's blocks
split when the model axis divides their heads (``small`` and up at
``tensor_parallel = 2``: 3 heads of 64 a rank at ViT-S), the predictor's
(3 heads at 192, one at 96) and ``tiny``'s 3-head encoder run whole on
every rank through K2, kernel 4, K1 and kernel 8. The patch embedding,
``patch_mask_values``, ``proj_in``, ``proj_out`` and ``mask_token`` stay
whole on every rank, and the context gather runs on the replicated tokens.

The context gather is a one-hot product (``gather_tokens``): the invalid
slots of a context set repeat its first member, and the product's backward
sums the repeats in a fixed order on any device, where ``torch.gather``'s
backward adds them with atomics on CUDA (so two runs of one step could
differ in their last bits).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sky_embeddings_tpu_torch.models.layers import Encoder, LayerNorm, Linear, PatchEmbed
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks
from sky_embeddings_tpu_torch.parallel.distributed import global_ratio
from sky_embeddings_tpu_torch.utils.device import resolve_device

_SIZES = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
}


def gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, L, D) tokens, (B, K) indices -> (B, K, D), as a one-hot product:
    exact (one nonzero term a row), and its backward sums repeated indices
    deterministically."""
    onehot = F.one_hot(idx, tokens.shape[1]).to(tokens.dtype)
    return torch.bmm(onehot, tokens)


def standardize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``jax.nn.standardize(x, axis=-1, epsilon=eps)`` as JAX 0.9 computes
    it, in x's dtype: the means accumulate in fp32 and round to x's dtype,
    the variance is E[x²] - E[x]² clipped at 0."""
    dt = x.dtype
    mean = x.float().mean(-1, keepdim=True).to(dt)
    mean_sq = (x * x).float().mean(-1, keepdim=True).to(dt)
    var = (mean_sq - mean * mean).clamp_min(0)
    return (x - mean) * torch.rsqrt(var + eps)


class JEPAEncoder(nn.Module):
    """ViT encoder over the full grid or a gathered token subset."""

    def __init__(self, img_size: int = 64, patch_size: int = 8, in_chans: int = 5,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, pixel_mean: float = 0.0, pixel_std: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_pos_embed_2d(embed_dim, self.grid_size, 0)), persistent=False)
        self.patch_mask_values = nn.Parameter(torch.zeros(in_chans, patch_size, patch_size))
        self.encoder = Encoder(depth, embed_dim, num_heads, mlp_ratio, dtype)
        self.norm = LayerNorm(embed_dim)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    def _tokens(self, imgs: torch.Tensor) -> torch.Tensor:
        x = (imgs - self.pixel_mean) / self.pixel_std
        g = self.grid_size
        fill = self.patch_mask_values.tile(1, g, g).expand_as(x).to(x.dtype)
        x = torch.where(torch.isnan(x), fill, x)
        tokens = self.patch_embed(x, self.dtype)
        return tokens + self.pos_embed.to(tokens.dtype)

    def forward(self, imgs: torch.Tensor, token_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, H, W) -> (B, L, D) in ``dtype``; with ``token_idx`` (B, K)
        only those grid positions are encoded (context mode)."""
        tokens = self._tokens(imgs)
        if token_idx is not None:
            tokens = gather_tokens(tokens, token_idx)
        return self.norm(self.encoder(tokens), self.dtype)


class JEPAPredictor(nn.Module):
    """Narrow transformer predicting target-token representations."""

    def __init__(self, embed_dim: int, pred_embed_dim: int = 192, depth: int = 4,
                 num_heads: int = 6, mlp_ratio: float = 4.0, grid_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pred_embed_dim = pred_embed_dim
        self.dtype = dtype
        self.proj_in = Linear(embed_dim, pred_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, pred_embed_dim))
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_pos_embed_2d(pred_embed_dim, grid_size, 0)), persistent=False)
        self.blocks = Encoder(depth, pred_embed_dim, num_heads, mlp_ratio, dtype)
        self.norm = LayerNorm(pred_embed_dim)
        self.proj_out = Linear(pred_embed_dim, embed_dim)

    def forward(self, ctx_repr: torch.Tensor, ctx_idx: torch.Tensor,
                tgt_idx: torch.Tensor) -> torch.Tensor:
        """(B, K_ctx, D_enc) context, its (B, K_ctx) positions and one target
        block's (B, K_tgt) positions -> (B, K_tgt, D_enc) predictions."""
        B, k_ctx, _ = ctx_repr.shape
        x_ctx = self.proj_in(ctx_repr, self.dtype)
        pos = self.pos_embed.to(x_ctx.dtype)
        x_ctx = x_ctx + pos[ctx_idx]
        queries = self.mask_token.to(x_ctx.dtype) + pos[tgt_idx]
        x = self.blocks(torch.cat([x_ctx, queries], dim=1))
        return self.proj_out(self.norm(x[:, k_ctx:], self.dtype), self.dtype)


class SkyJEPA(nn.Module):
    """Context encoder + predictor. The EMA target encoder is a separate
    :class:`JEPAEncoder` that the trainer owns."""

    # interface parity with SkyMIM for the embedding-extraction utilities
    num_extra_tokens = 0
    ra_dec = attn_pool = simmim = pooled = False

    def __init__(self, img_size: int = 64, patch_size: int = 8, in_chans: int = 5,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, pred_embed_dim: int = 192, pred_depth: int = 4,
                 pixel_mean: float = 0.0, pixel_std: float = 1.0, loss_fn: str = "l2",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if loss_fn not in ("l2", "smooth_l1"):
            raise ValueError(f"unknown JEPA loss {loss_fn!r}; options: l2, smooth_l1")
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.loss_fn = loss_fn
        self.dtype = dtype
        self.encoder = JEPAEncoder(img_size, patch_size, in_chans, embed_dim, depth, num_heads,
                                   mlp_ratio, pixel_mean, pixel_std, dtype)
        self.predictor = JEPAPredictor(embed_dim, pred_embed_dim, pred_depth,
                                       max(pred_embed_dim // 64, 1), mlp_ratio, self.grid_size,
                                       dtype)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def plain(self) -> bool:
        """Whether the blocks take the kernels' plain versions."""
        return self.encoder.encoder.plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self.encoder.encoder.plain = value
        self.predictor.blocks.plain = value

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator``: xavier-uniform
        kernels, zero biases, unit LN scales, N(0, 0.02) mask token, zero
        fill values."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.predictor.mask_token.normal_(0.0, 0.02, generator=generator)
            self.encoder.patch_mask_values.zero_()

    def encode(self, imgs: torch.Tensor, token_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The online encoder's tokens (B, L or K, D)."""
        return self.encoder(imgs, token_idx)

    def predict(self, ctx_repr, ctx_idx, tgt_idx) -> torch.Tensor:
        return self.predictor(ctx_repr, ctx_idx, tgt_idx)

    def forward(self, imgs: torch.Tensor, masks: BlockMasks, target_repr: torch.Tensor) -> torch.Tensor:
        """The masked latent-prediction loss (0-d fp32) of ``imgs`` given the
        EMA target representations (B, L, D)."""
        ctx = self.encoder(imgs, masks.ctx_idx)
        ctx = ctx * masks.ctx_valid[:, :, None].to(ctx.dtype)  # invalid slots act as padding
        tgt = standardize(target_repr)
        total = count = 0.0
        for t in range(masks.tgt_idx.shape[1]):
            idx, valid = masks.tgt_idx[:, t], masks.tgt_valid[:, t]
            pred = self.predictor(ctx, masks.ctx_idx, idx)
            want = torch.gather(tgt, 1, idx[:, :, None].expand(-1, -1, tgt.shape[-1]))
            diff = pred.float() - want.float()
            if self.loss_fn == "smooth_l1":
                ad = diff.abs()
                per = torch.where(ad < 1.0, 0.5 * diff ** 2, ad - 0.5).mean(-1)
            else:
                per = (diff ** 2).mean(-1)
            w = valid.float()
            total = total + (per * w).sum()
            count = count + w.sum()
        return global_ratio(total, count, 1e-6)  # over the global batch under a process group


def build_jepa_model(config, dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda",
                     generator: Optional[torch.Generator] = None, mesh=None) -> SkyJEPA:
    """A :class:`SkyJEPA` from an INI config (JAX ``build_jepa_model``) with
    weights drawn from ``generator`` (seed 0 when None), on ``device``. With
    a ``mesh`` of model axis > 1 the whole model is drawn, then cut to this
    rank's shard (``parallel/sharding.shard_module``)."""
    dev = resolve_device(device)
    arch = config["ARCHITECTURE"]
    model_type = arch.str("model_type", "small")
    if model_type not in _SIZES:
        raise ValueError(f"unknown JEPA model_type {model_type!r}; options: {sorted(_SIZES)}")
    model = SkyJEPA(
        img_size=arch.int("img_size"),
        patch_size=arch.int("patch_size"),
        in_chans=arch.int("num_channels"),
        pred_embed_dim=arch.int("pred_emb_dim", 192),
        pred_depth=arch.int("pred_depth", 4),
        pixel_mean=arch.float("pixel_mean", 0.0),
        pixel_std=arch.float("pixel_std", 1.0),
        dtype=dtype,
        **_SIZES[model_type],
    )
    model.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
    if mesh is not None and mesh.tp > 1:
        from sky_embeddings_tpu_torch.parallel.sharding import shard_module

        shard_module(model, mesh)
    return model.to(dev).eval()
