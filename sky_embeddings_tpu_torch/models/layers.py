"""Pre-norm ViT layers (port of ``sky_embeddings_tpu/models/layers.py``).

Parameters keep the JAX tree's names and layouts so that a state dict maps
onto the JAX params leaf for leaf (``models/weights.py``): Linear weights are
(in, out) ``kernel`` tensors, LayerNorms hold ``scale``/``bias``, and the
MLP block holds ``norm_scale``/``fc1_kernel``/... as flat parameters.
Parameters are fp32; ``dtype`` is the activation and GEMM-operand dtype.

Each ``Block`` calls the attention-block kernel and then the MLP-block
kernel (``ops/kernels/``) for every batch size; their wrappers take the plain
PyTorch versions for CPU tensors and raise on CUDA for what the kernels do not
take (fp32, N > 256, a head too wide for the attention core's shared
memory). With grad enabled the two calls go through their
``torch.autograd.Function``s: the attention stash forward and backward
(``stash=True``, the default, as in JAX) or K2 with the recompute backward
(``stash=False``, the ViT-H default), and the MLP forward with its recompute
backward (``stash_mlp=False``) or the MLP stash forward and backward
(``stash_mlp=True``, the ViT-L default). A wide MLP block (D·F > 1024·4096,
ViT-H) always takes the MLP forward with the weight-streaming backward
(kernel 9), JAX's width rule without its TPU-only gates (the backend, B % 16,
``SKY_MLP_STREAM``): on the card it never runs the plain MLP.
``Encoder.plain = True`` sends the blocks through the plain versions on any
device: the reference path that a check on the card holds the kernel path
against.

``Encoder(remat=True)`` runs each block under
``torch.utils.checkpoint.checkpoint`` (JAX ``nn.remat(Block)``): the block's
forward kernels run again in the backward, and both stashes are off, as JAX
turns them off under remat (``layers.py:422-425``).

Not ported yet (ROADMAP): the scan layout, ``CrossAttention`` and
``AttentionPoolLatent``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sky_embeddings_tpu_torch.ops.kernels.attn_block import fused_attn_block
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import fused_mlp_block


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Glorot-uniform over a (fan_in, fan_out) kernel (flax ``xavier_uniform``)."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, L, p²·C), row-major patches, (ph, pw, c) flatten."""
    B, C, H, W = imgs.shape
    p = patch_size
    h, w = H // p, W // p
    x = imgs.reshape(B, C, h, p, w, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(B, h * w, p * p * C)


def unpatchify(x: torch.Tensor, patch_size: int, channels: int) -> torch.Tensor:
    """(B, L, p²·C) -> (B, C, H, W); inverse of :func:`patchify`."""
    B, L, _ = x.shape
    p = patch_size
    h = w = int(round(L ** 0.5))
    if h * w != L:
        raise ValueError(f"token count {L} is not a square grid")
    x = x.reshape(B, h, w, p, p, channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, channels, h * p, w * p)


class Linear(nn.Module):
    """``kernel`` (in, out) + ``bias`` (out,), the paths of flax ``nn.Dense``."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(din, dout))
        self.bias = nn.Parameter(torch.zeros(dout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.kernel, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """flax ``Dense(dtype=...)``: operands and bias in ``dtype``."""
        return F.linear(x.to(dtype), self.kernel.t().to(dtype), self.bias.to(dtype))


class LayerNorm(nn.Module):
    """``scale``/``bias`` LayerNorm, eps 1e-6, fp32 statistics, output in ``dtype``."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, eps=1e-6)
        return y.to(dtype)


class PatchEmbed(nn.Module):
    """Patchify + one Linear (the stride-p convolution as a GEMM); the
    product stays ``F.linear``, as JAX computes it outside any kernel."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(patch_size * patch_size * in_chans, embed_dim)

    def forward(self, imgs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.proj(patchify(imgs, self.patch_size), dtype)


class AttnParams(nn.Module):
    """qkv + proj parameters under the ``attn/{qkv,proj}`` paths."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)


class MlpBlock(nn.Module):
    """LN -> fc1 -> exact GELU -> fc2 -> residual (``ffn`` scope). A wide
    block (D·F > 1024·4096, JAX ``layers.py:238``: ViT-H) takes the
    weight-streaming backward (``stash="stream"``, kernel 9) whatever
    ``stash`` says, as JAX's does (``layers.py:249``)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype, stash: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stash = stash
        self.wide = dim * hidden_dim > 1024 * 4096
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.fc1_kernel = nn.Parameter(torch.empty(dim, hidden_dim))
        self.fc1_bias = nn.Parameter(torch.zeros(hidden_dim))
        self.fc2_kernel = nn.Parameter(torch.empty(hidden_dim, dim))
        self.fc2_bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm_scale)
        nn.init.zeros_(self.norm_bias)
        xavier_uniform_(self.fc1_kernel, generator)
        nn.init.zeros_(self.fc1_bias)
        xavier_uniform_(self.fc2_kernel, generator)
        nn.init.zeros_(self.fc2_bias)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return fused_mlp_block(
            x.to(self.dtype), self.norm_scale, self.norm_bias,
            self.fc1_kernel.to(self.dtype), self.fc1_bias,
            self.fc2_kernel.to(self.dtype), self.fc2_bias,
            stash="stream" if self.wide else self.stash, plain=plain,
        )


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, stash: bool = True,
                 stash_mlp: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.stash = stash
        self.norm1 = LayerNorm(dim)
        self.attn = AttnParams(dim)
        self.ffn = MlpBlock(dim, int(dim * mlp_ratio), dtype, stash=stash_mlp)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = fused_attn_block(
            x.to(self.dtype), self.norm1.scale, self.norm1.bias,
            self.attn.qkv.kernel.to(self.dtype), self.attn.qkv.bias,
            self.attn.proj.kernel.to(self.dtype), self.attn.proj.bias,
            self.num_heads, stash=self.stash, plain=plain,
        )
        return self.ffn(x, plain)


class Encoder(nn.Module):
    """``depth`` blocks under the loop layout's ``block0``..``blockN`` scopes;
    with ``remat`` each block is checkpointed and both stashes are off."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, stash: bool = True,
                 stash_mlp: bool = False, remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        self.plain = False
        # the forward is replayed in the backward anyway: the stash writes
        # would be paid twice for no recompute saved
        stash, stash_mlp = stash and not remat, stash_mlp and not remat
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads, mlp_ratio, dtype, stash, stash_mlp))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if remat:
                x = checkpoint(block, x, self.plain, use_reentrant=False)
            else:
                x = block(x, self.plain)
        return x
