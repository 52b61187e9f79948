"""Pre-norm ViT layers (port of ``sky_embeddings_tpu/models/layers.py``).

Parameters keep the JAX tree's names and layouts so that a state dict maps
onto the JAX params leaf for leaf (``models/weights.py``): Linear weights are
(in, out) ``kernel`` tensors, LayerNorms hold ``scale``/``bias``, and the
MLP block holds ``norm_scale``/``fc1_kernel``/... as flat parameters.
Parameters are fp32; ``dtype`` is the activation and GEMM-operand dtype.

Each ``Block`` calls the attention-block kernel and then the MLP-block
kernel (``ops/kernels/``) for every batch size, in bf16 or fp32; their
wrappers take the plain PyTorch versions for CPU tensors and raise on CUDA for
what the kernels do not take (N > 256, a bf16 head that is no multiple of 16
or too wide for the attention core's shared memory). With grad enabled the two calls go through their
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

Tensor parallelism (``[TRAINING] tensor_parallel > 1``;
``parallel/sharding.shard_module``): each ``Block`` (and its ``MlpBlock``)
whose heads and MLP width the model axis divides holds the rank's shard of
its qkv / proj / fc1 / fc2 parameters and the mesh (``tp``), and calls the
kernels' tensor-parallel forms (``fused_attn_block_tp``: K2 and kernel 4;
``fused_mlp_block_tp``: K1 and kernel 8) through
``torch.autograd.Function``s that all-reduce the fp32 partials over the
model group themselves, in the forward and in the backward; their
``stash`` / ``stash_mlp`` flags do not apply. A block the axis does not
divide keeps ``tp = None`` and all its parameters whole: it runs the
ordinary kernels on the replicated activations with its stash flags
turned off (``fused_attn_block(..., stash=False)``: K2 and kernel 4; K1
and kernel 8), so that under tensor parallelism every block takes the
recompute forms, as JAX keeps no stash there (its Pallas kernels are off
under tensor parallelism). Remat replays the forward's all-reduces in the
backward, in the same order on every rank.

``Encoder(remat=True)`` runs each block under
``torch.utils.checkpoint.checkpoint`` (JAX ``nn.remat(Block)``): the block's
forward kernels run again in the backward, and both stashes are off, as JAX
turns them off under remat (``layers.py:422-425``).

``Encoder.forward(x, seg_len)`` runs N // seg_len samples packed along the
sequence (MAE sequence packing): every block's attention is masked to the
block diagonal (``ops/kernels/attn_block.py``), the per-token LN and MLP
need no change; remat replays each block with the same ``seg_len``.

The attention modules beside the blocks keep JAX's names too: ``Mlp``
(``fc1``/``fc2``), ``Attention`` (``qkv``/``proj`` around
``ops/kernels/attention.attention_context``: kernels 12 and 13),
``CrossAttention`` (``q``/``kv``/``proj``) and ``AttentionPoolLatent``
(``latent``, ``xattn``, ``norm``, ``mlp``: SimMIM's ``attn_pool``). ``Mlp``
and ``CrossAttention`` are plain torch (``F.linear``, einsum, exact-erf
GELU), as JAX computes them outside any Pallas kernel.

The scan layout (JAX ``Encoder(scan=True)``: one ``blocks/block`` scope
whose leaves stack the blocks on axis 0) is a naming layer here: the port
always builds the loop layout, and :func:`unstack_block_params` /
:func:`stack_block_params` convert a params tree between the two
(``utils/checkpoint.adapt_block_layout``, ``models/weights.params_from_jax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint
import numpy as np

from sky_embeddings_tpu_torch.ops.kernels.attention import attention_context
from sky_embeddings_tpu_torch.ops.kernels.attn_block import fused_attn_block, fused_attn_block_tp
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import fused_mlp_block, fused_mlp_block_tp


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


class Mlp(nn.Module):
    """Linear -> exact GELU -> Linear (``fc1``, ``fc2``), in ``dtype``."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x, self.dtype)), self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection: ``qkv`` ->
    :func:`attention_context` (kernel 12, and kernel 13 in the backward) ->
    cast to ``dtype`` -> ``proj``. ``plain`` sends the core through the
    kernels' plain versions on any device."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.plain = False
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x, self.dtype)
        out = attention_context(qkv, self.num_heads, self.plain).to(self.dtype)
        return self.proj(out, self.dtype)


class CrossAttention(nn.Module):
    """Query tokens attend over a separate key/value sequence (``q``, fused
    ``kv``, ``proj``): fp32 logits and softmax, probabilities cast to
    ``dtype`` before the PV product."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, q_tokens: torch.Tensor, kv_tokens: torch.Tensor) -> torch.Tensor:
        B, M, D = q_tokens.shape
        N = kv_tokens.shape[1]
        H, hd = self.num_heads, D // self.num_heads
        q = self.q(q_tokens, self.dtype).reshape(B, M, H, hd)
        k, v = self.kv(kv_tokens, self.dtype).reshape(B, N, 2, H, hd).unbind(2)
        logits = torch.einsum("bmhd,bnhd->bhmn", q.float(), k.float())
        probs = torch.softmax(logits * hd ** -0.5, dim=-1).to(self.dtype)
        out = torch.einsum("bhmn,bnhd->bmhd", probs.float(), v.float()).to(self.dtype)
        return self.proj(out.reshape(B, M, D), self.dtype)


class AttentionPoolLatent(nn.Module):
    """Latent-query attention pooling: one learned ``latent`` token
    cross-attends over the sequence, then a residual MLP on its LayerNorm;
    (B, N, D) -> the pooled (B, D)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.latent = nn.Parameter(torch.zeros(1, 1, dim))
        self.xattn = CrossAttention(dim, num_heads, dtype)
        self.norm = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``normal(stddev=D^-0.5)`` for the latent; the submodules
        reset their own."""
        with torch.no_grad():
            self.latent.normal_(0.0, self.latent.shape[-1] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, D = x.shape
        q = self.latent.to(self.dtype).expand(B, 1, D)
        y = self.xattn(q, x)
        y = y + self.mlp(self.norm(y, self.dtype))
        return y[:, 0]


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
        self.tp = None  # the mesh under tensor parallelism (parallel/sharding.shard_module)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm_scale)
        nn.init.zeros_(self.norm_bias)
        xavier_uniform_(self.fc1_kernel, generator)
        nn.init.zeros_(self.fc1_bias)
        xavier_uniform_(self.fc2_kernel, generator)
        nn.init.zeros_(self.fc2_bias)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if self.tp is not None:
            return fused_mlp_block_tp(
                x.to(self.dtype), self.norm_scale, self.norm_bias,
                self.fc1_kernel.to(self.dtype), self.fc1_bias,
                self.fc2_kernel.to(self.dtype), self.fc2_bias, self.tp.all_reduce_model,
                plain=plain)
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
        self.tp = None  # the mesh under tensor parallelism (parallel/sharding.shard_module)

    def forward(self, x: torch.Tensor, plain: bool = False, seg_len: int = 0) -> torch.Tensor:
        if self.tp is not None:  # this rank's heads; the stash flags do not apply
            x = fused_attn_block_tp(
                x.to(self.dtype), self.norm1.scale, self.norm1.bias,
                self.attn.qkv.kernel.to(self.dtype), self.attn.qkv.bias,
                self.attn.proj.kernel.to(self.dtype), self.attn.proj.bias,
                self.num_heads // self.tp.tp, self.tp.all_reduce_model, plain=plain,
                seg_len=seg_len,
            )
            return self.ffn(x, plain)
        x = fused_attn_block(
            x.to(self.dtype), self.norm1.scale, self.norm1.bias,
            self.attn.qkv.kernel.to(self.dtype), self.attn.qkv.bias,
            self.attn.proj.kernel.to(self.dtype), self.attn.proj.bias,
            self.num_heads, stash=self.stash, plain=plain, seg_len=seg_len,
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
        self._register_load_state_dict_pre_hook(self._unstack_scan_layout)

    def _unstack_scan_layout(self, state_dict, prefix, *args) -> None:
        """Load a state dict in the scan layout: each ``<prefix>blocks.block.*``
        entry, stacked over the blocks, becomes the ``<prefix>block{i}.*``
        entries of the loop layout."""
        scan = prefix + "blocks.block."
        for name in [k for k in state_dict if k.startswith(scan)]:
            stacked = state_dict.pop(name)
            for i in range(stacked.shape[0]):
                state_dict[f"{prefix}block{i}.{name[len(scan):]}"] = stacked[i]

    def forward(self, x: torch.Tensor, seg_len: int = 0) -> torch.Tensor:
        """(B, N, D) -> (B, N, D); ``seg_len > 0`` masks attention to packed
        segments of ``seg_len`` tokens."""
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if remat:
                x = checkpoint(block, x, self.plain, seg_len, use_reentrant=False)
            else:
                x = block(x, self.plain, seg_len)
        return x


def _is_block_key(key: str) -> bool:
    return key.startswith("block") and key[5:].isdigit()


def _map_leaves(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_block_params(params: dict, depth: int) -> dict:
    """Loop-layout params (``block0``..``blockN`` scopes) -> the scan layout
    (one ``blocks/block`` scope, leaves stacked on axis 0), numpy. Non-block
    entries pass through unchanged (JAX ``layers.py:448``)."""
    blocks = [params[f"block{i}"] for i in range(depth)]
    stacked = _map_leaves(lambda *ls: np.stack([np.asarray(x) for x in ls], axis=0), *blocks)
    out = {k: v for k, v in params.items() if not _is_block_key(k)}
    out["blocks"] = {"block": stacked}
    return out


def unstack_block_params(params: dict) -> dict:
    """Inverse of :func:`stack_block_params` (JAX ``layers.py:459``)."""
    stacked = params["blocks"]["block"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(np.shape(leaf)[0]):
        out[f"block{i}"] = _map_leaves(lambda x: np.asarray(x)[i], stacked)
    return out
