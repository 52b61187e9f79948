"""Attention-block forward: ``x + MHA(LN(x)·Wqkv + bqkv)·Wproj + bproj``.

Replaces the TPU kernel ``sky_embeddings_tpu/ops/kernels/attn_block.py``
``_pallas_fwd`` (``_fwd_kernel`` / ``_fwd_kernel_loop``), the primal of
``fused_attn_block``, for ``seg_len = 0``. The CUDA kernel is
``csrc/attn_block.cu``: LN, qkv GEMM, an attention core with one CTA per
(sample, head) holding q, k and v in shared memory, then proj GEMM +
residual.

What bounds it on the H100: tensor-core FLOPs of the two GEMMs
(8·M·D² at M = B·N rows); the attention core adds 4·B·H·N²·hd. qkv and ctx
go through device memory at the points where the TPU kernel rounds them to
bf16; keeping them on chip and wgmma are later work.

The packed-segment mask (``seg_len > 0``, MAE training) is not ported yet
(ROADMAP: MAE mode).

Numerics (both versions): fp32 LN statistics, bf16 GEMM operands with fp32
accumulation, qkv rounded to bf16 after its bias, fp32 logits scaled by
hd^-0.5 and fp32 softmax, probs rounded to bf16 before the PV product, ctx
rounded to bf16, residual added in fp32 and cast to x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import _dot, layer_norm

MAX_TOKENS = 256  # the TPU kernel's dispatch bound (layers.py:341)


def attn_block_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Plain PyTorch version (CPU path and parity reference); the same math
    as the JAX oracle ``xla_attn_block`` with ``seg_len = 0``."""
    B, N, D = x.shape
    hd = D // num_heads
    x2 = x.float()
    y = layer_norm(x2, scale, bias)
    qkv = (_dot(y.to(wqkv.dtype), wqkv) + bqkv).to(wqkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits * hd ** -0.5, dim=-1)
    ctx = torch.einsum("bhnm,bmhd->bnhd", probs.to(wqkv.dtype).float(), v.float())
    out = _dot(ctx.reshape(B, N, D).to(wproj.dtype), wproj) + bproj
    return (x2 + out).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attn_block")
    fn = lib.sky_attn_block_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads):
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"fused_attn_block on CUDA takes bf16 activations, got {x.dtype} "
            "(fp32 on CUDA is a ROADMAP item)"
        )
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, D) tensor")
    B, N, D = x.shape
    if N > MAX_TOKENS:
        raise ValueError(f"N={N} tokens exceeds the kernel's bound {MAX_TOKENS}")
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by num_heads={num_heads}")
    hd = D // num_heads
    if hd % 16 or hd > 64:
        raise ValueError(f"head dim {hd} must be a multiple of 16 and <= 64")
    if D % 8:
        raise ValueError(f"D={D} must be a multiple of 8 (16-byte loads)")
    if B * N > 65535 * 64 or B * num_heads > 2**31 - 1:
        raise ValueError("too many rows for one launch grid")
    want = {
        "scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
        "wqkv": (wqkv, (D, 3 * D), torch.bfloat16), "bqkv": (bqkv, (3 * D,), torch.float32),
        "wproj": (wproj, (D, D), torch.bfloat16), "bproj": (bproj, (D,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_attn_block(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int):
    """(B, N, D) -> (B, N, D). CPU tensors take :func:`attn_block_plain`;
    CUDA tensors launch ``csrc/attn_block.cu`` or raise."""
    if x.device.type == "cpu":
        return attn_block_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
    _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
    B, N, D = x.shape
    qkv = torch.empty((B, N, 3 * D), dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty((B, N, D), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().sky_attn_block_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            B, N, D, num_heads, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(err, "attn_block")
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0
