"""MLP-block forward: ``x + GELU(LN(x)·W1 + b1)·W2 + b2``.

Replaces the TPU kernel ``sky_embeddings_tpu/ops/kernels/mlp_block.py``
``_pallas_fwd`` (``_fwd_kernel``), the primal of ``fused_mlp_block``. The
CUDA kernel is ``csrc/mlp_block.cu`` (three launches: LN, fc1 + GELU, then
fc2 + residual, on the shared wmma GEMM of ``csrc/gemm.cuh``).

What bounds it on the H100: tensor-core FLOPs (4·M·D·F at M = B·65 rows),
not bytes. The first version moves h (M, F) through device memory in bf16,
where the TPU kernel rounds it; keeping h on chip and wgmma are later work.

Numerics (both versions): fp32 LN statistics (eps 1e-6), bf16 GEMM operands
with fp32 accumulation, exact-erf GELU in fp32, h rounded to bf16 before
fc2, residual added in fp32 and cast to x's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product with fp32 accumulation (bf16 operands multiply exactly in fp32)."""
    return torch.matmul(a.float(), b.float())


def layer_norm(x2: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """fp32 LayerNorm with the TPU kernels' two-pass variance."""
    mu = x2.mean(dim=-1, keepdim=True)
    var = ((x2 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x2 - mu) * torch.rsqrt(var + eps) * scale + bias


def mlp_block_plain(x, scale, bias, w1, b1, w2, b2):
    """Plain PyTorch version (CPU path and parity reference); the same math
    as the JAX oracle ``xla_mlp_block``."""
    x2 = x.float()
    y = layer_norm(x2, scale, bias)
    a = _dot(y.to(w1.dtype), w1) + b1
    h = 0.5 * a * (1.0 + torch.erf(a * _INV_SQRT2))
    out = _dot(h.to(w2.dtype), w2) + b2
    return (x2 + out).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mlp_block")
    fn = lib.sky_mlp_block_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(x, scale, bias, w1, b1, w2, b2):
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"fused_mlp_block on CUDA takes bf16 activations, got {x.dtype} "
            "(fp32 on CUDA is a ROADMAP item)"
        )
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, D) tensor")
    D = x.shape[-1]
    F = w1.shape[-1]
    want = {
        "scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
        "w1": (w1, (D, F), torch.bfloat16), "b1": (b1, (F,), torch.float32),
        "w2": (w2, (F, D), torch.bfloat16), "b2": (b2, (D,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 (16-byte loads)")
    if x.shape[0] * x.shape[1] > 65535 * 64:
        raise ValueError("too many rows for one launch grid")


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2):
    """(B, N, D) -> (B, N, D). CPU tensors take :func:`mlp_block_plain`;
    CUDA tensors launch ``csrc/mlp_block.cu`` or raise."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, scale, bias, w1, b1, w2, b2)
    _check_cuda_args(x, scale, bias, w1, b1, w2, b2)
    B, N, D = x.shape
    F = w1.shape[1]
    h = torch.empty((B * N, F), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().sky_mlp_block_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(), B * N, D, F,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(err, "mlp_block")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0
