"""MLP block: ``x + GELU(LN(x)·W1 + b1)·W2 + b2``, forward and backward.

Forward (K1): replaces the TPU kernel ``sky_embeddings_tpu/ops/kernels/mlp_block.py``
``_pallas_fwd`` (``_fwd_kernel``), the primal of ``fused_mlp_block``. The
CUDA kernel is ``csrc/mlp_block.cu`` (three launches: LN, fc1 + GELU, then
fc2 + residual, on the shared wmma GEMM of ``csrc/gemm.cuh``).

Backward (kernel 8): replaces ``_pallas_bwd`` (``_bwd_kernel``), the
recompute backward of ``fused_mlp_block(stash=False)``, the ViT-B training
default. The CUDA kernel is ``csrc/mlp_block_bwd.cu``: LN, fc1 and GELU
recomputed from x, then dh, dy and the two weight gradients as GEMMs that
own their whole reduction, with deterministic two-pass column sums for the
bias and LN gradients. :class:`MlpBlockFn` is the ``torch.autograd.Function``
that pairs the two.

What bounds them on the H100: tensor-core FLOPs (4·M·D·F forward, 10·M·D·F
backward at M = B·65 rows), not bytes. The first versions move h, a and da
through device memory at the TPU kernel's rounding points; keeping them on
chip and wgmma are later work.

Numerics (kernel and plain versions alike): fp32 LN statistics (eps 1e-6),
bf16 GEMM operands with fp32 accumulation, exact-erf GELU and GELU' in fp32,
h and da rounded to bf16 before the products that take them, db1 summed from
the fp32 da, weight gradients cast to the weight dtype, residual gradient
added in fp32 and cast to x's dtype.

The stashed backward (TPU kernels 6 and 7, ``stash=True``, the ViT-L
default) is not ported yet: with grad on CUDA it raises (ROADMAP).
"""

from __future__ import annotations

import ctypes
import math

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
ROWS_PER_PARTIAL = 32  # rows per partial column sum, csrc/bwd_common.cuh
MAX_SPLITS = 8  # K slices of a weight-gradient GEMM at most, csrc/gemm.cuh


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product with fp32 accumulation (bf16 operands multiply exactly in fp32)."""
    return torch.matmul(a.float(), b.float())


def _ln_forward(x2: torch.Tensor, scale, bias, eps: float = 1e-6):
    """fp32 LayerNorm with the TPU kernels' two-pass variance: (y, xhat, rstd)."""
    mu = x2.mean(dim=-1, keepdim=True)
    var = ((x2 - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x2 - mu) * rstd
    return xhat * scale + bias, xhat, rstd


def layer_norm(x2: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """fp32 LayerNorm with the TPU kernels' two-pass variance."""
    return _ln_forward(x2, scale, bias, eps)[0]


def _ln_backward(g2, dy, xhat, rstd, scale):
    """LN backward plus the residual gradient (mlp_block.py:333-337):
    (dx fp32, dscale, dbias) from the fp32 gradient ``dy`` of the LN output."""
    dxhat = dy * scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = g2 + rstd * (dxhat - m1 - xhat * m2)
    return dx, (dy * xhat).sum(0), dy.sum(0)


def gelu(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * a * (1.0 + torch.erf(a * _INV_SQRT2))


def gelu_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu / da (mlp_block.py:218-219, exact erf)."""
    return 0.5 * (1.0 + torch.erf(a * _INV_SQRT2)) + a * torch.exp(-0.5 * a * a) * _INV_SQRT2PI


def mlp_block_plain(x, scale, bias, w1, b1, w2, b2):
    """Plain PyTorch version (CPU path and parity reference); the same math
    as the JAX oracle ``xla_mlp_block``."""
    x2 = x.float()
    y = layer_norm(x2, scale, bias)
    a = _dot(y.to(w1.dtype), w1) + b1
    out = _dot(gelu(a).to(w2.dtype), w2) + b2
    return (x2 + out).to(x.dtype)


def mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g):
    """Plain version of kernel 8: mirrors ``_bwd_kernel`` (mlp_block.py:309-354)
    rounding point by rounding point. Returns (dx, dscale, dbias, dw1, db1,
    dw2, db2) in the dtypes of (x, scale, bias, w1, b1, w2, b2)."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).float()
    g2 = g.reshape(-1, D).float()
    y, xhat, rstd = _ln_forward(x2, scale, bias)
    y_c = y.to(w1.dtype)
    a = _dot(y_c, w1) + b1
    h_c = gelu(a).to(w2.dtype)
    g_c = g2.to(w2.dtype)
    dh = _dot(g_c, w2.t())
    da = dh * gelu_grad(a)
    da_c = da.to(w1.dtype)
    dy = _dot(da_c, w1.t())
    dx, dscale, dbias = _ln_backward(g2, dy, xhat, rstd, scale)
    return (
        dx.to(x.dtype).reshape(x.shape), dscale, dbias,
        _dot(y_c.t(), da_c).to(w1.dtype), da.sum(0),
        _dot(h_c.t(), g_c).to(w2.dtype), g2.sum(0),
    )


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mlp_block")
    fn = lib.sky_mlp_block_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = cuda_build.load("mlp_block_bwd")
    fn = lib.sky_mlp_block_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(x, scale, bias, w1, b1, w2, b2=None):
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
    if b2 is None:  # the backward does not read b2
        del want["b2"]
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 (16-byte loads)")
    if x.shape[0] * x.shape[1] > 65535 * ROWS_PER_PARTIAL:
        raise ValueError("too many rows for one launch grid")


def _launch_fwd(x, scale, bias, w1, b1, w2, b2):
    """K1 on CUDA tensors (counted on ``fused_mlp_block.launches``)."""
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


def mlp_block_bwd(x, scale, bias, w1, b1, w2, g):
    """Kernel 8: the gradients of the block from x and the output gradient
    ``g`` (see :func:`mlp_block_bwd_plain` for the outputs). CPU tensors take
    the plain version; CUDA tensors launch ``csrc/mlp_block_bwd.cu`` or raise."""
    if x.device.type == "cpu":
        return mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g)
    _check_cuda_args(x, scale, bias, w1, b1, w2)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"g: want a contiguous {tuple(x.shape)} {x.dtype} tensor on {x.device}")
    B, N, D = x.shape
    F = w1.shape[1]
    M = B * N
    parts = -(-M // ROWS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y, dy = torch.empty((M, D), **bf), torch.empty((M, D), **f32)
    a, da_c, h_c = torch.empty((M, F), **f32), torch.empty((M, F), **bf), torch.empty((M, F), **bf)
    part = torch.empty(parts * (F + 3 * D), **f32)
    ws = torch.empty(MAX_SPLITS * D * F, **f32)
    dx = torch.empty_like(x)
    dscale, dbias, db2 = (torch.empty(D, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.empty((D, F), **bf), torch.empty(F, **f32), torch.empty((F, D), **bf)
    ptrs = [t.data_ptr() for t in (x, scale, bias, w1, b1, w2, g, y, a, da_c, h_c, dy, part, ws,
                                   dx, dscale, dbias, dw1, db1, dw2, db2)]
    with torch.cuda.device(x.device):
        err = _lib_bwd().sky_mlp_block_bwd(*ptrs, M, D, F, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "mlp_block_bwd")
    mlp_block_bwd.launches += 1
    return dx, dscale, dbias, dw1, db1, dw2, db2


mlp_block_bwd.launches = 0


class MlpBlockFn(torch.autograd.Function):
    """K1 forward, kernel 8 backward (JAX ``fused_mlp_block`` with
    ``stash=False``: only the inputs are saved). ``plain`` runs the plain
    versions of both on any device: the reference path a check on the card
    holds the kernels against."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, plain):
        on_plain = plain or x.device.type == "cpu"
        out = (mlp_block_plain if on_plain else _launch_fwd)(x, scale, bias, w1, b1, w2, b2)
        ctx.save_for_backward(x, scale, bias, w1, b1, w2)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2 = ctx.saved_tensors
        bwd = mlp_block_bwd_plain if ctx.plain else mlp_block_bwd
        return (*bwd(x, scale, bias, w1, b1, w2, g.contiguous()), None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, stash: bool = False, plain: bool = False):
    """(B, N, D) -> (B, N, D). Without grad: CPU tensors (or ``plain``) take
    :func:`mlp_block_plain`, CUDA tensors launch K1 or raise. With grad, the
    call goes through :class:`MlpBlockFn` (K1 forward, kernel 8 backward);
    ``stash=True`` needs TPU kernels 6 and 7, not ported yet: it raises on
    CUDA and differentiates the plain version on the CPU."""
    args = (x, scale, bias, w1, b1, w2, b2)
    on_plain = plain or x.device.type == "cpu"
    if not _needs_grad(*args):
        return mlp_block_plain(*args) if on_plain else _launch_fwd(*args)
    if not stash:
        return MlpBlockFn.apply(*args, plain)
    if on_plain:
        return mlp_block_plain(*args)
    raise NotImplementedError(
        "fused_mlp_block(stash=True) with grad on CUDA needs the MLP stash forward and "
        "backward (TPU kernels 6 and 7), not ported yet (ROADMAP 1.1: MLP stash, "
        "configs/mim_25_large.ini)"
    )


fused_mlp_block.launches = 0
