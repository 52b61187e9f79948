"""Attention block ``x + MHA(LN(x)·Wqkv + bqkv)·Wproj + bproj``, forward and
stash backward.

Three kernels, all in CUDA C++:

- K2, the primal forward: replaces the TPU kernel
  ``sky_embeddings_tpu/ops/kernels/attn_block.py`` ``_pallas_fwd``
  (``_fwd_kernel`` / ``_fwd_kernel_loop``), for ``seg_len = 0``.
  ``csrc/attn_block.cu`` entry ``sky_attn_block_fwd``: LN, qkv GEMM, an
  attention core with one CTA per (sample, head) holding q, k and v in
  shared memory, then proj GEMM + residual.
- Kernel 2, the stash forward: replaces ``_pallas_fwd_stash``. The same
  launches (entry ``sky_attn_block_fwd_stash``), which also hand back qkv
  (B, N, 3D) and the softmax probabilities (B, H, N, N), bf16, in JAX's
  layout.
- Kernel 3, the stash backward: replaces ``_pallas_bwd_stash``.
  ``csrc/attn_block_bwd.cu``: dctx GEMM, a backward core per (sample, head)
  from the stashed qkv and probabilities (no qkv, logits or softmax
  recompute), dy and weight-gradient GEMMs, LN backward, deterministic
  two-pass column sums.

:class:`AttnBlockStashFn` is the ``torch.autograd.Function`` of the
training default ``stash=True``; inference never writes the stash, as in
JAX (``attn_block.py:1127-1131``).

What bounds them on the H100: tensor-core FLOPs of the GEMMs (8·M·D² forward,
16·M·D² backward at M = B·N rows); the cores add 4·B·H·N²·hd and
8·B·H·N²·hd. qkv, ctx and dqkv go through device memory at the points where
the TPU kernels round them; keeping them on chip and wgmma are later work.

Not ported yet (ROADMAP): the packed-segment mask (``seg_len > 0``, MAE
training) and the recompute backward (TPU kernel 4, ``stash=False``), which
raises with grad on CUDA.

Numerics (kernel and plain versions alike): fp32 LN statistics, bf16 GEMM
operands with fp32 accumulation, qkv rounded to bf16 after its bias, fp32
logits scaled by hd^-0.5 and fp32 softmax, probs rounded to bf16 before the
PV product, ctx rounded to bf16, residual added in fp32 and cast to x's
dtype. Backward: dctx, ds and dqkv rounded to bf16 before the products that
take them, dbqkv summed from the fp32 dqkv, weight gradients cast to the
weight dtype.
"""

from __future__ import annotations

import ctypes

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
    MAX_SPLITS,
    ROWS_PER_PARTIAL,
    _dot,
    _ln_backward,
    _ln_forward,
    _needs_grad,
)

MAX_TOKENS = 256  # the TPU kernel's dispatch bound (layers.py:341)


def attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Plain version of the stash forward: ``(out, qkv, probs)``, qkv
    (B, N, 3D) and probs (B, H, N, N) in x's dtype; ``out`` is the JAX
    oracle ``xla_attn_block`` with ``seg_len = 0``."""
    B, N, D = x.shape
    hd = D // num_heads
    x2 = x.float()
    y = _ln_forward(x2, scale, bias)[0]
    qkv = (_dot(y.to(wqkv.dtype), wqkv) + bqkv).to(wqkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits * hd ** -0.5, dim=-1).to(wqkv.dtype)
    ctx = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float())
    out = _dot(ctx.reshape(B, N, D).to(wproj.dtype), wproj) + bproj
    return (x2 + out).to(x.dtype), qkv.to(x.dtype), probs.to(x.dtype)


def attn_block_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Plain PyTorch version of the primal (CPU path and parity reference)."""
    return attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)[0]


def attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads: int):
    """Plain version of kernel 3: mirrors ``_bwd_stash_kernel``
    (attn_block.py:282-356) rounding point by rounding point. Returns
    (dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj) in the dtypes of
    (x, scale, bias, wqkv, fp32, wproj, fp32)."""
    B, N, D = x.shape
    H = num_heads
    hd = D // H
    dt = wqkv.dtype
    x2 = x.reshape(-1, D).float()
    g2 = g.reshape(-1, D).float()
    y, xhat, rstd = _ln_forward(x2, scale, bias)
    y_c = y.to(dt)
    g_c = g2.to(wproj.dtype)
    dc = _dot(g_c, wproj.t()).to(dt).float().reshape(B, N, H, hd)
    q, k, v = qkv.float().reshape(B, N, 3, H, hd).unbind(2)
    p = probs.float()
    ctx = torch.einsum("bhnm,bmhd->bnhd", p, v).to(dt)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dc)
    dp = torch.einsum("bnhd,bmhd->bhnm", dc, v)
    tmp = dp * p
    ds = ((tmp - p * tmp.sum(-1, keepdim=True)) * hd ** -0.5).to(dt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(B * N, 3 * D)
    dqkv_c = dqkv.to(dt)
    dy = _dot(dqkv_c, wqkv.t())
    dx, dscale, dbias = _ln_backward(g2, dy, xhat, rstd, scale)
    return (
        dx.to(x.dtype).reshape(x.shape), dscale, dbias,
        _dot(y_c.t(), dqkv_c).to(wqkv.dtype), dqkv.sum(0),
        _dot(ctx.reshape(B * N, D).t(), g_c).to(wproj.dtype), g2.sum(0),
    )


def _lib(name: str, entry: str, n_ptr: int) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    if B * N > 65535 * ROWS_PER_PARTIAL or B * num_heads > 2**31 - 1:
        raise ValueError("too many rows for one launch grid")
    want = {
        "scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
        "wqkv": (wqkv, (D, 3 * D), torch.bfloat16), "bqkv": (bqkv, (3 * D,), torch.float32),
        "wproj": (wproj, (D, D), torch.bfloat16), "bproj": (bproj, (D,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t is None:  # the backward reads neither bias
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, stash: bool):
    """K2 (``stash=False``, counted on ``fused_attn_block.launches``) or
    kernel 2 (counted on ``attn_block_fwd_stash.launches``) on CUDA tensors:
    ``(out, qkv, probs)``, probs None without the stash."""
    _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
    B, N, D = x.shape
    qkv = torch.empty((B, N, 3 * D), dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty((B, N, D), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), qkv.data_ptr(), ctx.data_ptr()]
    probs = None
    if stash:
        probs = torch.empty((B, num_heads, N, N), dtype=torch.bfloat16, device=x.device)
        ptrs.append(probs.data_ptr())
        entry = "sky_attn_block_fwd_stash"
    else:
        entry = "sky_attn_block_fwd"
    ptrs.append(out.data_ptr())
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block", entry, len(ptrs)), entry)(
            *ptrs, B, N, D, num_heads, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    if stash:
        attn_block_fwd_stash.launches += 1
    else:
        fused_attn_block.launches += 1
    return out, qkv, probs


def attn_block_fwd_stash(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Kernel 2: ``(out, qkv, probs)`` as :func:`attn_block_fwd_stash_plain`.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block.cu`` (stash entry) or raise."""
    if x.device.type == "cpu":
        return attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
    return _launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, stash=True)


attn_block_fwd_stash.launches = 0


def attn_block_bwd_stash(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads: int):
    """Kernel 3: the block's gradients from x, the stash and the output
    gradient ``g`` (outputs as :func:`attn_block_bwd_stash_plain`). CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block_bwd.cu`` or raise."""
    if x.device.type == "cpu":
        return attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads)
    _check_cuda_args(x, scale, bias, wqkv, None, wproj, None, num_heads)
    B, N, D = x.shape
    for name, t, shape in (("qkv", qkv, (B, N, 3 * D)), ("probs", probs, (B, num_heads, N, N)),
                           ("g", g, (B, N, D))):
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous {shape} bf16 tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    M = B * N
    parts = -(-M // ROWS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y, dc, ctx = (torch.empty((M, D), **bf) for _ in range(3))
    dqkv, dqkv_c = torch.empty((M, 3 * D), **f32), torch.empty((M, 3 * D), **bf)
    dy = torch.empty((M, D), **f32)
    part = torch.empty(parts * 6 * D, **f32)
    ws = torch.empty(MAX_SPLITS * 3 * D * D, **f32)
    dx = torch.empty_like(x)
    dscale, dbias, dbproj = (torch.empty(D, **f32) for _ in range(3))
    dwqkv, dbqkv = torch.empty((D, 3 * D), **bf), torch.empty(3 * D, **f32)
    dwproj = torch.empty((D, D), **bf)
    ptrs = [t.data_ptr() for t in (x, scale, bias, wqkv, wproj, qkv, probs, g, y, dc, ctx, dqkv,
                                   dqkv_c, dy, part, ws, dx, dscale, dbias, dwqkv, dbqkv, dwproj,
                                   dbproj)]
    entry = "sky_attn_block_bwd_stash"
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block_bwd", entry, len(ptrs)), entry)(
            *ptrs, B, N, D, num_heads, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    attn_block_bwd_stash.launches += 1
    return dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


attn_block_bwd_stash.launches = 0


class AttnBlockStashFn(torch.autograd.Function):
    """Kernel 2 forward, kernel 3 backward (JAX ``fused_attn_block`` with
    ``stash=True``: x, the weights, qkv and probs are saved). ``plain`` runs
    the plain versions of both on any device: the reference path a check on
    the card holds the kernels against."""

    @staticmethod
    def forward(ctx, x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, plain):
        fwd = attn_block_fwd_stash_plain if plain else attn_block_fwd_stash
        out, qkv, probs = fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
        ctx.save_for_backward(x, scale, bias, wqkv, wproj, qkv, probs)
        ctx.num_heads, ctx.plain = num_heads, plain
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, wqkv, wproj, qkv, probs = ctx.saved_tensors
        bwd = attn_block_bwd_stash_plain if ctx.plain else attn_block_bwd_stash
        grads = bwd(x, scale, bias, wqkv, wproj, qkv, probs, g.contiguous(), ctx.num_heads)
        return (*grads, None, None)


def fused_attn_block(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int,
                     stash: bool = True, plain: bool = False):
    """(B, N, D) -> (B, N, D). Without grad: CPU tensors (or ``plain``) take
    :func:`attn_block_plain`, CUDA tensors launch K2 or raise. With grad and
    ``stash``, the call goes through :class:`AttnBlockStashFn` (kernels 2 and
    3); ``stash=False`` needs TPU kernel 4, not ported yet: it raises on
    CUDA and differentiates the plain version on the CPU."""
    args = (x, scale, bias, wqkv, bqkv, wproj, bproj)
    on_plain = plain or x.device.type == "cpu"
    if not _needs_grad(*args):
        if on_plain:
            return attn_block_plain(*args, num_heads)
        return _launch_fwd(*args, num_heads, stash=False)[0]
    if stash:
        return AttnBlockStashFn.apply(*args, num_heads, plain)
    if on_plain:
        return attn_block_plain(*args, num_heads)
    raise NotImplementedError(
        "fused_attn_block(stash=False) with grad on CUDA needs the recompute backward "
        "(TPU kernel 4, attn_block.py _pallas_bwd), not ported yet (ROADMAP 1.1: "
        "attention recompute backward, for remat and ViT-H)"
    )


fused_attn_block.launches = 0
