"""MLP block: ``x + GELU(LN(x)·W1 + b1)·W2 + b2``, forward and backward.

Forward (K1): replaces the TPU kernel ``sky_embeddings_tpu/ops/kernels/mlp_block.py``
``_pallas_fwd`` (``_fwd_kernel``), the primal of ``fused_mlp_block``. The
CUDA kernel is ``csrc/mlp_block.cu`` (three launches: LN, fc1 + GELU, then
fc2 + residual, both products on the persistent wgmma + TMA GEMM of
``csrc/gemm_sm90.cuh``).

Backward (kernel 8): replaces ``_pallas_bwd`` (``_bwd_kernel``), the
recompute backward of ``fused_mlp_block(stash=False)``, the ViT-B training
default. The CUDA kernel is ``csrc/mlp_block_bwd.cu``: LN recomputed from
x; one dual-product launch computes fc1 (``a = y @ W1 + b1``) and ``dh = g
@ W2ᵀ`` for each hidden tile and writes ``da_c``, ``h_c`` and db1's column
partials, so neither fp32 (B·N, F) array reaches device memory; one group
launch then computes dy and the two weight gradients; the bias and LN
gradients are summed in a fixed order. :class:`MlpBlockFn` is the
``torch.autograd.Function`` that pairs the two.

Stash forward and backward (kernels 6 and 7, ``stash=True``, the ViT-L
default): replace ``_pallas_fwd_stash`` and ``_pallas_bwd_stash``. Kernel 6
is K1's launches with an fc1 epilogue that also stores the pre-activation
``a`` (B·N, F) in bf16 (``csrc/mlp_block.cu`` entry
``sky_mlp_block_fwd_stash``); kernel 7 is kernel 8 without the fc1 GEMM,
its dh epilogue reading the bf16 ``a`` (``csrc/mlp_block_bwd.cu`` entry
``sky_mlp_block_bwd_stash``). :class:`MlpBlockStashFn` pairs them.

What bounds them on the H100: tensor-core FLOPs (4·M·D·F forward, 10·M·D·F
backward, 8·M·D·F for kernel 7, at M = B·65 rows), not bytes. K1, kernel 6
and kernels 8 and 9 run every product on the persistent wgmma + TMA GEMM of
``csrc/gemm_sm90.cuh`` (the backwards through its K-major-B and
transposed-A forms); the forwards' fc1 erf-GELU epilogue still runs while
the tensor cores wait. Kernel 7 keeps the wmma GEMM of ``csrc/gemm.cuh``,
with a and da through device memory. h, da_c and h_c go through device
memory in bf16 at the TPU kernel's rounding points.

Numerics (kernel and plain versions alike): fp32 LN statistics (eps 1e-6),
bf16 GEMM operands with fp32 accumulation, exact-erf GELU and GELU' in fp32,
h and da rounded to bf16 before the products that take them, db1 summed from
the fp32 da, weight gradients cast to the weight dtype, residual gradient
added in fp32 and cast to x's dtype. Kernel 6 takes GELU of the fp32 ``a``
(its ``out`` is K1's); kernel 7 takes GELU and GELU' of the stashed,
rounded ``a``, so its h (for dW2) is not the forward's.

Weight-streaming backward (kernel 9, ``stash="stream"``, the backward of
wide blocks, D·F > 1024·4096: ViT-H): replaces ``_pallas_bwd_stream``
(``_bwd_stream_slab_kernel``). Kernel 8's gradients computed over
``nj = F / fs`` column slabs of W1 (rows of W2), ``fs`` from
:func:`_stream_slab` (JAX's partition: fs = 1280, nj = 4 at ViT-H), with the
fp32 ``dy`` summed slab by slab in JAX's order
(``csrc/mlp_block_bwd.cu`` entry ``sky_mlp_block_bwd_stream``: per slab
kernel 8's dual product and group launch). On the TPU the slabs bound the
VMEM-resident weights; here they bound the (B·N, fs) scratch in device
memory. With one slab JAX runs kernel 8, and so does
:func:`mlp_block_bwd_stream`. :class:`MlpBlockFn` pairs K1 with kernel 8 or,
with ``stream``, kernel 9; only the inputs are saved either way.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
ROWS_PER_PARTIAL = 32  # rows per partial column sum, csrc/bwd_common.cuh
MAX_SPLITS = 8  # K slices of a kernel 7 weight-gradient GEMM at most, csrc/gemm.cuh


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


def mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, b2):
    """Plain version of kernel 6 (``_fwd_stash_kernel``, mlp_block.py:357-375):
    ``(out, a)``, ``out`` the JAX oracle ``xla_mlp_block`` (GELU of the fp32
    pre-activation) and ``a`` the fc1 pre-activation (B·N, F) in x's dtype."""
    x2 = x.float()
    y = layer_norm(x2, scale, bias)
    a = _dot(y.to(w1.dtype), w1) + b1
    out = _dot(gelu(a).to(w2.dtype), w2) + b2
    return (x2 + out).to(x.dtype), a.reshape(-1, a.shape[-1]).to(x.dtype)


def mlp_block_plain(x, scale, bias, w1, b1, w2, b2):
    """Plain PyTorch version of the primal (CPU path and parity reference)."""
    return mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, b2)[0]


def _mlp_bwd_from(x, scale, bias, w1, w2, a, g):
    """The MLP backward from the fp32 pre-activation ``a`` (M, F), at the
    rounding points of ``_bwd_kernel`` / ``_bwd_stash_kernel``."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).float()
    g2 = g.reshape(-1, D).float()
    y, xhat, rstd = _ln_forward(x2, scale, bias)
    y_c = y.to(w1.dtype)
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


def mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g):
    """Plain version of kernel 8: mirrors ``_bwd_kernel`` (mlp_block.py:309-354)
    rounding point by rounding point: LN and fc1 recomputed, GELU of the fp32
    pre-activation. Returns (dx, dscale, dbias, dw1, db1, dw2, db2) in the
    dtypes of (x, scale, bias, w1, b1, w2, b2)."""
    y = layer_norm(x.reshape(-1, x.shape[-1]).float(), scale, bias)
    return _mlp_bwd_from(x, scale, bias, w1, w2, _dot(y.to(w1.dtype), w1) + b1, g)


def mlp_block_bwd_stash_plain(x, scale, bias, w1, w2, a, g):
    """Plain version of kernel 7: mirrors ``_bwd_stash_kernel``
    (mlp_block.py:378-423): GELU and GELU' of the stashed ``a`` (B·N, F) in
    x's dtype, upcast to fp32; no fc1 recompute. Outputs as
    :func:`mlp_block_bwd_plain`."""
    return _mlp_bwd_from(x, scale, bias, w1, w2, a.float(), g)


_STREAM_FIXED_BUDGET = 24 * 1024 * 1024  # JAX mlp_block.py:430


def _stream_slab(D: int, F: int) -> int:
    """F-column slab width of the streaming backward, JAX's partition
    (``_stream_slab``, mlp_block.py:433-446): the whole F when 12·D·F bytes
    fit the budget (one slab), else the largest 128-multiple divisor of F
    that fits; plain divisors as a last resort for odd test geometries."""
    budget = _STREAM_FIXED_BUDGET
    if 12 * D * F <= budget:
        return F
    for fs in range(F - F % 128, 0, -128):
        if F % fs == 0 and 12 * D * fs <= budget:
            return fs
    for fs in range(F, 0, -1):
        if F % fs == 0 and 12 * D * fs <= budget:
            return fs
    return 1


def mlp_block_bwd_stream_plain(x, scale, bias, w1, b1, w2, g):
    """Plain version of kernel 9: mirrors ``_bwd_stream_slab_kernel``
    (mlp_block.py:459-529) slab by slab over :func:`_stream_slab`'s
    partition: each slab's fc1, GELU and GELU', dh, da and weight gradients
    at kernel 8's rounding points, and ``dy`` summed over the slabs in fp32
    in JAX's order (``dy_j + dy``). Outputs as :func:`mlp_block_bwd_plain`."""
    D, F = x.shape[-1], w1.shape[1]
    fs = _stream_slab(D, F)
    x2 = x.reshape(-1, D).float()
    g2 = g.reshape(-1, D).float()
    y, xhat, rstd = _ln_forward(x2, scale, bias)
    y_c = y.to(w1.dtype)
    g_c = g2.to(w2.dtype)
    dy = None
    dw1, db1, dw2 = [], [], []
    for j in range(F // fs):
        cols = slice(j * fs, (j + 1) * fs)
        w1j, w2j = w1[:, cols], w2[cols]
        a = _dot(y_c, w1j) + b1[cols]
        h_c = gelu(a).to(w2.dtype)
        da = _dot(g_c, w2j.t()) * gelu_grad(a)
        da_c = da.to(w1.dtype)
        dy_j = _dot(da_c, w1j.t())
        dy = dy_j if dy is None else dy_j + dy
        dw1.append(_dot(y_c.t(), da_c))
        db1.append(da.sum(0))
        dw2.append(_dot(h_c.t(), g_c))
    dx, dscale, dbias = _ln_backward(g2, dy, xhat, rstd, scale)
    return (
        dx.to(x.dtype).reshape(x.shape), dscale, dbias,
        torch.cat(dw1, dim=1).to(w1.dtype), torch.cat(db1),
        torch.cat(dw2, dim=0).to(w2.dtype), g2.sum(0),
    )


def _entry(name: str, entry: str, n_ptr: int, n_int: int = 3):
    """The C function ``entry`` of ``lib<name>``: ``n_ptr`` pointers, then
    ``n_int`` ints (M, D, F[, fs]) and the stream."""
    fn = getattr(cuda_build.load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    for name, (t, shape, dtype) in want.items():
        if t is None:  # the backwards read no b2, the stash backward no b1
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 (16-byte loads)")
    if x.shape[0] * x.shape[1] > 65535 * ROWS_PER_PARTIAL:
        raise ValueError("too many rows for one launch grid")


def _launch_fwd(x, scale, bias, w1, b1, w2, b2, stash: bool = False):
    """K1 (counted on ``fused_mlp_block.launches``) or, with ``stash``, kernel 6
    (counted on ``mlp_block_fwd_stash.launches``) on CUDA tensors: ``(out,
    a)``, ``a`` None without the stash."""
    _check_cuda_args(x, scale, bias, w1, b1, w2, b2)
    B, N, D = x.shape
    F = w1.shape[1]
    h = torch.empty((B * N, F), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, scale, bias, w1, b1, w2, b2, h)]
    a = None
    if stash:
        a = torch.empty((B * N, F), dtype=torch.bfloat16, device=x.device)
        ptrs.append(a.data_ptr())
        entry = "sky_mlp_block_fwd_stash"
    else:
        entry = "sky_mlp_block_fwd"
    with torch.cuda.device(x.device):
        err = _entry("mlp_block", entry, len(ptrs) + 1)(
            *ptrs, out.data_ptr(), B * N, D, F, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    if stash:
        mlp_block_fwd_stash.launches += 1
    else:
        fused_mlp_block.launches += 1
    return out, a


def mlp_block_fwd_stash(x, scale, bias, w1, b1, w2, b2):
    """Kernel 6: ``(out, a)`` as :func:`mlp_block_fwd_stash_plain`. CPU
    tensors take the plain version; CUDA tensors launch ``csrc/mlp_block.cu``
    (stash entry) or raise."""
    if x.device.type == "cpu":
        return mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, b2)
    return _launch_fwd(x, scale, bias, w1, b1, w2, b2, stash=True)


mlp_block_fwd_stash.launches = 0


def _check_g(x, g):
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"g: want a contiguous {tuple(x.shape)} {x.dtype} tensor on {x.device}")


@functools.lru_cache(maxsize=64)
def _split_ws(lib: str, entry: str, device: int, *dims: int) -> int:
    """fp32 floats of split-K workspace a backward's weight-gradient group
    needs: what the C plan says for this card, through ``entry`` of
    ``lib`` (``sky_mlp_block_bwd_ws(M, D, F, fs)``: kernel 8 with ``fs =
    F``, or 9; ``sky_attn_block_bwd_ws(M, D)``: kernels 3 and 4)."""
    fn = getattr(cuda_build.load(lib), entry)
    fn.argtypes = [ctypes.c_int] * len(dims)
    fn.restype = ctypes.c_longlong
    with torch.cuda.device(device):
        n = fn(*dims)
    if n < 0:
        raise RuntimeError(f"{entry}: no CUDA device")
    return n


def _launch_bwd(entry, x, scale, bias, w1, b1, w2, a, g, fs=None):
    """Kernel 8 (``a`` None: fc1 recomputed from ``b1``), kernel 7 (the bf16
    stash ``a``) or, with a slab width ``fs``, kernel 9 on CUDA tensors;
    allocates the scratch (its (B·N, ·) buffers one slab wide; kernel 7's
    fp32 da too) and the outputs."""
    B, N, D = x.shape
    F = w1.shape[1]
    M = B * N
    w = fs or F
    parts = -(-M // ROWS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y, dy = torch.empty((M, D), **bf), torch.empty((M, D), **f32)
    da_c, h_c = torch.empty((M, w), **bf), torch.empty((M, w), **bf)
    part = torch.empty(parts * (w + 3 * D), **f32)
    dx = torch.empty_like(x)
    dscale, dbias, db2 = (torch.empty(D, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.empty((D, F), **bf), torch.empty(F, **f32), torch.empty((F, D), **bf)
    if a is None:
        ws = torch.empty(max(_split_ws("mlp_block_bwd", "sky_mlp_block_bwd_ws", x.device.index,
                                       M, D, F, w), 4), **f32)
        scratch = (x, scale, bias, w1, b1, w2, g, y, da_c, h_c, dy, part, ws)
    else:
        ws = torch.empty(MAX_SPLITS * D * F, **f32)
        da = torch.empty((M, F), **f32)
        scratch = (x, scale, bias, w1, w2, a, g, y, da, da_c, h_c, dy, part, ws)
    ptrs = [t.data_ptr() for t in (*scratch, dx, dscale, dbias, dw1, db1, dw2, db2)]
    ints = (M, D, F) if fs is None else (M, D, F, fs)
    with torch.cuda.device(x.device):
        err = _entry("mlp_block_bwd", entry, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return dx, dscale, dbias, dw1, db1, dw2, db2


def mlp_block_bwd(x, scale, bias, w1, b1, w2, g):
    """Kernel 8: the gradients of the block from x and the output gradient
    ``g`` (see :func:`mlp_block_bwd_plain` for the outputs). CPU tensors take
    the plain version; CUDA tensors launch ``csrc/mlp_block_bwd.cu`` or raise."""
    if x.device.type == "cpu":
        return mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g)
    _check_cuda_args(x, scale, bias, w1, b1, w2)
    _check_g(x, g)
    grads = _launch_bwd("sky_mlp_block_bwd", x, scale, bias, w1, b1, w2, None, g)
    mlp_block_bwd.launches += 1
    return grads


mlp_block_bwd.launches = 0


def mlp_block_bwd_stash(x, scale, bias, w1, w2, a, g):
    """Kernel 7: the gradients of the block from x, the bf16 stash ``a``
    (B·N, F) of kernel 6 and the output gradient ``g`` (outputs as
    :func:`mlp_block_bwd_stash_plain`). CPU tensors take the plain version;
    CUDA tensors launch ``csrc/mlp_block_bwd.cu`` (stash entry) or raise."""
    if x.device.type == "cpu":
        return mlp_block_bwd_stash_plain(x, scale, bias, w1, w2, a, g)
    _check_cuda_args(x, scale, bias, w1, None, w2)
    _check_g(x, g)
    M, F = x.shape[0] * x.shape[1], w1.shape[1]
    if tuple(a.shape) != (M, F) or a.dtype != torch.bfloat16 or not a.is_contiguous() \
            or a.device != x.device:
        raise ValueError(f"a: want a contiguous {(M, F)} bf16 tensor on {x.device}, "
                         f"got {tuple(a.shape)} {a.dtype} on {a.device}")
    grads = _launch_bwd("sky_mlp_block_bwd_stash", x, scale, bias, w1, None, w2, a, g)
    mlp_block_bwd_stash.launches += 1
    return grads


mlp_block_bwd_stash.launches = 0


def mlp_block_bwd_stream(x, scale, bias, w1, b1, w2, g):
    """Kernel 9: the gradients of the block (outputs as
    :func:`mlp_block_bwd_plain`) over :func:`_stream_slab`'s column slabs.
    With one slab it is kernel 8 (:func:`mlp_block_bwd`, counted there), as
    JAX dispatches (mlp_block.py:544-549). Otherwise CPU tensors take
    :func:`mlp_block_bwd_stream_plain` and CUDA tensors launch
    ``csrc/mlp_block_bwd.cu`` (stream entry) or raise."""
    D, F = x.shape[-1], w1.shape[1]
    fs = _stream_slab(D, F)
    if F % fs:
        raise ValueError(f"stream slab {fs} does not divide F={F}")
    if fs == F:
        return mlp_block_bwd(x, scale, bias, w1, b1, w2, g)
    if x.device.type == "cpu":
        return mlp_block_bwd_stream_plain(x, scale, bias, w1, b1, w2, g)
    _check_cuda_args(x, scale, bias, w1, b1, w2)
    _check_g(x, g)
    if fs % 8:
        raise ValueError(f"stream slab {fs} must be a multiple of 8 (16-byte loads)")
    grads = _launch_bwd("sky_mlp_block_bwd_stream", x, scale, bias, w1, b1, w2, None, g, fs)
    mlp_block_bwd_stream.launches += 1
    return grads


mlp_block_bwd_stream.launches = 0


class MlpBlockFn(torch.autograd.Function):
    """K1 forward, kernel 8 backward or, with ``stream``, kernel 9 (JAX
    ``fused_mlp_block`` with ``stash=False`` or ``"stream"``: only the
    inputs are saved). ``plain`` runs the plain versions on any device: the
    reference path a check on the card holds the kernels against."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, plain, stream):
        if plain or x.device.type == "cpu":
            out = mlp_block_plain(x, scale, bias, w1, b1, w2, b2)
        else:
            out = _launch_fwd(x, scale, bias, w1, b1, w2, b2)[0]
        ctx.save_for_backward(x, scale, bias, w1, b1, w2)
        ctx.plain, ctx.stream = plain, stream
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2 = ctx.saved_tensors
        if ctx.stream:
            bwd = mlp_block_bwd_stream_plain if ctx.plain else mlp_block_bwd_stream
        else:
            bwd = mlp_block_bwd_plain if ctx.plain else mlp_block_bwd
        return (*bwd(x, scale, bias, w1, b1, w2, g.contiguous()), None, None)


class MlpBlockStashFn(torch.autograd.Function):
    """Kernel 6 forward, kernel 7 backward (JAX ``fused_mlp_block`` with
    ``stash=True``: x, the weights and the bf16 pre-activation ``a`` are
    saved). ``plain`` runs the plain versions of both on any device."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, plain):
        fwd = mlp_block_fwd_stash_plain if plain else mlp_block_fwd_stash
        out, a = fwd(x, scale, bias, w1, b1, w2, b2)
        ctx.save_for_backward(x, scale, bias, w1, w2, a)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, w2, a = ctx.saved_tensors
        bwd = mlp_block_bwd_stash_plain if ctx.plain else mlp_block_bwd_stash
        return (*bwd(x, scale, bias, w1, w2, a, g.contiguous()), None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, stash: bool | str = False,
                    plain: bool = False):
    """(B, N, D) -> (B, N, D). Without grad: CPU tensors (or ``plain``) take
    :func:`mlp_block_plain`, CUDA tensors launch K1 or raise. With grad, the
    call goes through :class:`MlpBlockFn` (K1 forward, kernel 8 backward;
    kernel 9 with ``stash="stream"``) or, with ``stash=True``,
    :class:`MlpBlockStashFn` (kernels 6 and 7)."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if not _needs_grad(*args):
        if plain or x.device.type == "cpu":
            return mlp_block_plain(*args)
        return _launch_fwd(*args)[0]
    if stash == "stream":
        return MlpBlockFn.apply(*args, plain, True)
    if stash:
        return MlpBlockStashFn.apply(*args, plain)
    return MlpBlockFn.apply(*args, plain, False)


fused_mlp_block.launches = 0
