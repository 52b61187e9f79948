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
``sky_mlp_block_fwd_stash``); kernel 7 is kernel 8 with the dual product
replaced by the stash dh product, ``dh = g @ W2ᵀ`` with an epilogue that
reads the tile of the bf16 ``a`` in place of computing it
(``csrc/mlp_block_bwd.cu`` entry ``sky_mlp_block_bwd_stash``).
:class:`MlpBlockStashFn` pairs them.

What bounds them on the H100: tensor-core FLOPs (4·M·D·F forward, 10·M·D·F
backward, 8·M·D·F for kernel 7, at M = B·65 rows), not bytes. Every
kernel here runs every product on the persistent wgmma + TMA GEMM of
``csrc/gemm_sm90.cuh`` (the backwards through its K-major-B and
transposed-A forms); the fc1 erf-GELU epilogues still run while the tensor
cores wait. h, da_c and h_c go through device memory in bf16 at the TPU
kernel's rounding points; no fp32 (B·N, F) array does.

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

fp32 forms (the fp32 configs: JAX sends fp32 blocks to ``xla_mlp_block``,
``models/layers.py:253``): every kernel here also takes a uniform fp32 set
(x, w1, w2 and kernel 6's stash fp32; LN parameters and biases fp32 as
always), computing what the plain versions compute in fp32 (nothing
rounded, exact-erf GELU and GELU', kernel 6's ``a`` kept in fp32 as JAX's
fp32 autodiff keeps it) with every product on the 3xTF32 GEMM of
``csrc/gemm_f32.cuh``: the bf16 entry's name with ``_f32`` at the end and
the bf16 entry's arguments (``csrc/mlp_block.cu``, ``csrc/mlp_block_bwd.cu``,
where kernels 8, 7 and 9's fp32 forms are one slab loop). Their launches
also count on each wrapper's ``f32_launches``. :func:`operand_dtype` holds
the rule: bf16 or fp32, one dtype for x, the weights and the stash.
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
    rounding points of ``_bwd_kernel`` / ``_bwd_stash_kernel``:
    :func:`_mlp_bwd_local`, then :func:`tp_bwd_finish_plain`."""
    dy, dw1, db1, dw2 = _mlp_bwd_local(x, scale, bias, w1, w2, a, g)
    dx, dscale, dbias, db2 = tp_bwd_finish_plain(x, scale, bias, g, dy)
    return dx, dscale, dbias, dw1, db1, dw2, db2


def _mlp_bwd_local(x, scale, bias, w1, w2, a, g):
    """The MLP backward up to the fp32 gradient ``dy`` (M, D) of the LN
    output: ``(dy, dw1, db1, dw2)``. On a tensor-parallel rank's column
    block (w1 (D, F_r), w2 (F_r, D), its ``a`` (M, F_r)) ``dy`` is the
    rank's partial, which the ranks sum."""
    D = x.shape[-1]
    g2 = g.reshape(-1, D).float()
    y = _ln_forward(x.reshape(-1, D).float(), scale, bias)[0]
    y_c = y.to(w1.dtype)
    h_c = gelu(a).to(w2.dtype)
    g_c = g2.to(w2.dtype)
    dh = _dot(g_c, w2.t())
    da = dh * gelu_grad(a)
    da_c = da.to(w1.dtype)
    dy = _dot(da_c, w1.t())
    return dy, _dot(y_c.t(), da_c).to(w1.dtype), da.sum(0), _dot(h_c.t(), g_c).to(w2.dtype)


def tp_finish_plain(x, part, bias):
    """The tensor-parallel blocks' finish after the all-reduce (plain
    version of ``sky_attn_block_tp_finish`` / ``sky_mlp_block_tp_finish``):
    ``x + (part + bias)`` in fp32, cast to x's dtype, the order of the whole
    blocks' fused epilogue. ``part`` is the fp32 sum of the ranks' partial
    proj (fc2) products."""
    return (x.float() + (part.reshape(x.shape) + bias)).to(x.dtype)


def tp_bwd_finish_plain(x, scale, bias, g, dy):
    """What the blocks' backward computes from the whole fp32 ``dy`` (M, D)
    (plain version of the ``*_tp_bwd_finish`` entries): the LN backward
    with the residual gradient and the output bias's gradient, ``(dx,
    dscale, dbias, dbout)``; every block's backward ends with it, and a
    tensor-parallel one runs it after the all-reduce of the ranks' ``dy``."""
    D = x.shape[-1]
    g2 = g.reshape(-1, D).float()
    _, xhat, rstd = _ln_forward(x.reshape(-1, D).float(), scale, bias)
    dx, dscale, dbias = _ln_backward(g2, dy, xhat, rstd, scale)
    return dx.to(x.dtype).reshape(x.shape), dscale, dbias, g2.sum(0)


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


# the block kernels, every one with an fp32 form on CUDA beside its bf16
# one: attention blocks K2 and kernels 2, 3, 4 and the seg_len forms of K2,
# 2 and 4; MLP blocks K1 and kernels 6, 7, 8, 9; the tensor-parallel forms
# of K1, K2, 4 and 8 (and of K2 and 4 with seg_len)
F32_KERNELS = ("K1", "K2", "kernel 2", "kernel 3", "kernel 4", "kernel 6", "kernel 7",
               "kernel 8", "kernel 9", "K2 masked", "kernel 2 masked", "kernel 4 masked",
               "K1 TP", "K2 TP", "kernel 4 TP", "kernel 8 TP", "K2 TP masked",
               "kernel 4 TP masked")


def operand_dtype(kernel: str, x: torch.Tensor, **operands) -> torch.dtype:
    """The operand dtype of a block kernel's CUDA launch: x's, bf16 or fp32,
    which the weights and the stash in ``operands`` (None skipped) share;
    LN parameters and biases are fp32 either way. ``kernel`` names one of
    :data:`F32_KERNELS` ("K1", "kernel 6", "kernel 2 masked", ...). Raises
    ``ValueError`` for another dtype and for a mixed set (fp32 x with bf16
    weights). Reads dtypes only: it loads no library and takes CPU tensors
    too."""
    if kernel not in F32_KERNELS:
        raise ValueError(f"{kernel!r} is none of the block kernels {F32_KERNELS}")
    dt = x.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} on CUDA takes bf16 or fp32 operands, got {dt} x")
    for name, t in operands.items():
        if t is not None and t.dtype != dt:
            raise ValueError(f"{name}: {t.dtype} beside {dt} x; {kernel} on CUDA takes bf16 or "
                             "fp32 operands, all of one dtype")
    return dt


def _check_cuda_args(x, scale, bias, w1, b1, w2, b2=None, *, kernel: str):
    """Checks a CUDA launch of ``kernel``'s arguments; returns the operand
    dtype (:func:`operand_dtype`)."""
    dt = operand_dtype(kernel, x, w1=w1, w2=w2)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, D) tensor")
    D = x.shape[-1]
    F = w1.shape[-1]
    want = {
        "scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
        "w1": (w1, (D, F), dt), "b1": (b1, (F,), torch.float32),
        "w2": (w2, (F, D), dt), "b2": (b2, (D,), torch.float32),
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
    return dt


def _f32(entry: str, dt: torch.dtype) -> str:
    """The C entry of the operand dtype: the bf16 one, or its fp32 form."""
    return entry + "_f32" if dt == torch.float32 else entry


def _launch_fwd(x, scale, bias, w1, b1, w2, b2, stash: bool = False):
    """K1 (counted on ``fused_mlp_block.launches``) or, with ``stash``,
    kernel 6 (counted on ``mlp_block_fwd_stash.launches``) on CUDA tensors,
    each in bf16 or, for fp32 operands, its fp32 form (also counted on the
    wrapper's ``.f32_launches``): ``(out, a)``, ``a`` (B·N, F) in the
    operand dtype, None without the stash."""
    dt = _check_cuda_args(x, scale, bias, w1, b1, w2, b2, kernel="kernel 6" if stash else "K1")
    B, N, D = x.shape
    F = w1.shape[1]
    h = torch.empty((B * N, F), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, scale, bias, w1, b1, w2, b2, h)]
    a = None
    if stash:
        a = torch.empty((B * N, F), dtype=dt, device=x.device)
        ptrs.append(a.data_ptr())
    entry = _f32("sky_mlp_block_fwd_stash" if stash else "sky_mlp_block_fwd", dt)
    with torch.cuda.device(x.device):
        err = _entry("mlp_block", entry, len(ptrs) + 1)(
            *ptrs, out.data_ptr(), B * N, D, F, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    counted = mlp_block_fwd_stash if stash else fused_mlp_block
    counted.launches += 1
    counted.f32_launches += int(dt == torch.float32)
    return out, a


def mlp_block_fwd_stash(x, scale, bias, w1, b1, w2, b2):
    """Kernel 6: ``(out, a)`` as :func:`mlp_block_fwd_stash_plain`. CPU
    tensors take the plain version; CUDA tensors launch ``csrc/mlp_block.cu``
    (stash entry, its fp32 form for fp32 operands) or raise."""
    if x.device.type == "cpu":
        return mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, b2)
    return _launch_fwd(x, scale, bias, w1, b1, w2, b2, stash=True)


mlp_block_fwd_stash.launches = 0
mlp_block_fwd_stash.f32_launches = 0


def _check_g(x, g):
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"g: want a contiguous {tuple(x.shape)} {x.dtype} tensor on {x.device}")


@functools.lru_cache(maxsize=64)
def _split_ws(lib: str, entry: str, device: int, *dims: int) -> int:
    """fp32 floats of split-K workspace a backward's weight-gradient group
    needs: what the C plan says for this card, through ``entry`` of
    ``lib`` (``sky_mlp_block_bwd_ws(M, D, F, fs)``: kernels 8 and 7 with
    ``fs = F``, or 9; ``sky_attn_block_bwd_ws(M, D)``: kernels 3 and 4;
    ``..._f32_ws``: their fp32 forms)."""
    fn = getattr(cuda_build.load(lib), entry)
    fn.argtypes = [ctypes.c_int] * len(dims)
    fn.restype = ctypes.c_longlong
    with torch.cuda.device(device):
        n = fn(*dims)
    if n < 0:
        raise RuntimeError(f"{entry}: no CUDA device")
    return n


SCRATCH_ALIGN = 256  # bytes between the pieces of one scratch allocation


@functools.lru_cache(maxsize=64)
def scratch_layout(sizes: tuple[int, ...]) -> tuple[int, tuple[int, ...]]:
    """(bytes, offsets) of pieces of ``sizes`` bytes carved from one
    allocation, each SCRATCH_ALIGN-aligned (the TMA maps and the stream-K
    slots want 16): the TP backward halves take their scratch so, in one
    ``torch.empty`` a call."""
    offs, n = [], 0
    for size in sizes:
        offs.append(n)
        n += -(-max(size, 4) // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return n, tuple(offs)


def _launch_bwd(entry, dt, x, scale, bias, w1, b1, w2, a, g, fs=None):
    """Kernel 8 (``a`` None: fc1 recomputed from ``b1``), kernel 7 (the stash
    ``a``) or, with a slab width ``fs``, kernel 9 on CUDA tensors, each in
    the operand dtype ``dt`` (bf16, or its fp32 form); allocates the scratch
    (y (B·N, D) and da, h (B·N, fs) in ``dt``, dy fp32) and the outputs."""
    B, N, D = x.shape
    F = w1.shape[1]
    M = B * N
    w = fs or F
    parts = -(-M // ROWS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=x.device)
    op = dict(dtype=dt, device=x.device)
    y, dy = torch.empty((M, D), **op), torch.empty((M, D), **f32)
    da, h = torch.empty((M, w), **op), torch.empty((M, w), **op)
    part = torch.empty(parts * (w + 3 * D), **f32)
    dx = torch.empty_like(x)
    dscale, dbias, db2 = (torch.empty(D, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.empty((D, F), **op), torch.empty(F, **f32), torch.empty((F, D), **op)
    ws_entry = _f32("sky_mlp_block_bwd", dt) + "_ws"
    ws = torch.empty(max(_split_ws("mlp_block_bwd", ws_entry, x.device.index, M, D, F, w), 4),
                     **f32)
    inputs = (x, scale, bias, w1, b1, w2) if a is None else (x, scale, bias, w1, w2, a)
    scratch = (*inputs, g, y, da, h, dy, part, ws)
    ptrs = [t.data_ptr() for t in (*scratch, dx, dscale, dbias, dw1, db1, dw2, db2)]
    ints = (M, D, F) if fs is None else (M, D, F, fs)
    entry = _f32(entry, dt)
    with torch.cuda.device(x.device):
        err = _entry("mlp_block_bwd", entry, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return dx, dscale, dbias, dw1, db1, dw2, db2


def mlp_block_bwd(x, scale, bias, w1, b1, w2, g):
    """Kernel 8: the gradients of the block from x and the output gradient
    ``g`` (see :func:`mlp_block_bwd_plain` for the outputs). CPU tensors take
    the plain version; CUDA tensors launch ``csrc/mlp_block_bwd.cu`` (its
    fp32 form for fp32 operands, also counted on ``.f32_launches``) or
    raise."""
    if x.device.type == "cpu":
        return mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g)
    dt = _check_cuda_args(x, scale, bias, w1, b1, w2, kernel="kernel 8")
    _check_g(x, g)
    grads = _launch_bwd("sky_mlp_block_bwd", dt, x, scale, bias, w1, b1, w2, None, g)
    mlp_block_bwd.launches += 1
    mlp_block_bwd.f32_launches += int(dt == torch.float32)
    return grads


mlp_block_bwd.launches = 0
mlp_block_bwd.f32_launches = 0


def mlp_block_bwd_stash(x, scale, bias, w1, w2, a, g):
    """Kernel 7: the gradients of the block from x, the stash ``a`` (B·N, F)
    of kernel 6 (bf16, or fp32 for fp32 operands) and the output gradient
    ``g`` (outputs as :func:`mlp_block_bwd_stash_plain`). CPU tensors take
    the plain version; CUDA tensors launch ``csrc/mlp_block_bwd.cu`` (stash
    entry, its fp32 form also counted on ``.f32_launches``) or raise."""
    if x.device.type == "cpu":
        return mlp_block_bwd_stash_plain(x, scale, bias, w1, w2, a, g)
    dt = _check_cuda_args(x, scale, bias, w1, None, w2, kernel="kernel 7")
    _check_g(x, g)
    M, F = x.shape[0] * x.shape[1], w1.shape[1]
    if tuple(a.shape) != (M, F) or a.dtype != dt or not a.is_contiguous() \
            or a.device != x.device:
        raise ValueError(f"a: want a contiguous {(M, F)} {dt} tensor on {x.device}, "
                         f"got {tuple(a.shape)} {a.dtype} on {a.device}")
    grads = _launch_bwd("sky_mlp_block_bwd_stash", dt, x, scale, bias, w1, None, w2, a, g)
    mlp_block_bwd_stash.launches += 1
    mlp_block_bwd_stash.f32_launches += int(dt == torch.float32)
    return grads


mlp_block_bwd_stash.launches = 0
mlp_block_bwd_stash.f32_launches = 0


def mlp_block_bwd_stream(x, scale, bias, w1, b1, w2, g):
    """Kernel 9: the gradients of the block (outputs as
    :func:`mlp_block_bwd_plain`) over :func:`_stream_slab`'s column slabs.
    With one slab it is kernel 8 (:func:`mlp_block_bwd`, counted there), as
    JAX dispatches (mlp_block.py:544-549). Otherwise CPU tensors take
    :func:`mlp_block_bwd_stream_plain` and CUDA tensors launch
    ``csrc/mlp_block_bwd.cu`` (stream entry, its fp32 form also counted on
    ``.f32_launches``) or raise."""
    D, F = x.shape[-1], w1.shape[1]
    fs = _stream_slab(D, F)
    if F % fs:
        raise ValueError(f"stream slab {fs} does not divide F={F}")
    if fs == F:
        return mlp_block_bwd(x, scale, bias, w1, b1, w2, g)
    if x.device.type == "cpu":
        return mlp_block_bwd_stream_plain(x, scale, bias, w1, b1, w2, g)
    dt = _check_cuda_args(x, scale, bias, w1, b1, w2, kernel="kernel 9")
    _check_g(x, g)
    if fs % 8:
        raise ValueError(f"stream slab {fs} must be a multiple of 8 (16-byte loads)")
    grads = _launch_bwd("sky_mlp_block_bwd_stream", dt, x, scale, bias, w1, b1, w2, None, g, fs)
    mlp_block_bwd_stream.launches += 1
    mlp_block_bwd_stream.f32_launches += int(dt == torch.float32)
    return grads


mlp_block_bwd_stream.launches = 0
mlp_block_bwd_stream.f32_launches = 0


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
    ``stash=True``: x, the weights and the pre-activation ``a``, in the
    operand dtype, are saved). ``plain`` runs the plain versions of both on any device."""

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
fused_mlp_block.f32_launches = 0  # those of the launches in fp32


# ---- the tensor-parallel forms of K1 and kernel 8 ------------------------------
#
# A rank holds the contiguous column block F_r = F / tp of W1 and b1 and the
# same rows of W2 (parallel/sharding.py). Each form is split at the
# all-reduce over the model group: the rank's half writes an fp32 partial
# (the forward's fc2 product, the backward's dy), the caller sums the
# partials over the ranks (torch.distributed.all_reduce, or a plain sum
# where one process holds every rank's shard), and the finish runs on the
# sum. Forward: ``sky_mlp_block_tp_fwd`` then ``sky_mlp_block_tp_finish``
# (``csrc/mlp_block.cu``); backward: ``sky_mlp_block_tp_bwd`` (kernel 8's
# slab loop over the rank's columns, stopping before the LN backward) then
# ``sky_mlp_block_tp_bwd_finish`` (``csrc/mlp_block_bwd.cu``). Each has its
# fp32 form. The finishes count on the form's ``finish_launches``.


def layernorm_cuda(x, scale, bias, held: bool) -> torch.Tensor:
    """One bf16 LN launch over x's rows (``sky_layernorm_bf16``): the row held
    in registers (``held``: the TP forms' LN, D <= 1 280) or read once a
    pass (the whole blocks'); the check that compares their bits takes it."""
    if x.dtype != torch.bfloat16 or x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 CUDA tensor")
    if held:
        check_ln_held(x)
    y = torch.empty_like(x)
    D = x.shape[-1]
    fn = cuda_build.load("mlp_block").sky_layernorm_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // D,
                 D, int(held), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_layernorm_bf16")
    return y


def mlp_block_tp_fwd_plain(x, scale, bias, w1, b1, w2):
    """Plain version of K1's TP form's rank half: the fp32 partial (B, N, D)
    of fc2 over the rank's columns, before b2 and the residual."""
    y = layer_norm(x.float(), scale, bias)
    a = _dot(y.to(w1.dtype), w1) + b1
    return _dot(gelu(a).to(w2.dtype), w2)


def mlp_block_tp_bwd_plain(x, scale, bias, w1, b1, w2, g):
    """Plain version of kernel 8's TP form's rank half: ``(dy, dw1, db1,
    dw2)``, dy (B·N, D) the rank's fp32 partial of the LN output's
    gradient, at kernel 8's rounding points."""
    y = layer_norm(x.reshape(-1, x.shape[-1]).float(), scale, bias)
    return _mlp_bwd_local(x, scale, bias, w1, w2, _dot(y.to(w1.dtype), w1) + b1, g)


def _check_finish(x, part, out_bias):
    M, D = x.shape[0] * x.shape[1], x.shape[-1]
    want = {"part": (part, (M, D), torch.float32), "bias": (out_bias, (D,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.numel() != math.prod(shape):  # part as (B, N, D) or (B·N, D)
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous {dtype} tensor on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous() or D % 8:
        raise ValueError("x must be a contiguous bf16 or fp32 (B, N, D) tensor with D % 8 == 0")


def _finish(lib: str, entry: str, x, part, out_bias):
    """``x + (part + out_bias)`` by ``entry`` of ``lib`` (or its fp32 form)."""
    _check_finish(x, part, out_bias)
    out = torch.empty_like(x)
    entry = _f32(entry, x.dtype)
    with torch.cuda.device(x.device):
        err = _entry(lib, entry, 4, 2)(x.data_ptr(), part.data_ptr(), out_bias.data_ptr(),
                                       out.data_ptr(), x.shape[0] * x.shape[1], x.shape[-1],
                                       torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return out


def mlp_block_tp_fwd(x, scale, bias, w1, b1, w2):
    """K1's TP form, the rank's half: the fp32 partial (B, N, D) as
    :func:`mlp_block_tp_fwd_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``sky_mlp_block_tp_fwd`` (its fp32 form for fp32
    operands, also counted on ``.f32_launches``) or raise. The partial and
    the h (B·N, F_r) scratch are carved from one allocation."""
    if x.device.type == "cpu":
        return mlp_block_tp_fwd_plain(x, scale, bias, w1, b1, w2)
    check_ln_held(x)
    dt = _check_cuda_args(x, scale, bias, w1, b1, w2, kernel="K1 TP")  # at the local F_r
    B, N, D = x.shape
    F = w1.shape[1]
    M = B * N
    nbytes, offs = scratch_layout((M * D * 4, M * F * x.element_size()))
    base = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    part = base[:M * D * 4].view(torch.float32).view(B, N, D)
    entry = _f32("sky_mlp_block_tp_fwd", dt)
    with torch.cuda.device(x.device):
        err = _entry("mlp_block", entry, 8)(
            *(t.data_ptr() for t in (x, scale, bias, w1, b1, w2)), base.data_ptr() + offs[1],
            part.data_ptr(), M, D, F, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    mlp_block_tp_fwd.launches += 1
    mlp_block_tp_fwd.f32_launches += int(dt == torch.float32)
    return part


mlp_block_tp_fwd.launches = 0
mlp_block_tp_fwd.f32_launches = 0
mlp_block_tp_fwd.finish_launches = 0


def mlp_block_tp_finish(x, part, b2):
    """K1's TP form after the all-reduce: ``out = x + (part + b2)`` in x's
    dtype (:func:`tp_finish_plain` for CPU tensors; CUDA tensors launch
    ``sky_mlp_block_tp_finish``, counted on
    ``mlp_block_tp_fwd.finish_launches``)."""
    if x.device.type == "cpu":
        return tp_finish_plain(x, part, b2)
    out = _finish("mlp_block", "sky_mlp_block_tp_finish", x, part, b2)
    mlp_block_tp_fwd.finish_launches += 1
    return out


def mlp_block_tp_bwd(x, scale, bias, w1, b1, w2, g):
    """Kernel 8's TP form, the rank's half: ``(dy, dw1, db1, dw2)`` as
    :func:`mlp_block_tp_bwd_plain`, over one slab of the rank's F_r
    columns (kernel 8's form: it takes every local width of the shipped
    configs, ViT-H's F_r = 2 560 at tp = 2 included). CPU tensors take the
    plain version; CUDA tensors launch ``sky_mlp_block_tp_bwd`` (its fp32
    form also counted on ``.f32_launches``) or raise."""
    if x.device.type == "cpu":
        return mlp_block_tp_bwd_plain(x, scale, bias, w1, b1, w2, g)
    dt = _check_cuda_args(x, scale, bias, w1, b1, w2, kernel="kernel 8 TP")
    _check_g(x, g)
    check_ln_held(x)
    B, N, D = x.shape
    F = w1.shape[1]
    M = B * N
    es = x.element_size()
    f32 = dict(dtype=torch.float32, device=x.device)
    op = dict(dtype=dt, device=x.device)
    # the scratch (y (M, D); da_c, h_c (M, F); part; ws) from one allocation
    n_ws = _split_ws("mlp_block_bwd", _f32("sky_mlp_block_bwd", dt) + "_ws", x.device.index,
                     M, D, F, F)
    nbytes, offs = scratch_layout((M * D * es, M * F * es, M * F * es,
                                   -(-M // ROWS_PER_PARTIAL) * (F + 3 * D) * 4, n_ws * 4))
    base = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    y, da, h, part, ws = (base.data_ptr() + o for o in offs)
    dy = torch.empty((M, D), **f32)
    dw1, db1, dw2 = torch.empty((D, F), **op), torch.empty(F, **f32), torch.empty((F, D), **op)
    ptrs = [*(t.data_ptr() for t in (x, scale, bias, w1, b1, w2, g)), y, da, h,
            dy.data_ptr(), part, ws, *(t.data_ptr() for t in (dw1, db1, dw2))]
    entry = _f32("sky_mlp_block_tp_bwd", dt)
    with torch.cuda.device(x.device):
        err = _entry("mlp_block_bwd", entry, len(ptrs), 4)(
            *ptrs, M, D, F, F, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    mlp_block_tp_bwd.launches += 1
    mlp_block_tp_bwd.f32_launches += int(dt == torch.float32)
    return dy, dw1, db1, dw2


mlp_block_tp_bwd.launches = 0
mlp_block_tp_bwd.f32_launches = 0
mlp_block_tp_bwd.finish_launches = 0


# the widest row the bf16 TP forms' LN and LN backward hold in registers
# (csrc/common.cuh LN_REG_CHUNKS * 256: ViT-H's 1 280)
LN_HELD_MAX = 5 * 256


def check_ln_held(x) -> None:
    """Refuse a bf16 row wider than the TP forms' LN holds (before any
    library loads)."""
    if x.dtype == torch.bfloat16 and x.shape[-1] > LN_HELD_MAX:
        raise ValueError(f"D={x.shape[-1]}: the bf16 TP forms hold LN rows of at most "
                         f"{LN_HELD_MAX} elements in registers")


def _bwd_finish(lib: str, entry: str, x, scale, bias, g, dy):
    """``(dx, dscale, dbias, dbout)`` of :func:`tp_bwd_finish_plain` by
    ``entry`` of ``lib`` (or its fp32 form) on CUDA tensors."""
    B, N, D = x.shape
    M = B * N
    _check_g(x, g)
    check_ln_held(x)
    if tuple(dy.shape) != (M, D) or dy.dtype != torch.float32 or not dy.is_contiguous():
        raise ValueError(f"dy: want a contiguous {(M, D)} fp32 tensor, got {tuple(dy.shape)}")
    if tuple(scale.shape) != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"scale: want ({D},) fp32")
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(-(-M // ROWS_PER_PARTIAL) * 3 * D, **f32)
    dx = torch.empty_like(x)
    dscale, dbias, dbout = (torch.empty(D, **f32) for _ in range(3))
    entry = _f32(entry, x.dtype)
    ptrs = [t.data_ptr() for t in (x, scale, g, dy, part, dx, dscale, dbias, dbout)]
    with torch.cuda.device(x.device):
        err = _entry(lib, entry, len(ptrs), 2)(*ptrs, M, D, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return dx, dscale, dbias, dbout


def mlp_block_tp_bwd_finish(x, scale, bias, g, dy):
    """Kernel 8's TP form after the all-reduce of ``dy``: ``(dx, dscale,
    dbias, db2)`` (:func:`tp_bwd_finish_plain` for CPU tensors; CUDA
    tensors launch ``sky_mlp_block_tp_bwd_finish``, counted on
    ``mlp_block_tp_bwd.finish_launches``)."""
    if x.device.type == "cpu":
        return tp_bwd_finish_plain(x, scale, bias, g, dy)
    grads = _bwd_finish("mlp_block_bwd", "sky_mlp_block_tp_bwd_finish", x, scale, bias, g, dy)
    mlp_block_tp_bwd.finish_launches += 1
    return grads


class MlpBlockTPFn(torch.autograd.Function):
    """K1's TP form forward, kernel 8's TP form backward, each split at the
    all-reduce that ``reduce`` (an in-place sum of an fp32 tensor over the
    model group) runs: only the inputs are saved, as :class:`MlpBlockFn`
    saves them. Under ``torch.utils.checkpoint`` the forward, and with it
    its all-reduce, runs again in the backward, in the same order on every
    rank. ``plain`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, reduce, plain):
        part = (mlp_block_tp_fwd_plain if plain else mlp_block_tp_fwd)(x, scale, bias, w1, b1, w2)
        reduce(part)
        ctx.save_for_backward(x, scale, bias, w1, b1, w2)
        ctx.reduce, ctx.plain = reduce, plain
        return (tp_finish_plain if plain else mlp_block_tp_finish)(x, part, b2)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2 = ctx.saved_tensors
        g = g.contiguous()
        dy, dw1, db1, dw2 = (mlp_block_tp_bwd_plain if ctx.plain else mlp_block_tp_bwd)(
            x, scale, bias, w1, b1, w2, g)
        ctx.reduce(dy)
        dx, dscale, dbias, db2 = (tp_bwd_finish_plain if ctx.plain else mlp_block_tp_bwd_finish)(
            x, scale, bias, g, dy)
        return dx, dscale, dbias, dw1, db1, dw2, db2, None, None


def fused_mlp_block_tp(x, scale, bias, w1, b1, w2, b2, reduce, plain: bool = False):
    """A tensor-parallel rank's MLP block, (B, N, D) -> (B, N, D): its
    column block of W1 / b1 and rows of W2 (``b2`` and the LN whole), the
    partials summed by ``reduce``. Without grad the two halves run with the
    all-reduce between them; with grad the call goes through
    :class:`MlpBlockTPFn`."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if not _needs_grad(*args):
        part = (mlp_block_tp_fwd_plain if plain else mlp_block_tp_fwd)(x, scale, bias, w1, b1, w2)
        reduce(part)
        return (tp_finish_plain if plain else mlp_block_tp_finish)(x, part, b2)
    return MlpBlockTPFn.apply(*args, reduce, plain)
