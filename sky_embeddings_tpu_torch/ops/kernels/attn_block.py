"""Attention block ``x + MHA(LN(x)·Wqkv + bqkv)·Wproj + bproj``, forward and
backward.

Four kernels, all in CUDA C++:

- K2, the primal forward: replaces the TPU kernel
  ``sky_embeddings_tpu/ops/kernels/attn_block.py`` ``_pallas_fwd``
  (``_fwd_kernel`` / ``_fwd_kernel_loop``).
  ``csrc/attn_block.cu`` entry ``sky_attn_block_fwd``: LN, qkv GEMM, the
  attention core of ``csrc/attn_core.cuh`` (``mma.sync`` with S and P in
  registers, CTAs walking (sample, head) pairs through a cp.async ring),
  then proj GEMM + residual; both GEMMs on ``csrc/gemm_sm90.cuh``.
- Kernel 2, the stash forward: replaces ``_pallas_fwd_stash``. The same
  launches (entry ``sky_attn_block_fwd_stash``), which also hand back qkv
  (B, N, 3D) and the softmax probabilities (B, H, N, N), bf16, in JAX's
  layout.
- Kernel 3, the stash backward: replaces ``_pallas_bwd_stash``.
  ``csrc/attn_block_bwd.cu`` entry ``sky_attn_block_bwd_stash``: dctx GEMM,
  a backward core per (sample, head) from the stashed qkv and probabilities
  (no qkv, logits or softmax recompute) that writes bf16 dqkv and each
  sample's fp32 column sums of it (dbqkv's partials), the dy GEMM, the
  dWqkv and dWproj GEMMs in one launch, LN backward, deterministic
  two-pass column sums.
- Kernel 4, the recompute backward: replaces ``_pallas_bwd`` (``_bwd_kernel``
  and ``_bwd_kernel_loop``). Entry ``sky_attn_block_bwd`` of the same file:
  kernel 3's launches behind the forward's LN and qkv GEMM; its core
  computes the logits and the fp32 softmax itself and keeps the fp32 P (for
  the softmax backward) beside the bf16 P (for ctx and dV).

:class:`AttnBlockStashFn` (kernels 2 and 3) is the ``torch.autograd.Function``
of the training default ``stash=True``; :class:`AttnBlockFn` (K2 and kernel
4) that of ``stash=False`` and remat, saving only the inputs. Inference
never writes the stash, as in JAX (``attn_block.py:1127-1131``).

What bounds them on the H100: tensor-core FLOPs of the GEMMs (8·M·D² forward,
16·M·D² stash backward, 22·M·D² recompute backward at M = B·N rows); the
cores add 4·B·H·N²·hd, 8·B·H·N²·hd and 10·B·H·N²·hd. Every product runs
on the wgmma + TMA GEMM of ``csrc/gemm_sm90.cuh``: the forwards' qkv and
proj and kernel 4's qkv recompute on its forward form, the backwards'
dctx and dy on its K-major-B form, dWqkv and dWproj together on its
transposed-A group. qkv, ctx and dqkv go through device memory in bf16 at
the points where the TPU kernels round them; no fp32 dqkv does.

Head dims: any multiple of 16 whose core fits a block's shared memory at
the given N. The check asks the CUDA source for its plan's bytes
(``sky_attn_fwd_plan_bytes``, ``sky_attn_bwd_plan_bytes``), so the wrapper
and the kernel cannot disagree; a backward plan shrinks its query blocks
and splits its output columns over CTAs before it gives up, a forward plan
drops its second ring slot, then Q. ViT-H's 80 fits every core up to
N = 256; at N = 256 the backward cores take up to 144, the forward up to
208, and 224 fits none.

Packed segments: ``seg_len > 0`` declares the N tokens to be N // seg_len
samples packed along the sequence (MAE sequence packing,
``models/mim.SkyMIM.encode``), and K2, kernel 2 and kernel 4 restrict
attention to the block diagonal, as JAX's ``_seg_bias`` does with a -1e9
logit bias: each softmax row runs over its own segment's keys and the
probabilities are exactly 0 elsewhere, in the stash too. Kernel 3 takes no
``seg_len``: the stashed probabilities carry the zeros. ``seg_len = 0`` or
``>= N`` means no mask. The plain versions add JAX's bias.

Numerics (kernel and plain versions alike): fp32 LN statistics, bf16 GEMM
operands with fp32 accumulation, qkv rounded to bf16 after its bias, fp32
logits scaled by hd^-0.5 and fp32 softmax, probs rounded to bf16 before the
PV product, ctx rounded to bf16, residual added in fp32 and cast to x's
dtype. Backward: dctx, ds and dqkv rounded to bf16 before the products that
take them, dbqkv summed from the fp32 dqkv (on the card per sample, then
over the samples), weight gradients cast to the weight dtype. The softmax
backward takes the stashed bf16 probabilities in kernel 3 and the
recomputed fp32 ones in kernel 4, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
    ROWS_PER_PARTIAL,
    _dot,
    _split_ws,
    _ln_backward,
    _ln_forward,
    _needs_grad,
)

MAX_TOKENS = 256  # the TPU kernel's dispatch bound (layers.py:341)
SMEM_PER_BLOCK = 232448  # dynamic shared memory a block may use, csrc/gemm.cuh SMEM_OPTIN_MAX


def _seg_bias(N: int, seg_len: int, device) -> torch.Tensor | None:
    """JAX ``_seg_bias``: the (N, N) fp32 logit bias of packed segments, 0
    within a segment and -1e9 across (exp underflows to exactly 0); None
    without a mask (``seg_len`` 0 or >= N)."""
    if not seg_len or seg_len >= N:
        return None
    ids = torch.arange(N, device=device) // seg_len
    return torch.where(ids[:, None] == ids[None, :], 0.0, -1e9)


def _qkv_probs(x, scale, bias, wqkv, bqkv, num_heads: int, seg_len: int = 0):
    """The forward up to the softmax: qkv (B, N, 3D) rounded to wqkv's dtype
    and the fp32 probabilities (B, H, N, N), masked to packed segments of
    ``seg_len`` tokens."""
    B, N, D = x.shape
    hd = D // num_heads
    y = _ln_forward(x.float(), scale, bias)[0]
    qkv = (_dot(y.to(wqkv.dtype), wqkv) + bqkv).to(wqkv.dtype)
    q, k, _ = qkv.reshape(B, N, 3, num_heads, hd).unbind(2)
    z = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * hd ** -0.5
    seg = _seg_bias(N, seg_len, x.device)
    if seg is not None:
        z = z + seg
    return qkv, torch.softmax(z, dim=-1)


def attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int,
                               seg_len: int = 0):
    """Plain version of the stash forward: ``(out, qkv, probs)``, qkv
    (B, N, 3D) and probs (B, H, N, N) in x's dtype; ``out`` is the JAX
    oracle ``xla_attn_block(..., seg_len)``."""
    B, N, D = x.shape
    qkv, probs = _qkv_probs(x, scale, bias, wqkv, bqkv, num_heads, seg_len)
    probs = probs.to(wqkv.dtype)
    v = qkv.reshape(B, N, 3, num_heads, D // num_heads)[:, :, 2]
    ctx = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float())
    out = _dot(ctx.reshape(B, N, D).to(wproj.dtype), wproj) + bproj
    return (x.float() + out).to(x.dtype), qkv.to(x.dtype), probs.to(x.dtype)


def attn_block_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int,
                     seg_len: int = 0):
    """Plain PyTorch version of the primal (CPU path and parity reference)."""
    return attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads,
                                      seg_len)[0]


def attn_bwd_core_plain(qkv, p_soft, p_c, dc, num_heads: int):
    """Plain version of the backward core that kernels 3 and 4 launch
    (``csrc/attn_core.cuh``): ``(dqkv, ctx)`` from qkv (B, N, 3D), the
    probabilities ``p_soft`` (fp32, B, H, N, N) that the softmax backward
    takes, ``p_c`` (their rounded values, upcast) that ctx and dV take, and
    the rounded dctx ``dc`` (B, N, D). dqkv (B·N, 3D) stays fp32: the core
    rounds it to bf16 and sums its columns from it; ctx is in qkv's dtype."""
    B, N, three_d = qkv.shape
    H, hd = num_heads, three_d // 3 // num_heads
    dt = qkv.dtype
    dc = dc.float().reshape(B, N, H, hd)
    q, k, v = qkv.float().reshape(B, N, 3, H, hd).unbind(2)
    ctx = torch.einsum("bhnm,bmhd->bnhd", p_c, v).to(dt)
    dv = torch.einsum("bhnm,bnhd->bmhd", p_c, dc)
    dp = torch.einsum("bnhd,bmhd->bhnm", dc, v)
    tmp = dp * p_soft
    ds = ((tmp - p_soft * tmp.sum(-1, keepdim=True)) * hd ** -0.5).to(dt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(B * N, three_d), ctx.reshape(B, N, -1)


def _attn_bwd_from(x, scale, bias, wqkv, wproj, qkv, p_soft, p_c, g, num_heads: int):
    """The attention-block backward from qkv (B, N, 3D) and the
    probabilities of :func:`attn_bwd_core_plain`; the rounding points of
    ``_bwd_kernel`` / ``_bwd_stash_kernel``."""
    B, N, D = x.shape
    dt = wqkv.dtype
    x2 = x.reshape(-1, D).float()
    g2 = g.reshape(-1, D).float()
    y, xhat, rstd = _ln_forward(x2, scale, bias)
    y_c = y.to(dt)
    g_c = g2.to(wproj.dtype)
    dc = _dot(g_c, wproj.t()).to(dt)
    dqkv, ctx = attn_bwd_core_plain(qkv.to(dt), p_soft, p_c, dc.reshape(B, N, D), num_heads)
    dqkv_c = dqkv.to(dt)
    dy = _dot(dqkv_c, wqkv.t())
    dx, dscale, dbias = _ln_backward(g2, dy, xhat, rstd, scale)
    return (
        dx.to(x.dtype).reshape(x.shape), dscale, dbias,
        _dot(y_c.t(), dqkv_c).to(wqkv.dtype), dqkv.sum(0),
        _dot(ctx.reshape(B * N, D).t(), g_c).to(wproj.dtype), g2.sum(0),
    )


def attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads: int):
    """Plain version of kernel 3: mirrors ``_bwd_stash_kernel``
    (attn_block.py:282-356) rounding point by rounding point: the stashed
    bf16 probabilities in the softmax backward and the products alike. It
    takes no ``seg_len``: packed probabilities carry their zeros.
    Returns (dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj) in the dtypes
    of (x, scale, bias, wqkv, fp32, wproj, fp32)."""
    p = probs.float()
    return _attn_bwd_from(x, scale, bias, wqkv, wproj, qkv, p, p, g, num_heads)


def attn_block_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, num_heads: int,
                         seg_len: int = 0):
    """Plain version of kernel 4: mirrors ``_bwd_kernel`` (attn_block.py:156-235)
    rounding point by rounding point. LN, qkv (rounded after its bias), the
    logits and the fp32 softmax (masked to packed segments of ``seg_len``)
    are recomputed; the softmax backward takes the fp32 probabilities, ctx
    and dV their bf16 rounding. Outputs as :func:`attn_block_bwd_stash_plain`."""
    qkv, probs = _qkv_probs(x, scale, bias, wqkv, bqkv, num_heads, seg_len)
    p_c = probs.to(wqkv.dtype).float()
    return _attn_bwd_from(x, scale, bias, wqkv, wproj, qkv, probs, p_c, g, num_heads)


def _lib(name: str, entry: str, n_ptr: int, n_int: int) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _plan_bytes(core: str, N: int, hd: int) -> int:
    """Shared-memory bytes of a core's plan at (N, hd), as the CUDA source
    computes them: ``"fwd"`` (K2, kernel 2), ``"stash"`` (kernel 3) or
    ``"recompute"`` (kernel 4); kernels 3 and 4 share one plan, kernel 13's
    without its rows of column sums."""
    if core == "fwd":
        lib, entry = "attn_block", "sky_attn_fwd_plan_bytes"
    else:
        lib, entry = "attn_block_bwd", "sky_attn_bwd_plan_bytes"
    fn = getattr(cuda_build.load(lib), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
    return int(fn(N, hd))


def _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, core: str,
                     seg_len: int = 0):
    if seg_len < 0:
        raise ValueError(f"seg_len={seg_len} must be >= 0")
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
    if hd % 16:
        raise ValueError(f"head dim {hd} must be a multiple of 16")
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
        if t is None:  # a backward reads bproj never, bqkv only to recompute qkv
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    smem = _plan_bytes(core, N, hd)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head dim {hd} at N={N}: the {core} core's shared-memory plan needs "
                         f"{smem} bytes, more than the {SMEM_PER_BLOCK} a block may use")


def _launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, stash: bool,
                seg_len: int = 0):
    """K2 (``stash=False``, counted on ``fused_attn_block.launches``) or
    kernel 2 (counted on ``attn_block_fwd_stash.launches``) on CUDA tensors:
    ``(out, qkv, probs, ctx)``, probs None without the stash, ctx the
    attention core's bf16 output. A launch with packed segments also counts
    on the wrapper's ``seg_launches``."""
    _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, "fwd", seg_len)
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
        err = getattr(_lib("attn_block", entry, len(ptrs), 5), entry)(
            *ptrs, B, N, D, num_heads, seg_len, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    counted = attn_block_fwd_stash if stash else fused_attn_block
    counted.launches += 1
    counted.seg_launches += int(0 < seg_len < N)
    return out, qkv, probs, ctx


def attn_block_fwd_stash(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int,
                         seg_len: int = 0):
    """Kernel 2: ``(out, qkv, probs)`` as :func:`attn_block_fwd_stash_plain`.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block.cu`` (stash entry) or raise."""
    if x.device.type == "cpu":
        return attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads,
                                          seg_len)
    return _launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, stash=True,
                       seg_len=seg_len)[:3]


attn_block_fwd_stash.launches = 0
attn_block_fwd_stash.seg_launches = 0  # those of the launches with packed segments


def _check_bwd_inputs(x, num_heads, **tensors):
    B, N, D = x.shape
    shapes = {"qkv": (B, N, 3 * D), "probs": (B, num_heads, N, N), "g": (B, N, D)}
    for name, t in tensors.items():
        shape = shapes[name]
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous {shape} bf16 tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch_bwd(entry, x, ins, num_heads, qkv=None, seg_len=0):
    """Kernel 3 (``ins`` holds the stash) or kernel 4 (``qkv`` is scratch for
    the recompute, ``seg_len`` its mask) on CUDA tensors; allocates the
    scratch (``part``: the core's B per-sample dbqkv partials, then dbproj's,
    dscale's and dbias's over ``ROWS_PER_PARTIAL`` rows each) and the
    outputs."""
    B, N, D = x.shape
    M = B * N
    parts = -(-M // ROWS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y, dc, ctx = (torch.empty((M, D), **bf) for _ in range(3))
    dqkv_c = torch.empty((M, 3 * D), **bf)
    dy = torch.empty((M, D), **f32)
    part = torch.empty(B * 3 * D + parts * 3 * D, **f32)
    ws = torch.empty(max(_split_ws("attn_block_bwd", "sky_attn_block_bwd_ws", x.device.index, M, D),
                         4), **f32)
    dx = torch.empty_like(x)
    dscale, dbias, dbproj = (torch.empty(D, **f32) for _ in range(3))
    dwqkv, dbqkv = torch.empty((D, 3 * D), **bf), torch.empty(3 * D, **f32)
    dwproj = torch.empty((D, D), **bf)
    scratch = (y,) if qkv is None else (y, qkv)
    ptrs = [t.data_ptr() for t in (*ins, *scratch, dc, ctx, dqkv_c, dy, part, ws, dx,
                                   dscale, dbias, dwqkv, dbqkv, dwproj, dbproj)]
    ints = (B, N, D, num_heads) if qkv is None else (B, N, D, num_heads, seg_len)
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block_bwd", entry, len(ptrs), len(ints)), entry)(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def attn_block_bwd_stash(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads: int):
    """Kernel 3: the block's gradients from x, the stash and the output
    gradient ``g`` (outputs as :func:`attn_block_bwd_stash_plain`). CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block_bwd.cu`` or raise."""
    if x.device.type == "cpu":
        return attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads)
    _check_cuda_args(x, scale, bias, wqkv, None, wproj, None, num_heads, "stash")
    _check_bwd_inputs(x, num_heads, qkv=qkv, probs=probs, g=g)
    grads = _launch_bwd("sky_attn_block_bwd_stash", x,
                        (x, scale, bias, wqkv, wproj, qkv, probs, g), num_heads)
    attn_block_bwd_stash.launches += 1
    return grads


attn_block_bwd_stash.launches = 0


def attn_block_bwd(x, scale, bias, wqkv, bqkv, wproj, g, num_heads: int, seg_len: int = 0):
    """Kernel 4: the block's gradients from x and the output gradient ``g``
    alone, the forward recomputed (outputs as :func:`attn_block_bwd_plain`).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block_bwd.cu`` (recompute entry) or raise."""
    if x.device.type == "cpu":
        return attn_block_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, num_heads, seg_len)
    _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, None, num_heads, "recompute", seg_len)
    _check_bwd_inputs(x, num_heads, g=g)
    qkv = torch.empty((*x.shape[:2], 3 * x.shape[2]), dtype=torch.bfloat16, device=x.device)
    grads = _launch_bwd("sky_attn_block_bwd", x, (x, scale, bias, wqkv, bqkv, wproj, g),
                        num_heads, qkv=qkv, seg_len=seg_len)
    attn_block_bwd.launches += 1
    attn_block_bwd.seg_launches += int(0 < seg_len < x.shape[1])
    return grads


attn_block_bwd.launches = 0
attn_block_bwd.seg_launches = 0


class AttnBlockStashFn(torch.autograd.Function):
    """Kernel 2 forward, kernel 3 backward (JAX ``fused_attn_block`` with
    ``stash=True``: x, the weights, qkv and probs are saved; the stashed
    probabilities carry the ``seg_len`` mask into the backward). ``plain``
    runs the plain versions of both on any device: the reference path a
    check on the card holds the kernels against."""

    @staticmethod
    def forward(ctx, x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, plain, seg_len):
        fwd = attn_block_fwd_stash_plain if plain else attn_block_fwd_stash
        out, qkv, probs = fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, seg_len)
        ctx.save_for_backward(x, scale, bias, wqkv, wproj, qkv, probs)
        ctx.num_heads, ctx.plain = num_heads, plain
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, wqkv, wproj, qkv, probs = ctx.saved_tensors
        bwd = attn_block_bwd_stash_plain if ctx.plain else attn_block_bwd_stash
        grads = bwd(x, scale, bias, wqkv, wproj, qkv, probs, g.contiguous(), ctx.num_heads)
        return (*grads, None, None, None)


class AttnBlockFn(torch.autograd.Function):
    """K2 forward, kernel 4 backward (JAX ``fused_attn_block`` with
    ``stash=False``: only the inputs are saved, ``_fab_fwd`` computes the
    primal). ``plain`` runs the plain versions of both on any device."""

    @staticmethod
    def forward(ctx, x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, plain, seg_len):
        args = (x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads)
        if plain or x.device.type == "cpu":
            out = attn_block_plain(*args, seg_len)
        else:
            out = _launch_fwd(*args, stash=False, seg_len=seg_len)[0]
        ctx.save_for_backward(x, scale, bias, wqkv, bqkv, wproj)
        ctx.num_heads, ctx.plain, ctx.seg_len = num_heads, plain, seg_len
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, wqkv, bqkv, wproj = ctx.saved_tensors
        bwd = attn_block_bwd_plain if ctx.plain else attn_block_bwd
        grads = bwd(x, scale, bias, wqkv, bqkv, wproj, g.contiguous(), ctx.num_heads, ctx.seg_len)
        return (*grads, None, None, None)


def fused_attn_block(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int,
                     stash: bool = True, plain: bool = False, seg_len: int = 0):
    """(B, N, D) -> (B, N, D), attention masked to packed segments of
    ``seg_len`` tokens when it is > 0. Without grad: CPU tensors (or
    ``plain``) take :func:`attn_block_plain`, CUDA tensors launch K2 or
    raise. With grad, the call goes through :class:`AttnBlockStashFn`
    (kernels 2 and 3) or, with ``stash=False``, :class:`AttnBlockFn` (K2 and
    kernel 4)."""
    args = (x, scale, bias, wqkv, bqkv, wproj, bproj)
    if not _needs_grad(*args):
        if plain or x.device.type == "cpu":
            return attn_block_plain(*args, num_heads, seg_len)
        return _launch_fwd(*args, num_heads, stash=False, seg_len=seg_len)[0]
    return (AttnBlockStashFn if stash else AttnBlockFn).apply(*args, num_heads, plain, seg_len)


fused_attn_block.launches = 0
fused_attn_block.seg_launches = 0
