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

Head dims (bf16): any multiple of 16 whose core fits a block's shared
memory at the given N; narrower heads are refused, since the bf16 cores'
``mma.sync`` tiles are 16 wide along the head (no shipped bf16 config has
one). fp32 takes heads of any width (the tiny configs' 4, the MAE
decoder's 512): its cores pad the head to a multiple of 4. The check asks the CUDA source for its plan's bytes
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

fp32 forms (the fp32 configs: JAX sends fp32 blocks to ``xla_attn_block``,
``models/layers.py:356``): all four kernels, masked too, also take a
uniform fp32 set (x, wqkv, wproj and the stash fp32), computing what the
plain versions compute in fp32 (nothing rounded; the stash is fp32 qkv and
fp32 probabilities; the mask JAX's -1e9 logit bias): the bf16 entry's name
with ``_f32`` at the end and the bf16 entry's arguments
(``csrc/attn_block.cu``, ``csrc/attn_block_bwd.cu``), every product on the
3xTF32 GEMM of ``csrc/gemm_f32.cuh``, the cores kernels 12 and 13's fp32
FMA tiles (``csrc/attn_f32.cuh``): kernel 3's reads the stashed
probabilities, kernel 4's recomputes them and writes ctx for dWproj
beside dqkv. Their launches also count on ``f32_launches``
(``mlp_block.operand_dtype`` holds the dtype rule).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import (
    ROWS_PER_PARTIAL,
    _bwd_finish,
    _dot,
    _f32,
    _finish,
    _split_ws,
    _ln_forward,
    _needs_grad,
    check_ln_held,
    operand_dtype,
    scratch_layout,
    tp_bwd_finish_plain,
    tp_finish_plain,
)

MAX_TOKENS = 256  # the TPU kernel's dispatch bound (layers.py:341)
SMEM_PER_BLOCK = 232448  # dynamic shared memory a block may use, csrc/common.cuh SMEM_OPTIN_MAX


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
    ``seg_len`` tokens. A tensor-parallel rank's ``wqkv`` (D, 3·Dl) gives its
    heads' qkv (B, N, 3·Dl)."""
    B, N, _ = x.shape
    hd = wqkv.shape[1] // 3 // num_heads
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
    qkv, probs, ctx = _qkv_probs_ctx(x, scale, bias, wqkv, bqkv, num_heads, seg_len)
    out = _dot(ctx.to(wproj.dtype), wproj) + bproj
    return (x.float() + out).to(x.dtype), qkv.to(x.dtype), probs.to(x.dtype)


def _qkv_probs_ctx(x, scale, bias, wqkv, bqkv, num_heads: int, seg_len: int = 0):
    """:func:`_qkv_probs` with the probabilities rounded to wqkv's dtype and
    the fp32 ctx (B, N, H·hd) of their product with v."""
    B, N, _ = x.shape
    qkv, probs = _qkv_probs(x, scale, bias, wqkv, bqkv, num_heads, seg_len)
    probs = probs.to(wqkv.dtype)
    v = qkv.reshape(B, N, 3, num_heads, -1)[:, :, 2]
    ctx = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float())
    return qkv, probs, ctx.reshape(B, N, -1)


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
    ``_bwd_kernel`` / ``_bwd_stash_kernel``: :func:`_attn_bwd_local`, then
    :func:`~sky_embeddings_tpu_torch.ops.kernels.mlp_block.tp_bwd_finish_plain`."""
    dy, dwqkv, dbqkv, dwproj = _attn_bwd_local(x, scale, bias, wqkv, wproj, qkv, p_soft, p_c, g,
                                                num_heads)
    dx, dscale, dbias, dbproj = tp_bwd_finish_plain(x, scale, bias, g, dy)
    return dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def _attn_bwd_local(x, scale, bias, wqkv, wproj, qkv, p_soft, p_c, g, num_heads: int):
    """The backward up to the fp32 gradient ``dy`` (B·N, D) of the LN
    output: ``(dy, dwqkv, dbqkv, dwproj)``. On a tensor-parallel rank's
    shard (wqkv (D, 3·Dl), wproj (Dl, D), its heads' qkv) ``dy`` is the
    rank's partial, which the ranks sum."""
    B, N, D = x.shape
    dt = wqkv.dtype
    g2 = g.reshape(-1, D).float()
    y = _ln_forward(x.reshape(-1, D).float(), scale, bias)[0]
    y_c = y.to(dt)
    g_c = g2.to(wproj.dtype)
    dc = _dot(g_c, wproj.t()).to(dt)
    dqkv, ctx = attn_bwd_core_plain(qkv.to(dt), p_soft, p_c, dc.reshape(B, N, -1), num_heads)
    dqkv_c = dqkv.to(dt)
    dy = _dot(dqkv_c, wqkv.t())
    return (dy, _dot(y_c.t(), dqkv_c).to(wqkv.dtype), dqkv.sum(0),
            _dot(ctx.reshape(B * N, -1).t(), g_c).to(wproj.dtype))


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


@functools.lru_cache(maxsize=256)
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
                     seg_len: int = 0, stash: bool = False):
    """Checks a CUDA launch of a core's kernel (``"fwd"``: K2, or kernel 2
    with ``stash``; ``"stash"``: kernel 3; ``"recompute"``: kernel 4);
    returns the operand dtype (``mlp_block.operand_dtype``). In bf16, heads
    that are not a multiple of 16 are refused before any library loads;
    fp32 takes any head width."""
    if seg_len < 0:
        raise ValueError(f"seg_len={seg_len} must be >= 0")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, D) tensor")
    kernel = {"fwd": "kernel 2" if stash else "K2", "stash": "kernel 3",
              "recompute": "kernel 4"}[core]
    masked = 0 < seg_len < x.shape[1]
    dt = operand_dtype(kernel + " masked" if masked else kernel, x, wqkv=wqkv, wproj=wproj)
    B, N, D = x.shape
    if N > MAX_TOKENS:
        raise ValueError(f"N={N} tokens exceeds the kernel's bound {MAX_TOKENS}")
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by num_heads={num_heads}")
    hd = D // num_heads
    if dt == torch.bfloat16 and hd % 16:
        raise ValueError(f"head dim {hd} must be a multiple of 16 in bf16 (the cores' mma.sync "
                         "tiles); fp32 takes heads of any width")
    vec = 8 if dt == torch.bfloat16 else 4
    if D % vec:
        raise ValueError(f"D={D} must be a multiple of {vec} (16-byte loads)")
    if B * N > 65535 * ROWS_PER_PARTIAL or B * num_heads > 2**31 - 1:
        raise ValueError("too many rows for one launch grid")
    want = {
        "scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
        "wqkv": (wqkv, (D, 3 * D), dt), "bqkv": (bqkv, (3 * D,), torch.float32),
        "wproj": (wproj, (D, D), dt), "bproj": (bproj, (D,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t is None:  # a backward reads bproj never, bqkv only to recompute qkv
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if dt == torch.float32:  # the fp32 cores' plan fits every N <= 256 at any head width
        return dt
    smem = _plan_bytes(core, N, hd)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head dim {hd} at N={N}: the {core} core's shared-memory plan needs "
                         f"{smem} bytes, more than the {SMEM_PER_BLOCK} a block may use")
    return dt


def _launch_fwd(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, stash: bool,
                seg_len: int = 0):
    """K2 (``stash=False``, counted on ``fused_attn_block.launches``) or
    kernel 2 (counted on ``attn_block_fwd_stash.launches``) on CUDA tensors:
    ``(out, qkv, probs, ctx)``, probs None without the stash, ctx the
    attention core's output, all in x's dtype. A launch with packed segments
    also counts on the wrapper's ``seg_launches``, one in fp32 on its
    ``f32_launches``."""
    dt = _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, "fwd", seg_len,
                          stash)
    B, N, D = x.shape
    qkv = torch.empty((B, N, 3 * D), dtype=dt, device=x.device)
    ctx = torch.empty((B, N, D), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    probs = torch.empty((B, num_heads, N, N), dtype=dt, device=x.device) if stash else None
    ptrs = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), qkv.data_ptr(), ctx.data_ptr()]
    entry = _f32("sky_attn_block_fwd_stash" if stash else "sky_attn_block_fwd", dt)
    ints = (B, N, D, num_heads, seg_len)
    if stash:
        ptrs.append(probs.data_ptr())
    ptrs.append(out.data_ptr())
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block", entry, len(ptrs), len(ints)), entry)(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    counted = attn_block_fwd_stash if stash else fused_attn_block
    counted.launches += 1
    counted.seg_launches += int(0 < seg_len < N)
    counted.f32_launches += int(dt == torch.float32)
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
attn_block_fwd_stash.f32_launches = 0  # those of the launches in fp32


def _check_bwd_inputs(x, num_heads, **tensors):
    B, N, D = x.shape
    shapes = {"qkv": (B, N, 3 * D), "probs": (B, num_heads, N, N), "g": (B, N, D)}
    for name, t in tensors.items():
        shape = shapes[name]
        if tuple(t.shape) != shape or t.dtype != x.dtype or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous {shape} {x.dtype} tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch_bwd(entry, dt, x, ins, num_heads, qkv=None, seg_len=0):
    """Kernel 3 (``ins`` holds the stash) or kernel 4 (``qkv`` is scratch for
    the recompute, ``seg_len`` its mask) on CUDA tensors, each in the
    operand dtype ``dt`` (bf16, or its fp32 form); allocates the scratch (y,
    dc, ctx (B·N, D) and dqkv (B·N, 3D) in ``dt``, dy fp32; ``part``: the
    core's column-sum partials of dqkv (bf16: one row per sample; fp32: per
    ``ROWS_PER_PARTIAL`` rows), then dbproj's, dscale's and dbias's over
    ``ROWS_PER_PARTIAL`` rows each) and the outputs."""
    B, N, D = x.shape
    M = B * N
    parts = -(-M // ROWS_PER_PARTIAL)
    fp32 = dt == torch.float32
    f32 = dict(dtype=torch.float32, device=x.device)
    op = dict(dtype=dt, device=x.device)
    y, dc, ctx = (torch.empty((M, D), **op) for _ in range(3))
    dqkv = torch.empty((M, 3 * D), **op)
    dy = torch.empty((M, D), **f32)
    part = torch.empty(((parts if fp32 else B) + parts) * 3 * D, **f32)
    ws_entry = _f32("sky_attn_block_bwd", dt) + "_ws"
    ws = torch.empty(max(_split_ws("attn_block_bwd", ws_entry, x.device.index, M, D), 4), **f32)
    dx = torch.empty_like(x)
    dscale, dbias, dbproj = (torch.empty(D, **f32) for _ in range(3))
    dwqkv, dbqkv = torch.empty((D, 3 * D), **op), torch.empty(3 * D, **f32)
    dwproj = torch.empty((D, D), **op)
    scratch = (y,) if qkv is None else (y, qkv)
    ptrs = [t.data_ptr() for t in (*ins, *scratch, dc, ctx, dqkv, dy, part, ws, dx,
                                   dscale, dbias, dwqkv, dbqkv, dwproj, dbproj)]
    ints = (B, N, D, num_heads) if qkv is None else (B, N, D, num_heads, seg_len)
    entry = _f32(entry, dt)
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block_bwd", entry, len(ptrs), len(ints)), entry)(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def attn_block_bwd_stash(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads: int):
    """Kernel 3: the block's gradients from x, the stash and the output
    gradient ``g`` (outputs as :func:`attn_block_bwd_stash_plain`). CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block_bwd.cu`` (its fp32 form for fp32 operands, also
    counted on ``.f32_launches``) or raise."""
    if x.device.type == "cpu":
        return attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, num_heads)
    dt = _check_cuda_args(x, scale, bias, wqkv, None, wproj, None, num_heads, "stash")
    _check_bwd_inputs(x, num_heads, qkv=qkv, probs=probs, g=g)
    ins = (x, scale, bias, wqkv, wproj, qkv, probs, g)
    grads = _launch_bwd("sky_attn_block_bwd_stash", dt, x, ins, num_heads)
    attn_block_bwd_stash.launches += 1
    attn_block_bwd_stash.f32_launches += int(dt == torch.float32)
    return grads


attn_block_bwd_stash.launches = 0
attn_block_bwd_stash.f32_launches = 0


def attn_block_bwd(x, scale, bias, wqkv, bqkv, wproj, g, num_heads: int, seg_len: int = 0):
    """Kernel 4: the block's gradients from x and the output gradient ``g``
    alone, the forward recomputed (outputs as :func:`attn_block_bwd_plain`).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/attn_block_bwd.cu`` (recompute entry, its fp32 form also counted
    on ``.f32_launches``) or raise."""
    if x.device.type == "cpu":
        return attn_block_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, num_heads, seg_len)
    dt = _check_cuda_args(x, scale, bias, wqkv, bqkv, wproj, None, num_heads, "recompute",
                          seg_len)
    _check_bwd_inputs(x, num_heads, g=g)
    qkv = torch.empty((*x.shape[:2], 3 * x.shape[2]), dtype=dt, device=x.device)
    grads = _launch_bwd("sky_attn_block_bwd", dt, x, (x, scale, bias, wqkv, bqkv, wproj, g),
                        num_heads, qkv=qkv, seg_len=seg_len)
    attn_block_bwd.launches += 1
    attn_block_bwd.seg_launches += int(0 < seg_len < x.shape[1])
    attn_block_bwd.f32_launches += int(dt == torch.float32)
    return grads


attn_block_bwd.launches = 0
attn_block_bwd.seg_launches = 0
attn_block_bwd.f32_launches = 0


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
fused_attn_block.f32_launches = 0


# ---- the tensor-parallel forms of K2 and kernel 4 ------------------------------
#
# A rank holds the qkv columns of its H / tp heads, [q_r | k_r | v_r], each
# Dl = D / tp wide (wqkv (D, 3·Dl), bqkv (3·Dl,)), and wproj's rows of the
# same heads (wproj (Dl, D)); LN and bproj are whole (parallel/sharding.py).
# ``num_heads`` is the rank's head count. Each form is split at the
# all-reduce over the model group: the rank's half writes an fp32 partial
# (the forward's proj product, the backward's dy), the caller sums the
# partials over the ranks, and the finish runs on the sum. Forward:
# ``sky_attn_block_tp_fwd`` then ``sky_attn_block_tp_finish``; backward:
# ``sky_attn_block_tp_bwd`` (kernel 4's launches at the rank's widths,
# masked by ``seg_len``) then ``sky_attn_block_tp_bwd_finish``; all in
# ``csrc/attn_block_tp.cu``, each with its fp32 form. The finishes count on
# the form's ``finish_launches``. The bf16 forward half is one fused launch
# where :func:`tp_fwd_path` says so (the ViT-S shard), else a chain of four;
# its fused launches also count on ``fused_launches``.

# the fused bf16 forward half's shapes (csrc/attn_block_tp.cu
# attn_tp_fused_ok): rows of TP_FUSED_D, heads of TP_FUSED_HD, at most
# TP_FUSED_HEADS of them a rank, at most TP_FUSED_N tokens (one row block)
TP_FUSED_D, TP_FUSED_HD, TP_FUSED_HEADS, TP_FUSED_N = 384, 64, 3, 64


def tp_fwd_path(N: int, D: int, Dl: int, Hl: int, seg_len: int, dtype: torch.dtype) -> str:
    """The form of K2 TP's forward half a shape takes on CUDA: ``"fused"``
    (one launch, y, qkv and ctx kept on chip) or ``"chain"`` (LN, qkv, the
    core, proj); fp32 takes its own chain. The Python copy of the C rule
    (``sky_attn_block_tp_fwd_path``); it reads shapes only."""
    fused = (dtype == torch.bfloat16 and D == TP_FUSED_D and 1 <= Hl <= TP_FUSED_HEADS
             and Dl == TP_FUSED_HD * Hl and 0 < N <= TP_FUSED_N and not 0 < seg_len < N)
    return "fused" if fused else "chain"


def tp_fwd_path_cuda(B: int, N: int, D: int, Dl: int, Hl: int, seg_len: int) -> str:
    """The bf16 rule as the C source computes it (builds ``lib attn_block_tp``)."""
    fn = cuda_build.load("attn_block_tp").sky_attn_block_tp_fwd_path
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return "fused" if fn(B, N, D, Dl, Hl, seg_len) else "chain"


def attn_block_tp_fwd_plain(x, scale, bias, wqkv, bqkv, wproj, num_heads: int,
                            seg_len: int = 0):
    """Plain version of K2's TP form's rank half: the fp32 partial (B, N, D)
    of proj over the rank's heads, before bproj and the residual."""
    ctx = _qkv_probs_ctx(x, scale, bias, wqkv, bqkv, num_heads, seg_len)[2]
    return _dot(ctx.to(wproj.dtype), wproj)


def attn_block_tp_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, num_heads: int,
                            seg_len: int = 0):
    """Plain version of kernel 4's TP form's rank half: ``(dy, dwqkv, dbqkv,
    dwproj)``, dy (B·N, D) the rank's fp32 partial of the LN output's
    gradient, at kernel 4's rounding points (the forward recomputed)."""
    qkv, probs = _qkv_probs(x, scale, bias, wqkv, bqkv, num_heads, seg_len)
    p_c = probs.to(wqkv.dtype).float()
    return _attn_bwd_local(x, scale, bias, wqkv, wproj, qkv, probs, p_c, g, num_heads)


def _check_tp_args(x, scale, bias, wqkv, bqkv, wproj, num_heads: int, core: str, seg_len: int):
    """Checks a CUDA launch of a rank's half of an attention TP form
    (``core`` "fwd": K2's, "recompute": kernel 4's); returns the operand
    dtype. As :func:`_check_cuda_args` at the rank's widths."""
    if seg_len < 0:
        raise ValueError(f"seg_len={seg_len} must be >= 0")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, D) tensor")
    kernel = {"fwd": "K2 TP", "recompute": "kernel 4 TP"}[core]
    masked = 0 < seg_len < x.shape[1]
    dt = operand_dtype(kernel + " masked" if masked else kernel, x, wqkv=wqkv, wproj=wproj)
    B, N, D = x.shape
    Dl = wqkv.shape[-1] // 3
    if N > MAX_TOKENS:
        raise ValueError(f"N={N} tokens exceeds the kernel's bound {MAX_TOKENS}")
    if Dl % num_heads:
        raise ValueError(f"the rank's width {Dl} is not divisible by its {num_heads} heads")
    hd = Dl // num_heads
    if dt == torch.bfloat16 and hd % 16:
        raise ValueError(f"head dim {hd} must be a multiple of 16 in bf16 (the cores' mma.sync "
                         "tiles); fp32 takes heads of any width")
    vec = 8 if dt == torch.bfloat16 else 4
    if D % 8 or Dl % vec:
        raise ValueError(f"D={D} must be a multiple of 8 and the rank's width {Dl} of {vec}")
    if B * N > 65535 * ROWS_PER_PARTIAL or B * num_heads > 2**31 - 1:
        raise ValueError("too many rows for one launch grid")
    want = {"scale": (scale, (D,), torch.float32), "bias": (bias, (D,), torch.float32),
            "wqkv": (wqkv, (D, 3 * Dl), dt), "bqkv": (bqkv, (3 * Dl,), torch.float32),
            "wproj": (wproj, (Dl, D), dt)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if dt == torch.bfloat16:
        smem = _plan_bytes(core, N, hd)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"head dim {hd} at N={N}: the {core} core's shared-memory plan needs "
                             f"{smem} bytes, more than the {SMEM_PER_BLOCK} a block may use")
    return dt


def _tp_fwd_launch(entry, x, scale, bias, wqkv, bqkv, wproj, num_heads, seg_len,
                   chain: bool = False):
    """``entry`` of ``lib attn_block_tp`` (the rank's forward half, or its
    bf16 chain with ``chain``) on CUDA tensors: the fp32 partial (B, N, D),
    carved with the chain's qkv (B·N, 3·Dl) and ctx (B·N, Dl) scratch from
    one allocation; the fused half gets null scratch pointers, which the
    chain refuses. Returns ``(part, dtype, path)``."""
    check_ln_held(x)
    dt = _check_tp_args(x, scale, bias, wqkv, bqkv, wproj, num_heads, "fwd", seg_len)
    B, N, D = x.shape
    Dl = wqkv.shape[-1] // 3
    path = "chain" if chain else tp_fwd_path(N, D, Dl, num_heads, seg_len, dt)
    M, es = B * N, x.element_size()
    scratch = (M * 3 * Dl * es, M * Dl * es) if path == "chain" else ()
    nbytes, offs = scratch_layout((M * D * 4, *scratch))
    base = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    part = base[:M * D * 4].view(torch.float32).view(B, N, D)
    ptrs = [*(t.data_ptr() for t in (x, scale, bias, wqkv, bqkv, wproj)),
            *((base.data_ptr() + o for o in offs[1:]) if scratch else (None, None)),
            part.data_ptr()]
    entry = _f32(entry, dt)
    ints = (B, N, D, Dl, num_heads, seg_len)
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block_tp", entry, len(ptrs), len(ints)), entry)(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    return part, dt, path


def attn_block_tp_fwd(x, scale, bias, wqkv, bqkv, wproj, num_heads: int, seg_len: int = 0):
    """K2's TP form, the rank's half: the fp32 partial (B, N, D) as
    :func:`attn_block_tp_fwd_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``sky_attn_block_tp_fwd`` (its fp32 form for fp32
    operands, also counted on ``.f32_launches``; with packed segments on
    ``.seg_launches``; the fused bf16 half, :func:`tp_fwd_path`, on
    ``.fused_launches``) or raise."""
    if x.device.type == "cpu":
        return attn_block_tp_fwd_plain(x, scale, bias, wqkv, bqkv, wproj, num_heads, seg_len)
    part, dt, path = _tp_fwd_launch("sky_attn_block_tp_fwd", x, scale, bias, wqkv, bqkv, wproj,
                                    num_heads, seg_len)
    attn_block_tp_fwd.launches += 1
    attn_block_tp_fwd.seg_launches += int(0 < seg_len < x.shape[1])
    attn_block_tp_fwd.f32_launches += int(dt == torch.float32)
    attn_block_tp_fwd.fused_launches += int(path == "fused")
    return part


def attn_block_tp_fwd_chain(x, scale, bias, wqkv, bqkv, wproj, num_heads: int, seg_len: int = 0):
    """The bf16 forward half's chain at any shape (``sky_attn_block_tp_fwd_chain``,
    uncounted): the reference the card's checks hold the fused half to, bit
    for bit."""
    if x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError("the chain is the bf16 CUDA form")
    return _tp_fwd_launch("sky_attn_block_tp_fwd_chain", x, scale, bias, wqkv, bqkv, wproj,
                          num_heads, seg_len, chain=True)[0]


attn_block_tp_fwd.launches = 0
attn_block_tp_fwd.seg_launches = 0
attn_block_tp_fwd.f32_launches = 0
attn_block_tp_fwd.fused_launches = 0
attn_block_tp_fwd.finish_launches = 0


def attn_block_tp_finish(x, part, bproj):
    """K2's TP form after the all-reduce: ``out = x + (part + bproj)`` in
    x's dtype (``tp_finish_plain`` for CPU tensors; CUDA tensors launch
    ``sky_attn_block_tp_finish``, counted on
    ``attn_block_tp_fwd.finish_launches``)."""
    if x.device.type == "cpu":
        return tp_finish_plain(x, part, bproj)
    out = _finish("attn_block_tp", "sky_attn_block_tp_finish", x, part, bproj)
    attn_block_tp_fwd.finish_launches += 1
    return out


def attn_block_tp_bwd(x, scale, bias, wqkv, bqkv, wproj, g, num_heads: int, seg_len: int = 0):
    """Kernel 4's TP form, the rank's half: ``(dy, dwqkv, dbqkv, dwproj)``
    as :func:`attn_block_tp_bwd_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``sky_attn_block_tp_bwd`` (its fp32 form also
    counted on ``.f32_launches``) or raise."""
    if x.device.type == "cpu":
        return attn_block_tp_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, num_heads, seg_len)
    dt = _check_tp_args(x, scale, bias, wqkv, bqkv, wproj, num_heads, "recompute", seg_len)
    _check_bwd_inputs(x, num_heads, g=g)
    check_ln_held(x)
    B, N, D = x.shape
    Dl = wqkv.shape[-1] // 3
    M = B * N
    es = x.element_size()
    f32 = dict(dtype=torch.float32, device=x.device)
    op = dict(dtype=dt, device=x.device)
    # the scratch (y (M, D); qkv (M, 3 Dl); dc, ctx (M, Dl); dqkv (M, 3 Dl);
    # part; ws) from one allocation
    rows = -(-M // ROWS_PER_PARTIAL) if dt == torch.float32 else B
    n_ws = _split_ws("attn_block_tp", _f32("sky_attn_block_tp_bwd", dt) + "_ws", x.device.index,
                     M, D, Dl)
    nbytes, offs = scratch_layout((M * D * es, M * 3 * Dl * es, M * Dl * es, M * Dl * es,
                                   M * 3 * Dl * es, rows * 3 * Dl * 4, n_ws * 4))
    base = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    scratch = [base.data_ptr() + o for o in offs]
    dy = torch.empty((M, D), **f32)
    dwqkv, dbqkv = torch.empty((D, 3 * Dl), **op), torch.empty(3 * Dl, **f32)
    dwproj = torch.empty((Dl, D), **op)
    ptrs = [*(t.data_ptr() for t in (x, scale, bias, wqkv, bqkv, wproj, g)), *scratch,
            *(t.data_ptr() for t in (dy, dwqkv, dbqkv, dwproj))]
    ints = (B, N, D, Dl, num_heads, seg_len)
    entry = _f32("sky_attn_block_tp_bwd", dt)
    with torch.cuda.device(x.device):
        err = getattr(_lib("attn_block_tp", entry, len(ptrs), len(ints)), entry)(
            *ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)
    attn_block_tp_bwd.launches += 1
    attn_block_tp_bwd.seg_launches += int(0 < seg_len < N)
    attn_block_tp_bwd.f32_launches += int(dt == torch.float32)
    return dy, dwqkv, dbqkv, dwproj


attn_block_tp_bwd.launches = 0
attn_block_tp_bwd.seg_launches = 0
attn_block_tp_bwd.f32_launches = 0
attn_block_tp_bwd.finish_launches = 0


def attn_block_tp_bwd_finish(x, scale, bias, g, dy):
    """Kernel 4's TP form after the all-reduce of ``dy``: ``(dx, dscale,
    dbias, dbproj)`` (``tp_bwd_finish_plain`` for CPU tensors; CUDA tensors
    launch ``sky_attn_block_tp_bwd_finish``, counted on
    ``attn_block_tp_bwd.finish_launches``)."""
    if x.device.type == "cpu":
        return tp_bwd_finish_plain(x, scale, bias, g, dy)
    grads = _bwd_finish("attn_block_tp", "sky_attn_block_tp_bwd_finish", x, scale, bias, g, dy)
    attn_block_tp_bwd.finish_launches += 1
    return grads


class AttnBlockTPFn(torch.autograd.Function):
    """K2's TP form forward, kernel 4's TP form backward, each split at the
    all-reduce that ``reduce`` (an in-place sum of an fp32 tensor over the
    model group) runs: only the inputs are saved, as :class:`AttnBlockFn`
    saves them. ``plain`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads, seg_len, reduce, plain):
        fwd = attn_block_tp_fwd_plain if plain else attn_block_tp_fwd
        part = fwd(x, scale, bias, wqkv, bqkv, wproj, num_heads, seg_len)
        reduce(part)
        ctx.save_for_backward(x, scale, bias, wqkv, bqkv, wproj)
        ctx.num_heads, ctx.seg_len, ctx.reduce, ctx.plain = num_heads, seg_len, reduce, plain
        return (tp_finish_plain if plain else attn_block_tp_finish)(x, part, bproj)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, wqkv, bqkv, wproj = ctx.saved_tensors
        g = g.contiguous()
        bwd = attn_block_tp_bwd_plain if ctx.plain else attn_block_tp_bwd
        dy, dwqkv, dbqkv, dwproj = bwd(x, scale, bias, wqkv, bqkv, wproj, g, ctx.num_heads,
                                       ctx.seg_len)
        ctx.reduce(dy)
        finish = tp_bwd_finish_plain if ctx.plain else attn_block_tp_bwd_finish
        dx, dscale, dbias, dbproj = finish(x, scale, bias, g, dy)
        return dx, dscale, dbias, dwqkv, dbqkv, dwproj, dbproj, None, None, None, None


def fused_attn_block_tp(x, scale, bias, wqkv, bqkv, wproj, bproj, num_heads: int, reduce,
                        plain: bool = False, seg_len: int = 0):
    """A tensor-parallel rank's attention block, (B, N, D) -> (B, N, D): its
    heads' qkv columns and proj rows (LN and bproj whole), ``num_heads``
    the rank's heads, the partials summed by ``reduce``. Without grad the
    two halves run with the all-reduce between them; with grad the call
    goes through :class:`AttnBlockTPFn`."""
    args = (x, scale, bias, wqkv, bqkv, wproj, bproj)
    if not _needs_grad(*args):
        fwd = attn_block_tp_fwd_plain if plain else attn_block_tp_fwd
        part = fwd(x, scale, bias, wqkv, bqkv, wproj, num_heads, seg_len)
        reduce(part)
        return (tp_finish_plain if plain else attn_block_tp_finish)(x, part, bproj)
    return AttnBlockTPFn.apply(*args, num_heads, seg_len, reduce, plain)
