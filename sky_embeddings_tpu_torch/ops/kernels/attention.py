"""Multi-head attention core ``(B, N, 3D) qkv -> (B, N, D)`` context, forward
and backward (port of ``sky_embeddings_tpu/ops/kernels/attention.py``).

Two kernels, both in CUDA C++ (``csrc/attention.cu``):

- Kernel 12, the forward: replaces the TPU kernel ``fused_attention``
  (``_attn_kernel``). bf16 qkv runs K2's attention core
  (``csrc/attn_core.cuh``) alone; fp32 qkv a register-tiled fp32 kernel.
- Kernel 13, the backward: replaces ``_fused_attention_bwd_call``
  (``_attn_bwd_kernel``). bf16 runs kernel 4's recompute core without its
  ctx product, writing dq, dk and dv straight to bf16 (each rounded once);
  fp32 the register-tiled kernel's backward, one pass over the head.

:class:`AttentionFn` pairs them (JAX ``fused_attention_ad``: qkv is saved,
the backward recomputes the probabilities) and :func:`attention_context` is
the dispatcher ``models/layers.Attention`` calls (JAX ``attention_context``).
JAX's TPU-only gates (the backend, ``B % 16 == 0``) are dropped: any batch
launches. N > 256 tokens (the TPU kernel's bound), a head count that does not
divide D, a dtype other than bf16 or fp32, a bf16 head dim that is not a
multiple of 16, or a head no shared-memory plan fits raise on CUDA tensors;
they never take the plain path.

What bounds them on the H100: bytes. Kernel 12 reads 3·B·N·D elements and
writes B·N·D against 4·B·H·N²·hd FLOP (ViT-B: about 33 FLOP per bf16 byte,
under the card's ~295; 8 per fp32 byte, under the CUDA cores' 20);
kernel 13 moves 7·B·N·D for 10·B·H·N²·hd. The bf16 cores
(``csrc/attn_core.cuh``) keep each head's logits and probabilities in
registers (``mma.sync``), kernel 12 keeps the next heads' loads in flight,
and kernel 13 writes its bf16 output once, with no fp32 scratch.

The fp32 kernels stage a (sample, head)'s Q, K, V (and dC) in shared memory
with ``cp.async`` and cut each product into 4 × 4 register tiles of fp32
FMAs, one per thread (``csrc/attention.cu``; :func:`f32_plan` is the Python
copy of their shared-memory plan). Each output element is one FMA chain in
the order the plain version's fp32 GEMMs sum on the card (S over the head
dims, ctx and dQ over the keys, dK and dV over the queries), with P and dS
in fp32 shared memory, never rounded to a narrower type, and the softmax in
the order of a warp per row (``expf``, the lanes' sums in an xor
butterfly, ``e / sum``): the forward equals the plain version bit for bit.
Three TF32 tensor-core products per fp32 one (the split fp32 SDPA runs)
land twice the fp32 bar from it, so these kernels stay on the CUDA cores,
where loads from shared memory bound them. Heads whose whole plan does not
fit read their operands from device memory in blocks of query rows (and,
backward, column chunks).

Numerics (kernel and plain versions alike), per (sample, head): S = q·kᵀ
with fp32 accumulation, P = softmax(S·hd^-0.5) in fp32, P rounded to v's
dtype before the PV product, ctx in qkv's dtype. Backward: dV = P_cᵀ·dC,
dP = dC·Vᵀ, dS = (P⊙dP − P·Σ(P⊙dP))·hd^-0.5 with the fp32 P, rounded to
qkv's dtype before dQ = dS·K and dK = dSᵀ·Q, each gradient rounded to qkv's
dtype once. On the card the plain versions' fp32 products want TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.attn_block import MAX_TOKENS, SMEM_PER_BLOCK, _lib


def _heads(t: torch.Tensor, parts: int, num_heads: int) -> tuple[torch.Tensor, ...]:
    """(B, N, parts·D) -> ``parts`` fp32 tensors (B, H, N, hd)."""
    B, N, width = t.shape
    hd = width // parts // num_heads
    return t.float().reshape(B, N, parts, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)


def _probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 softmax(q·kᵀ·hd^-0.5) over (B, H, N, hd) heads."""
    return torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)


def attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of kernel 12: ``_attn_kernel`` (attention.py:29-53) step
    by step, with its rounding points. (B, N, 3D) -> (B, N, D) in qkv's dtype."""
    B, N, three_d = qkv.shape
    q, k, v = _heads(qkv, 3, num_heads)
    p = _probs(q, k).to(qkv.dtype).float()
    return torch.matmul(p, v).transpose(1, 2).reshape(B, N, three_d // 3).to(qkv.dtype)


def attention_bwd_plain(qkv: torch.Tensor, dctx: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of kernel 13: ``_attn_bwd_kernel`` (attention.py:104-138)
    step by step: the fp32 P recomputed, dS rounded to qkv's dtype, dqkv
    (B, N, 3D) in qkv's dtype."""
    B, N, three_d = qkv.shape
    dt = qkv.dtype
    q, k, v = _heads(qkv, 3, num_heads)
    (dc,) = _heads(dctx, 1, num_heads)
    p = _probs(q, k)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dc)
    dp = torch.matmul(dc, v.transpose(-1, -2))
    tmp = dp * p
    ds = ((tmp - p * tmp.sum(-1, keepdim=True)) * q.shape[-1] ** -0.5).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv], dim=2)  # (B, H, 3, N, hd)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B, N, three_d).to(dt)


# csrc/attention.cu's AttnF32Plan: the most threads a CTA takes
F32_MAX_THREADS = 512


@dataclass(frozen=True)
class F32Plan:
    """The fp32 kernels' plan at (N, hd): ``staged`` (the whole head in
    shared memory, one CTA per (sample, head)) or operands from device
    memory; ``qb`` query rows a block, ``hc`` output columns a CTA (the
    backward's column chunks), ``threads`` a CTA, shared-memory ``bytes``."""

    staged: bool
    qb: int
    hc: int
    threads: int
    bytes: int


def f32_plan(N: int, hd: int, backward: bool) -> F32Plan:
    """Python copy of ``AttnF32Plan`` (``csrc/attention.cu``). Tokens pad to
    NP (a multiple of 4), head dims to HD4, staged rows HP = HD4 + 4 floats
    apart. Staged (one CTA per (sample, head)): the forward's Q, K, V (NP ×
    HP each) and S (NP × NP); the backward's Q, K, V, dC, dP (NP × NP) and
    S in V's place where NP <= HP, else a buffer of its own. Otherwise the
    forward takes the largest block of query rows whose S (QB × NP) fits,
    the backward the widest column chunk HC (a multiple of 8), then the
    largest QB, whose S, dP (QB × NP each) and, with several blocks, dK and
    dV accumulators (NP × HC each) fit. One thread per 4 × 4 tile of the
    largest product, 128 to 512."""
    cap = SMEM_PER_BLOCK // 4
    NP, HD4 = -(-N // 4) * 4, -(-hd // 4) * 4
    HP = HD4 + 4
    sq, rows = NP * NP, NP * HP
    total = 4 * rows + sq + (sq if NP > HP else 0) if backward else 3 * rows + sq
    staged, qb, hc = total <= cap, NP, -(-hd // 8) * 8

    def halve(q):  # the next block: 128 (forward) or 64 rows, then halves
        top = 64 if backward else 128
        return top if q > top else q // 2 // 4 * 4

    def bwd_floats(q, c):
        return 2 * q * NP + (2 * NP * c if q < NP else 0)

    if not staged and not backward:
        while qb > 4 and qb * NP > cap:
            qb = halve(qb)
        total = qb * NP
    elif not staged:
        fit, widest = bwd_floats(qb, hc) <= cap, hc
        for i, c in enumerate((widest, 64, 32, 16, 8)):
            if fit:
                break
            if i and c >= widest:
                continue
            hc, qb = c, NP
            while qb >= 4 and not (fit := bwd_floats(qb, hc) <= cap):
                qb = halve(qb)
        total = bwd_floats(qb, hc)
    rg, kg, cg = qb // 4, NP // 4, hc // 4
    tiles = max(rg * kg, rg * cg, kg * cg if backward else 0)
    threads = min(max(-(-tiles // 32) * 32, 128), F32_MAX_THREADS)
    return F32Plan(bool(staged), qb, hc, threads, 4 * total)


def _f32_plan_cuda(N: int, hd: int, backward: bool) -> F32Plan:
    """The fp32 plan as the CUDA source computes it (the card tests hold
    :func:`f32_plan` to it)."""
    fn = cuda_build.load("attention").sky_attention_f32_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = None
    out = (ctypes.c_longlong * 5)()
    fn(N, hd, int(backward), ctypes.cast(out, ctypes.c_void_p))
    return F32Plan(bool(out[0]), *(int(v) for v in out[1:]))


def _plan_bytes(N: int, hd: int, f32: bool, backward: bool) -> int:
    """Shared-memory bytes of a kernel's plan, as the CUDA source computes them."""
    fn = cuda_build.load("attention").sky_attention_plan_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return int(fn(N, hd, int(f32), int(backward)))


def _check_cuda_args(qkv: torch.Tensor, num_heads: int, dctx: torch.Tensor | None = None) -> None:
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_attention on CUDA takes bf16 or fp32 qkv, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous() or qkv.shape[2] % 3:
        raise ValueError("qkv must be a contiguous (B, N, 3D) tensor")
    B, N, three_d = qkv.shape
    D = three_d // 3
    if not 0 < N <= MAX_TOKENS:
        raise ValueError(f"N={N} tokens is outside the kernel's bound 1..{MAX_TOKENS}")
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"D={D} not divisible by num_heads={num_heads}")
    hd = D // num_heads
    f32 = qkv.dtype == torch.float32
    if not f32 and hd % 16:
        raise ValueError(f"head dim {hd} must be a multiple of 16 for bf16 qkv")
    if B * num_heads > 2**31 - 1:
        raise ValueError("too many (sample, head) pairs for one launch grid")
    if dctx is not None and (tuple(dctx.shape) != (B, N, D) or dctx.dtype != qkv.dtype
                             or not dctx.is_contiguous() or dctx.device != qkv.device):
        raise ValueError(f"dctx: want a contiguous {(B, N, D)} {qkv.dtype} tensor on "
                         f"{qkv.device}, got {tuple(dctx.shape)} {dctx.dtype} on {dctx.device}")
    smem = _plan_bytes(N, hd, f32, dctx is not None)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head dim {hd} at N={N} ({qkv.dtype}): the shared-memory plan needs "
                         f"{smem} bytes, more than the {SMEM_PER_BLOCK} a block may use")


def _launch(entry: str, ptrs: list, qkv: torch.Tensor, num_heads: int) -> None:
    B, N, three_d = qkv.shape
    with torch.cuda.device(qkv.device):
        err = getattr(_lib("attention", entry, len(ptrs), 4), entry)(
            *ptrs, B, N, three_d // 3, num_heads, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)


def fused_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 12: (B, N, 3D) -> (B, N, D) as :func:`attention_plain`. CPU
    tensors take the plain version; CUDA tensors launch ``csrc/attention.cu``
    or raise."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads)
    _check_cuda_args(qkv, num_heads)
    B, N, three_d = qkv.shape
    ctx = torch.empty((B, N, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    entry = "sky_attention_fwd_f32" if qkv.dtype == torch.float32 else "sky_attention_fwd"
    _launch(entry, [qkv.data_ptr(), ctx.data_ptr()], qkv, num_heads)
    fused_attention.launches += 1
    return ctx


fused_attention.launches = 0


def fused_attention_bwd(qkv: torch.Tensor, dctx: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 13: dqkv (B, N, 3D) from qkv and the context gradient ``dctx``
    (B, N, D), as :func:`attention_bwd_plain`. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/attention.cu`` or raise."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, dctx, num_heads)
    _check_cuda_args(qkv, num_heads, dctx)
    dqkv = torch.empty_like(qkv)
    entry = "sky_attention_bwd_f32" if qkv.dtype == torch.float32 else "sky_attention_bwd"
    _launch(entry, [qkv.data_ptr(), dctx.data_ptr(), dqkv.data_ptr()], qkv, num_heads)
    fused_attention_bwd.launches += 1
    return dqkv


fused_attention_bwd.launches = 0


class AttentionFn(torch.autograd.Function):
    """Kernel 12 forward, kernel 13 backward (JAX ``fused_attention_ad``: qkv
    is saved, the backward recomputes the probabilities). ``plain`` runs the
    plain versions of both on any device: the reference path a check on the
    card holds the kernels against."""

    @staticmethod
    def forward(ctx, qkv, num_heads, plain):
        out = (attention_plain if plain else fused_attention)(qkv, num_heads)
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.plain = num_heads, plain
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        bwd = attention_bwd_plain if ctx.plain else fused_attention_bwd
        return bwd(qkv, g.to(qkv.dtype).contiguous(), ctx.num_heads), None, None


def attention_context(qkv: torch.Tensor, num_heads: int, plain: bool = False) -> torch.Tensor:
    """(B, N, 3D) -> (B, N, D). With grad the call goes through
    :class:`AttentionFn` (kernels 12 and 13); without, CPU tensors (or
    ``plain``) take :func:`attention_plain` and CUDA tensors launch kernel 12
    or raise."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return AttentionFn.apply(qkv, num_heads, plain)
    return (attention_plain if plain else fused_attention)(qkv, num_heads)
