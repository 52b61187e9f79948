"""The forward GEMM of K1 and K2 (``csrc/gemm_sm90.cuh``) on its own.

K1 (``mlp_block``) and K2 (``attn_block``), and their stash twins (kernels 6
and 2), launch this GEMM from C for every forward product (fc1, fc2, qkv,
proj): a persistent, warp-specialised wgmma mainloop fed by TMA, with the
epilogues at the TPU kernels' rounding points. No model calls :func:`gemm`;
it launches one product with a chosen epilogue (``sky_gemm_sm90`` in
``csrc/mlp_block.cu``) so that the card tests and ``chip_smoke.py`` can
hold the GEMM alone to its plain version and time it beside cuBLAS.

:func:`gemm_plan` is a copy of the C tile rule (``gemm_sm90_plan``): output
tiles of 128 rows x BN columns, BN the one of 256, 192, 128 whose last wave
over the card's resident CTAs (one per SM) ends first, counted as waves x
BN; a narrower tile wins only when it cuts that by more than a sixteenth (a
wider one reads less shared memory per FLOP). Beside the staged 128 x BN
bf16 output tile, the ring holds as many 128 x 64 + 64 x BN bf16 slots as
fit a block's shared memory. A card test holds the copy to the C rule; the
CPU tests hold it at every shipped config.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import gelu

BM = 128  # rows of an output tile: two consumer warpgroups of 64
BK = 64  # depth of a ring slot: one 128-byte swizzle row of bf16
BNS = (256, 192, 128)  # tile widths, widest first
SMEM_OPTIN_MAX = 232448  # dynamic shared memory a block may use, csrc/gemm.cuh
SMEM_EXTRA = 1024 + 256  # alignment slack and barriers, csrc/gemm_sm90.cuh
H100_SMS = 132
# the epilogues the C entry takes (csrc/gemm.cuh enum Epilogue)
EPILOGUES = {"bias": 0, "bias_gelu": 1, "bias_residual": 2, "bias_gelu_stash": 7}


@dataclass(frozen=True)
class GemmPlan:
    bn: int  # tile width
    stages: int  # ring slots
    tiles: int  # output tiles of BM x bn
    smem: int  # dynamic shared-memory bytes of a CTA


def _stage_bytes(bn: int) -> int:
    return BM * BK * 2 + BK * bn * 2


def _out_bytes(bn: int) -> int:
    return BM * bn * 2  # the staged output tile


def _stages(bn: int) -> int:
    return (SMEM_OPTIN_MAX - SMEM_EXTRA - _out_bytes(bn)) // _stage_bytes(bn)


def gemm_plan(M: int, N: int, sms: int = H100_SMS) -> GemmPlan:
    """The tile rule of ``csrc/gemm_sm90.cuh`` (``gemm_sm90_plan``) for an
    (M, N) output over ``sms`` resident CTAs."""
    best, best_cost = None, 0
    m_tiles = -(-M // BM)
    for bn in BNS:
        tiles = m_tiles * -(-N // bn)
        cost = -(-tiles // sms) * bn
        if best is None or cost * 16 < best_cost * 15:
            stages = _stages(bn)
            smem = stages * _stage_bytes(bn) + _out_bytes(bn) + SMEM_EXTRA
            best, best_cost = GemmPlan(bn, stages, tiles, smem), cost
    return best


def gemm_plan_cuda(M: int, N: int, sms: int = H100_SMS) -> GemmPlan:
    """The same rule as the C source computes it (builds ``lib mlp_block``)."""
    fn = cuda_build.load("mlp_block").sky_gemm_sm90_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    fn(M, N, sms, out)
    return GemmPlan(*out)


def gemm_encode_us(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds to encode one launch's TMA maps (A, B, the output),
    the mean of ``reps`` (``sky_gemm_sm90_encode_us``)."""
    fn = cuda_build.load("mlp_block").sky_gemm_sm90_encode_us
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_double
    us = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1], a.shape[1], reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the operands")
    return us


def gemm_plain(a, b, bias, epi: str, resid=None):
    """Plain version: ``(out, out2)`` with the kernel's rounding points, out2
    the bf16 pre-activation for ``"bias_gelu_stash"`` and None otherwise."""
    acc = torch.matmul(a.float(), b.float()) + bias
    out2 = None
    if epi == "bias":
        out = acc
    elif epi == "bias_gelu":
        out = gelu(acc)
    elif epi == "bias_gelu_stash":
        out, out2 = gelu(acc), acc.to(torch.bfloat16)
    elif epi == "bias_residual":
        out = resid.float() + acc
    else:
        raise ValueError(f"epilogue {epi!r} is none of {sorted(EPILOGUES)}")
    return out.to(torch.bfloat16), out2


def _check(a, b, bias, epi, resid):
    if epi not in EPILOGUES:
        raise ValueError(f"epilogue {epi!r} is none of {sorted(EPILOGUES)}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    want = {"a": (a, (M, K), torch.bfloat16), "b": (b, (K, N), torch.bfloat16),
            "bias": (bias, (N,), torch.float32)}
    if epi == "bias_residual":
        want["resid"] = (resid, (M, N), torch.bfloat16)
    for name, (t, shape, dtype) in want.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise ValueError(f"{name}: want contiguous {shape} {dtype}, got {got}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte TMA strides)")


def gemm(a, b, bias, epi: str, resid=None):
    """``(out, out2)`` as :func:`gemm_plain`. CPU tensors take the plain
    version; CUDA tensors launch ``sky_gemm_sm90`` or raise."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, bias, epi, resid)
    _check(a, b, bias, epi, resid)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    out2 = torch.empty_like(out) if epi == "bias_gelu_stash" else None
    fn = cuda_build.load("mlp_block").sky_gemm_sm90
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(bias), ptr(resid), ptr(out), ptr(out2), M, N, K,
                 EPILOGUES[epi], torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90")
    gemm.launches += 1
    return out, out2


gemm.launches = 0
