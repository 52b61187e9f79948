"""The persistent wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) on its own.

K1 (``mlp_block``) and K2 (``attn_block``), and their stash twins (kernels 6
and 2), launch this GEMM from C for every forward product (fc1, fc2, qkv,
proj); kernels 8 and 9 (the MLP block's recompute and weight-streaming
backwards) for all five of theirs, and kernels 3 and 4 (the attention
block's stash and recompute backwards) for all of theirs (kernel 4's qkv
recompute on the forward form), in two more forms:

- the dual product: for each 128 x 128 tile of the (B·N, F) hidden layer,
  ``a = y @ W1 + b1`` and ``dh = g @ W2ᵀ`` into two accumulator sets, with
  an epilogue that writes ``da_c = bf16(dh · gelu'(a))``, ``h_c =
  bf16(gelu(a))`` and the fp32 column sums of ``da`` for db1;
- the group: up to three products in one persistent launch over the union
  of their output tiles, each ``"nt"`` (``a @ bᵀ``, b stored (N, K): dy =
  da_c @ W1ᵀ, dctx = g @ Wprojᵀ) or ``"tn"`` (``aᵀ @ b``, a stored (K, M):
  the weight gradients over the B·N token rows), a ``"tn"`` product rounded
  to bf16 optionally split along K into slices added in order.

No model calls the functions here: :func:`gemm` launches one forward
product with a chosen epilogue (``sky_gemm_sm90`` in ``csrc/mlp_block.cu``),
:func:`gemm_bwd` one backward product, :func:`mlp_weight_grads` kernel 8's
weight-gradient group and :func:`gemm_dual` the dual product
(``csrc/mlp_block_bwd.cu``), :func:`attn_weight_grads` kernels 3 and 4's
group (``csrc/attn_block_bwd.cu``), so that the card tests and
``chip_smoke.py`` can hold the GEMM alone to its plain version and time it
beside cuBLAS.

:func:`gemm_plan` is a copy of the forward tile rule (``gemm_sm90_plan``):
output tiles of 128 rows x BN columns, BN the one of 256, 192, 128 whose
last wave over the card's resident CTAs (one per SM) ends first, counted as
waves x BN; a narrower tile wins only when it cuts that by more than a
sixteenth (a wider one reads less shared memory per FLOP). Beside the
staged 128 x BN bf16 output tile, the ring holds as many 128 x 64 + 64 x BN
bf16 slots as fit a block's shared memory. :func:`bwd_plan` is a copy of
the group rule (``bwd_plan``): of BN = 256, 192, 128 and split counts 1 and
2, the pair of least modelled cost, the units dealt to the CTAs in
turn as the kernel deals them. Card tests hold the copies to the C rules;
the CPU tests hold them at every shipped config.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

import numpy as np

from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels.mlp_block import gelu, gelu_grad

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


# ---- the backward forms (csrc/gemm_sm90.cuh, entries in csrc/mlp_block_bwd.cu) ----

FORMS = {"nt": 1, "tn": 2}  # enum Form
BWD_EPILOGUES = {"store": 3, "store_f32": 4, "add_f32": 9}  # csrc/gemm.cuh enum Epilogue
SPLIT_CANDIDATES = (1, 2)
MAX_PROBLEMS = 3  # products in one group launch
# a product's kind in a group plan (enum ShapeKind): "nt" (never split), a
# weight gradient ("tn" rounded to bf16, may split its K), another "tn"
KIND_NT, KIND_TN_SPLIT, KIND_TN = 0, 1, 2
# the group plan's cost model (csrc/gemm_sm90.cuh), in units of about 0.1 us
# of one CTA: a 64-deep slab of a 128 x BN tile costs SLAB_COST[kind is
# "tn"][BN], its epilogue EPI_COST per 64 columns, a split product's reduce
# one unit per REDUCE_BYTES_PER_COST bytes it moves
SLAB_COST = {False: {256: 11, 192: 7, 128: 5}, True: {256: 6, 192: 5, 128: 4}}
EPI_COST = 1
REDUCE_BYTES_PER_COST = 1 << 16
DUAL_BN = 128
DUAL_STAGE_BYTES = 4 * BM * BK * 2  # y, g, W1 and W2 slabs of one ring slot


@dataclass(frozen=True)
class BwdPlan:
    bn: int  # tile width of every product of the group
    splits: int  # the split count offered to each weight gradient
    units: int  # (tile, K slice) units over all products
    smem: int  # dynamic shared-memory bytes of a CTA
    cost: int  # the modelled cost


def split_count(nk: int, split: int) -> tuple[int, int]:
    """(slices, slabs per slice) of a K of ``nk`` 64-deep slabs cut into at
    most ``split`` slices (``split_count``)."""
    want = min(split, nk)
    chunk = -(-nk // want)
    return -(-nk // chunk), chunk


def _bwd_cost(shapes, bn: int, split: int, sms: int) -> tuple[int, int]:
    """(modelled cost, units) of a group (``bwd_cost``): ``shapes`` is a
    sequence of (kind, M, N, K)."""
    costs, extra = [], 0
    for kind, M, N, K in shapes:
        nk = -(-K // BK)
        sp, chunk = split_count(nk, split) if kind == KIND_TN_SPLIT else (1, nk)
        tiles = -(-M // BM) * -(-N // bn)
        slab = SLAB_COST[kind != KIND_NT][bn]
        per = np.array([(chunk if z < sp - 1 else nk - (sp - 1) * chunk) * slab
                        + EPI_COST * (bn // 64) for z in range(sp)], dtype=np.int64)
        costs.append(np.tile(per, tiles))
        if sp > 1:
            extra += (sp * M * N * 4 + M * N * 2) // REDUCE_BYTES_PER_COST
    costs = np.concatenate(costs)
    units = len(costs)
    grid = min(units, sms)
    load = np.bincount(np.arange(units) % grid, weights=costs, minlength=grid)
    return int(load.max()) + extra, units


def bwd_plan(shapes, sms: int = H100_SMS) -> BwdPlan:
    """The group rule of ``csrc/gemm_sm90.cuh`` (``bwd_plan``) for products
    (kind, M, N, K) over ``sms`` resident CTAs: of BN = 256, 192, 128 and
    the split counts 1 and 2 (only 1 when no product may split) the pair of
    least modelled cost, a later candidate winning only by more than a
    sixteenth."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    splits = SPLIT_CANDIDATES if any(s[0] == KIND_TN_SPLIT for s in shapes) else (1,)
    best = None
    for bn in BNS:
        for split in splits:
            cost, units = _bwd_cost(shapes, bn, split, sms)
            if best is None or cost * 16 < best.cost * 15:
                smem = _stages(bn) * _stage_bytes(bn) + _out_bytes(bn) + SMEM_EXTRA
                best = BwdPlan(bn, split, units, smem, cost)
    return best


def bwd_workspace(shapes, plan: BwdPlan) -> int:
    """fp32 floats of split partials a group needs under ``plan``: a copy of
    the C rule, which sizes every launch's workspace (:func:`bwd_plan_cuda`)."""
    n = 0
    for kind, M, N, K in shapes:
        sp = split_count(-(-K // BK), plan.splits)[0] if kind == KIND_TN_SPLIT else 1
        if sp > 1:
            n += sp * M * N
    return n


def bwd_plan_cuda(shapes, sms: int = H100_SMS, splits: int = 0) -> tuple[BwdPlan, int]:
    """The group rule as the C source computes it (builds ``lib mlp_block_bwd``):
    ``(plan, workspace floats)`` of one to three products; ``splits`` > 0
    forces the split count, as :func:`gemm_bwd` may."""
    if not 1 <= len(shapes) <= MAX_PROBLEMS:
        raise ValueError(f"a group holds 1 to {MAX_PROBLEMS} products, got {len(shapes)}")
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_bwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    flat = [int(v) for s in shapes for v in s]
    out = (ctypes.c_longlong * 6)()
    fn(len(shapes), (ctypes.c_int * len(flat))(*flat), sms, splits, out)
    if out[0] < 0:
        raise ValueError(f"sky_gemm_sm90_bwd_plan refused {shapes}")
    return BwdPlan(*(int(v) for v in out[:5])), int(out[5])


def mlp_bwd_groups(M: int, D: int, fs: int):
    """The two launches of the group kernel in kernel 8 (``fs = F``) or in
    one slab of kernel 9, as lists of (kind, M, N, K): dy (``"nt"``, fp32),
    then dW1 and dW2 together (``"tn"``, bf16, may split)."""
    return [[(KIND_NT, M, D, fs)], [(KIND_TN_SPLIT, D, fs, M), (KIND_TN_SPLIT, fs, D, M)]]


def attn_bwd_groups(M: int, D: int):
    """The three launches of the group kernel in kernels 3 and 4 at M = B·N
    token rows and width D, as lists of (kind, M, N, K): dctx = g @ Wprojᵀ
    (``"nt"``, bf16), dy = dqkv_c @ Wqkvᵀ (``"nt"``, fp32), then dWqkv and
    dWproj together (``"tn"``, bf16, may split). Kernel 4's qkv recompute
    runs on the forward form (:func:`gemm_plan` of (M, 3·D))."""
    return [[(KIND_NT, M, D, D)], [(KIND_NT, M, D, 3 * D)],
            [(KIND_TN_SPLIT, D, 3 * D, M), (KIND_TN_SPLIT, D, D, M)]]


def dual_plan(M: int, N: int) -> dict:
    """Tiles, ring stages and shared memory of the dual product: 128 x 128
    tiles, 64 KB slots beside one staged 128 x 128 bf16 tile."""
    out_bytes = BM * DUAL_BN * 2
    stages = (SMEM_OPTIN_MAX - SMEM_EXTRA - out_bytes) // DUAL_STAGE_BYTES
    return {"tiles": -(-M // BM) * -(-N // DUAL_BN), "stages": stages,
            "smem": stages * DUAL_STAGE_BYTES + out_bytes + SMEM_EXTRA}


def _bwd_operands(a, b, form):
    if form == "nt":
        (M, K), N = a.shape, b.shape[0]
        if b.shape[1] != K:
            raise ValueError(f"nt: want a (M, K) and b (N, K), got {tuple(a.shape)}, {tuple(b.shape)}")
    elif form == "tn":
        (K, M), N = a.shape, b.shape[1]
        if b.shape[0] != K:
            raise ValueError(f"tn: want a (K, M) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    else:
        raise ValueError(f"form {form!r} is none of {sorted(FORMS)}")
    return M, N, K


def gemm_bwd_plain(a, b, form: str, epi: str, c=None):
    """Plain version of one backward product: ``a @ bᵀ`` (``"nt"``) or
    ``aᵀ @ b`` (``"tn"``) of the bf16 operands in fp32, then ``"store"``
    rounds it to bf16, ``"store_f32"`` keeps it, ``"add_f32"`` returns
    ``product + c``."""
    _bwd_operands(a, b, form)
    if epi not in BWD_EPILOGUES:
        raise ValueError(f"epilogue {epi!r} is none of {sorted(BWD_EPILOGUES)}")
    acc = torch.matmul(a.float(), b.float().t()) if form == "nt" else torch.matmul(a.float().t(), b.float())
    if epi == "store":
        return acc.to(torch.bfloat16)
    return acc + c if epi == "add_f32" else acc


def gemm_bwd(a, b, form: str, epi: str, c=None, bn: int = 0, splits: int = 0):
    """As :func:`gemm_bwd_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``sky_gemm_sm90_bwd`` (the group kernel with this one
    product) or raise. ``bn`` / ``splits`` > 0 force the tile width and,
    for a ``"tn"`` product stored in bf16, the split count."""
    if a.device.type == "cpu":
        return gemm_bwd_plain(a, b, form, epi, c)
    M, N, K = _bwd_operands(a, b, form)
    if epi not in BWD_EPILOGUES:
        raise ValueError(f"epilogue {epi!r} is none of {sorted(BWD_EPILOGUES)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name}: want a contiguous bf16 tensor on {a.device}")
    if N % 8 or (K % 8 if form == "nt" else M % 8):
        raise ValueError(f"M={M}, N={N}, K={K}: the contiguous axes must be multiples of 8 "
                         "(16-byte TMA strides)")
    if bn not in (0, *BNS):
        raise ValueError(f"bn {bn} is none of {BNS}")
    out = out_f32 = None
    if epi == "store":
        out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    elif epi == "add_f32":
        if c is None or tuple(c.shape) != (M, N) or c.dtype != torch.float32 or c.device != a.device:
            raise ValueError(f"c: want a ({M}, {N}) fp32 tensor on {a.device}")
        out_f32 = c.clone()
    else:
        out_f32 = torch.empty((M, N), dtype=torch.float32, device=a.device)
    kind = KIND_NT if form == "nt" else KIND_TN_SPLIT if epi == "store" else KIND_TN
    shapes = [(kind, M, N, K)]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    ws = torch.empty(max(bwd_plan_cuda(shapes, sms, splits)[1], 4), dtype=torch.float32,
                     device=a.device)
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(out), ptr(out_f32), ws.data_ptr(), FORMS[form],
                 BWD_EPILOGUES[epi], M, N, K, bn, splits, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90_bwd")
    gemm_bwd.launches += 1
    return out if epi == "store" else out_f32


gemm_bwd.launches = 0


def mlp_weight_grads(y, da_c, h_c, g, bn: int = 0, splits: int = 0):
    """``(dW1, dW2) = (yᵀ @ da_c, h_cᵀ @ g)`` rounded to bf16, from y, g (M,
    D) and da_c, h_c (M, F). CPU tensors take the plain version; CUDA
    tensors launch the two as kernel 8 does, one group of the ``"tn"`` form
    (``sky_mlp_bwd_weight_grads``), or raise. ``bn`` / ``splits`` > 0 force
    the tile width and the split count."""
    if y.device.type == "cpu":
        return gemm_bwd_plain(y, da_c, "tn", "store"), gemm_bwd_plain(h_c, g, "tn", "store")
    (M, D), F = y.shape, da_c.shape[1]
    for name, t, shape in (("y", y, (M, D)), ("g", g, (M, D)), ("da_c", da_c, (M, F)),
                           ("h_c", h_c, (M, F))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != y.device):
            raise ValueError(f"{name}: want a contiguous {shape} bf16 tensor on {y.device}")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 (16-byte TMA strides)")
    if bn not in (0, *BNS):
        raise ValueError(f"bn {bn} is none of {BNS}")
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    n_ws = bwd_plan_cuda(mlp_bwd_groups(M, D, F)[1], sms, splits)[1]
    ws = torch.empty(max(n_ws, 4), dtype=torch.float32, device=y.device)
    dw1 = torch.empty((D, F), dtype=torch.bfloat16, device=y.device)
    dw2 = torch.empty((F, D), dtype=torch.bfloat16, device=y.device)
    fn = cuda_build.load("mlp_block_bwd").sky_mlp_bwd_weight_grads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(t.data_ptr() for t in (y, da_c, h_c, g, dw1, dw2, ws)), M, D, F, F, bn, splits,
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_mlp_bwd_weight_grads")
    mlp_weight_grads.launches += 1
    return dw1, dw2


mlp_weight_grads.launches = 0


def attn_weight_grads(y, dqkv_c, ctx, g, bn: int = 0, splits: int = 0):
    """``(dWqkv, dWproj) = (yᵀ @ dqkv_c, ctxᵀ @ g)`` rounded to bf16, from y,
    ctx, g (M, D) and dqkv_c (M, 3·D). CPU tensors take the plain version;
    CUDA tensors launch the two as kernels 3 and 4 do, one group of the
    ``"tn"`` form (``sky_attn_bwd_weight_grads``), or raise. ``bn`` /
    ``splits`` > 0 force the tile width and the split count."""
    if y.device.type == "cpu":
        return gemm_bwd_plain(y, dqkv_c, "tn", "store"), gemm_bwd_plain(ctx, g, "tn", "store")
    M, D = y.shape
    for name, t, shape in (("y", y, (M, D)), ("ctx", ctx, (M, D)), ("g", g, (M, D)),
                           ("dqkv_c", dqkv_c, (M, 3 * D))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != y.device):
            raise ValueError(f"{name}: want a contiguous {shape} bf16 tensor on {y.device}")
    if D % 8:
        raise ValueError(f"D={D} must be a multiple of 8 (16-byte TMA strides)")
    if bn not in (0, *BNS):
        raise ValueError(f"bn {bn} is none of {BNS}")
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    n_ws = bwd_plan_cuda(attn_bwd_groups(M, D)[2], sms, splits)[1]
    ws = torch.empty(max(n_ws, 4), dtype=torch.float32, device=y.device)
    dwqkv = torch.empty((D, 3 * D), dtype=torch.bfloat16, device=y.device)
    dwproj = torch.empty((D, D), dtype=torch.bfloat16, device=y.device)
    fn = cuda_build.load("attn_block_bwd").sky_attn_bwd_weight_grads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(t.data_ptr() for t in (y, dqkv_c, ctx, g, dwqkv, dwproj, ws)), M, D, bn, splits,
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_attn_bwd_weight_grads")
    attn_weight_grads.launches += 1
    return dwqkv, dwproj


attn_weight_grads.launches = 0


def gemm_dual_plain(y, w1, b1, g, w2):
    """Plain version of the dual product: ``(da_c, h_c, db1)`` with ``a = y @
    W1 + b1`` and ``dh = g @ W2ᵀ`` in fp32, ``da = dh · gelu'(a)``, ``da_c``
    and ``h_c = gelu(a)`` rounded to bf16, ``db1`` the fp32 column sums of
    ``da`` (``_bwd_kernel``, mlp_block.py:322-329, :352)."""
    a = torch.matmul(y.float(), w1.float()) + b1
    da = torch.matmul(g.float(), w2.float().t()) * gelu_grad(a)
    return da.to(torch.bfloat16), gelu(a).to(torch.bfloat16), da.sum(0)


def gemm_dual(y, w1, b1, g, w2):
    """As :func:`gemm_dual_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``sky_gemm_sm90_dual`` or raise."""
    if y.device.type == "cpu":
        return gemm_dual_plain(y, w1, b1, g, w2)
    (M, K), N = y.shape, w1.shape[1]
    want = {"y": (y, (M, K), torch.bfloat16), "g": (g, (M, K), torch.bfloat16),
            "w1": (w1, (K, N), torch.bfloat16), "w2": (w2, (N, K), torch.bfloat16),
            "b1": (b1, (N,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() or t.device != y.device:
            raise ValueError(f"{name}: want contiguous {shape} {dtype} on {y.device}")
    if N % 8 or K % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte TMA strides)")
    bf = dict(dtype=torch.bfloat16, device=y.device)
    da_c, h_c = torch.empty((M, N), **bf), torch.empty((M, N), **bf)
    part = torch.empty(-(-M // 64) * N, dtype=torch.float32, device=y.device)
    db1 = torch.empty(N, dtype=torch.float32, device=y.device)
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_dual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(t.data_ptr() for t in (y, w1, b1, g, w2, da_c, h_c, part, db1)), M, N, K,
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90_dual")
    gemm_dual.launches += 1
    return da_c, h_c, db1


gemm_dual.launches = 0
