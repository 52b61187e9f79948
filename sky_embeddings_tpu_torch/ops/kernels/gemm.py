"""The persistent wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) on its own.

K1 (``mlp_block``) and K2 (``attn_block``), and their stash twins (kernels 6
and 2), launch this GEMM from C for every forward product (fc1, fc2, qkv,
proj); the backwards, kernels 8, 7 and 9 (the MLP block's recompute, stash
and weight-streaming ones) and 3 and 4 (the attention block's stash and
recompute ones), for every product of theirs (kernel 4's qkv recompute on
the forward form), in three more forms:

- the dual product: for each 128 x 128 tile of the (B·N, F) hidden layer,
  ``a = y @ W1 + b1`` and ``dh = g @ W2ᵀ`` into two accumulator sets, with
  an epilogue that writes ``da_c = bf16(dh · gelu'(a))``, ``h_c =
  bf16(gelu(a))`` and the fp32 column sums of ``da`` for db1;
- the stash dh product (kernel 7's): ``dh = g @ W2ᵀ`` alone, with the
  dual's epilogue on ``a`` read from the tile of the bf16 stash;
- the group: up to three products in one persistent launch over the union
  of their output tiles, each ``"nt"`` (``a @ bᵀ``, b stored (N, K): dy =
  da_c @ W1ᵀ, dctx = g @ Wprojᵀ) or ``"tn"`` (``aᵀ @ b``, a stored (K, M):
  the weight gradients over the B·N token rows), a ``"tn"`` product rounded
  to bf16 optionally split along K into slices added in order.

No model calls the functions here: :func:`gemm` launches one forward
product with a chosen epilogue (``sky_gemm_sm90`` in ``csrc/mlp_block.cu``),
:func:`gemm_bwd` one backward product, :func:`mlp_weight_grads` kernel 8's
weight-gradient group, :func:`gemm_dual` the dual product and
:func:`gemm_dh_stash` the stash dh product (``csrc/mlp_block_bwd.cu``),
:func:`attn_weight_grads` kernels 3 and 4's group
(``csrc/attn_block_bwd.cu``), :func:`gemm_bwd_group` any group of weight
gradients (the tensor-parallel ranks' among them), so that the card tests
and ``chip_smoke.py`` can hold the GEMM alone to its plain version and time
it beside cuBLAS.

:func:`gemm_plan` is a copy of the forward tile rule (``gemm_sm90_plan``):
output tiles of 128 rows x BN columns, BN the one of 256, 192, 128 whose
last wave over the card's resident CTAs (one per SM) ends first, counted as
waves x BN; a narrower tile wins only when it cuts that by more than a
sixteenth (a wider one reads less shared memory per FLOP). Beside the
staged 128 x BN bf16 output tile, the ring holds as many 128 x 64 + 64 x BN
bf16 slots as fit a block's shared memory. :func:`bwd_plan` is a copy of
the group rule (``bwd_plan``): of BN = 256, 192, 128 and split counts 1 and
2, the pair of least modelled cost, the units dealt to the CTAs in
turn as the kernel deals them; then, where the tiles at BN = 128 cut in
two slices leave SMs idle and every product is a weight gradient, the
stream-K schedule at each width (the group's (tile, 64-deep slab)
iterations dealt in equal contiguous runs to the persistent CTAs, a
tile's partials added by its owner in segment order:
:func:`stream_k_segments`, :func:`gemm_bwd_stream_k_plain`), the plan
saying which (``BwdPlan.schedule``). Card tests hold the copies to the C
rules; the CPU tests hold them at every shipped config.

:func:`gemm_f32` launches one product of the fp32 GEMM (``csrc/gemm_f32.cuh``,
3xTF32 on wgmma fed by TMA; ``sky_gemm_f32_ld`` in ``csrc/mlp_block.cu``)
that the block kernels' fp32 forms run every product on, in any of its
forms and epilogues and with row pitches, so that the card tests can hold
it to fp32 ``torch.mm`` (TF32 off) and ``chip_smoke.py`` can time it.
:func:`f32_plan` is a copy of its tile rule (``f32_plan``): output tiles of
128 rows x BN columns, BN = 128 or 64, and for a ``"tn"`` product with a
workspace 1 to 8 K slices, whichever the modelled time (waves x slabs a
slice x (BN + a tile's fixed cost), plus the split's partials' traffic)
favours by more than a sixteenth; :func:`f32_workspace` the workspace the
blocks' C entries size from it.
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
SMEM_OPTIN_MAX = 232448  # dynamic shared memory a block may use, csrc/common.cuh
SMEM_EXTRA = 1024 + 256  # alignment slack and barriers, csrc/gemm_sm90.cuh
H100_SMS = 132
# the epilogues the C entry takes (csrc/common.cuh enum Epilogue)
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
BWD_EPILOGUES = {"store": 3, "store_f32": 4, "add_f32": 9}  # csrc/common.cuh enum Epilogue
SPLIT_CANDIDATES = (1, 2)
SCHEDULES = {"split": 1, "stream_k": 2}  # a forced schedule, bwd_plan_forced in the C source
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
# stream-K: one unit per STREAMK_BYTES_PER_COST bytes of each 128 x BN fp32
# partial a CTA stores or, as a tile's owner, reads through L2
STREAMK_BYTES_PER_COST = 1 << 13
# stream-K runs that cross tiles: their slabs at this many times the cost
# (their K out of step with the other tiles' runs; the card's reading, PERF.md §6)
STREAMK_SCATTER = 2
DUAL_BN = 128
DUAL_STAGE_BYTES = 4 * BM * BK * 2  # y, g, W1 and W2 slabs of one ring slot
STASH_BN = 128  # the stash dh product's tile width (csrc/gemm_sm90.cuh STASH_BN)


@dataclass(frozen=True)
class BwdPlan:
    bn: int  # tile width of every product of the group
    splits: int  # the split count offered to each weight gradient (stream-K: 1)
    units: int  # (tile, K slice) units over all products; stream-K: (tile, slab) iterations
    smem: int  # dynamic shared-memory bytes of a CTA
    cost: int  # the modelled cost
    schedule: str = "split"  # or "stream_k"
    ctas: int = 0  # CTAs launched: min(units, sms), or stream-K's deal's


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


def _smem(bn: int) -> int:
    return _stages(bn) * _stage_bytes(bn) + _out_bytes(bn) + SMEM_EXTRA


def stream_k_fits(shapes, sms: int = H100_SMS) -> bool:
    """Stream-K may run a group (``stream_k_fits``): every product a weight
    gradient, and the tiles at BN = 128 cut in two slices give fewer units
    than SMs."""
    if any(kind != KIND_TN_SPLIT for kind, *_ in shapes):
        return False
    units = sum(-(-M // BM) * -(-N // 128) * split_count(-(-K // BK), 2)[0]
                for _, M, N, K in shapes)
    return units < sms


def _stream_k_tiles(shapes, bn: int):
    """(problem, tile, first iteration, slabs) of every tile in the deal's
    order, and W, the group's (tile, slab) iterations."""
    tiles, t0 = [], 0
    for i, (_, M, N, K) in enumerate(shapes):
        nk = -(-K // BK)
        for tile in range(-(-M // BM) * -(-N // bn)):
            tiles.append((i, tile, t0, nk))
            t0 += nk
    return tiles, t0


def stream_k_grids(shapes, bn: int, sms: int = H100_SMS) -> tuple[int, int]:
    """Stream-K's two deals at width ``bn`` (``streamk_work``): the CTA
    count whose runs each lie inside one tile, in step in K with the other
    tiles' (the largest multiple of the tile count within ``sms``, at two or
    more CTAs a tile, where every product has the same K; 0 when there is
    none), and min(W, sms), whose runs cross tiles."""
    tiles, W = _stream_k_tiles(shapes, bn)
    same_k = len({nk for *_, nk in tiles}) == 1
    aligned = sms // len(tiles) * len(tiles) if same_k and sms // len(tiles) >= 2 and W >= sms \
        else 0
    return aligned, min(W, sms)


def _cta_of(it: int, grid: int, W: int) -> int:
    """The CTA whose run [g W / grid, (g + 1) W / grid) holds iteration it."""
    return ((it + 1) * grid - 1) // W


def _streamk_cost(shapes, bn: int, grid: int) -> tuple[int, int]:
    """(modelled cost, W) of the stream-K schedule over ``grid`` CTAs
    (``streamk_cost``): each CTA's slabs and the epilogues of the tiles it
    finishes, one partial stored for a piece without its tile's last slab,
    the owner's read of each of its tile's partials; the most loaded CTA's.
    Runs that cross tiles pay STREAMK_SCATTER times a slab's cost."""
    tiles, W = _stream_k_tiles(shapes, bn)
    aligned = stream_k_grids(shapes, bn, grid)[0] == grid
    part = BM * bn * 4 // STREAMK_BYTES_PER_COST
    slab = SLAB_COST[True][bn] * (1 if aligned else STREAMK_SCATTER)
    epi = EPI_COST * (bn // 64)
    load = [0] * grid
    for _, _, t0, nk in tiles:
        first, last = _cta_of(t0, grid, W), _cta_of(t0 + nk - 1, grid, W)
        for g in range(first, last + 1):
            lo, hi = g * W // grid, (g + 1) * W // grid
            load[g] += (min(hi, t0 + nk) - max(lo, t0)) * slab
            load[g] += epi + part * (last - first) if g == last else part
    return max(load), W


def _streamk_plan(shapes, bn: int, sms: int) -> BwdPlan:
    """Stream-K at width ``bn`` (``streamk_plan``): the deal in step with
    the tiles where there is one, then the one over min(W, sms) CTAs,
    which must cut the cost by more than a sixteenth."""
    best = None
    aligned, crossing = stream_k_grids(shapes, bn, sms)
    for grid in (aligned, crossing):
        if grid <= 0 or (best is not None and grid == best.ctas):
            continue
        cost, units = _streamk_cost(shapes, bn, grid)
        if best is None or cost * 16 < best.cost * 15:
            best = BwdPlan(bn, 1, units, _smem(bn), cost, "stream_k", grid)
    return best


def split_plan(shapes, sms: int = H100_SMS) -> BwdPlan:
    """The split schedule's plan of ``csrc/gemm_sm90.cuh`` (``split_plan``)
    for products (kind, M, N, K) over ``sms`` resident CTAs: of BN = 256,
    192, 128 and the split counts 1 and 2 (only 1 when no product may
    split), the one of least modelled cost, a later candidate winning only
    by more than a sixteenth."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    splits = SPLIT_CANDIDATES if any(s[0] == KIND_TN_SPLIT for s in shapes) else (1,)
    best = None
    for bn in BNS:
        for split in splits:
            cost, units = _bwd_cost(shapes, bn, split, sms)
            if best is None or cost * 16 < best.cost * 15:
                best = BwdPlan(bn, split, units, _smem(bn), cost, "split", min(units, sms))
    return best


def bwd_plan(shapes, sms: int = H100_SMS) -> BwdPlan:
    """The group rule of ``csrc/gemm_sm90.cuh`` (``bwd_plan``):
    :func:`split_plan`'s, then stream-K at each width where
    :func:`stream_k_fits`, which must cut the modelled cost by more than a
    sixteenth."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    best = split_plan(shapes, sms)
    if stream_k_fits(shapes, sms):
        for bn in BNS:
            sk = _streamk_plan(shapes, bn, sms)
            if sk.cost * 16 < best.cost * 15:
                best = sk
    return best


def bwd_plan_forced(shapes, sms: int = H100_SMS, bn: int = 0, splits: int = 0,
                    schedule: str | None = None) -> BwdPlan:
    """The plan a launch runs with ``bn``, ``splits`` or ``schedule``
    forced (``bwd_plan_forced``): ``splits`` > 0 or ``"split"`` the split
    schedule (one slice unless ``splits`` says), ``"stream_k"`` stream-K
    (a group of weight gradients only); what is not forced, the plan's."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    plan = bwd_plan(shapes, sms)
    if not bn and not splits and schedule is None:
        return plan
    if schedule not in (None, *SCHEDULES):
        raise ValueError(f"schedule {schedule!r} is none of {sorted(SCHEDULES)}")
    b = bn or plan.bn
    if b not in BNS:
        raise ValueError(f"bn {b} is none of {BNS}")
    if schedule == "stream_k" or (schedule is None and not splits
                                  and plan.schedule == "stream_k"):
        if any(kind != KIND_TN_SPLIT for kind, *_ in shapes):
            raise ValueError("stream-K runs a group of weight gradients alone")
        return _streamk_plan(shapes, b, sms)
    sp = splits or (1 if plan.schedule == "stream_k" else plan.splits)
    cost, units = _bwd_cost(shapes, b, sp, sms)
    return BwdPlan(b, sp, units, _smem(b), cost, "split", min(units, sms))


def bwd_workspace(shapes, plan: BwdPlan) -> int:
    """fp32 floats of workspace a group needs under ``plan``: the split
    partials, or stream-K's flags (two a CTA, padded to 64 floats) and a
    128 x BN slot for each of its CTAs. A copy of the C rule, which sizes
    every launch's workspace (:func:`bwd_plan_cuda`)."""
    if plan.schedule == "stream_k":
        return -(-2 * plan.ctas // 64) * 64 + plan.ctas * BM * plan.bn
    n = 0
    for kind, M, N, K in shapes:
        sp = split_count(-(-K // BK), plan.splits)[0] if kind == KIND_TN_SPLIT else 1
        if sp > 1:
            n += sp * M * N
    return n


def bwd_plan_cuda(shapes, sms: int = H100_SMS, splits: int = 0, bn: int = 0,
                  schedule: str | None = None) -> tuple[BwdPlan, int]:
    """The group rule as the C source computes it (builds ``lib mlp_block_bwd``):
    ``(plan, workspace floats)`` of one to three products; ``bn``,
    ``splits``, ``schedule`` force the plan as :func:`gemm_bwd` may."""
    if not 1 <= len(shapes) <= MAX_PROBLEMS:
        raise ValueError(f"a group holds 1 to {MAX_PROBLEMS} products, got {len(shapes)}")
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_bwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    flat = [int(v) for s in shapes for v in s]
    out = (ctypes.c_longlong * 8)()
    fn(len(shapes), (ctypes.c_int * len(flat))(*flat), sms, bn, splits,
       SCHEDULES.get(schedule, 0), out)
    if out[0] < 0:
        raise ValueError(f"sky_gemm_sm90_bwd_plan refused {shapes} (bn {bn}, splits {splits}, "
                         f"schedule {schedule})")
    plan = BwdPlan(*(int(v) for v in out[:5]), "stream_k" if out[6] else "split", int(out[7]))
    return plan, int(out[5])


def stream_k_segments(shapes, bn: int, grid: int):
    """The stream-K deal of a group at tile width ``bn`` over ``grid`` CTAs
    (at most W): for each CTA, its pieces in the order it walks them (its
    run's last first), each (problem, tile, kb0, kb1): slabs [kb0, kb1) of
    that output tile (tiles row-major over 128 x bn, n fastest)."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    tiles, W = _stream_k_tiles(shapes, bn)
    starts = np.array([t0 for _, _, t0, _ in tiles])
    out = []
    for g in range(grid):
        lo, hi, segs = g * W // grid, (g + 1) * W // grid, []
        while hi > lo:
            i, tile, t0, nk = tiles[int(np.searchsorted(starts, hi - 1, side="right")) - 1]
            frm = max(lo, t0)
            segs.append((i, tile, frm - t0, hi - t0))
            hi = frm
        out.append(segs)
    return out


def gemm_bwd_stream_k_plain(ops, bn: int, grid: int, out_dtype=torch.bfloat16):
    """The stream-K schedule of a group of weight gradients over ``grid``
    CTAs run in fp32 as the kernel runs it: ``ops`` a list of (a (K, M),
    b (K, N)); each CTA's
    pieces summed over their slabs, a piece without its tile's last slab
    kept as the CTA's partial, and each tile's owner (the CTA with its last
    slab) adding to its own piece the partials of the CTAs before it whose
    runs reach into the tile, in CTA order (the segments' order), then
    rounding once. Returns the outputs (M, N) in ``out_dtype`` (the
    kernel's bf16; fp32 reads the sums before the rounding)."""
    shapes = [(KIND_TN_SPLIT, a.shape[1], b.shape[1], a.shape[0]) for a, b in ops]
    tiles, W = _stream_k_tiles(shapes, bn)
    first = {(i, tile): t0 for i, tile, t0, _ in tiles}
    nks = [-(-K // BK) for *_, K in shapes]
    runs = stream_k_segments(shapes, bn, grid)

    def piece(i, tile, kb0, kb1):
        a, b = ops[i]
        n_tiles = -(-b.shape[1] // bn)
        m0, n0 = (tile // n_tiles) * BM, (tile % n_tiles) * bn
        acc = a[kb0 * BK:kb1 * BK, m0:m0 + BM].float().t() @ b[kb0 * BK:kb1 * BK, n0:n0 + bn].float()
        return acc, m0, n0

    partials = {g: piece(*seg)[0] for g, run in enumerate(runs) for seg in run
                if seg[3] < nks[seg[0]]}
    outs = [torch.empty(M, N) for _, M, N, _ in shapes]
    for g, run in enumerate(runs):
        for i, tile, kb0, kb1 in run:
            if kb1 < nks[i]:
                continue
            acc, m0, n0 = piece(i, tile, kb0, kb1)
            if kb0 > 0:
                for c in range(_cta_of(first[(i, tile)], grid, W), g):
                    acc = acc + partials[c]
            outs[i][m0:m0 + BM, n0:n0 + bn] = acc
    return [o.to(out_dtype) for o in outs]


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


def dh_stash_plan(M: int, N: int) -> dict:
    """Tiles, ring stages and shared memory of the stash dh product
    (``StashCfg``): 128 x STASH_BN tiles; slots of g's 128 x 64 box and
    W2's STASH_BN x 64 box beside two 128 x STASH_BN bf16 buffers (the
    stash, then h_c; da_c) and the four warps' column sums of each
    consumer."""
    stage = BM * BK * 2 + STASH_BN * BK * 2
    fixed = 2 * BM * STASH_BN * 2 + 2 * 4 * STASH_BN * 4 + SMEM_EXTRA
    stages = (SMEM_OPTIN_MAX - fixed) // stage
    return {"tiles": -(-M // BM) * -(-N // STASH_BN), "stages": stages,
            "smem": stages * stage + fixed}


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


def gemm_bwd(a, b, form: str, epi: str, c=None, bn: int = 0, splits: int = 0,
             schedule: str | None = None):
    """As :func:`gemm_bwd_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``sky_gemm_sm90_bwd`` (the group kernel with this one
    product) or raise. ``bn`` / ``splits`` > 0 force the tile width and,
    for a ``"tn"`` product stored in bf16, the split count; ``schedule``
    (``"split"`` or ``"stream_k"``, the latter for such a product alone)
    the schedule."""
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
    if schedule not in (None, *SCHEDULES):
        raise ValueError(f"schedule {schedule!r} is none of {sorted(SCHEDULES)}")
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
    with torch.cuda.device(a.device):
        n_ws = bwd_plan_cuda(shapes, sms, splits, bn, schedule)[1]
    ws = torch.empty(max(n_ws, 4), dtype=torch.float32, device=a.device)
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(out), ptr(out_f32), ws.data_ptr(), FORMS[form],
                 BWD_EPILOGUES[epi], M, N, K, bn, splits, SCHEDULES.get(schedule, 0),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90_bwd")
    gemm_bwd.launches += 1
    return out if epi == "store" else out_f32


gemm_bwd.launches = 0


def mlp_weight_grads(y, da_c, h_c, g, bn: int = 0, splits: int = 0,
                     schedule: str | None = None):
    """``(dW1, dW2) = (yᵀ @ da_c, h_cᵀ @ g)`` rounded to bf16, from y, g (M,
    D) and da_c, h_c (M, F). CPU tensors take the plain version; CUDA
    tensors launch the two as kernel 8 does, one group of the ``"tn"`` form
    (``sky_mlp_bwd_weight_grads``), or raise. ``bn`` / ``splits`` > 0 force
    the tile width and the split count, ``schedule`` the schedule."""
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
    with torch.cuda.device(y.device):
        n_ws = bwd_plan_cuda(mlp_bwd_groups(M, D, F)[1], sms, splits, bn, schedule)[1]
    ws = torch.empty(max(n_ws, 4), dtype=torch.float32, device=y.device)
    dw1 = torch.empty((D, F), dtype=torch.bfloat16, device=y.device)
    dw2 = torch.empty((F, D), dtype=torch.bfloat16, device=y.device)
    fn = cuda_build.load("mlp_block_bwd").sky_mlp_bwd_weight_grads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(t.data_ptr() for t in (y, da_c, h_c, g, dw1, dw2, ws)), M, D, F, F, bn, splits,
                 SCHEDULES.get(schedule, 0), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_mlp_bwd_weight_grads")
    mlp_weight_grads.launches += 1
    return dw1, dw2


mlp_weight_grads.launches = 0


def attn_weight_grads(y, dqkv_c, ctx, g, bn: int = 0, splits: int = 0,
                      schedule: str | None = None):
    """``(dWqkv, dWproj) = (yᵀ @ dqkv_c, ctxᵀ @ g)`` rounded to bf16, from y,
    ctx, g (M, D) and dqkv_c (M, 3·D). CPU tensors take the plain version;
    CUDA tensors launch the two as kernels 3 and 4 do, one group of the
    ``"tn"`` form (``sky_attn_bwd_weight_grads``), or raise. ``bn`` /
    ``splits`` > 0 force the tile width and the split count, ``schedule``
    the schedule."""
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
    with torch.cuda.device(y.device):
        n_ws = bwd_plan_cuda(attn_bwd_groups(M, D)[2], sms, splits, bn, schedule)[1]
    ws = torch.empty(max(n_ws, 4), dtype=torch.float32, device=y.device)
    dwqkv = torch.empty((D, 3 * D), dtype=torch.bfloat16, device=y.device)
    dwproj = torch.empty((D, D), dtype=torch.bfloat16, device=y.device)
    fn = cuda_build.load("attn_block_bwd").sky_attn_bwd_weight_grads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        err = fn(*(t.data_ptr() for t in (y, dqkv_c, ctx, g, dwqkv, dwproj, ws)), M, D, bn, splits,
                 SCHEDULES.get(schedule, 0), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_attn_bwd_weight_grads")
    attn_weight_grads.launches += 1
    return dwqkv, dwproj


attn_weight_grads.launches = 0


def gemm_bwd_group_plain(ops):
    """Plain version of a group of weight gradients: ``aᵀ @ b`` of each
    (a (K, M), b (K, N)) in ``ops`` in fp32, rounded to bf16."""
    return [gemm_bwd_plain(a, b, "tn", "store") for a, b in ops]


def _group_shapes(ops):
    if not 1 <= len(ops) <= MAX_PROBLEMS:
        raise ValueError(f"a group holds 1 to {MAX_PROBLEMS} products, got {len(ops)}")
    return [(KIND_TN_SPLIT, a.shape[1], b.shape[1], a.shape[0]) for a, b in ops]


def gemm_bwd_group_plan(ops, bn: int = 0, splits: int = 0, schedule: str | None = None):
    """``(plan, workspace floats)`` of what :func:`gemm_bwd_group` runs for
    ``ops`` on their card, as the C source computes it (``bn``,
    ``splits``, ``schedule`` forced as there)."""
    dev = ops[0][0].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        return bwd_plan_cuda(_group_shapes(ops), sms, splits, bn, schedule)


def gemm_bwd_group(ops, bn: int = 0, splits: int = 0, schedule: str | None = None):
    """As :func:`gemm_bwd_group_plain`: one to three weight gradients in one
    launch of the group kernel (``sky_gemm_sm90_bwd_group``), as the
    backward kernels run theirs (the TP forms' dWqkv_r and dWproj_r, dW1_r
    and dW2_r). CPU tensors take the plain version; CUDA tensors launch or
    raise. ``bn``, ``splits``, ``schedule`` force the plan, as
    :func:`gemm_bwd`'s."""
    if ops[0][0].device.type == "cpu":
        return gemm_bwd_group_plain(ops)
    shapes = _group_shapes(ops)
    dev = ops[0][0].device
    for a, b in ops:
        M, N, _ = _bwd_operands(a, b, "tn")
        if any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != dev
               for t in (a, b)):
            raise ValueError(f"want contiguous bf16 operands on {dev}")
        if M % 8 or N % 8:
            raise ValueError(f"M={M}, N={N}: the contiguous axes must be multiples of 8 "
                             "(16-byte TMA strides)")
    if bn not in (0, *BNS):
        raise ValueError(f"bn {bn} is none of {BNS}")
    if schedule not in (None, *SCHEDULES):
        raise ValueError(f"schedule {schedule!r} is none of {sorted(SCHEDULES)}")
    ws = torch.empty(max(gemm_bwd_group_plan(ops, bn, splits, schedule)[1], 4),
                     dtype=torch.float32, device=dev)
    outs = [torch.empty((a.shape[1], b.shape[1]), dtype=torch.bfloat16, device=dev)
            for a, b in ops]
    n = len(ops)
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_bwd_group
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 3
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))  # noqa: E731
    dims = (ctypes.c_int * (3 * n))(*(v for _, M, N, K in shapes for v in (M, N, K)))
    with torch.cuda.device(dev):
        err = fn(n, ptrs(a for a, _ in ops), ptrs(b for _, b in ops), ptrs(outs), dims,
                 ws.data_ptr(), bn, splits, SCHEDULES.get(schedule, 0),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90_bwd_group")
    gemm_bwd_group.launches += 1
    return outs


gemm_bwd_group.launches = 0


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


def gemm_dh_stash_plain(g, w2, a):
    """Plain version of the stash dh product: ``(da_c, h_c, db1)`` with ``dh
    = g @ W2ᵀ`` in fp32 and the bf16 stash ``a`` upcast, ``da = dh ·
    gelu'(a)``, ``da_c`` and ``h_c = gelu(a)`` rounded to bf16, ``db1`` the
    fp32 column sums of ``da`` (``_bwd_stash_kernel``, mlp_block.py:392-399,
    :419)."""
    af = a.float()
    da = torch.matmul(g.float(), w2.float().t()) * gelu_grad(af)
    return da.to(torch.bfloat16), gelu(af).to(torch.bfloat16), da.sum(0)


def gemm_dh_stash(g, w2, a):
    """As :func:`gemm_dh_stash_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``sky_gemm_sm90_dh_stash`` or raise."""
    if g.device.type == "cpu":
        return gemm_dh_stash_plain(g, w2, a)
    (M, K), N = g.shape, w2.shape[0]
    want = {"g": (g, (M, K)), "w2": (w2, (N, K)), "a": (a, (M, N))}
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != g.device):
            raise ValueError(f"{name}: want a contiguous {shape} bf16 tensor on {g.device}")
    if N % 8 or K % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte TMA strides)")
    bf = dict(dtype=torch.bfloat16, device=g.device)
    da_c, h_c = torch.empty((M, N), **bf), torch.empty((M, N), **bf)
    part = torch.empty(-(-M // 64) * N, dtype=torch.float32, device=g.device)
    db1 = torch.empty(N, dtype=torch.float32, device=g.device)
    fn = cuda_build.load("mlp_block_bwd").sky_gemm_sm90_dh_stash
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(*(t.data_ptr() for t in (g, w2, a, da_c, h_c, part, db1)), M, N, K,
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_sm90_dh_stash")
    gemm_dh_stash.launches += 1
    return da_c, h_c, db1


gemm_dh_stash.launches = 0


# ---- the fp32 GEMM (csrc/gemm_f32.cuh, entry in csrc/mlp_block.cu) ----------

F32_FORMS = {"fwd": 0, "nt": 1, "tn": 2}  # enum f32::Form
F32_EPILOGUES = {"bias": 0, "bias_gelu": 1, "bias_residual": 2, "store": 3, "dgelu": 4,
                 "bias_gelu_stash": 5, "add": 6}
F32_FORM_EPILOGUES = {"fwd": ("bias", "bias_gelu", "bias_residual", "bias_gelu_stash"),
                      "nt": ("store", "dgelu", "add"), "tn": ("store",)}
F32_BK = 32  # depth of a ring slot: one 128-byte swizzle row of fp32
F32_A_BYTES = BM * F32_BK * 4
F32_BNS = (128, 64)  # tile widths, widest first
F32_MAX_SPLITS = 8
F32_MIN_SLICE = 1024  # token rows of a split slice at least
F32_REDUCE_BYTES_PER_COST = 1 << 15
F32_TILE_COST = 32  # a tile's cost per slab beyond its columns (A's loads and splits)


def _f32_operands(a, b, form):
    if form == "fwd":
        (M, K), N = a.shape, b.shape[1]
        if b.shape[0] != K:
            raise ValueError(f"fwd: want a (M, K) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
        return M, N, K
    return _bwd_operands(a, b, form)


def gemm_f32_plain(a, b, form: str, epi: str, bias=None, resid=None, aux=None):
    """Plain version of one fp32 product: ``a @ b`` (``"fwd"``), ``a @ bᵀ``
    (``"nt"``) or ``aᵀ @ b`` (``"tn"``), then the epilogue: ``"bias"``,
    ``"bias_gelu"`` (exact erf), ``"bias_residual"`` (``resid + (acc +
    bias)``), ``"store"``, ``"dgelu"`` (``(acc · gelu'(aux), gelu(aux))``:
    da and h from dh and the pre-activation), ``"bias_gelu_stash"``
    (``(gelu(acc + bias), acc + bias)``: kernel 6's h and its stash) or
    ``"add"`` (``acc + resid``: kernel 9's dy over the slabs). Returns
    ``(out, aux_out)``, aux_out None but for ``"dgelu"`` and
    ``"bias_gelu_stash"``."""
    M, N, K = _f32_operands(a, b, form)
    if epi not in F32_FORM_EPILOGUES.get(form, ()):
        raise ValueError(f"{form}: epilogue {epi!r} is none of {F32_FORM_EPILOGUES.get(form)}")
    acc = (torch.matmul(a, b) if form == "fwd" else torch.matmul(a, b.t()) if form == "nt"
           else torch.matmul(a.t(), b))
    if epi == "bias":
        return acc + bias, None
    if epi == "bias_gelu":
        return gelu(acc + bias), None
    if epi == "bias_gelu_stash":
        return gelu(acc + bias), acc + bias
    if epi == "bias_residual":
        return resid + (acc + bias), None
    if epi == "add":
        return acc + resid, None
    if epi == "dgelu":
        return acc * gelu_grad(aux), gelu(aux)
    return acc, None


@dataclass(frozen=True)
class F32Plan:
    bn: int  # tile width
    splits: int  # K slices (1: unsplit)
    kslabs: int  # F32_BK-deep slabs of a slice
    units: int  # (tile, K slice) units the persistent CTAs walk
    stages: int  # ring slots
    smem: int  # dynamic shared-memory bytes of a CTA


def _f32_stages(bn: int) -> int:
    return (SMEM_OPTIN_MAX - SMEM_EXTRA) // (F32_A_BYTES + 3 * bn * F32_BK * 4)


def f32_plan(M: int, N: int, K: int, may_split: bool = False, sms: int = H100_SMS) -> F32Plan:
    """The fp32 GEMM's tile rule (``f32_plan`` in ``csrc/gemm_f32.cuh``) for
    an (M, N, K) product over ``sms`` resident CTAs: of BN = 128, 64 and
    split counts 1 to F32_MAX_SPLITS (1 unless ``may_split``: a ``"tn"``
    product with a workspace; each slice F32_MIN_SLICE rows or more), the
    least modelled time, waves x slabs a slice x (BN + F32_TILE_COST) plus
    the split partials' traffic, a later candidate winning only by more
    than a sixteenth."""
    nk = -(-K // F32_BK)
    best, best_cost = None, 0
    for bn in F32_BNS:
        tiles = -(-M // BM) * -(-N // bn)
        for s in range(1, (F32_MAX_SPLITS if may_split else 1) + 1):
            if s > 1 and s * F32_MIN_SLICE > K:
                break
            per = -(-nk // s)
            if -(-nk // per) != s:
                continue  # the same slices as a smaller count
            units = tiles * s
            cost = -(-units // sms) * per * (bn + F32_TILE_COST)
            if s > 1:
                cost += (2 * s + 1) * M * N * 4 // F32_REDUCE_BYTES_PER_COST
            if best is None or cost * 16 < best_cost * 15:
                stages = _f32_stages(bn)
                smem = stages * (F32_A_BYTES + 3 * bn * F32_BK * 4) + SMEM_EXTRA
                best, best_cost = F32Plan(bn, s, per, units, stages, smem), cost
    return best


def f32_workspace(M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """fp32 floats of workspace a ``"tn"`` product's split slices take (0:
    unsplit): a copy of ``workspace`` in ``csrc/gemm_f32.cuh``, by which the
    blocks' C entries size theirs."""
    plan = f32_plan(M, N, K, True, sms)
    return plan.splits * M * N if plan.splits > 1 else 0


def f32_plan_cuda(M: int, N: int, K: int, may_split: bool = False,
                  sms: int = H100_SMS) -> F32Plan:
    """The same rule as the C source computes it (builds ``lib mlp_block``)."""
    fn = cuda_build.load("mlp_block").sky_gemm_f32_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 6)()
    fn(M, N, K, int(may_split), sms, out)
    return F32Plan(*out)


def _row_pitch(t, width: int) -> int:
    """The row pitch of a 2-D view whose rows are contiguous, or -1."""
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < width:
        return -1
    return t.stride(0)


def gemm_f32(a, b, form: str, epi: str, bias=None, resid=None, aux=None, out=None,
             bn: int = 0, splits: int = 0):
    """As :func:`gemm_f32_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``sky_gemm_f32_ld`` or raise. A ``"tn"`` product splits
    along K into slices added in order where its plan says so, as the block
    kernels' do; ``aux`` is not changed. ``a``, ``b`` and ``out`` (written in
    place when given) may be views whose rows lie apart (column slabs, as
    kernel 9 passes its weights), with pitches that are multiples of 4;
    a ``"bias_residual"`` ``resid`` then shares ``out``'s. ``bn`` (128 or
    64) and ``splits`` (a ``"tn"`` product's) force the plan, for sweeps."""
    if a.device.type == "cpu":
        got = gemm_f32_plain(a, b, form, epi, bias, resid, aux)
        if out is not None:
            out.copy_(got[0])
            return out, got[1]
        return got
    M, N, K = _f32_operands(a, b, form)
    if epi not in F32_FORM_EPILOGUES.get(form, ()):
        raise ValueError(f"{form}: epilogue {epi!r} is none of {F32_FORM_EPILOGUES.get(form)}")
    want = {"a": (a, tuple(a.shape)), "b": (b, tuple(b.shape))}
    if epi.startswith("bias"):
        want["bias"] = (bias, (N,))
    if epi in ("bias_residual", "add"):
        want["resid"] = (resid, (M, N))
    if epi == "dgelu":
        want["aux"] = (aux, (M, N))
    if out is not None:
        want["out"] = (out, (M, N))
    for name, (t, shape) in want.items():
        rows_ok = t is not None and (_row_pitch(t, shape[-1]) >= 0 if len(shape) == 2
                                     else t.is_contiguous())
        if not rows_ok or tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != a.device:
            got = None if t is None else (tuple(t.shape), t.dtype, str(t.device))
            raise ValueError(f"{name}: want an fp32 {shape} tensor on {a.device} with contiguous "
                             f"rows, got {got}")
    if (M if form == "tn" else K) % 4 or (K if form == "nt" else N) % 4 or N % 4:
        raise ValueError(f"M={M}, N={N}, K={K}: the contiguous axes must be multiples of 4 "
                         "(16-byte copies)")
    if out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    ldc = out.stride(0)
    if epi == "bias_residual" and resid.stride(0) != ldc:
        raise ValueError(f"resid: its row pitch {resid.stride(0)} is not out's ({ldc})")
    lds = (a.stride(0), b.stride(0), ldc)
    if any(ld % 4 for ld in lds) or any(t.data_ptr() % 16 for t in (a, b, out)):
        raise ValueError(f"row pitches {lds} must be multiples of 4 and the operands 16-byte "
                         "aligned")
    if epi == "add":
        out.copy_(resid)
    aux_out = None
    if epi == "dgelu":
        aux_out = torch.empty_strided((M, N), (ldc, 1), dtype=torch.float32, device=a.device)
        aux_out.copy_(aux)
    elif epi == "bias_gelu_stash":
        aux_out = torch.empty_strided((M, N), (ldc, 1), dtype=torch.float32, device=a.device)
    lib = cuda_build.load("mlp_block")
    ws = None
    if form == "tn":
        fn = lib.sky_gemm_f32_ws
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
        with torch.cuda.device(a.device):
            n = splits * M * N if splits > 1 else fn(M, N, K)
        ws = torch.empty(max(n, 4), dtype=torch.float32, device=a.device)
    fn = lib.sky_gemm_f32_ld
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(bias), ptr(resid if epi == "bias_residual" else None),
                 ptr(out), ptr(aux_out), ptr(ws), F32_FORMS[form], F32_EPILOGUES[epi], M, N, K,
                 *lds, bn, splits, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_gemm_f32_ld")
    gemm_f32.launches += 1
    return out, aux_out


gemm_f32.launches = 0
