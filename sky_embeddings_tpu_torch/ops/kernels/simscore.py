"""Weighted-cosine scoring of an embedding bank: one target, several targets,
the int8 two-stage scorers and the chunked out-of-memory scorer.

    score_i = <w·t, x_i> / (‖t‖_w · ‖x_i‖_w + 1e-6)

K3 (one target) replaces the TPU kernel
``sky_embeddings_tpu/ops/kernels/simscore.py`` ``weighted_bank_scores_pallas``
(``_scores_kernel``). On the TPU the dispatch sent Q = 1 to XLA; here a CUDA
tensor always launches the Triton kernel in ``simscore_triton.py``, for fp32
and bf16 banks. What bounds it on the H100: bytes. Each bank row is read once
in its storage dtype and upcast in registers; two fp32 row sums and a scalar
epilogue follow, with no tensor-core work at Q = 1. A masked block load
streams rows at memory rate, so the design is one pass over the bank.
``‖t‖_w`` and ``w·t`` are computed by the wrapper in fp32 (as
``simscore.py:115-116``).

Kernel 11 (Q targets, each with its own weights) replaces
``weighted_bank_scores_multi_pallas`` (``_scores_multi_kernel``); on the TPU
the dispatch sent it to XLA, here a CUDA tensor always launches
``csrc/simscore_multi.cu`` (CUDA C++; its header says what bounds it and how
it is laid out). What bounds it on the H100: bytes, the bank read once per
block of up to 64 queries in its storage dtype. Both products run on the
tensor cores (wgmma) with each fp32 operand split into two bf16 terms (a
bf16 bank's x² into two exact ones), five bf16 products per row and query
(six for an fp32 bank), so the scores keep fp32 grade (within 1e-4 of the
plain version) while the products take less time than the bank's bytes.
``(W⊙T)ᵀ``, ``Wᵀ`` (D, Q) and ``‖t‖_w`` (Q,) are computed by the wrapper in
fp32 and split where the kernel stages them; the output is (N, Q) fp32.

Around the kernels, as in JAX ``simscore.py:231-472``: ``bank_topk`` and
``bank_topk_multi`` (a kernel, then ``torch.topk``); ``bank_topk_int8`` and
``bank_topk_multi_int8`` (stage 1: exact int8 products of a per-row max-abs
int8 bank with the int8-quantised ``w·t``, ranked by the quantised rows'
norms; stage 2: the ``oversample`` best candidates gathered from the
stored-precision bank and rescored exactly in fp32); ``bank_topk_chunked``
(fixed-shape host slabs streamed through K3, the next slab's copy in flight
while the current one scores, winners merged on the host). Stage 1 is an
XLA ``dot_general`` in JAX, not a Pallas kernel; here it is
``torch._int_mm``. ``approx_max_k`` is exact off the TPU, so ``torch.topk``
takes its place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sky_embeddings_tpu_torch.ops.kernels import cuda_build

BLOCK_N = 64
BLOCK_D = 128
QUANT_ROWS = 1 << 18  # rows quantised at once: bounds the fp32 temporaries


def weighted_bank_scores_plain(bank, target, weights):
    """Plain PyTorch version (CPU path and parity reference): the Pallas
    kernel's math, fp32 on the upcast bank."""
    x = bank.float()
    dots = x @ (weights * target)
    prods = (x * x) @ weights
    tnorm = torch.sqrt(torch.sum(weights * target ** 2))
    return dots / (torch.sqrt(prods) * tnorm + 1e-6)


def _check_bank(bank):
    if bank.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bank dtype {bank.dtype} not supported (fp32 or bf16)")
    if bank.dim() != 2 or not bank.is_contiguous():
        raise ValueError("bank must be a contiguous (N, D) tensor")
    if bank.shape[0] == 0 or bank.shape[1] == 0:
        raise ValueError(f"bank of shape {tuple(bank.shape)} is empty")


def _check_query(name, t, shape, bank):
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(f"{name}: want {shape} float32, got {tuple(t.shape)} {t.dtype}")
    if t.device != bank.device:
        raise ValueError(f"{name} is on {t.device}, bank on {bank.device}")


def weighted_bank_scores(bank, target, weights):
    """(N, D) bank (fp32 or bf16), (D,) fp32 target and weights -> (N,) fp32.
    CPU tensors take :func:`weighted_bank_scores_plain`; CUDA tensors launch
    the Triton kernel or raise."""
    if bank.device.type == "cpu":
        return weighted_bank_scores_plain(bank, target, weights)
    _check_bank(bank)
    D = bank.shape[1]
    _check_query("target", target, (D,), bank)
    _check_query("weights", weights, (D,), bank)
    from sky_embeddings_tpu_torch.ops.kernels.simscore_triton import weighted_scores_kernel

    N = bank.shape[0]
    wt = (weights * target).contiguous()
    tnorm = torch.sqrt(torch.sum(weights * target ** 2)).reshape(1)
    out = torch.empty(N, dtype=torch.float32, device=bank.device)
    with torch.cuda.device(bank.device):
        weighted_scores_kernel[(-(-N // BLOCK_N),)](
            bank, wt, weights.contiguous(), tnorm, out, N, D, bank.stride(0),
            BLOCK_N=BLOCK_N, BLOCK_D=BLOCK_D, num_warps=4,
        )
    weighted_bank_scores.launches += 1
    return out


weighted_bank_scores.launches = 0


def bank_topk(bank, target, weights, k: int):
    """Top-k (scores, indices) of the weighted-cosine search over a bank."""
    return torch.topk(weighted_bank_scores(bank, target, weights), k)


# -- several targets, one bank pass (kernel 11) ---------------------------------

def weighted_bank_scores_multi_plain(bank, targets, weights):
    """Plain version of kernel 11 (CPU path and parity reference): fp32 math
    on the upcast bank, as ``weighted_bank_scores_multi_xla``."""
    x = bank.float()
    dots = x @ (weights * targets).t()
    prods = (x * x) @ weights.t()
    tnorms = torch.sqrt(torch.sum(weights * targets ** 2, dim=1))
    return dots / (torch.sqrt(prods) * tnorms[None, :] + 1e-6)


def _multi_entry():
    fn = cuda_build.load("simscore_multi").sky_scores_multi
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def weighted_bank_scores_multi(bank, targets, weights):
    """(N, D) bank (fp32 or bf16), (Q, D) fp32 targets and per-target weights
    -> (N, Q) fp32. CPU tensors take :func:`weighted_bank_scores_multi_plain`;
    CUDA tensors launch kernel 11 (``csrc/simscore_multi.cu``) or raise."""
    if bank.device.type == "cpu":
        return weighted_bank_scores_multi_plain(bank, targets, weights)
    _check_bank(bank)
    N, D = bank.shape
    Q = targets.shape[0] if targets.dim() == 2 else -1
    _check_query("targets", targets, (Q, D), bank)
    _check_query("weights", weights, (Q, D), bank)
    if Q < 1:
        raise ValueError("targets must hold at least one (D,) row")
    wt = (weights * targets).t().contiguous()  # (D, Q): the kernel reads query columns
    w = weights.t().contiguous()
    tnorms = torch.sqrt(torch.sum(weights * targets ** 2, dim=1))
    out = torch.empty((N, Q), dtype=torch.float32, device=bank.device)
    with torch.cuda.device(bank.device):
        err = _multi_entry()(
            bank.data_ptr(), int(bank.dtype == torch.bfloat16), wt.data_ptr(), w.data_ptr(),
            tnorms.data_ptr(), out.data_ptr(), N, D, Q, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "sky_scores_multi")
    weighted_bank_scores_multi.launches += 1
    return out


weighted_bank_scores_multi.launches = 0


def bank_topk_multi(bank, targets, weights, k: int):
    """Per-query top-k: (Q, k) scores and bank indices."""
    return torch.topk(weighted_bank_scores_multi(bank, targets, weights).t(), k, dim=1)


# -- int8 two-stage ---------------------------------------------------------------

def _quantize_rows(x):
    """Per-row max-abs int8 code, with ``simscore.py:309-314``'s clip to ±127,
    ``max(scale, 1e-30)`` guard and fp32 division (round half to even)."""
    x = x.float()
    scale = x.abs().amax(dim=1, keepdim=True) / 127.0
    return torch.clamp(torch.round(x / torch.clamp(scale, min=1e-30)), -127, 127).to(torch.int8)


def quantize_bank_int8(bank):
    """Per-row max-abs int8 quantisation of an embedding bank: ``(bank8,
    rnorm)``, the (N, D) int8 bank and the (N,) fp32 unweighted norms of the
    quantised rows (the stage-1 ranking denominators). The per-row scale is
    dropped: weighted cosine is scale-invariant in the bank row. Rows are
    quantised :data:`QUANT_ROWS` at a time, so no fp32 copy of the whole bank
    is made."""
    N = bank.shape[0]
    bank8 = torch.empty(bank.shape, dtype=torch.int8, device=bank.device)
    rnorm = torch.empty(N, dtype=torch.float32, device=bank.device)
    for s in range(0, N, QUANT_ROWS):
        q = _quantize_rows(bank[s:s + QUANT_ROWS])
        bank8[s:s + q.shape[0]] = q
        # the square root in fp64, rounded once to fp32: correctly rounded as
        # XLA's is (torch's vectorised fp32 sqrt on the CPU is not always)
        rnorm[s:s + q.shape[0]] = torch.sqrt(torch.sum(q.float() ** 2, dim=1).double()).float()
    return bank8, rnorm


def _int8_dots(bank8, q8):
    """(N, D) int8 bank · (Q, D) int8 queries -> (N, Q) int32, exact, with no
    wider copy of the bank. ``torch._int_mm`` takes on CUDA more than 16 rows
    and a D and a column count that are multiples of 8: Q is zero-padded to
    8, and the query matrix goes in column-major."""
    N, D = bank8.shape
    if bank8.device.type == "cuda" and (D % 8 or N <= 16):
        raise ValueError(f"the int8 stage needs D % 8 == 0 and more than 16 rows, got {N} x {D}")
    Q = q8.shape[0]
    q8 = torch.cat([q8, q8.new_zeros(((-Q) % 8, D))])
    return torch._int_mm(bank8, q8.t())[:, :Q]


def bank_topk_int8(bank8, rnorm, bank_hi, target, weights, k: int, oversample: int = 8192):
    """Two-stage retrieval over an int8 bank (JAX ``bank_topk_int8``): stage 1
    ranks ``int8 dots / quantised row norm`` and keeps ``oversample``
    candidates; stage 2 rescores them in fp32 from ``bank_hi`` (the bf16 or
    fp32 bank). The returned top-k is exact over the candidate set."""
    wt = weights * target
    dots = _int8_dots(bank8, _quantize_rows(wt[None]))[:, 0].float()
    cand = torch.topk(dots / (rnorm + 1e-6), oversample).indices
    rows = bank_hi[cand].float()
    mags = torch.sqrt((rows ** 2) @ weights)
    tnorm = torch.sqrt(torch.sum(weights * target ** 2))
    vals, j = torch.topk((rows @ wt) / (mags * tnorm + 1e-6), k)
    return vals, cand[j]


def bank_topk_multi_int8(bank8, rnorm, bank_hi, targets, weights, k: int,
                         oversample: int = 2048):
    """Multi-query :func:`bank_topk_int8`: one int8 bank pass for all Q
    targets, then each query's candidates (a (Q, oversample, D) gather)
    rescored with its own weights. Returns (Q, k) scores and indices."""
    wt = weights * targets
    dots = _int8_dots(bank8, _quantize_rows(wt)).t().float()  # (Q, N)
    cand = torch.topk(dots / (rnorm[None, :] + 1e-6), oversample, dim=1).indices
    rows = bank_hi[cand].float()  # (Q, oversample, D)
    d2 = torch.bmm(rows, wt[:, :, None])[..., 0]
    mags = torch.sqrt(torch.bmm(rows * rows, weights[:, :, None])[..., 0])
    tnorms = torch.sqrt(torch.sum(weights * targets ** 2, dim=1))
    vals, j = torch.topk(d2 / (mags * tnorms[:, None] + 1e-6), k, dim=1)
    return vals, torch.gather(cand, 1, j)


# -- banks larger than device memory --------------------------------------------

def _bank_topk_masked(bank, target, weights, k: int, n_valid: int):
    """:func:`bank_topk` with rows ≥ ``n_valid`` forced to -inf: tail-slab
    padding must never outrank real rows (a zero pad row scores exactly 0,
    which beats any negative true cosine)."""
    scores = weighted_bank_scores(bank, target, weights)
    scores[n_valid:] = -torch.inf
    return torch.topk(scores, k)


def _host_rows(bank, s: int, e: int) -> torch.Tensor:
    """Rows [s, e) of a host bank (a tensor, a numpy array or any
    row-sliceable view) as a CPU tensor."""
    rows = bank[s:e]
    return rows if isinstance(rows, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(rows))


def bank_topk_chunked(bank, target, weights, k: int, slab_rows: int = 1 << 20):
    """Weighted-cosine top-k over a bank too large for device memory.

    ``bank`` is any row-sliceable (N, D) bank on the host (tensor, numpy
    array, ``np.memmap``, the lazy disk view of ``eval/bank.py``). Slabs of
    ``slab_rows`` rows (the tail zero-padded and masked) are scored with K3
    on ``target``'s device, one launch each. On CUDA two pinned host buffers
    and two device slabs (one of each for a one-slab bank) alternate: while slab i scores, slab i+1 is read on
    the host and copied on a side stream. Per-slab winners merge on the host;
    returns numpy ``(scores, indices)``, best first."""
    N, D = bank.shape
    k_eff = min(k, N)
    slab_rows = max(min(slab_rows, N), 1)
    starts = list(range(0, N, slab_rows))
    k_slab = min(k_eff, slab_rows)
    dev = target.device
    cuda = dev.type == "cuda"
    first = _host_rows(bank, 0, min(slab_rows, N))
    n_buf = min(2, len(starts))
    host = [torch.empty((slab_rows, D), dtype=first.dtype, pin_memory=cuda) for _ in range(n_buf)]
    slabs = [torch.empty((slab_rows, D), dtype=first.dtype, device=dev)
             for _ in range(n_buf)] if cuda else host
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    copied: list = [None] * n_buf  # events: the slab's copy to the device is done
    scored: list = [None] * n_buf  # events: the slab's device buffer is free again

    def stage(i: int) -> None:
        s, b = starts[i], i % n_buf
        e = min(s + slab_rows, N)
        rows = first if i == 0 else _host_rows(bank, s, e)
        if copied[b] is not None:
            copied[b].synchronize()  # the pinned buffer's last copy has left
        host[b][: e - s].copy_(rows)
        host[b][e - s:].zero_()
        if cuda:
            with torch.cuda.stream(copy_stream):
                if scored[b] is not None:
                    copy_stream.wait_event(scored[b])
                slabs[b].copy_(host[b], non_blocking=True)
                copied[b] = torch.cuda.Event()
                copied[b].record(copy_stream)

    per_slab = []
    stage(0)
    for i, s in enumerate(starts):
        b = i % n_buf
        if cuda:
            torch.cuda.current_stream(dev).wait_event(copied[b])
        n_valid = min(s + slab_rows, N) - s
        per_slab.append((s, *_bank_topk_masked(slabs[b], target, weights, k_slab, n_valid)))
        if cuda:
            scored[b] = torch.cuda.Event()
            scored[b].record(torch.cuda.current_stream(dev))
        if i + 1 < len(starts):
            stage(i + 1)

    all_scores, all_idx = [], []
    for s, vals, idx in per_slab:
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        valid = np.isfinite(vals)  # drop the -inf-masked tail padding
        all_scores.append(vals[valid])
        all_idx.append(idx[valid] + s)
    scores = np.concatenate(all_scores)
    gidx = np.concatenate(all_idx)
    order = np.argsort(-scores, kind="stable")[:k_eff]
    return scores[order], gidx[order]
