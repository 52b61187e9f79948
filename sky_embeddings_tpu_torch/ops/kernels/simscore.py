"""Weighted-cosine scoring of an embedding bank against one target.

    score_i = <w·t, x_i> / (‖t‖_w · ‖x_i‖_w + 1e-6)

Replaces the TPU kernel ``sky_embeddings_tpu/ops/kernels/simscore.py``
``weighted_bank_scores_pallas`` (``_scores_kernel``). On the TPU the dispatch
sent Q = 1 to XLA; here a CUDA tensor always launches the Triton kernel in
``simscore_triton.py``, for fp32 and bf16 banks.

What bounds it on the H100: bytes. Each bank row is read once in its storage
dtype and upcast in registers; two fp32 row sums and a scalar epilogue
follow, with no tensor-core work at Q = 1. A masked block load streams rows
at memory rate, so the design is one pass over the bank. ``‖t‖_w`` and
``w·t`` are computed by the wrapper in fp32 (as ``simscore.py:115-116``).

``bank_topk`` is this kernel followed by ``torch.topk``. The int8 two-stage,
chunked and multi-query scorers are not ported yet (ROADMAP: retrieval).
"""

from __future__ import annotations

import torch

BLOCK_N = 64
BLOCK_D = 128


def weighted_bank_scores_plain(bank, target, weights):
    """Plain PyTorch version (CPU path and parity reference): the Pallas
    kernel's math, fp32 on the upcast bank."""
    x = bank.float()
    dots = x @ (weights * target)
    prods = (x * x) @ weights
    tnorm = torch.sqrt(torch.sum(weights * target ** 2))
    return dots / (torch.sqrt(prods) * tnorm + 1e-6)


def _check_cuda_args(bank, target, weights):
    if bank.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bank dtype {bank.dtype} not supported (fp32 or bf16)")
    if bank.dim() != 2 or not bank.is_contiguous():
        raise ValueError("bank must be a contiguous (N, D) tensor")
    D = bank.shape[1]
    for name, t in (("target", target), ("weights", weights)):
        if tuple(t.shape) != (D,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want ({D},) float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != bank.device:
            raise ValueError(f"{name} is on {t.device}, bank on {bank.device}")


def weighted_bank_scores(bank, target, weights):
    """(N, D) bank (fp32 or bf16), (D,) fp32 target and weights -> (N,) fp32.
    CPU tensors take :func:`weighted_bank_scores_plain`; CUDA tensors launch
    the Triton kernel or raise."""
    if bank.device.type == "cpu":
        return weighted_bank_scores_plain(bank, target, weights)
    _check_cuda_args(bank, target, weights)
    from sky_embeddings_tpu_torch.ops.kernels.simscore_triton import weighted_scores_kernel

    N, D = bank.shape
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
