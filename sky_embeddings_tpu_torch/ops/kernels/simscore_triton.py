"""Triton body of the weighted bank scorer (see ``simscore.py``).

Imported only from ``simscore.weighted_bank_scores`` on the CUDA path, since
it imports ``triton`` at module level for ``@triton.jit``.
"""

import triton
import triton.language as tl


@triton.jit
def weighted_scores_kernel(
    bank_ptr, wt_ptr, w_ptr, tnorm_ptr, out_ptr, N, D, stride,
    BLOCK_N: tl.constexpr, BLOCK_D: tl.constexpr,
):
    """One program scores BLOCK_N bank rows: Σ x·(w·t) and Σ w·x² in fp32
    over BLOCK_D-wide column slabs, then dots / (sqrt(prods)·‖t‖_w + 1e-6)."""
    rows = tl.program_id(0).to(tl.int64) * BLOCK_N + tl.arange(0, BLOCK_N)
    rmask = rows < N
    dots = tl.zeros([BLOCK_N], dtype=tl.float32)
    prods = tl.zeros([BLOCK_N], dtype=tl.float32)
    for d0 in range(0, D, BLOCK_D):
        cols = d0 + tl.arange(0, BLOCK_D)
        cmask = cols < D
        x = tl.load(
            bank_ptr + rows[:, None] * stride + cols[None, :],
            mask=rmask[:, None] & cmask[None, :], other=0.0,
        ).to(tl.float32)
        wt = tl.load(wt_ptr + cols, mask=cmask, other=0.0)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
        dots += tl.sum(x * wt[None, :], axis=1)
        prods += tl.sum(x * x * w[None, :], axis=1)
    tnorm = tl.load(tnorm_ptr)
    tl.store(out_ptr + rows, dots / (tl.sqrt(prods) * tnorm + 1e-6), mask=rmask)
