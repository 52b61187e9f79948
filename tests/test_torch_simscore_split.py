"""Kernel 11's arithmetic (``csrc/simscore_multi.cu``: both products on the
tensor cores with bf16-split operands) on the CPU, where the CUDA kernel
cannot run.

The kernel splits each fp32 operand v into bf16 terms, v_hi = bf16(v) and
v_lo = bf16(v - v_hi), and a bf16 bank's x² into x2_hi = bf16(x²) and x2_lo
= x² - x2_hi; it sums bf16 x bf16 products (exact in fp32) in fp32:

    bf16 bank:  dots  = x·wt_lo + x·wt_hi
                prods = x2_lo·w_hi + x2_hi·w_lo + x2_hi·w_hi
    fp32 bank:  dots  = x_hi·wt_lo + x_lo·wt_hi + x_hi·wt_hi   (x² rounded in
                fp32, then split as above)
    out = dots / (sqrt(prods) · ‖t‖_w + 1e-6)

Held here: (a) the split is exact where it claims to be (x2_hi + x2_lo ==
x² bit for bit for bf16 x whose x² and x2_lo are normal), and each other
residual is within 2^-16 of its value; (b) a torch emulation of that term
list against the plain version (``weighted_bank_scores_multi_plain``) and
the Pallas kernel in interpret mode, both bank dtypes, within TOL_SPLIT =
1e-4 max|a-b|/max|b|; measured 2.1e-6 to 6.2e-6 against either at these
shapes (fp32 banks 4.1e-6 to 6.2e-6, bf16 2.1e-6 to 4.8e-6), which is the
fp32 rounding of the sums, not the dropped terms; (c) the emulation ranks a bank
without near ties as the plain version does. Inputs are drawn with numpy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.ops.kernels import simscore as jss
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

TOL_SPLIT = 1e-4
RESIDUAL = 2.0 ** -16


def _split(v):
    """v (fp32) -> (hi, lo), both bf16 values held in fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _emulate(bank, targets, weights):
    """Kernel 11's term list: bf16 terms, fp32 sums, the plain epilogue."""
    wt_hi, wt_lo = _split((weights * targets).t().contiguous())  # (D, Q), as the wrapper passes
    w_hi, w_lo = _split(weights.t().contiguous())
    x = bank.float()
    x2_hi, x2_lo = _split(x * x)
    if bank.dtype == torch.bfloat16:
        dots = x @ wt_lo + x @ wt_hi
    else:
        x_hi, x_lo = _split(x)
        dots = x_hi @ wt_lo + x_lo @ wt_hi + x_hi @ wt_hi
    prods = x2_lo @ w_hi + x2_hi @ w_lo + x2_hi @ w_hi
    tnorms = torch.sqrt(torch.sum(weights * targets ** 2, dim=1))
    return dots / (torch.sqrt(prods) * tnorms[None, :] + 1e-6)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(seed, n, d, q):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(n, d)).astype(np.float32)
    targets = rng.normal(size=(q, d)).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(q, d)).astype(np.float32)
    return bank, targets, weights / weights.sum(axis=1, keepdims=True)


# -- (a) the split ------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(-55, -20), (-20, 20), (20, 60)])
def test_square_of_a_bf16_value_splits_exactly(lo, hi):
    """Every bf16 mantissa at exponents lo..hi (x² and x2_lo stay normal): x²
    is exact in fp32 and x2_hi + x2_lo gives it back bit for bit, x2_lo being
    exact in bf16 too (what the kernel's fused bf16 multiply-add rounds)."""
    mant = torch.arange(128, dtype=torch.float32) / 128 + 1.0  # the 128 bf16 mantissas
    exps = torch.arange(lo, hi + 1, dtype=torch.float32)
    x = (mant[None, :] * torch.exp2(exps)[:, None]).flatten()
    x = torch.cat([x, -x]).to(torch.bfloat16)
    assert torch.equal(x.float().to(torch.bfloat16), x)  # each value is a bf16
    sq = x.float() * x.float()
    assert torch.equal(sq.double(), x.double() ** 2)  # exact in fp32
    x2_hi = sq.to(torch.bfloat16).float()
    rest = sq - x2_hi
    assert torch.equal(rest.to(torch.bfloat16).float(), rest)  # x2_lo is exact in bf16
    assert torch.equal(x2_hi + rest, sq)


@pytest.mark.parametrize("what", ["wt", "w", "fp32 bank"])
def test_two_term_residuals_are_within_two_to_the_minus_16(what):
    """v - v_hi - v_lo for the query operands and an fp32 bank's rows, over a
    wide range of magnitudes, relative to |v|."""
    rng = np.random.default_rng({"wt": 1, "w": 2, "fp32 bank": 3}[what])
    v = rng.normal(size=200_000) * np.exp2(rng.uniform(-40, 40, size=200_000))
    if what == "w":
        v = np.abs(v)
    v = torch.from_numpy(v.astype(np.float32))
    hi, lo = _split(v)
    resid = (v.double() - hi.double() - lo.double()).abs()
    assert float((resid / v.double().abs()).max()) <= RESIDUAL


# -- (b) the term list against the plain version and JAX ---------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,q", [(1000, 48, 8), (2049, 768, 17), (1000, 37, 130),
                                   (2049, 768, 1)])
def test_split_terms_match_the_plain_version_and_jax(n, d, q, dtype):
    bank, targets, weights = _inputs(30 + q, n, d, q)
    stored = torch.from_numpy(bank).to(dtype)
    t, w = torch.from_numpy(targets), torch.from_numpy(weights)
    got = _emulate(stored, t, w)
    assert got.shape == (n, q) and torch.isfinite(got).all()
    plain = tss.weighted_bank_scores_multi_plain(stored, t, w)
    jbank = jnp.asarray(stored.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                       else jnp.float32)
    pallas = jss.weighted_bank_scores_multi_pallas(jbank, jnp.asarray(targets),
                                                   jnp.asarray(weights), interpret=True)
    assert _max_rel(got, plain) <= TOL_SPLIT
    assert _max_rel(got, np.asarray(pallas)) <= TOL_SPLIT


# -- (c) ranking -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_terms_rank_as_the_plain_version(dtype):
    """Top-10 of each of 8 queries over a 4 096-row bank whose top-11 scores
    are at least 1e-5 apart (14 times the emulation's largest error here):
    the same rows in the same order."""
    bank, targets, weights = _inputs(41, 4096, 768, 8)
    stored = torch.from_numpy(bank).to(dtype)
    t, w = torch.from_numpy(targets), torch.from_numpy(weights)
    plain = tss.weighted_bank_scores_multi_plain(stored, t, w).t()
    top = torch.topk(plain, 11, dim=1).values
    assert float((top[:, :-1] - top[:, 1:]).min()) >= 1e-5  # no near ties
    want = torch.topk(plain, 10, dim=1).indices
    got = torch.topk(_emulate(stored, t, w).t(), 10, dim=1).indices
    assert torch.equal(got, want)
