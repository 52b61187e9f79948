"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card, at ragged shapes that the serving path's fixed shapes
(``chip_smoke.py``) do not reach: odd batch and token counts, heads of 16,
sequences over 128 tokens (the attention core's query blocks), bank rows
and widths that do not fill a block. Also what the wrappers must refuse on
CUDA, and that each launch is counted.

Every test is marked ``cuda`` and skips where there is no card. This file
imports neither JAX nor the JAX package, so it runs on a host without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: bf16 max|a-b|/max|b| <= 2e-2 (``TOL_FWD`` of tools/kernel_parity.py);
the bank scorer 5e-3 on fp32 banks (``TOL_SCORE_F32``), 2e-2 on bf16.
"""

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

pytestmark = pytest.mark.cuda

TOL_FWD = 2e-2
TOL_SCORE_F32 = 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


def _block_args(dev, B, N, D, wa, wb, seed):
    """(x, scale, bias, w_a, b_a, w_b, b_b) from numpy: bf16 activation and
    weights, fp32 LN parameters and biases, on ``dev``."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    bf = torch.bfloat16
    return (
        (0.5 * f32(B, N, D)).to(bf), 1.0 + 0.1 * f32(D), 0.1 * f32(D),
        (f32(*wa) * wa[0] ** -0.5).to(bf), 0.01 * f32(wa[1]),
        (f32(*wb) * wb[0] ** -0.5).to(bf), 0.01 * f32(wb[1]),
    )


@pytest.mark.parametrize("B,N,D,F", [(3, 17, 64, 256), (5, 33, 96, 200), (2, 65, 768, 3072)])
def test_mlp_block_kernel_matches_plain(dev, B, N, D, F):
    args = _block_args(dev, B, N, D, (D, F), (F, D), seed=1)
    got = tmb.fused_mlp_block(*args)
    assert got.shape == (B, N, D) and got.dtype == torch.bfloat16
    assert _max_rel(got, tmb.mlp_block_plain(*args)) <= TOL_FWD


@pytest.mark.parametrize(
    "B,N,D,H",
    [(3, 17, 64, 4), (2, 65, 768, 12), (2, 129, 128, 2), (3, 200, 96, 6), (1, 256, 64, 1)],
)
def test_attn_block_kernel_matches_plain(dev, B, N, D, H):
    args = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=2)
    got = tab.fused_attn_block(*args, H)
    assert got.shape == (B, N, D) and got.dtype == torch.bfloat16
    assert _max_rel(got, tab.attn_block_plain(*args, H)) <= TOL_FWD


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_FWD)])
@pytest.mark.parametrize("N,D", [(1000, 48), (4097, 768), (3, 200)])
def test_bank_scores_kernel_matches_plain(dev, N, D, dtype, tol):
    rng = np.random.default_rng(3)
    bank = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(dev, dtype)
    target = torch.from_numpy(rng.normal(size=D).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=D).astype(np.float32)).to(dev)
    w = w / w.sum()
    got = tss.weighted_bank_scores(bank, target, w)
    assert got.shape == (N,) and got.dtype == torch.float32
    assert _max_rel(got, tss.weighted_bank_scores_plain(bank, target, w)) <= tol
    vals, idx = tss.bank_topk(bank, target, w, min(5, N))
    assert torch.equal(vals, got[idx]) and bool((vals[:-1] >= vals[1:]).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    args = _block_args(dev, 2, 17, 64, (64, 256), (256, 64), seed=4)
    with pytest.raises(ValueError, match="bf16"):
        tmb.fused_mlp_block(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tmb.fused_mlp_block(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="w1"):
        tmb.fused_mlp_block(args[0], args[1], args[2], args[3].float(), *args[4:])
    with pytest.raises(ValueError, match="on cpu"):
        tmb.fused_mlp_block(args[0], args[1].cpu(), *args[2:])

    args = _block_args(dev, 1, 257, 64, (64, 192), (64, 64), seed=5)
    with pytest.raises(ValueError, match="exceeds"):
        tab.fused_attn_block(*args, 4)
    args = _block_args(dev, 1, 17, 96, (96, 288), (96, 96), seed=5)
    with pytest.raises(ValueError, match="head dim"):
        tab.fused_attn_block(*args, 4)  # hd = 24

    bank = torch.zeros(10, 16, dtype=torch.float16, device=dev)
    ones = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="not supported"):
        tss.weighted_bank_scores(bank, ones, ones)
    with pytest.raises(ValueError, match="target"):
        tss.weighted_bank_scores(bank.float(), ones.double(), ones)


def test_each_cuda_call_counts_one_launch(dev):
    counters = (tmb.fused_mlp_block, tab.fused_attn_block, tss.weighted_bank_scores)
    before = [f.launches for f in counters]
    mlp = _block_args(dev, 2, 17, 64, (64, 256), (256, 64), seed=6)
    attn = _block_args(dev, 2, 17, 64, (64, 192), (64, 64), seed=6)
    bank = torch.randn(100, 64, device=dev)
    tmb.fused_mlp_block(*mlp)
    tab.fused_attn_block(*attn, 4)
    tab.fused_attn_block(*attn, 4)
    tss.bank_topk(bank, bank[0], torch.ones(64, device=dev) / 64, 3)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 2, 1]


def test_encoder_kernel_path_matches_plain_path(dev):
    """A small bf16 SimMIM encoder: 3 blocks through the kernels against the
    same blocks through the plain versions, on the card."""
    from sky_embeddings_tpu_torch.models.mim import SkyMIM

    model = SkyMIM(img_size=32, patch_size=4, in_chans=5, embed_dim=128, depth=3, num_heads=4,
                   dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    imgs = np.random.default_rng(7).normal(size=(6, 5, 32, 32)).astype(np.float32)
    imgs[1, 2] = np.nan
    x = torch.from_numpy(imgs).to(dev)
    before = tab.fused_attn_block.launches
    with torch.inference_mode():
        got = model.encode(x)[0]
        model.encoder.plain = True
        want = model.encode(x)[0]
    assert tab.fused_attn_block.launches - before == 3
    assert got.shape == (6, 65, 128)
    # three layers of bf16 rounding flips (PERF.md: 2e-2 after 12 at ViT-B)
    assert _max_rel(got, want) <= TOL_FWD
