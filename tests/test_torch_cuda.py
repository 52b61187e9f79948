"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card, at ragged shapes that the main paths' fixed shapes
(``chip_smoke.py``) do not reach: odd batch and token counts, heads of 16
to 64, sequences over 128 tokens (the attention cores' query blocks), bank
rows and widths that do not fill a block. The training kernels (attention
stash forward and backward, MLP backward) are held to their plain versions
output by output. Also what the wrappers must refuse on CUDA, that each
launch is counted, and that ``loss.backward()`` through the model on the
card reaches every parameter.

Every test is marked ``cuda`` and skips where there is no card. This file
imports neither JAX nor the JAX package, so it runs on a host without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: bf16 max|a-b|/max|b| <= 2e-2 (``TOL_FWD`` of tools/kernel_parity.py),
3e-2 for each gradient output (``TOL_BWD``); the bank scorer 5e-3 on fp32
banks (``TOL_SCORE_F32``), 2e-2 on bf16.
"""

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

pytestmark = pytest.mark.cuda

TOL_FWD = 2e-2
TOL_BWD = 3e-2
TOL_SCORE_F32 = 5e-3
# (9, 65, 128, 2): 585 token rows split the weight-gradient GEMMs into K
# slices with a ragged last one (launch_weight_grad, csrc/gemm.cuh)
ATTN_SHAPES = [(3, 17, 64, 4), (2, 65, 768, 12), (5, 33, 96, 3), (2, 129, 128, 2),
               (3, 200, 96, 6), (1, 256, 64, 1), (1, 256, 256, 4), (9, 65, 128, 2)]


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


@pytest.mark.parametrize("B,N,D,H", ATTN_SHAPES)
def test_attn_stash_forward_kernel_matches_plain(dev, B, N, D, H):
    args = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=7)
    got = tab.attn_block_fwd_stash(*args, H)
    want = tab.attn_block_fwd_stash_plain(*args, H)
    for name, a, b, shape in zip(("out", "qkv", "probs"), got, want,
                                 ((B, N, D), (B, N, 3 * D), (B, H, N, N))):
        assert a.shape == shape and a.dtype == torch.bfloat16, name
        assert _max_rel(a, b) <= TOL_FWD, name


@pytest.mark.parametrize("B,N,D,H", ATTN_SHAPES)
def test_attn_stash_backward_kernel_matches_plain(dev, B, N, D, H):
    x, scale, bias, wqkv, bqkv, wproj, bproj = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=8)
    _, qkv, probs = tab.attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj, bproj, H)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(B, N, D)).astype(np.float32))
    bwd_args = (x, scale, bias, wqkv, wproj, qkv, probs, g.to(dev, torch.bfloat16), H)
    got = tab.attn_block_bwd_stash(*bwd_args)
    want = tab.attn_block_bwd_stash_plain(*bwd_args)
    names = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= TOL_BWD, name


@pytest.mark.parametrize("B,N,D,F", [(3, 17, 64, 256), (5, 33, 96, 200), (2, 65, 768, 3072),
                                     (3, 129, 128, 512), (9, 65, 128, 512)])
def test_mlp_backward_kernel_matches_plain(dev, B, N, D, F):
    x, scale, bias, w1, b1, w2, _ = _block_args(dev, B, N, D, (D, F), (F, D), seed=10)
    g = torch.from_numpy(np.random.default_rng(11).normal(size=(B, N, D)).astype(np.float32))
    bwd_args = (x, scale, bias, w1, b1, w2, g.to(dev, torch.bfloat16))
    got = tmb.mlp_block_bwd(*bwd_args)
    want = tmb.mlp_block_bwd_plain(*bwd_args)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= TOL_BWD, name


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

    args = _block_args(dev, 2, 17, 64, (64, 192), (64, 64), seed=5)
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*args, 4)
    g = torch.ones_like(args[0])
    with pytest.raises(ValueError, match="bf16"):
        tab.attn_block_fwd_stash(args[0].float(), *args[1:], 4)
    with pytest.raises(ValueError, match="bf16"):
        tab.attn_block_bwd_stash(args[0].float(), args[1], args[2], args[3], args[5], qkv, probs, g, 4)
    with pytest.raises(ValueError, match="probs"):
        tab.attn_block_bwd_stash(args[0], args[1], args[2], args[3], args[5], qkv, probs.float(), g, 4)
    with pytest.raises(ValueError, match="bf16"):
        tmb.mlp_block_bwd(args[0].float(), *_block_args(dev, 2, 17, 64, (64, 256), (256, 64), 5)[1:6], g)
    big = _block_args(dev, 1, 257, 64, (64, 192), (64, 64), seed=5)
    with pytest.raises(ValueError, match="exceeds"):
        tab.attn_block_fwd_stash(*big, 4)
    wide = _block_args(dev, 1, 17, 96, (96, 288), (96, 96), seed=5)
    _, qkv24, probs24 = tab.attn_block_fwd_stash_plain(*wide, 4)
    with pytest.raises(ValueError, match="head dim"):
        tab.attn_block_bwd_stash(wide[0], wide[1], wide[2], wide[3], wide[5], qkv24, probs24,
                                 torch.ones_like(wide[0]), 4)  # hd = 24

    # with grad, the combinations that need unported TPU kernels refuse
    leaf = args[0].detach().requires_grad_()
    with pytest.raises(NotImplementedError, match="kernel 4"):
        tab.fused_attn_block(leaf, *args[1:], 4, stash=False)
    mlp = _block_args(dev, 2, 17, 64, (64, 256), (256, 64), seed=5)
    with pytest.raises(NotImplementedError, match="kernels 6 and 7"):
        tmb.fused_mlp_block(leaf, *mlp[1:], stash=True)

    bank = torch.zeros(10, 16, dtype=torch.float16, device=dev)
    ones = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="not supported"):
        tss.weighted_bank_scores(bank, ones, ones)
    with pytest.raises(ValueError, match="target"):
        tss.weighted_bank_scores(bank.float(), ones.double(), ones)


def test_each_cuda_call_counts_one_launch(dev):
    counters = (tmb.fused_mlp_block, tab.fused_attn_block, tss.weighted_bank_scores,
                tab.attn_block_fwd_stash, tab.attn_block_bwd_stash, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    mlp = _block_args(dev, 2, 17, 64, (64, 256), (256, 64), seed=6)
    attn = _block_args(dev, 2, 17, 64, (64, 192), (64, 64), seed=6)
    bank = torch.randn(100, 64, device=dev)
    tmb.fused_mlp_block(*mlp)
    tab.fused_attn_block(*attn, 4)
    tab.fused_attn_block(*attn, 4)
    tss.bank_topk(bank, bank[0], torch.ones(64, device=dev) / 64, 3)
    # with grad: one stash forward, one stash backward, one MLP forward and
    # one MLP backward
    x = attn[0].detach().requires_grad_()
    y = tmb.fused_mlp_block(tab.fused_attn_block(x, *attn[1:], 4), *mlp[1:])
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 1, 1, 1, 1]
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()


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


def test_loss_backward_reaches_every_parameter(dev):
    """One bf16 training forward and ``loss.backward()`` of a small SimMIM
    model on the card: every parameter it uses gets a finite gradient, every block
    parameter a nonzero one, through the training kernels (one launch of
    each per block); the gradients agree with the plain path's."""
    from sky_embeddings_tpu_torch.models.mim import SkyMIM

    def grads(plain):
        model = SkyMIM(img_size=32, patch_size=4, in_chans=5, embed_dim=128, depth=3, num_heads=4,
                       norm_pix_loss=True, dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(dev).train()
        model.encoder.plain = plain
        rng = np.random.default_rng(12)
        imgs = rng.normal(size=(6, 5, 32, 32)).astype(np.float32)
        imgs[1, 2] = np.nan
        mask = (rng.random((6, 5, 32, 32)) < 0.5).astype(np.float32)
        loss = model(torch.from_numpy(imgs).to(dev), torch.from_numpy(mask).to(dev))[0]
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}

    counters = (tab.attn_block_fwd_stash, tab.attn_block_bwd_stash, tmb.fused_mlp_block,
                tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    got = grads(plain=False)
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 3, 3, 3]
    want = grads(plain=True)
    for name, grad in got.items():
        if name == "mask_token":  # held for the JAX tree; SimMIM does not use it
            continue
        assert grad is not None and torch.isfinite(grad).all(), name
        if ".block" in name:
            assert grad.abs().max() > 0, name
        # three layers of bf16 rounding flips in both directions
        rel = float((grad - want[name]).norm() / (want[name].norm() + 1e-12))
        assert rel <= 5e-2, (name, rel)
