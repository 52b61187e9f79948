"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card, at ragged shapes that the main paths' fixed shapes
(``chip_smoke.py``) do not reach: odd batch and token counts, heads of 16
to 64, sequences over 128 tokens (the attention cores' query blocks), bank
rows and widths that do not fill a block. The training kernels (attention
stash forward and backward, attention recompute backward, MLP backward, MLP
stash forward and backward) are held to their plain versions output by
output. Also what the wrappers must refuse on CUDA, that each launch is
counted, that ``loss.backward()`` through the model on the card reaches
every parameter (ViT-B's stash path, ViT-L's MLP stash path, the remat path
with the RA/Dec token), and that remat leaves the gradients bit-equal.

The attention kernels also run at heads of 80 (ViT-H) and 128, up to
N = 256, and refuse a head no shared-memory plan fits. Kernel 9 (the
weight-streaming MLP backward) is held to its plain version and to kernel 8
at ViT-H's slabs, ragged rows and slab widths; with one slab it launches
kernel 8; a depth-2 ViT-H's ``loss.backward()`` reaches every parameter
through K2, kernel 4, K1 and kernel 9.

MAE: K2, kernel 2 and kernel 4 with the packed-segment mask (``seg_len``)
at ragged packed shapes (odd sequence counts; segments of 17 and 18 at
N = 34, 68, 72), against their plain versions and against the unmasked
kernels on the same samples; the four attention kernels at a head of 512
(``maesimple``'s decoder); small MAE models' ``loss.backward()`` on each
decoder backward and under remat, with their launch counts, and remat's
gradients bit-equal to the stored path's.

Kernel 11 (the multi-query bank scorer) is held to its plain version at
ragged bank rows, widths and query counts, within 1e-4 at the retrieval
width (its bf16-split products' promise), and the retrieval routes on the
card: one launch per ``query_multi``, the chunked scorer against the single
pass, the int8 two-stage scorers' agreement with the exact ranking.

Kernels 12 and 13 (the standalone attention forward and backward behind
``layers.Attention``) are held to their plain versions in bf16 and fp32 at
ViT-B, ViT-H (heads of 80), the MAE decoder's heads of 32, N = 256 and
ragged shapes (fp32 also at head dims that are no multiple of 16, and N =
256 at hd = 128); kernel 12's bf16 context equals, bit for bit, the context
K2's core computes from the same qkv; kernel 13 in fp32 gives the same bits
twice; the fp32 plan as the C source computes it equals its Python copy;
the wrappers refuse what the kernels do not take; an ``Attention``
module's ``backward()`` launches each kernel once and matches the plain
path.

The forward GEMM of K1 and K2 (``csrc/gemm_sm90.cuh``: persistent wgmma
fed by TMA) is held alone, through its test entry, to an fp32 product of
the same bf16 operands at every epilogue and at ragged and model shapes,
twice bit-equal; its tile rule as the C source computes it equals the
Python copy; K1 and K2 (and kernel 6 bit-equal to K1) match their plain
versions at every shipped width, and their launches run that GEMM (the
profiler's kernel names). So do kernels 3 and 4 (masked too), whose
backward core writes bf16 dqkv and dbqkv's per-sample column sums (no fp32
dqkv reaches their device memory), and kernels 8, 7 and 9, whose
products run on its dual, stash dh and group kernels (no fp32 (B·N, F)
array in kernel 7's memory).

The fp32 forms of every block kernel (K1, K2, kernels 2, 3, 4, 6, 7, 8, 9
and the masked K2, 2 and 4) are held to their plain versions at ragged
shapes: token rows not a multiple of 32, N = 1 to 256, heads of 4 to 512,
segments of 5 and 17; kernel 6's out bit-equal to K1's fp32 form, kernels
3, 4, 7, 8 and 9 twice bit-equal; the routes that once refused fp32 run
their fp32 forms with the plain versions patched to fail; small fp32
encoders on each route reach every parameter; their 3xTF32 GEMM in each
form and epilogue against fp32 ``torch.mm``.

I-JEPA's widths: the five kernels a JEPA step runs (K2, kernels 2 and 3,
K1 and kernel 8) at the ViT-S encoder (D = 384, 6 heads of 64, N = 64)
and the 192-wide predictor (3 heads of 64, N = 77) in bf16, and at
``jepa_tiny``'s fp32 widths (D = 192 over 16 tokens; one head of 96 over
21), against their plain versions; one ``JEPATrainer`` step of
``jepa_struct`` and ``jepa_tiny`` cut to depth 2 launches exactly those
kernels, reaches every parameter and matches the plain path.

CosmicEmbeds: a step of its loss (a masked context, a NaN band) at a small
width in fp32 and bf16 launches kernels 2, 3, 8 and K1 once per block, and
``generate`` K2 and K1, matching the plain path. The host-to-device prefetch
copies numpy arrays and CPU tensors to the card equal to the source, on a
side stream that the current stream waits on, and passes a tensor already
on the card through.

Every test is marked ``cuda`` and skips where there is no card. This file
imports neither JAX nor the JAX package, so it runs on a host without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: bf16 max|a-b|/max|b| <= 2e-2 (``TOL_FWD`` of tools/kernel_parity.py),
3e-2 for each gradient output (``TOL_BWD``); the bank scorer 5e-3 on fp32
banks (``TOL_SCORE_F32``), 2e-2 on bf16.
"""

import ctypes

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.ops.kernels import attention as tat
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import gemm as tg
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

pytestmark = pytest.mark.cuda

TOL_FWD = 2e-2
TOL_BWD = 3e-2
TOL_SCORE_F32 = 5e-3
# (9, 65, 128, 2): 585 token rows split the weight-gradient GEMMs into K
# slices with a ragged last one (csrc/gemm_sm90.cuh's group plan)
# hd = 80 (ViT-H: (3, 66, 1280, 16); N = 256 shrinks kernel 3's query
# blocks to 32), hd = 128 at N = 256 (the forward's blocks to 32, kernel
# 4's to 16) and hd = 512 (maesimple's decoder: 16-row blocks, 32-column
# chunks, the column sums over several blocks)
ATTN_SHAPES = [(3, 17, 64, 4), (2, 65, 768, 12), (5, 33, 96, 3), (2, 129, 128, 2),
               (3, 200, 96, 6), (1, 256, 64, 1), (1, 256, 256, 4), (9, 65, 128, 2),
               (3, 66, 1280, 16), (5, 17, 80, 1), (2, 256, 160, 2), (3, 131, 240, 3),
               (1, 256, 256, 2), (3, 65, 512, 1)]
# the recompute backward's query blocks: one block up to N = 64, 64 rows up
# to 128, 32 beyond; ViT-L's heads of 48 (mim_25_large) and 64 at N = 66
# (mim_32, the RA/Dec token)
RECOMPUTE_SHAPES = ATTN_SHAPES + [(3, 66, 768, 16), (2, 66, 1024, 16), (3, 113, 192, 4),
                                  (1, 145, 64, 4)]
MLP_SHAPES = [(3, 17, 64, 256), (5, 33, 96, 200), (2, 65, 768, 3072), (3, 129, 128, 512),
              (9, 65, 128, 512)]


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
    [(3, 17, 64, 4), (2, 65, 768, 12), (2, 129, 128, 2), (3, 200, 96, 6), (1, 256, 64, 1),
     (3, 66, 1280, 16), (31, 66, 1280, 16), (2, 256, 160, 2), (1, 256, 256, 2)],
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


@pytest.mark.parametrize("B,N,D,H", RECOMPUTE_SHAPES)
def test_attn_recompute_backward_kernel_matches_plain(dev, B, N, D, H):
    x, scale, bias, wqkv, bqkv, wproj, _ = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=13)
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(B, N, D)).astype(np.float32))
    bwd_args = (x, scale, bias, wqkv, bqkv, wproj, g.to(dev, torch.bfloat16), H)
    got = tab.attn_block_bwd(*bwd_args)
    want = tab.attn_block_bwd_plain(*bwd_args)
    names = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= TOL_BWD, name


@pytest.mark.parametrize("B,N,D,F", MLP_SHAPES)
def test_mlp_stash_forward_kernel_matches_plain(dev, B, N, D, F):
    args = _block_args(dev, B, N, D, (D, F), (F, D), seed=15)
    out, a = tmb.mlp_block_fwd_stash(*args)
    want_out, want_a = tmb.mlp_block_fwd_stash_plain(*args)
    assert out.shape == (B, N, D) and a.shape == (B * N, F) and a.dtype == torch.bfloat16
    assert _max_rel(out, want_out) <= TOL_FWD and _max_rel(a, want_a) <= TOL_FWD
    # GELU reads the fp32 pre-activation: the output is K1's, bit for bit
    assert torch.equal(out, tmb.fused_mlp_block(*args))


@pytest.mark.parametrize("B,N,D,F", MLP_SHAPES)
def test_mlp_stash_backward_kernel_matches_plain(dev, B, N, D, F):
    x, scale, bias, w1, b1, w2, b2 = _block_args(dev, B, N, D, (D, F), (F, D), seed=16)
    _, a = tmb.mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, b2)
    g = torch.from_numpy(np.random.default_rng(17).normal(size=(B, N, D)).astype(np.float32))
    bwd_args = (x, scale, bias, w1, w2, a, g.to(dev, torch.bfloat16))
    got = tmb.mlp_block_bwd_stash(*bwd_args)
    want = tmb.mlp_block_bwd_stash_plain(*bwd_args)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, a_, b in zip(names, got, want):
        assert a_.shape == b.shape and a_.dtype == b.dtype, name
        assert _max_rel(a_, b) <= TOL_BWD, name


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

    # the recompute backward and the MLP stash kernels refuse the same
    with pytest.raises(ValueError, match="bf16"):
        tab.attn_block_bwd(args[0].float(), *args[1:6], g, 4)
    with pytest.raises(ValueError, match="head dim"):
        tab.attn_block_bwd(wide[0], *wide[1:6], torch.ones_like(wide[0]), 4)
    with pytest.raises(ValueError, match="exceeds"):
        tab.attn_block_bwd(big[0], *big[1:6], torch.ones_like(big[0]), 4)
    mlp = _block_args(dev, 2, 17, 64, (64, 256), (256, 64), seed=5)
    with pytest.raises(ValueError, match="bf16"):
        tmb.mlp_block_fwd_stash(mlp[0].float(), *mlp[1:])
    _, a = tmb.mlp_block_fwd_stash_plain(*mlp)
    with pytest.raises(ValueError, match="a:"):
        tmb.mlp_block_bwd_stash(*mlp[:4], mlp[5], a.float(), g)
    with pytest.raises(ValueError, match="a:"):
        tmb.mlp_block_bwd_stash(*mlp[:4], mlp[5], a[:-1], g)
    # with grad, both stash settings take their kernels: a mixed set (fp32
    # x, bf16 weights) is refused, never sent to the plain versions
    leaf = args[0].float().detach().requires_grad_()
    for stash in (True, False):
        with pytest.raises(ValueError, match="bf16"):
            tab.fused_attn_block(leaf, *args[1:], 4, stash=stash)
        with pytest.raises(ValueError, match="bf16"):
            tmb.fused_mlp_block(mlp[0].float().requires_grad_(), *mlp[1:], stash=stash)

    bank = torch.zeros(10, 16, dtype=torch.float16, device=dev)
    ones = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="not supported"):
        tss.weighted_bank_scores(bank, ones, ones)
    with pytest.raises(ValueError, match="target"):
        tss.weighted_bank_scores(bank.float(), ones.double(), ones)


def test_each_cuda_call_counts_one_launch(dev):
    counters = (tmb.fused_mlp_block, tab.fused_attn_block, tss.weighted_bank_scores,
                tab.attn_block_fwd_stash, tab.attn_block_bwd_stash, tmb.mlp_block_bwd,
                tab.attn_block_bwd, tmb.mlp_block_fwd_stash, tmb.mlp_block_bwd_stash)
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
    # and the other pair: K2 forward with the recompute backward, the MLP
    # stash forward and backward
    x2 = attn[0].detach().requires_grad_()
    y = tmb.fused_mlp_block(tab.fused_attn_block(x2, *attn[1:], 4, stash=False), *mlp[1:],
                            stash=True)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 3, 1, 1, 1, 1, 1, 1, 1]
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    assert x2.grad is not None and torch.isfinite(x2.grad.float()).all()


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


def _vitl_grads(dev, plain, **kw):
    """One bf16 training forward and ``loss.backward()`` of a small ViT-L-style
    SimMIM model (16 heads) on the card: (gradients by name, model)."""
    from sky_embeddings_tpu_torch.models.mim import SkyMIM

    model = SkyMIM(img_size=32, patch_size=4, in_chans=kw.pop("in_chans", 5), embed_dim=256,
                   depth=3, num_heads=16, norm_pix_loss=True, dtype=torch.bfloat16, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    model.encoder.plain = plain
    rng = np.random.default_rng(18)
    imgs = rng.normal(size=(5, model.in_chans, 32, 32)).astype(np.float32)
    imgs[1, 2] = np.nan
    mask = (rng.random(imgs.shape) < 0.5).astype(np.float32)
    rd = np.stack([rng.uniform(0, 360, 5), rng.uniform(-90, 90, 5)], axis=1).astype(np.float32)
    loss = model(torch.from_numpy(imgs).to(dev), torch.from_numpy(mask).to(dev),
                 ra_dec=torch.from_numpy(rd).to(dev) if model.ra_dec else None)[0]
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}, model


@pytest.mark.parametrize("path", ["stash_mlp", "remat_ra_dec"])
def test_loss_backward_reaches_every_parameter_on_the_vitl_paths(dev, path):
    """The MLP stash path (kernels 2, 3, 6, 7) and the remat path with the
    RA/Dec token and 9 bands (K2 and K1 twice per block, kernels 4 and 8):
    every parameter gets a finite gradient, every block parameter a nonzero
    one, one launch per block of each backward kernel; the gradients agree
    with the plain path's."""
    kw = (dict(stash_mlp=True) if path == "stash_mlp"
          else dict(remat=True, ra_dec=True, in_chans=9))
    counters = (tab.attn_block_fwd_stash, tab.attn_block_bwd_stash, tmb.mlp_block_fwd_stash,
                tmb.mlp_block_bwd_stash, tab.fused_attn_block, tmb.fused_mlp_block,
                tab.attn_block_bwd, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    got, model = _vitl_grads(dev, False, **dict(kw))
    want = (([3, 3, 3, 3, 0, 0, 0, 0]) if path == "stash_mlp" else [0, 0, 0, 0, 6, 6, 3, 3])
    assert [f.launches - b for f, b in zip(counters, before)] == want
    assert model.num_extra_tokens == (2 if path == "remat_ra_dec" else 1)
    ref, _ = _vitl_grads(dev, True, **dict(kw))
    rels = {}
    for name, grad in got.items():
        if name == "mask_token":
            continue
        assert grad is not None and torch.isfinite(grad).all(), name
        if ".block" in name or "ra_dec_embed" in name:
            assert grad.abs().max() > 0, name
        rels[name] = float((grad - ref[name]).norm() / (ref[name].norm() + 1e-12))
    # three layers of bf16 rounding flips at 16 heads of 16 and batch 5; the
    # patch embedding's gradient sums them over every token. Measured on the
    # H100 (the same in two runs): 5.5e-2 (stash_mlp) and 6.0e-2
    # (remat_ra_dec) on patch_embed.proj.kernel, every other leaf <= 3.6e-2
    worst = max(rels, key=rels.get)
    assert rels[worst] <= 1.2e-1, (worst, rels[worst])


def test_remat_gradients_equal_the_stored_path_on_the_card(dev):
    """Remat replays each block's forward kernels in the backward; the kernels
    are deterministic, so the gradients equal those of the same model stored
    without remat (stash off, the same kernels 4 and 8), bit for bit."""
    got, _ = _vitl_grads(dev, False, remat=True, ra_dec=True)
    want, _ = _vitl_grads(dev, False, remat=False, stash=False, ra_dec=True)
    assert got.keys() == want.keys()
    for name, grad in got.items():
        assert (grad is None and want[name] is None) or torch.equal(grad, want[name]), name


# -- kernel 9 (the weight-streaming MLP backward) and ViT-H ---------------------------

_MLP_GRADS = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")


def _stream_case(dev, B, N, D, F, seed):
    x, scale, bias, w1, b1, w2, _ = _block_args(dev, B, N, D, (D, F), (F, D), seed=seed)
    g = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(B, N, D)).astype(np.float32))
    return x, scale, bias, w1, b1, w2, g.to(dev, torch.bfloat16)


# (B, N, D, F, forced slab width or None for JAX's partition): ViT-H's
# (fs = 1280, nj = 4) at M = 32 x 66 and a ragged M; F = 2000 (fs = 1000,
# no 128-multiple); forced narrow slabs at ragged M, D and F
STREAM_SHAPES = [(32, 66, 1280, 5120, None), (3, 33, 1280, 5120, None), (5, 17, 1280, 2000, None),
                 (3, 33, 96, 200, 40), (7, 65, 128, 512, 128), (1, 9, 64, 256, 64)]


@pytest.mark.parametrize("B,N,D,F,fs", STREAM_SHAPES)
def test_stream_backward_kernel_matches_plain_and_kernel_8(dev, B, N, D, F, fs, monkeypatch):
    if fs is not None:
        monkeypatch.setattr(tmb, "_stream_slab", lambda D_, F_, **kw: fs)
    nj = F // tmb._stream_slab(D, F)
    assert nj > 1
    args = _stream_case(dev, B, N, D, F, seed=40)
    before = (tmb.mlp_block_bwd_stream.launches, tmb.mlp_block_bwd.launches)
    got = tmb.mlp_block_bwd_stream(*args)
    torch.cuda.synchronize()
    assert (tmb.mlp_block_bwd_stream.launches - before[0], tmb.mlp_block_bwd.launches - before[1]) == (1, 0)
    want = tmb.mlp_block_bwd_stream_plain(*args)
    k8 = tmb.mlp_block_bwd(*args)
    for name, a, b, c in zip(_MLP_GRADS, got, want, k8):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= TOL_BWD, name
        # kernel 8 differs in the order of dy's fp32 sums and the weight
        # gradients' K slices; the bias gradients are the same bits
        assert _max_rel(a, c) <= TOL_BWD, name
        if name in ("db1", "db2"):
            assert torch.equal(a, c), name


def test_stream_backward_with_one_slab_launches_kernel_8(dev):
    args = _stream_case(dev, 3, 17, 64, 256, seed=41)
    assert tmb._stream_slab(64, 256) == 256
    before = (tmb.mlp_block_bwd_stream.launches, tmb.mlp_block_bwd.launches)
    got = tmb.mlp_block_bwd_stream(*args)
    assert (tmb.mlp_block_bwd_stream.launches - before[0], tmb.mlp_block_bwd.launches - before[1]) == (0, 1)
    for name, a, b in zip(_MLP_GRADS, got, tmb.mlp_block_bwd(*args)):
        assert torch.equal(a, b), name


def test_stream_backward_refuses_and_counts(dev, monkeypatch):
    x, scale, bias, w1, b1, w2, g = _stream_case(dev, 2, 17, 1280, 5120, seed=42)
    with pytest.raises(ValueError, match="bf16"):
        tmb.mlp_block_bwd_stream(x.float(), scale, bias, w1, b1, w2, g)
    with pytest.raises(ValueError, match="g:"):
        tmb.mlp_block_bwd_stream(x, scale, bias, w1, b1, w2, g.float())
    with pytest.raises(ValueError, match="w1"):
        tmb.mlp_block_bwd_stream(x, scale, bias, w1.float(), b1, w2, g)
    monkeypatch.setattr(tmb, "_stream_slab", lambda D_, F_, **kw: 1000)
    with pytest.raises(ValueError, match="does not divide"):
        tmb.mlp_block_bwd_stream(x, scale, bias, w1, b1, w2, g)
    monkeypatch.setattr(tmb, "_stream_slab", lambda D_, F_, **kw: 20)
    with pytest.raises(ValueError, match="multiple of 8"):
        tmb.mlp_block_bwd_stream(x, scale, bias, w1, b1, w2, g)
    monkeypatch.undo()
    # with grad, stash="stream": K1 forward, kernel 9 backward, one launch each
    counters = (tmb.fused_mlp_block, tmb.mlp_block_bwd_stream, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    leaf = x.detach().requires_grad_()
    tmb.fused_mlp_block(leaf, scale, bias, w1, b1, w2, torch.zeros_like(scale),
                        stash="stream").float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0]
    assert torch.isfinite(leaf.grad.float()).all()


def test_attention_refuses_a_head_no_plan_fits(dev):
    """hd = 224 at N = 256: no plan fits any core in 227 KB (the forward's K
    and V alone take 237 568 bytes; the backward's smallest plan 310 272);
    hd = 128 at N = 256 fits with smaller query blocks and column chunks and
    is taken (ATTN_SHAPES)."""
    args = _block_args(dev, 1, 256, 224, (224, 672), (224, 224), seed=43)
    g = torch.ones_like(args[0])
    for call in (lambda: tab.fused_attn_block(*args, 1),
                 lambda: tab.attn_block_fwd_stash(*args, 1),
                 lambda: tab.attn_block_bwd(*args[:6], g, 1)):
        with pytest.raises(ValueError, match="shared-memory plan"):
            call()
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*args, 1)
    with pytest.raises(ValueError, match="shared-memory plan"):
        tab.attn_block_bwd_stash(args[0], args[1], args[2], args[3], args[5], qkv, probs, g, 1)
    assert tab._plan_bytes("fwd", 256, 224) == 237568
    # ViT-H's head: kernel 13's plan, and kernels 3 and 4's with five warps'
    # rows of 80 column sums
    assert tat._plan_bytes(66, 80, False, True) == 84480
    assert tab._plan_bytes("recompute", 66, 80) == tab._plan_bytes("stash", 66, 80) == 84480 + 5 * 80 * 4
    assert tab._plan_bytes("stash", 256, 80) <= tab.SMEM_PER_BLOCK


def test_loss_backward_reaches_every_parameter_of_vith(dev, monkeypatch):
    """A depth-2 ViT-H (``mimhuge``: D = 1280, 16 heads of 80, F = 5120, the
    RA/Dec token, 9 bands, ``stash = False``) on the card: K2 and kernel 4
    in the attention, K1 and kernel 9 in the MLP, one launch per block each;
    every parameter gets a finite gradient, every block parameter a nonzero
    one, and the gradients agree with the plain path's."""
    from sky_embeddings_tpu_torch.configuration import Config
    from sky_embeddings_tpu_torch.models import mim as port_mim

    monkeypatch.setitem(port_mim._SIZES["huge"], "depth", 2)
    cfg = Config.from_dict({
        "ARCHITECTURE": {"model_type": "mimhuge", "embed_dim": "1280", "img_size": "64",
                         "patch_size": "8", "num_channels": "9", "ra_dec": "True"},
        "TRAINING": {"norm_pix_loss": "True", "loss_fn": "L1"},
    })
    rng = np.random.default_rng(44)
    imgs = rng.normal(size=(6, 9, 64, 64)).astype(np.float32)
    imgs[1, 2] = np.nan
    mask = (rng.random(imgs.shape) < 0.5).astype(np.float32)
    rd = np.stack([rng.uniform(0, 360, 6), rng.uniform(-90, 90, 6)], axis=1).astype(np.float32)

    def grads(plain):
        model = port_mim.build_mim_model(cfg, dtype=torch.bfloat16, device=dev).train()
        model.encoder.plain = plain
        loss = model(torch.from_numpy(imgs).to(dev), torch.from_numpy(mask).to(dev),
                     ra_dec=torch.from_numpy(rd).to(dev))[0]
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}, model

    counters = (tab.fused_attn_block, tab.attn_block_bwd, tmb.fused_mlp_block,
                tmb.mlp_block_bwd_stream, tab.attn_block_fwd_stash, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    got, model = grads(False)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 2, 2, 0, 0]
    assert model.encoder.block0.ffn.wide and not model.encoder.block0.stash
    ref, _ = grads(True)
    rels = {}
    for name, grad in got.items():
        if name == "mask_token":
            continue
        assert grad is not None and torch.isfinite(grad).all(), name
        if ".block" in name:
            assert grad.abs().max() > 0, name
        rels[name] = float((grad - ref[name]).norm() / (ref[name].norm() + 1e-12))
    # two layers of bf16 rounding flips; the ViT-L paths measured up to
    # 6.0e-2 at three layers (see above)
    worst = max(rels, key=rels.get)
    assert rels[worst] <= 1.2e-1, (worst, rels[worst])


# -- kernel 11 (multi-query bank scorer) and the retrieval routes ------------------

MULTI_SHAPES = [(1000, 48, 5), (4097, 768, 8), (3, 200, 1), (1025, 37, 130), (333, 3072, 17),
                (513, 64, 33), (130, 7, 64), (4097, 768, 64)]
# kernel 11's products are bf16 terms of the fp32 operands (csrc/simscore_multi.cu):
# each term's residual is <= 2^-16 relative, so the scores keep fp32 grade
TOL_SPLIT = 1e-4


def _multi_args(dev, N, D, Q, dtype, seed):
    rng = np.random.default_rng(seed)
    bank = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(dev, dtype)
    targets = torch.from_numpy(rng.normal(size=(Q, D)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=(Q, D)).astype(np.float32)).to(dev)
    return bank, targets, w / w.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_SCORE_F32), (torch.bfloat16, TOL_FWD)])
@pytest.mark.parametrize("N,D,Q", MULTI_SHAPES)
def test_multi_scores_kernel_matches_plain(dev, N, D, Q, dtype, tol):
    """Ragged N (not a multiple of the 128-row block), D (odd widths take the
    scalar loads, 3072 the central-pool width) and Q (past one 64-query block)."""
    bank, targets, w = _multi_args(dev, N, D, Q, dtype, seed=20)
    got = tss.weighted_bank_scores_multi(bank, targets, w)
    assert got.shape == (N, Q) and got.dtype == torch.float32
    assert _max_rel(got, tss.weighted_bank_scores_multi_plain(bank, targets, w)) <= tol
    vals, idx = tss.bank_topk_multi(bank, targets, w, min(5, N))
    assert vals.shape == (Q, min(5, N))
    assert torch.equal(vals, torch.gather(got.t(), 1, idx))
    # an unaligned bank (a row-offset view of another) takes the scalar loads
    if dtype == torch.float32 and D % 4 == 0 and N > 1:
        tail = bank[1:].contiguous().view(-1)[: (N - 1) * D]
        shifted = torch.cat([tail.new_zeros(1), tail])[1:].view(N - 1, D)
        assert shifted.data_ptr() % 16 != 0
        assert _max_rel(tss.weighted_bank_scores_multi(shifted, targets, w), got[1:]) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Q", [1, 8, 64, 130])
def test_multi_scores_keep_the_split_promise(dev, Q, dtype):
    """At the retrieval width (D = 768) the bf16-split products stay within
    TOL_SPLIT of the plain fp32 version, far inside the bank bars."""
    bank, targets, w = _multi_args(dev, 4097, 768, Q, dtype, seed=25)
    got = tss.weighted_bank_scores_multi(bank, targets, w)
    assert _max_rel(got, tss.weighted_bank_scores_multi_plain(bank, targets, w)) <= TOL_SPLIT


def test_multi_scorer_refuses_what_it_does_not_take(dev):
    bank, targets, w = _multi_args(dev, 64, 32, 3, torch.float32, seed=21)
    with pytest.raises(ValueError, match="not supported"):
        tss.weighted_bank_scores_multi(bank.half(), targets, w)
    with pytest.raises(ValueError, match="contiguous"):
        tss.weighted_bank_scores_multi(bank.t(), targets, w)
    with pytest.raises(ValueError, match="on cpu"):
        tss.weighted_bank_scores_multi(bank, targets.cpu(), w)
    with pytest.raises(ValueError, match="weights"):
        tss.weighted_bank_scores_multi(bank, targets, w.double())
    with pytest.raises(ValueError, match="targets"):
        tss.weighted_bank_scores_multi(bank, targets[0], w)
    narrow = bank[:, :30].contiguous()  # quantising takes it, torch._int_mm does not
    with pytest.raises(ValueError, match="D % 8"):
        tss.bank_topk_int8(*tss.quantize_bank_int8(narrow), narrow, targets[0, :30],
                           w[0, :30].contiguous(), 5, oversample=20)


def test_multi_scorer_counts_one_launch_per_call(dev):
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank

    bank, _, _ = _multi_args(dev, 5000, 64, 1, torch.bfloat16, seed=22)
    before = (tss.weighted_bank_scores_multi.launches, tss.weighted_bank_scores.launches)
    eb = EmbeddingBank(bank.cpu(), np.zeros((5000, 2), np.float32), np.zeros(64), np.ones(64),
                       device=dev)
    groups = [np.random.default_rng(g).normal(size=(3, 4, 64)) for g in range(4)]
    scores, rows = eb.query_multi(groups, k=10)
    eb.query_multi(groups, k=10, exact=True)
    torch.cuda.synchronize()
    assert scores.shape == rows.shape == (4, 10)
    assert (tss.weighted_bank_scores_multi.launches - before[0],
            tss.weighted_bank_scores.launches - before[1]) == (2, 0)


def test_chunked_scorer_equals_single_pass_on_the_card(dev):
    """A host bank in 4 slabs (a ragged tail) through K3 on the card: the
    single pass's indices and, row by row the same K3 code, its scores bit
    for bit; one K3 launch per slab."""
    rng = np.random.default_rng(23)
    host = torch.from_numpy(rng.normal(size=(10_000, 64)).astype(np.float32)).to(torch.bfloat16)
    target = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(dev)
    w = torch.full((64,), 1 / 64, device=dev)
    before = tss.weighted_bank_scores.launches
    vals, idx = tss.bank_topk_chunked(host, target, w, 300, slab_rows=3000)
    assert tss.weighted_bank_scores.launches - before == 4
    want_v, want_i = tss.bank_topk(host.to(dev), target, w, 300)
    np.testing.assert_array_equal(idx, want_i.cpu().numpy())
    np.testing.assert_array_equal(vals, want_v.cpu().numpy())


def test_int8_routes_agree_with_the_exact_scorers(dev):
    """The two-stage scorers on a 100 000-row bf16 bank: top-300 agreement
    with the exact ranking (share of returned rows whose exact score reaches
    the exact cut - 5e-3) at least 0.999 (one target) and 0.99 (each of 8),
    and the returned scores are the exact scores of those rows."""
    rng = np.random.default_rng(24)
    bank = torch.from_numpy(rng.normal(size=(100_000, 768)).astype(np.float32)).to(dev, torch.bfloat16)
    targets = torch.from_numpy(rng.normal(size=(8, 768)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=(8, 768)).astype(np.float32)).to(dev)
    w = w / w.sum(dim=1, keepdim=True)
    bank8, rnorm = tss.quantize_bank_int8(bank)
    exact = tss.weighted_bank_scores_multi(bank, targets, w)  # (N, 8)
    vals, idx = tss.bank_topk_int8(bank8, rnorm, bank, targets[0], w[0], 300, oversample=8192)
    cut = torch.topk(exact[:, 0], 300).values[-1]
    assert float((exact[idx, 0] >= cut - 5e-3).float().mean()) >= 0.999
    assert _max_rel(vals, exact[idx, 0]) <= TOL_SCORE_F32
    mvals, midx = tss.bank_topk_multi_int8(bank8, rnorm, bank, targets, w, 300, oversample=2048)
    assert mvals.shape == midx.shape == (8, 300)
    for q in range(8):
        cut = torch.topk(exact[:, q], 300).values[-1]
        assert float((exact[midx[q], q] >= cut - 5e-3).float().mean()) >= 0.99, q
        assert _max_rel(mvals[q], exact[midx[q], q]) <= TOL_SCORE_F32


# -- MAE: the packed-segment mask of kernels 1, 2 and 4, the decoder ----------------

# (packed sequences, seg_len, samples a sequence, D, H): pairs and fours of 17
# tokens (N = 34, 68: MAE at ViT-B), fours of 18 (N = 72, the RA/Dec token),
# odd sequence counts (63: a ragged batch of 252)
SEG_SHAPES = [(3, 17, 2, 64, 4), (5, 17, 4, 768, 12), (63, 17, 4, 768, 12), (7, 18, 4, 128, 2),
              (1, 18, 4, 96, 3), (2, 18, 2, 1280, 16)]


def _seg_block(N, seg):
    """(N, N) bool: key j is in query i's segment."""
    ids = torch.arange(N) // seg
    return ids[:, None] == ids[None, :]


@pytest.mark.parametrize("S,seg,pack,D,H", SEG_SHAPES)
def test_seg_kernels_match_plain(dev, S, seg, pack, D, H):
    """K2, kernel 2 and kernel 4 with ``seg_len`` against their plain
    versions (which add JAX's -1e9 bias); kernel 2's stashed probabilities
    are exactly 0 outside each sample's block; kernel 3 (no mask) from the
    packed stash; every call counts one launch, a masked one on
    ``seg_launches`` too."""
    N = seg * pack
    x, scale, bias, wqkv, bqkv, wproj, bproj = args = _block_args(dev, S, N, D, (D, 3 * D), (D, D), 50)
    g = torch.from_numpy(np.random.default_rng(51).normal(size=(S, N, D)).astype(np.float32)).to(dev)
    g = g.to(torch.bfloat16)
    counters = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd)
    before = [(f.launches, f.seg_launches) for f in counters]
    assert _max_rel(tab.fused_attn_block(*args, H, seg_len=seg), tab.attn_block_plain(*args, H, seg)) <= TOL_FWD
    got = tab.attn_block_fwd_stash(*args, H, seg)
    want = tab.attn_block_fwd_stash_plain(*args, H, seg)
    for name, a, b in zip(("out", "qkv", "probs"), got, want):
        assert _max_rel(a, b) <= TOL_FWD, name
    off = ~_seg_block(N, seg).to(dev)
    assert not got[2][:, :, off].any()
    got = tab.attn_block_bwd(x, scale, bias, wqkv, bqkv, wproj, g, H, seg)
    for name, a, b in zip(("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"),
                          got, tab.attn_block_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, H, seg)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= TOL_BWD, name
    _, qkv, probs = want
    bwd = (x, scale, bias, wqkv, wproj, qkv, probs, g, H)
    for name, a, b in zip(("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"),
                          tab.attn_block_bwd_stash(*bwd), tab.attn_block_bwd_stash_plain(*bwd)):
        assert _max_rel(a, b) <= TOL_BWD, name
    torch.cuda.synchronize()
    assert [(f.launches - l0, f.seg_launches - s0) for f, (l0, s0) in zip(counters, before)] == \
        [(1, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("S,seg,pack", [(5, 17, 4), (3, 18, 4), (4, 17, 2)])
def test_packed_kernels_equal_unpacked(dev, S, seg, pack):
    """The same samples through the masked kernels packed ``pack`` to a
    sequence and through the unmasked kernels one to a sequence: K2's
    output, kernel 2's output, qkv and probabilities (the packed blocks on
    the diagonal), kernel 4's gradients."""
    B, D, H = S * pack, 128, 2
    x, *w = _block_args(dev, B, seg, D, (D, 3 * D), (D, D), 52)
    g = torch.from_numpy(np.random.default_rng(53).normal(size=(B, seg, D)).astype(np.float32))
    g = g.to(dev, torch.bfloat16)
    xp, gp = x.reshape(S, pack * seg, D), g.reshape(S, pack * seg, D)
    assert _max_rel(tab.fused_attn_block(xp, *w, H, seg_len=seg).reshape(B, seg, D),
                    tab.fused_attn_block(x, *w, H)) <= TOL_FWD
    out_p, qkv_p, probs_p = tab.attn_block_fwd_stash(xp, *w, H, seg)
    out_u, qkv_u, probs_u = tab.attn_block_fwd_stash(x, *w, H)
    assert _max_rel(out_p.reshape(B, seg, D), out_u) <= TOL_FWD
    assert _max_rel(qkv_p.reshape(B, seg, 3 * D), qkv_u) <= TOL_FWD
    diag = torch.stack([probs_p[:, :, i * seg:(i + 1) * seg, i * seg:(i + 1) * seg] for i in range(pack)], 1)
    assert _max_rel(diag.reshape(B, H, seg, seg), probs_u) <= TOL_FWD
    got = tab.attn_block_bwd(xp, *w[:5], gp, H, seg)
    want = tab.attn_block_bwd(x, *w[:5], g, H)
    assert _max_rel(got[0].reshape(B, seg, D), want[0]) <= TOL_BWD
    for name, a, b in zip(("dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"), got[1:], want[1:]):
        assert _max_rel(a, b) <= TOL_BWD, name


def test_attention_kernels_at_a_head_of_512(dev):
    """``maesimple``'s decoder: one head of 512 at N = 65. Each core's plan
    shrinks to fit (the forward reads Q's fragments from device memory,
    166 400 bytes; the backward takes 16-row query blocks and 32-column
    chunks, 228 352 of 232 448), and K2, kernels 2, 3 and 4 match their
    plain versions."""
    B, N, D, H = 6, 65, 512, 1
    assert [tab._plan_bytes(c, N, D) for c in ("fwd", "stash", "recompute")] == [166400, 228352, 228352]
    x, scale, bias, wqkv, bqkv, wproj, bproj = args = _block_args(dev, B, N, D, (D, 3 * D), (D, D), 54)
    g = torch.from_numpy(np.random.default_rng(55).normal(size=(B, N, D)).astype(np.float32))
    g = g.to(dev, torch.bfloat16)
    assert _max_rel(tab.fused_attn_block(*args, H), tab.attn_block_plain(*args, H)) <= TOL_FWD
    for name, a, b in zip(("out", "qkv", "probs"), tab.attn_block_fwd_stash(*args, H),
                          tab.attn_block_fwd_stash_plain(*args, H)):
        assert _max_rel(a, b) <= TOL_FWD, name
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*args, H)
    grads = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")
    bwd = (x, scale, bias, wqkv, wproj, qkv, probs, g, H)
    for name, a, b in zip(grads, tab.attn_block_bwd_stash(*bwd), tab.attn_block_bwd_stash_plain(*bwd)):
        assert _max_rel(a, b) <= TOL_BWD, name
    rec = (x, scale, bias, wqkv, bqkv, wproj, g, H)
    for name, a, b in zip(grads, tab.attn_block_bwd(*rec), tab.attn_block_bwd_plain(*rec)):
        assert _max_rel(a, b) <= TOL_BWD, name


def _mae_grads(dev, plain, **kw):
    """One bf16 training forward and ``loss.backward()`` of a small MAE model
    on the card: 64 patches, 16 kept (n = 17), batch 8 packed four to a
    sequence (N = 68), a 3-block encoder and a 2-block decoder. (gradients
    by name, loss)."""
    from sky_embeddings_tpu_torch.models.mim import SkyMIM

    model = SkyMIM(img_size=32, patch_size=4, in_chans=5, embed_dim=128, depth=3, num_heads=4,
                   simmim=False, decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
                   pack_tokens=4, norm_pix_loss=True, dtype=torch.bfloat16, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    model.plain = plain
    rng = np.random.default_rng(56)
    imgs = rng.normal(size=(8, 5, 32, 32)).astype(np.float32)
    imgs[1, 2] = np.nan
    noise = rng.random((8, 64)).astype(np.float32)
    loss = model(torch.from_numpy(imgs).to(dev), mae_noise=torch.from_numpy(noise).to(dev))[0]
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}, loss.detach()


# per path: launches of (K2, kernel 2, kernel 3, kernel 4, K1, kernel 8) and
# of the masked ones (K2, kernel 2, kernel 4) in one step: the packed encoder
# (3 blocks) and the decoder (2 blocks, unmasked)
MAE_PATHS = {
    "stash": (dict(), [0, 5, 5, 0, 5, 5], [0, 3, 0]),
    "stash_decoder_off": (dict(stash_decoder=False), [2, 3, 3, 2, 5, 5], [0, 3, 0]),
    "remat": (dict(remat=True), [6, 2, 2, 3, 8, 5], [6, 0, 3]),
}


@pytest.mark.parametrize("path", list(MAE_PATHS))
def test_mae_training_step_reaches_every_parameter(dev, path):
    """A MAE training step on the card: the stated launches (the encoder's
    masked, the decoder's not); every parameter, the decoder's and
    ``mask_token`` included, gets a finite, nonzero gradient; the gradients
    agree with the plain path's."""
    kw, launches, seg = MAE_PATHS[path]
    counters = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
                tab.attn_block_bwd, tmb.fused_mlp_block, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    seg_before = [f.seg_launches for f in counters[:2] + counters[3:4]]
    got, _ = _mae_grads(dev, False, **kw)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == launches
    assert [f.seg_launches - b for f, b in zip(counters[:2] + counters[3:4], seg_before)] == seg
    ref, _ = _mae_grads(dev, True, **kw)
    rels = {}
    for name, grad in got.items():
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0, name
        rels[name] = float((grad - ref[name]).norm() / (ref[name].norm() + 1e-12))
    assert any(n.startswith("decoder.") for n in rels) and "mask_token" in rels
    # five layers of bf16 rounding flips (three encoder, two decoder); the
    # SimMIM paths above measured up to 6.0e-2 at three layers
    worst = max(rels, key=rels.get)
    assert rels[worst] <= 1.2e-1, (worst, rels[worst])


def test_mae_remat_gradients_equal_the_stored_path_on_the_card(dev):
    """Remat replays the packed encoder's blocks with the same ``seg_len``
    (K2 and kernel 4, masked); the gradients equal those of the model stored
    with the encoder's stash off, bit for bit."""
    got, la = _mae_grads(dev, False, remat=True)
    want, lb = _mae_grads(dev, False, stash=False)
    assert torch.equal(la, lb) and got.keys() == want.keys()
    for name, grad in got.items():
        assert torch.equal(grad, want[name]), name


# -- kernels 12 and 13: the standalone attention core ---------------------------------

# (B, N, D, H): ViT-B, ViT-H's heads of 80, the MAE decoder's 16 heads of
# 32, N = 256 at hd = 64 (the bf16 plans' largest N), ragged B and N
CORE_SHAPES = [(3, 65, 768, 12), (2, 66, 1280, 16), (4, 65, 512, 16), (2, 256, 256, 4),
               (5, 17, 64, 4), (3, 131, 240, 3), (1, 200, 96, 6)]
TOL_F32_CORE = 1e-4


def _core_inputs(dev, B, N, D, dtype, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
    return f(B, N, 3 * D), f(B, N, D)


# fp32 also at head dims of 15 and 12 (bf16 refuses them: tested below) and
# N = 256 at hd = 128 (the fp32 plan reads it from device memory in blocks)
F32_SHAPES = CORE_SHAPES + [(3, 17, 60, 4), (2, 33, 36, 3), (1, 256, 128, 1)]
CORE_CASES = ([(*s, torch.bfloat16) for s in CORE_SHAPES]
              + [(*s, torch.float32) for s in F32_SHAPES])


@pytest.mark.parametrize("B,N,D,H,dtype", CORE_CASES)
def test_attention_kernels_match_plain(dev, B, N, D, H, dtype):
    qkv, dctx = _core_inputs(dev, B, N, D, dtype, seed=B + N)
    ctx = tat.fused_attention(qkv, H)
    dqkv = tat.fused_attention_bwd(qkv, dctx, H)
    assert ctx.shape == (B, N, D) and dqkv.shape == qkv.shape
    assert ctx.dtype == dqkv.dtype == dtype
    fwd_bar, bwd_bar = (TOL_FWD, TOL_BWD) if dtype == torch.bfloat16 else (TOL_F32_CORE,) * 2
    assert _max_rel(ctx, tat.attention_plain(qkv, H)) <= fwd_bar
    assert _max_rel(dqkv, tat.attention_bwd_plain(qkv, dctx, H)) <= bwd_bar


@pytest.mark.parametrize("B,N,D,H", [(3, 65, 768, 12), (2, 66, 1280, 16), (2, 256, 256, 4)])
def test_attention_forward_equals_the_attention_block_core(dev, B, N, D, H):
    """Kernel 12 in bf16 is K2's core launched alone: on the qkv that kernel 2
    hands back, its context equals the one K2's core computed, bit for bit."""
    args = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=9)
    _, qkv, _, ctx = tab._launch_fwd(*args, H, stash=True)
    assert torch.equal(tat.fused_attention(qkv, H), ctx)


def test_attention_wrappers_refuse_and_count(dev):
    qkv, dctx = _core_inputs(dev, 2, 65, 768, torch.bfloat16, seed=1)
    for bad, match in ((qkv.half(), "bf16 or fp32"), (qkv[:, :, :-1], "contiguous"),
                       (torch.zeros(1, 257, 192, device=dev, dtype=torch.bfloat16), "bound"),
                       (torch.zeros(2, 17, 3 * 72, device=dev, dtype=torch.bfloat16), "multiple of 16")):
        with pytest.raises(ValueError, match=match):
            tat.fused_attention(bad, 6 if bad.shape[-1] == 3 * 72 else 12)
    with pytest.raises(ValueError, match="divisible"):
        tat.fused_attention(qkv, 7)
    with pytest.raises(ValueError, match="dctx"):
        tat.fused_attention_bwd(qkv, dctx.float(), 12)
    # bf16 K and V of 256 x 224 (the fp32 plan takes every N <= 256: below)
    with pytest.raises(ValueError, match="shared-memory plan"):
        tat.fused_attention(torch.zeros(1, 256, 3 * 224, device=dev, dtype=torch.bfloat16), 1)
    n12, n13 = tat.fused_attention.launches, tat.fused_attention_bwd.launches
    tat.fused_attention(qkv, 12)
    tat.fused_attention_bwd(qkv, dctx, 12)
    torch.cuda.synchronize()
    assert (tat.fused_attention.launches, tat.fused_attention_bwd.launches) == (n12 + 1, n13 + 1)


@pytest.mark.parametrize("B,N,D,H", F32_SHAPES)
def test_attention_f32_backward_gives_the_same_bits_twice(dev, B, N, D, H):
    """Kernel 13 in fp32 twice on the same inputs, bit for bit (every element
    one thread's FMA chain in a fixed order; no atomics), staged and from
    device memory (N = 131, 200, 256)."""
    qkv, dctx = _core_inputs(dev, B, N, D, torch.float32, seed=B + N + 1)
    first, second = tat.fused_attention_bwd(qkv, dctx, H), tat.fused_attention_bwd(qkv, dctx, H)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("N", [1, 17, 65, 66, 128, 131, 200, 256])
def test_attention_f32_plan_equals_the_python_copy(dev, N):
    """``AttnF32Plan`` as the CUDA source computes it equals
    ``attention.f32_plan`` (staged or not, QB, HC, threads, bytes) at head
    widths 1 to 1 024, forward and backward, and every plan fits."""
    for hd in list(range(1, 129)) + [144, 160, 224, 256, 384, 512, 1000, 1024]:
        for backward in (False, True):
            want = tat.f32_plan(N, hd, backward)
            assert tat._f32_plan_cuda(N, hd, backward) == want, (N, hd, backward)
            assert want.bytes == tat._plan_bytes(N, hd, True, backward) <= tab.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_module_backward_launches_kernels_12_and_13(dev, dtype):
    """``layers.Attention`` at ViT-B width: one forward and ``backward()``
    launch kernel 12 once and kernel 13 once, and every gradient matches the
    plain path's from the same weights."""
    from sky_embeddings_tpu_torch.models.layers import Attention

    mod = Attention(768, 12, dtype)
    for lin in (mod.qkv, mod.proj):
        lin.reset_parameters(torch.Generator().manual_seed(1))
    mod.to(dev)
    x = (torch.randn(4, 65, 768, device=dev) * 0.5).to(dtype)
    grads = []
    for plain in (False, True):
        mod.plain = plain
        mod.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        n = (tat.fused_attention.launches, tat.fused_attention_bwd.launches)
        (mod(xi).float() ** 2).sum().backward()
        torch.cuda.synchronize()
        got = (tat.fused_attention.launches - n[0], tat.fused_attention_bwd.launches - n[1])
        assert got == ((0, 0) if plain else (1, 1))
        grads.append({"x": xi.grad, **{k: p.grad for k, p in mod.named_parameters()}})
    bar = TOL_BWD if dtype == torch.bfloat16 else TOL_F32_CORE
    for k, g in grads[0].items():
        assert _max_rel(g, grads[1][k]) <= bar, k


# -- the mma.sync attention cores (csrc/attn_core.cuh): ragged edges, head widths,
# determinism, the plans' bytes ---------------------------------------------------

SMEM = 232448
# every N edge (one token, a single 16-row tile, ragged tiles, the 80-row
# padding of ViT-B/H and MAE, 129: the first query-blocked backward, 256)
# at every head width; a head of 512 has no plan past N = 80
CORE_EDGES = [(n, hd) for n in (1, 17, 63, 65, 66, 129, 256) for hd in (16, 32, 64, 80, 128, 512)
              if hd < 512 or n <= 80]


def _plans(N, hd, sums=False):
    """The forward's and the backward's shared-memory bytes at (N, hd), as
    AttnPlan and AttnBwdPlan choose them: the forward two ring slots of K, V
    and Q, else one, else K and V alone; the backward the widest column
    chunk, then the largest query block, that fits, with (``sums``, kernels
    3 and 4) or without (kernel 13) a row of column sums per warp (with
    one block only: several keep them in their accumulators' padding)."""
    NP, HL = -(-N // 16) * 16, hd + 8
    fwd = next(b for b in (2 * 3 * NP * HL * 2, 3 * NP * HL * 2, 2 * NP * HL * 2)
               if b <= SMEM or b == 2 * NP * HL * 2)
    warps = min(NP // 16, 8)

    def bwd_bytes(qb, hc):
        acc = 2 * NP * (hc + 4) * 4 if qb < NP else 0
        red = warps * hc * 4 if sums and qb == NP else 0
        return (2 * NP * HL + 2 * qb * HL + 2 * qb * (NP + 8)) * 2 + acc + red

    for i, hc in enumerate((hd, 128, 64, 32, 16)):
        if i and hc >= hd:
            continue
        qb = NP if NP <= 128 else 64
        while qb >= 16:
            if bwd_bytes(qb, hc) <= SMEM:
                return fwd, bwd_bytes(qb, hc)
            qb = 64 if qb > 64 else qb // 2
    return fwd, bwd_bytes(16, 16)


@pytest.mark.parametrize("N,hd", CORE_EDGES)
def test_attention_cores_at_every_edge(dev, N, hd):
    """Kernels 12 and 13 (bf16) against their plain versions at each ragged
    N and head width; kernel 13's dq, dk and dv come straight out in bf16
    (each rounded once, no fp32 scratch)."""
    B, H = 3, 2
    qkv, dctx = _core_inputs(dev, B, N, H * hd, torch.bfloat16, seed=N + hd)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dqkv = tat.fused_attention_bwd(qkv, dctx, H)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= qkv.numel() * 2 + 512  # dqkv alone
    assert dqkv.dtype == torch.bfloat16 and dqkv.shape == qkv.shape
    assert _max_rel(dqkv, tat.attention_bwd_plain(qkv, dctx, H)) <= TOL_BWD
    assert _max_rel(tat.fused_attention(qkv, H), tat.attention_plain(qkv, H)) <= TOL_FWD


@pytest.mark.parametrize("N,hd", [(65, 64), (66, 80), (17, 32), (129, 64), (256, 128), (65, 512)])
def test_attention_cores_give_the_same_bits_twice(dev, N, hd):
    """Every core twice on the same inputs, bit for bit: kernels 12 and 13,
    K2 and kernel 2 (the forward core), kernels 3 and 4 (the backward core,
    stashed, recomputed and masked; across query blocks and column chunks at
    N = 129, 256 and hd = 512, with dbqkv's per-sample column sums and the
    weight-gradient group's split slices)."""
    H = 2
    D = H * hd
    qkv, dctx = _core_inputs(dev, 2, N, D, torch.bfloat16, seed=7)
    args = _block_args(dev, 2, N, D, (D, 3 * D), (D, D), seed=8)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(2, N, D)).astype(np.float32)).to(dev, torch.bfloat16)
    _, qkv_s, probs_s = tab.attn_block_fwd_stash_plain(*args, H)
    calls = {
        "kernel 12": lambda: (tat.fused_attention(qkv, H),),
        "kernel 13": lambda: (tat.fused_attention_bwd(qkv, dctx, H),),
        "K2": lambda: (tab.fused_attn_block(*args, H),),
        "kernel 2": lambda: tab.attn_block_fwd_stash(*args, H),
        "kernel 3": lambda: tab.attn_block_bwd_stash(*args[:4], args[5], qkv_s, probs_s, g, H),
        "kernel 4": lambda: tab.attn_block_bwd(*args[:6], g, H),
        "kernel 4 masked": lambda: tab.attn_block_bwd(*args[:6], g, H, max(N // 4, 1)),
    }
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), name


@pytest.mark.parametrize("S,seg,pack,D,H", [(3, 17, 4, 768, 12), (2, 17, 4, 1280, 16), (4, 17, 4, 512, 16)])
def test_packed_cores_equal_unpacked_at_model_width(dev, S, seg, pack, D, H):
    """MAE's packing (N = 68, seg_len = 17) at ViT-B, ViT-H and the MAE
    decoder's head widths: K2's output and kernel 4's gradients with the
    mask equal the unmasked kernels' on the same samples one to a sequence,
    within the bars."""
    B = S * pack
    x, *w = _block_args(dev, B, seg, D, (D, 3 * D), (D, D), 57)
    g = torch.from_numpy(np.random.default_rng(58).normal(size=(B, seg, D)).astype(np.float32))
    g = g.to(dev, torch.bfloat16)
    xp, gp = x.reshape(S, pack * seg, D), g.reshape(S, pack * seg, D)
    assert _max_rel(tab.fused_attn_block(xp, *w, H, seg_len=seg).reshape(B, seg, D),
                    tab.fused_attn_block(x, *w, H)) <= TOL_FWD
    got = tab.attn_block_bwd(xp, *w[:5], gp, H, seg)
    want = tab.attn_block_bwd(x, *w[:5], g, H)
    assert _max_rel(got[0].reshape(B, seg, D), want[0]) <= TOL_BWD
    for name, a, b in zip(("dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"), got[1:], want[1:]):
        assert _max_rel(a, b) <= TOL_BWD, name


@pytest.mark.parametrize("N", [17, 65, 129, 256])
def test_core_plans_and_refusals(dev, N):
    """The plan bytes each wrapper reads are the cores' plans, and the
    wrappers refuse exactly the heads whose plan exceeds a block's shared
    memory: kernels 12 and 13 and K2 / kernel 4 at every multiple of 16
    from 16 to 512. Kernels 3 and 4's plan, with its column sums, fits
    every head kernel 13's does."""
    for hd in range(16, 513, 16):
        fwd, bwd = _plans(N, hd)
        bwd_sums = _plans(N, hd, sums=True)[1]
        assert tat._plan_bytes(N, hd, False, False) == tab._plan_bytes("fwd", N, hd) == fwd, hd
        assert tat._plan_bytes(N, hd, False, True) == bwd, hd
        assert tab._plan_bytes("recompute", N, hd) == tab._plan_bytes("stash", N, hd) == bwd_sums, hd
        assert (bwd_sums <= SMEM) == (bwd <= SMEM), hd
    for hd in (96, 144, 160, 208, 224, 512):
        fwd, bwd = _plans(N, hd)
        qkv = torch.zeros(1, N, 3 * hd, device=dev, dtype=torch.bfloat16)
        for call, nbytes in ((lambda: tat.fused_attention(qkv, 1), fwd),
                             (lambda: tat.fused_attention_bwd(qkv, qkv[:, :, :hd].contiguous(), 1), bwd)):
            if nbytes > SMEM:
                with pytest.raises(ValueError, match="shared-memory plan"):
                    call()
            else:
                assert torch.isfinite(call().float()).all()


# -- the forward GEMM of K1 and K2 (csrc/gemm_sm90.cuh) ----------------------------

GEMM_M = (1, 63, 4160, 4161)
GEMM_N = (8, 200, 768, 2304, 3072)
GEMM_K = (8, 200, 768, 3072)


@pytest.mark.parametrize("epi", sorted(tg.EPILOGUES))
@pytest.mark.parametrize("K", GEMM_K)
@pytest.mark.parametrize("N", GEMM_N)
@pytest.mark.parametrize("M", GEMM_M)
def test_sm90_gemm_matches_an_fp32_product(dev, M, N, K, epi):
    """One product on the new GEMM against the fp32 product of the same
    bf16 operands with the epilogue's rounding (``gemm_plain``): ragged rows
    (M = 1, 63, 4 161), N and K past a whole box (200, 8) and the model
    widths; then the same launch again, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(M * 7 + N * 3 + K)
    a = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(N, generator=gen, device=dev)
    resid = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
    out, out2 = tg.gemm(a, b, bias, epi, resid)
    want, want2 = tg.gemm_plain(a, b, bias, epi, resid)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert _max_rel(out, want) <= TOL_FWD
    if epi == "bias_gelu_stash":
        assert _max_rel(out2, want2) <= TOL_FWD
        assert torch.equal(out, tg.gemm(a, b, bias, "bias_gelu")[0])  # GELU of the fp32 value
    again, again2 = tg.gemm(a, b, bias, epi, resid)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and (out2 is None or torch.equal(out2, again2))


def test_sm90_gemm_refuses_and_counts(dev):
    a = torch.zeros(16, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(64, 32, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(32, device=dev)
    before = tg.gemm.launches
    tg.gemm(a, b, bias, "bias")
    assert tg.gemm.launches == before + 1
    with pytest.raises(ValueError, match="multiples of 8"):
        tg.gemm(a[:, :60].contiguous(), b[:60], bias, "bias")
    with pytest.raises(ValueError, match="resid"):
        tg.gemm(a, b, bias, "bias_residual")
    with pytest.raises(ValueError, match="b:"):
        tg.gemm(a, b.float(), bias, "bias")
    assert tg.gemm.launches == before + 1


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_sm90_tile_rule_equals_its_python_copy(dev, sms):
    """The plan the C source computes (``sky_gemm_sm90_plan``) is
    ``gemm_plan``'s at every model product and ragged shape."""
    for M in (1, 63, 64 * 65, 4161, 32 * 66, 256 * 66, 256 * 68, 1024 * 65):
        for N in (8, 200, 512, 768, 1024, 1280, 1536, 2048, 2304, 3072, 3840, 4096, 5120):
            assert tg.gemm_plan_cuda(M, N, sms) == tg.gemm_plan(M, N, sms), (M, N, sms)


# (B, N, D, H, F): the MAE decoder (512 wide, 16 heads), ViT-B, ViT-L
# (mim_32, with the RA/Dec token) and ViT-H, at a few samples each
MODEL_WIDTHS = [(8, 65, 512, 16, 2048), (5, 65, 768, 12, 3072), (3, 66, 1024, 16, 4096),
                (3, 66, 1280, 16, 5120)]


@pytest.mark.parametrize("B,N,D,H,F", MODEL_WIDTHS)
def test_forward_blocks_match_plain_at_every_shipped_width(dev, B, N, D, H, F):
    """K1 and K2, kernel 6 (bit-equal to K1) and kernel 2, at each width a
    shipped model runs."""
    margs = _block_args(dev, B, N, D, (D, F), (F, D), seed=D)
    out = tmb.fused_mlp_block(*margs)
    assert _max_rel(out, tmb.mlp_block_plain(*margs)) <= TOL_FWD
    stash_out, a = tmb.mlp_block_fwd_stash(*margs)
    assert torch.equal(stash_out, out)
    assert _max_rel(a, tmb.mlp_block_fwd_stash_plain(*margs)[1]) <= TOL_FWD
    aargs = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=D + 1)
    assert _max_rel(tab.fused_attn_block(*aargs, H), tab.attn_block_plain(*aargs, H)) <= TOL_FWD
    got = tab.attn_block_fwd_stash(*aargs, H)
    for name, g_, w_ in zip(("out", "qkv", "probs"), got, tab.attn_block_fwd_stash_plain(*aargs, H)):
        assert _max_rel(g_, w_) <= TOL_FWD, name


def test_forward_blocks_launch_only_the_sm90_gemm(dev):
    """K1, K2, kernels 2 and 6 and K2 masked run their products on
    ``gemm_sm90_kernel``, and no launch of theirs is a wmma GEMM
    (``gemm_bf16``, which the port no longer has; the profiler's kernel
    names)."""
    from torch.profiler import ProfilerActivity, profile

    margs = _block_args(dev, 4, 68, 768, (768, 3072), (3072, 768), seed=3)
    aargs = _block_args(dev, 4, 68, 768, (768, 2304), (768, 768), seed=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tmb.fused_mlp_block(*margs)
        tmb.mlp_block_fwd_stash(*margs)
        tab.fused_attn_block(*aargs, 12)
        tab.fused_attn_block(*aargs, 12, seg_len=17)
        tab.attn_block_fwd_stash(*aargs, 12)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    assert sum("gemm_sm90_kernel" in n for n in names) >= 4, names
    assert not any("gemm_bf16" in n for n in names), names


# -- the backward forms of csrc/gemm_sm90.cuh (kernels 8, 7 and 9) -----------------

# fp32 outputs against the fp32 product of the same bf16 operands: the sums
# run in another order (K up to 17 408 terms), nothing is rounded to bf16
TOL_F32 = 1e-4


def _bwd_operands(dev, form, M, N, K, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a_shape, b_shape = ((M, K), (N, K)) if form == "nt" else ((K, M), (K, N))
    a = torch.randn(*a_shape, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(*b_shape, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    c = torch.randn(M, N, generator=gen, device=dev)
    return a, b, c


def _check_bwd(dev, form, epi, M, N, K, bn=0, splits=0, seed=0, schedule=None):
    a, b, c = _bwd_operands(dev, form, M, N, K, seed)
    out = tg.gemm_bwd(a, b, form, epi, c, bn=bn, splits=splits, schedule=schedule)
    want = tg.gemm_bwd_plain(a, b, form, epi, c)
    assert out.shape == (M, N) and out.dtype == want.dtype
    assert _max_rel(out, want) <= (TOL_FWD if epi == "store" else TOL_F32)
    again = tg.gemm_bwd(a, b, form, epi, c, bn=bn, splits=splits, schedule=schedule)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("epi", ["store", "store_f32", "add_f32"])
@pytest.mark.parametrize("K", (8, 200, 3072, 5120))
@pytest.mark.parametrize("N", (8, 200, 768, 5120))
@pytest.mark.parametrize("M", (1, 63, 4161))
def test_sm90_nt_form_matches_an_fp32_product(dev, M, N, K, epi):
    """out = a @ bᵀ with b stored (N, K), read K-major in place (dh = g @
    W2ᵀ, dy = da_c @ W1ᵀ): ragged rows, N and K past a whole box, model
    widths; twice bit-equal."""
    _check_bwd(dev, "nt", epi, M, N, K, seed=M + 3 * N + 7 * K)


@pytest.mark.parametrize("epi", ["store", "store_f32"])
@pytest.mark.parametrize("K", (8, 520, 4160, 17408))
@pytest.mark.parametrize("N", (8, 768, 3072))
@pytest.mark.parametrize("M", (8, 200, 1280, 5120))
def test_sm90_tn_form_matches_an_fp32_product(dev, M, N, K, epi):
    """out = aᵀ @ b with a stored (K, M), read MN-major (the weight
    gradients over K = B·N token rows: 8, 520, 64·65 and the MAE encoder's
    256·68 = 17 408), with the plan's split count; twice bit-equal."""
    _check_bwd(dev, "tn", epi, M, N, K, seed=M + 5 * N + 11 * K)


@pytest.mark.parametrize("splits", (1, 2, 3, 4, 6, 8))
@pytest.mark.parametrize("bn", tg.BNS)
@pytest.mark.parametrize("M,N,K", [(768, 3072, 4160), (1280, 1280, 2112), (200, 8, 65 * 9)])
def test_sm90_weight_gradient_at_every_split_and_width(dev, M, N, K, bn, splits):
    """Each split count and tile width forced: the slices' fp32 partials
    added in order, then rounded once; twice bit-equal."""
    _check_bwd(dev, "tn", "store", M, N, K, bn=bn, splits=splits, seed=splits)


@pytest.mark.parametrize("bn,splits", [(0, 0)] + [(bn, sp) for bn in tg.BNS
                                                   for sp in tg.SPLIT_CANDIDATES])
@pytest.mark.parametrize("M,D,F", [(4160, 768, 3072), (2112, 1280, 1280), (520, 64, 256)])
def test_sm90_weight_gradient_group_matches_plain(dev, M, D, F, bn, splits):
    """dW1 and dW2 in one launch, as kernels 8 and 9 run them
    (``mlp_weight_grads``), at the plan's choice and at each tile width and
    split count forced, the workspace sized by the C plan; twice bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(M + D + F + splits)
    y, g = (torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    da_c, h_c = (torch.randn(M, F, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    got = tg.mlp_weight_grads(y, da_c, h_c, g, bn=bn, splits=splits)
    want = tg.mlp_weight_grads(y.cpu(), da_c.cpu(), h_c.cpu(), g.cpu())
    for a_, b_ in zip(got, want):
        assert a_.shape == b_.shape and a_.dtype == b_.dtype
        assert _max_rel(a_, b_.to(dev)) <= TOL_FWD
    again = tg.mlp_weight_grads(y, da_c, h_c, g, bn=bn, splits=splits)
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


@pytest.mark.parametrize("M,N,K", [(4160, 3072, 768), (2112, 1280, 1280), (63, 200, 64),
                                   (1, 8, 8), (4161, 5120, 1280), (33, 136, 96)])
def test_sm90_dual_product_matches_plain(dev, M, N, K):
    """a = y @ W1 + b1 and dh = g @ W2ᵀ in one launch: da_c, h_c and db1
    against the plain version; twice bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(M + N + K)
    bf = torch.bfloat16
    y = torch.randn(M, K, generator=gen, device=dev).to(bf)
    g = (0.1 * torch.randn(M, K, generator=gen, device=dev)).to(bf)
    w1 = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(bf)
    w2 = (torch.randn(N, K, generator=gen, device=dev) * N ** -0.5).to(bf)
    b1 = 0.1 * torch.randn(N, generator=gen, device=dev)
    got = tg.gemm_dual(y, w1, b1, g, w2)
    want = tg.gemm_dual_plain(y, w1, b1, g, w2)
    for name, a_, b_, tol in zip(("da_c", "h_c", "db1"), got, want, (TOL_FWD, TOL_FWD, TOL_BWD)):
        assert a_.shape == b_.shape and a_.dtype == b_.dtype, name
        assert _max_rel(a_, b_) <= tol, name
    again = tg.gemm_dual(y, w1, b1, g, w2)
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


@pytest.mark.parametrize("D", (64, 768, 1280))
@pytest.mark.parametrize("F", (8, 136, 3072))
@pytest.mark.parametrize("M", (1, 63, 65, 4160))
def test_sm90_dh_stash_matches_plain(dev, M, F, D):
    """dh = g @ W2ᵀ with the epilogue that reads the bf16 stash a: da_c,
    h_c and db1 against the plain version, at ragged rows, N past a whole
    box and model widths; twice bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(M + F + D)
    bf = torch.bfloat16
    g = (0.1 * torch.randn(M, D, generator=gen, device=dev)).to(bf)
    w2 = (torch.randn(F, D, generator=gen, device=dev) * F ** -0.5).to(bf)
    a = torch.randn(M, F, generator=gen, device=dev).to(bf)
    got = tg.gemm_dh_stash(g, w2, a)
    want = tg.gemm_dh_stash_plain(g, w2, a)
    for name, a_, b_ in zip(("da_c", "h_c", "db1"), got, want):
        assert a_.shape == b_.shape and a_.dtype == b_.dtype, name
        assert _max_rel(a_, b_) <= TOL_BWD, name
    again = tg.gemm_dh_stash(g, w2, a)
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


def test_sm90_backward_entries_refuse_and_count(dev):
    a = torch.zeros(64, 32, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(16, 32, device=dev, dtype=torch.bfloat16)
    before = tg.gemm_bwd.launches
    assert tg.gemm_bwd(a, b, "nt", "store").shape == (64, 16)
    assert tg.gemm_bwd.launches == before + 1
    with pytest.raises(ValueError, match="multiples of 8"):
        tg.gemm_bwd(a[:, :20].contiguous(), b[:, :20].contiguous(), "nt", "store")
    with pytest.raises(ValueError, match="tn"):
        tg.gemm_bwd(a, b, "tn", "store")
    with pytest.raises(ValueError, match="c:"):
        tg.gemm_bwd(a, b, "nt", "add_f32")
    with pytest.raises(ValueError, match="b:"):
        tg.gemm_bwd(a, b.float(), "nt", "store")
    assert tg.gemm_bwd.launches == before + 1
    with pytest.raises(ValueError, match="w2"):
        tg.gemm_dual(a, b.t().contiguous(), torch.zeros(16, device=dev), a, b[:, :8].contiguous())
    before = tg.gemm_dh_stash.launches
    hid = torch.zeros(64, 16, device=dev, dtype=torch.bfloat16)
    assert [t.shape for t in tg.gemm_dh_stash(a, b, hid)] == [(64, 16), (64, 16), (16,)]
    assert tg.gemm_dh_stash.launches == before + 1
    with pytest.raises(ValueError, match="a:"):
        tg.gemm_dh_stash(a, b, hid.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        tg.gemm_dh_stash(a[:, :20].contiguous(), b[:, :20].contiguous(), hid)
    assert tg.gemm_dh_stash.launches == before + 1
    before = tg.mlp_weight_grads.launches
    hid = torch.zeros(64, 16, device=dev, dtype=torch.bfloat16)
    dw1, dw2 = tg.mlp_weight_grads(a, hid, hid, a)
    assert (dw1.shape, dw2.shape) == ((32, 16), (16, 32))
    assert tg.mlp_weight_grads.launches == before + 1
    with pytest.raises(ValueError, match="h_c"):
        tg.mlp_weight_grads(a, hid, hid[:, :8].contiguous(), a)
    with pytest.raises(ValueError, match="bn"):
        tg.mlp_weight_grads(a, hid, hid, a, bn=64)
    assert tg.mlp_weight_grads.launches == before + 1
    with pytest.raises(ValueError, match="1 to 3 products"):
        tg.bwd_plan_cuda([(1, 8, 8, 8)] * 4)
    with pytest.raises(ValueError, match="1 to 3 products"):
        tg.bwd_plan_cuda([])


def _bwd_groups():
    """Kernel 8's groups at every shipped width and at ragged rows, kernel
    9's ViT-H slab groups, and single products."""
    groups = []
    for M in (1, 63, 64 * 65, 4161, 32 * 66, 256 * 66, 256 * 68, 1024 * 65, 512 * 65):
        for D in (512, 768, 1024, 1280):
            groups += tg.mlp_bwd_groups(M, D, 4 * D)
        groups += tg.mlp_bwd_groups(M, 1280, 1280)
    groups += [[(1, 768, 3072, 17408)], [(0, 4161, 200, 8)], [(1, 8, 8, 8)]]
    return groups


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_sm90_backward_plan_equals_its_python_copy(dev, sms):
    """The group plan the C source computes (``sky_gemm_sm90_bwd_plan``: BN,
    split count, units, shared memory, modelled cost, workspace) is
    ``bwd_plan``'s, and the dual product's shared memory fits."""
    for shapes in _bwd_groups():
        plan, ws = tg.bwd_plan_cuda(shapes, sms)
        want = tg.bwd_plan(shapes, sms)
        assert plan == want, (shapes, sms)
        assert ws == tg.bwd_workspace(shapes, want), (shapes, sms)


# the stream-K schedule: the tensor-parallel ranks' groups at jepa_struct's
# ViT-S shard (kernel 4 TP's dWqkv_r, dWproj_r; kernel 8 TP's dW1_r, dW2_r
# over 16 384 tokens), jepa_struct's whole kernel 3 and 8 groups, and
# ragged groups
STREAM_K_GROUPS = [
    [(384, 576, 16384), (192, 384, 16384)], [(384, 768, 16384), (768, 384, 16384)],
    [(384, 1152, 16384), (384, 384, 16384)], [(384, 1536, 16384), (1536, 384, 16384)],
    [(200, 136, 585), (72, 24, 1000)], [(264, 392, 3003)], [(8, 8, 100), (16, 8, 33)],
]


@pytest.mark.parametrize("bn", (0, *tg.BNS))
@pytest.mark.parametrize("case", range(len(STREAM_K_GROUPS)))
def test_sm90_stream_k_group_matches_plain(dev, case, bn):
    """A group of weight gradients in one launch under stream-K (forced; bn
    0: the plan's width), each CTA's run of (tile, slab) iterations crossing
    tiles, the owners adding the partials: within TOL_FWD of the plain
    version and of the plain walk, twice bit-equal; the C plan's workspace
    and schedule equal the Python copy's."""
    gen = torch.Generator(device=dev).manual_seed(case * 7 + bn)
    ops = [(torch.randn(K, M, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16))
           for M, N, K in STREAM_K_GROUPS[case]]
    shapes = [(tg.KIND_TN_SPLIT, M, N, K) for M, N, K in STREAM_K_GROUPS[case]]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, ws = tg.gemm_bwd_group_plan(ops, bn=bn, schedule="stream_k")
    want_plan = tg.bwd_plan_forced(shapes, sms, bn=bn, schedule="stream_k")
    assert plan == want_plan and ws == tg.bwd_workspace(shapes, want_plan)
    got = tg.gemm_bwd_group(ops, bn=bn, schedule="stream_k")
    walk = tg.gemm_bwd_stream_k_plain([(a.cpu(), b.cpu()) for a, b in ops], plan.bn, plan.ctas)
    for o, w, p in zip(got, walk, tg.gemm_bwd_group_plain(ops)):
        assert o.dtype == torch.bfloat16 and o.shape == p.shape
        assert _max_rel(o, p) <= TOL_FWD and _max_rel(o, w.to(dev)) <= TOL_FWD
    again = tg.gemm_bwd_group(ops, bn=bn, schedule="stream_k")
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


@pytest.mark.parametrize("schedule", ["split", "stream_k"])
@pytest.mark.parametrize("M,N,K", [(200, 136, 585), (384, 576, 16384), (8, 8, 64)])
def test_sm90_weight_gradient_under_each_schedule(dev, M, N, K, schedule):
    """One weight gradient through ``gemm_bwd`` with its schedule forced,
    against its plain version; twice bit-equal; the plans the group entry
    names are the Python copy's at the TP forms' groups."""
    _check_bwd(dev, "tn", "store", M, N, K, seed=M + K, schedule=schedule)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shapes in ([(1, 384, 576, 16384), (1, 192, 384, 16384)],
                   [(1, 384, 768, 16384), (1, 768, 384, 16384)]):
        plan, ws = tg.bwd_plan_cuda(shapes, sms)
        assert plan == tg.bwd_plan(shapes, sms) and ws == tg.bwd_workspace(shapes, plan)


@pytest.mark.parametrize("B,N,D,F,fs", [(3, 17, 64, 256, None), (9, 65, 128, 512, None),
                                        (2, 65, 768, 3072, None), (3, 33, 1280, 5120, 1280),
                                        (7, 65, 128, 512, 128), (3, 17, 64, 256, "stash"),
                                        (9, 65, 128, 512, "stash"), (2, 65, 768, 3072, "stash"),
                                        (5, 66, 1024, 4096, "stash")])
def test_mlp_backwards_give_the_same_bits_twice(dev, B, N, D, F, fs, monkeypatch):
    """Kernel 8 (``fs`` None), kernel 9 (a slab width) and kernel 7
    (``"stash"``, from the plain stash forward's a): every output bit-equal
    run to run (no atomics; the split slices, the dual and stash dh
    products' column sums and the slabs' dy added in a fixed order)."""
    args = _stream_case(dev, B, N, D, F, seed=50)
    if fs == "stash":
        x, scale, bias, w1, b1, w2, g = args
        a = tmb.mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, torch.zeros_like(scale))[1]
        args, fn = (x, scale, bias, w1, w2, a, g), tmb.mlp_block_bwd_stash
    elif fs is not None:
        monkeypatch.setattr(tmb, "_stream_slab", lambda D_, F_, **kw: fs)
        fn = tmb.mlp_block_bwd_stream
    else:
        fn = tmb.mlp_block_bwd
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(_MLP_GRADS, first, second):
        assert torch.equal(a, b), name


def test_mlp_backwards_launch_only_the_sm90_gemm(dev, monkeypatch):
    """Kernels 8, 9 and 7 run every product on gemm_sm90.cuh: 8 and 9 on its
    dual and group kernels, 7 on its stash dh and group kernels, with no
    fp32 column-sum pass; no launch of theirs is a wmma GEMM (``gemm_bf16``;
    the profiler's kernel names). Kernel 7 allocates no fp32 (B·N, F) da
    and no MAX_SPLITS·D·F workspace: its device memory stays under the
    scratch and outputs it needs without them (the allocator's peak)."""
    from torch.profiler import ProfilerActivity, profile

    def names(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    B, N, D, F = 4, 65, 768, 3072
    args = _stream_case(dev, B, N, D, F, seed=51)
    k8 = names(lambda: tmb.mlp_block_bwd(*args))
    x, scale, bias, w1, b1, w2, g = args
    _, a = tmb.mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, torch.zeros_like(scale))
    k7_call = lambda: tmb.mlp_block_bwd_stash(x, scale, bias, w1, w2, a, g)
    k7_call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k7 = names(k7_call)
    peak = torch.cuda.max_memory_allocated() - base
    monkeypatch.setattr(tmb, "_stream_slab", lambda D_, F_, **kw: 768)
    k9 = names(lambda: tmb.mlp_block_bwd_stream(*args))
    for name, got in (("kernel 8", k8), ("kernel 9", k9), ("kernel 7", k7)):
        assert any(("gemm_dh_stash_kernel" if name == "kernel 7" else "gemm_dual_kernel") in n
                   for n in got), (name, got)
        assert any("gemm_bwd_kernel" in n for n in got), (name, got)
        assert not any("gemm_bf16" in n for n in got), (name, got)
        assert not any("colsum_partial_kernel<float>" in n for n in got), (name, got)
    assert not any("gemm_dual_kernel" in n for n in k7), k7
    M = B * N
    parts = -(-M // tmb.ROWS_PER_PARTIAL)
    # y, dx bf16; da_c, h_c bf16; dy fp32; the partials; the split
    # workspace; the weight gradients bf16, the vectors fp32
    need = (2 * M * D * 2 + 2 * M * F * 2 + M * D * 4 + parts * (F + 3 * D) * 4
            + max(tmb._split_ws("mlp_block_bwd", "sky_mlp_block_bwd_ws", dev.index or 0,
                                M, D, F, F), 4) * 4
            + 2 * D * F * 2 + (3 * D + F) * 4)
    assert peak <= need + (1 << 16) < need + M * F * 4, (peak, need)


@pytest.mark.parametrize("B,N,D,H", [(4, 65, 768, 12), (3, 66, 1280, 16), (2, 129, 128, 2)])
def test_attention_backwards_launch_only_the_sm90_gemm(dev, B, N, D, H):
    """Kernels 3 and 4 (masked too) run every product on gemm_sm90.cuh:
    kernel 4's qkv recompute on ``gemm_sm90_kernel``, dctx, dy and the
    weight-gradient group on ``gemm_bwd_kernel``; no launch of theirs is
    a wmma GEMM (``gemm_bf16``) or an fp32 column-sum pass, and no fp32
    (B·N, 3D) dqkv is allocated: their device memory stays under the
    scratch and outputs they need without it (the profiler's kernel names,
    the allocator's peak)."""
    from torch.profiler import ProfilerActivity, profile

    args = _block_args(dev, B, N, D, (D, 3 * D), (D, D), seed=60)
    g = torch.from_numpy(np.random.default_rng(61).normal(size=(B, N, D)).astype(np.float32))
    g = g.to(dev, torch.bfloat16)
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*args, H)
    M = B * N
    calls = {
        "kernel 3": lambda: tab.attn_block_bwd_stash(*args[:4], args[5], qkv, probs, g, H),
        "kernel 4": lambda: tab.attn_block_bwd(*args[:6], g, H),
        "kernel 4 masked": lambda: tab.attn_block_bwd(*args[:6], g, H, 17),
    }
    parts = -(-M // tab.ROWS_PER_PARTIAL)
    # y, dc, ctx, dqkv_c, qkv (kernel 4) bf16; dy fp32; the partials; the
    # split workspace; dx and the weight gradients bf16, the vectors fp32
    need = (M * D * 2 * 3 + M * 3 * D * 2 * 2 + M * D * 4 + (B + parts) * 3 * D * 4
            + max(tab._split_ws("attn_block_bwd", "sky_attn_block_bwd_ws", dev.index or 0, M, D), 4) * 4
            + M * D * 2 + 4 * D * D * 2 + 6 * D * 4)
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert peak <= need + (1 << 16) < need + M * 3 * D * 4, (name, peak, need)
        names = [e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        assert sum("gemm_bwd_kernel" in n for n in names) >= 2, (name, names)
        assert any("gemm_sm90_kernel" in n for n in names) == (name != "kernel 3"), (name, names)
        assert not any("gemm_bf16" in n for n in names), (name, names)
        assert not any("colsum_partial_kernel<float>" in n for n in names), (name, names)



# ---- the fp32 forms of K1, K2 and kernels 2, 3 and 8, and their GEMM --------

# max|a-b|/max|b| per output of an fp32 form against its plain version (TF32
# off), as chip_smoke.py's TOL_F32_FORMS / TOL_GEMM_F32: the card measured
# 2.25e-6 and 2.5e-6 at worst at the main path's widths
TOL_F32_FORMS = 5e-6
TOL_GEMM_F32 = 5e-6
# (B, N, D, H, F): ViT-B at mim_1's N and cls_fs_1k's, ragged rows and
# tokens, heads of 16, 80 (ViT-H) and 96, N = 256
F32_SHAPES = [(3, 17, 64, 4, 256), (2, 65, 768, 12, 3072), (5, 66, 768, 12, 3072),
              (3, 33, 96, 1, 200), (2, 66, 1280, 16, 5120), (1, 256, 256, 4, 512),
              (7, 129, 192, 2, 384)]


def _f32_block(dev, B, N, D, wa, wb, seed):
    """(x, scale, bias, w_a, b_a, w_b, b_b), all fp32 and drawn in fp32."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    return (0.5 * f32(B, N, D), 1.0 + 0.1 * f32(D), 0.1 * f32(D), f32(*wa) * wa[0] ** -0.5,
            0.01 * f32(wa[1]), f32(*wb) * wb[0] ** -0.5, 0.01 * f32(wb[1]))


@pytest.mark.parametrize("B,N,D,H,F", F32_SHAPES)
def test_f32_forms_match_plain(dev, B, N, D, H, F):
    """Each fp32 form against its plain version, output by output; every
    launch an fp32 one, every output fp32; kernels 3 and 8 twice bit-equal."""
    attn = _f32_block(dev, B, N, D, (D, 3 * D), (D, D), seed=40)
    mlp = _f32_block(dev, B, N, D, (D, F), (F, D), seed=41)
    g = 0.1 * torch.randn(B, N, D, device=dev, generator=torch.Generator(dev).manual_seed(42))
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*attn, H)
    counted = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
               tmb.fused_mlp_block, tmb.mlp_block_bwd)
    before = [f.f32_launches for f in counted]
    cases = [
        (tab.fused_attn_block(*attn, H), tab.attn_block_plain(*attn, H)),
        (tab.attn_block_fwd_stash(*attn, H), tab.attn_block_fwd_stash_plain(*attn, H)),
        (tab.attn_block_bwd_stash(*attn[:4], attn[5], qkv, probs, g, H),
         tab.attn_block_bwd_stash_plain(*attn[:4], attn[5], qkv, probs, g, H)),
        (tmb.fused_mlp_block(*mlp), tmb.mlp_block_plain(*mlp)),
        (tmb.mlp_block_bwd(*mlp[:6], g), tmb.mlp_block_bwd_plain(*mlp[:6], g)),
    ]
    torch.cuda.synchronize()
    assert [f.f32_launches - b for f, b in zip(counted, before)] == [1] * 5
    for got, want in cases:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == b.shape
            assert _max_rel(a, b) <= TOL_F32_FORMS
    again = (tab.attn_block_bwd_stash(*attn[:4], attn[5], qkv, probs, g, H),
             tmb.mlp_block_bwd(*mlp[:6], g))
    for first, second in zip((cases[2][0], cases[4][0]), again):
        assert all(torch.equal(a, b) for a, b in zip(first, second))


# (M, N, K): ragged rows and columns (multiples of 4), a K that is no
# multiple of the 32-deep slab, M, N and K that are multiples of no tile
# (1 036 x 332 x 1 124), the M = 2 112 products of kernels 4 and 9 (64-wide
# tiles), and the weight gradients' long K (split into slices where the
# plan says so: the K = 16 896 TN products of cls_fs_1k B=256)
GEMM_F32_SHAPES = [(4, 8, 4), (300, 264, 200), (132, 36, 1028), (16896, 768, 3072),
                   (768, 768, 16896), (1024, 4096, 4160), (1036, 332, 1124), (2112, 1024, 3072),
                   (768, 3072, 16896)]


@pytest.mark.parametrize("form,epi", [(f, e) for f, es in tg.F32_FORM_EPILOGUES.items() for e in es])
@pytest.mark.parametrize("M,N,K", GEMM_F32_SHAPES)
def test_gemm_f32_matches_fp32_torch_mm(dev, form, epi, M, N, K):
    """The fp32 GEMM (csrc/gemm_f32.cuh, 3xTF32) in each form and epilogue
    against fp32 torch.mm with TF32 off (a "tn" product split along K where
    its tiles would leave SMs idle: the long K here); two launches
    bit-equal."""
    gen = torch.Generator(dev).manual_seed(M + N + K)
    rn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    sa = {"fwd": (M, K), "nt": (M, K), "tn": (K, M)}[form]
    sb = {"fwd": (K, N), "nt": (N, K), "tn": (K, N)}[form]
    a, b = rn(*sa), rn(*sb) * K ** -0.5
    bias, resid, aux = rn(N), rn(M, N), rn(M, N)
    want = tg.gemm_f32_plain(a, b, form, epi, bias, resid, aux)
    got = tg.gemm_f32(a, b, form, epi, bias, resid, aux)
    again = tg.gemm_f32(a, b, form, epi, bias, resid, aux)
    torch.cuda.synchronize()
    assert _max_rel(got[0], want[0]) <= TOL_GEMM_F32
    assert torch.equal(got[0], again[0])
    if epi in ("dgelu", "bias_gelu_stash"):
        assert _max_rel(got[1], want[1]) <= TOL_GEMM_F32
    else:
        assert got[1] is None


@pytest.mark.parametrize("form,epi", [(f, e) for f, es in tg.F32_FORM_EPILOGUES.items() for e in es])
def test_gemm_f32_takes_pitched_operands(dev, form, epi):
    """Operands and output as column slabs of wider rows (kernel 9's W1 and
    dW1 slabs; pitches that are multiples of 4, not of any tile) give the
    dense operands' bits, and match fp32 torch.mm."""
    M, N, K = 1036, 332, 1124
    gen = torch.Generator(dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    sa = {"fwd": (M, K), "nt": (M, K), "tn": (K, M)}[form]
    sb = {"fwd": (K, N), "nt": (N, K), "tn": (K, N)}[form]
    wide_a, wide_b = rn(sa[0], sa[1] + 12), rn(sb[0], sb[1] + 36) * K ** -0.5
    a, b = wide_a[:, 8:8 + sa[1]], wide_b[:, 4:4 + sb[1]]
    bias, aux = rn(N), rn(M, N)
    wide_c, wide_r = torch.zeros(M, N + 20, device=dev), rn(M, N + 20)
    out, resid = wide_c[:, 4:4 + N], wide_r[:, 4:4 + N]
    got = tg.gemm_f32(a, b, form, epi, bias, resid, aux, out=out)
    dense = tg.gemm_f32(a.contiguous(), b.contiguous(), form, epi, bias, resid.contiguous(), aux)
    want = tg.gemm_f32_plain(a, b, form, epi, bias, resid, aux)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == out.data_ptr()
    assert torch.equal(got[0], dense[0])
    assert float(wide_c[:, :4].abs().max()) == 0 and float(wide_c[:, 4 + N:].abs().max()) == 0
    assert _max_rel(got[0], want[0]) <= TOL_GEMM_F32
    if got[1] is not None:
        assert torch.equal(got[1], dense[1]) and _max_rel(got[1], want[1]) <= TOL_GEMM_F32


def test_f32_plan_equals_the_python_copy(dev):
    """``f32_plan`` as the CUDA source computes it equals
    ``gemm.f32_plan`` (tile width, splits, slabs a slice, units, ring
    slots, shared memory) and the C workspace rule ``gemm.f32_workspace``,
    at the fp32 configs' products and at ragged shapes, split or not."""
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    ws = cuda_build.load("mlp_block").sky_gemm_f32_ws
    ws.argtypes, ws.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    shapes = [(4, 8, 4), (300, 264, 200), (1036, 332, 1124), (16896, 768, 3072),
              (768, 3072, 16896), (3072, 768, 16896), (768, 2304, 16896), (768, 768, 16896),
              (2112, 1024, 1024), (1024, 3072, 2112), (1280, 1280, 2112), (2112, 1280, 1280)]
    for M in (1, 68, 4160, 8448, 16896, 16640, 2112, 544, 16 * 65, 256 * 68):
        for D in (48, 64, 512, 768, 1024, 1280):
            shapes += [(M, 3 * D, D), (M, D, 4 * D), (D, 4 * D, M), (4 * D, D, M)]
    for M, N, K in shapes:
        for may_split in (False, True):
            for sms in (132, 114, 1):
                want = tg.f32_plan(M, N, K, may_split, sms)
                assert tg.f32_plan_cuda(M, N, K, may_split, sms) == want, (M, N, K, may_split, sms)
        assert ws(M, N, K) == tg.f32_workspace(M, N, K, torch.cuda.get_device_properties(
            0).multi_processor_count), (M, N, K)


def test_gemm_f32_refuses_what_it_does_not_take(dev):
    a = torch.randn(8, 8, device=dev)
    with pytest.raises(ValueError, match="fp32"):
        tg.gemm_f32(a.bfloat16(), a.bfloat16(), "fwd", "bias", torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="multiples of 4"):
        tg.gemm_f32(torch.randn(8, 6, device=dev), torch.randn(8, 6, device=dev), "nt", "store")
    with pytest.raises(ValueError, match="epilogue"):
        tg.gemm_f32(a, a, "tn", "bias")


def test_f32_routes_not_ported_raise_and_nothing_falls_back(dev, monkeypatch):
    """fp32 on CUDA through the routes that refused it until their fp32 forms
    were written: kernel 4 (stash=False with grad, remat), kernels 6 and 7
    (the MLP stash), kernel 9 (wide blocks over several slabs) and the
    seg_len forms now launch their fp32 forms (counted on ``f32_launches``)
    with every plain version patched to fail, and match the plain versions
    computed before."""
    attn = _f32_block(dev, 2, 20, 64, (64, 192), (64, 64), seed=43)
    mlp = _f32_block(dev, 2, 17, 64, (64, 256), (256, 64), seed=44)
    g_a = 0.1 * torch.randn(2, 20, 64, device=dev, generator=torch.Generator(dev).manual_seed(47))
    g_m = 0.1 * torch.randn(2, 17, 64, device=dev, generator=torch.Generator(dev).manual_seed(48))
    monkeypatch.setattr(tmb, "_STREAM_FIXED_BUDGET", 12 * 64 * 128)  # two slabs of 128

    def grads(fn, args, g, **kw):
        leaves = [t.clone().requires_grad_() for t in args]
        out = fn(*leaves, **kw)
        out.backward(g)
        return (out.detach(), *(t.grad for t in leaves))

    calls = {
        "kernel 4": (lambda plain: grads(tab.fused_attn_block, attn, g_a, num_heads=4, stash=False,
                                         plain=plain), (tab.fused_attn_block, tab.attn_block_bwd)),
        "kernel 4 masked": (lambda plain: grads(tab.fused_attn_block, attn, g_a, num_heads=4,
                                                stash=False, seg_len=5, plain=plain),
                            (tab.fused_attn_block, tab.attn_block_bwd)),
        "K2 masked": (lambda plain: (tab.fused_attn_block(*attn, 4, seg_len=5, plain=plain),),
                      (tab.fused_attn_block,)),
        "kernel 2 masked": (lambda plain: grads(tab.fused_attn_block, attn, g_a, num_heads=4,
                                                seg_len=5, plain=plain),
                            (tab.attn_block_fwd_stash, tab.attn_block_bwd_stash)),
        "kernels 6, 7": (lambda plain: grads(tmb.fused_mlp_block, mlp, g_m, stash=True,
                                             plain=plain),
                         (tmb.mlp_block_fwd_stash, tmb.mlp_block_bwd_stash)),
        "kernel 9": (lambda plain: grads(tmb.fused_mlp_block, mlp, g_m, stash="stream",
                                         plain=plain),
                     (tmb.fused_mlp_block, tmb.mlp_block_bwd_stream)),
    }
    want = {name: call(True) for name, (call, _) in calls.items()}
    for name in ("attn_block_plain", "attn_block_bwd_plain", "attn_block_fwd_stash_plain",
                 "attn_block_bwd_stash_plain"):
        monkeypatch.setattr(tab, name, lambda *a, **k: pytest.fail("plain version on CUDA"))
    for name in ("mlp_block_plain", "mlp_block_fwd_stash_plain", "mlp_block_bwd_stash_plain",
                 "mlp_block_bwd_stream_plain", "mlp_block_bwd_plain"):
        monkeypatch.setattr(tmb, name, lambda *a, **k: pytest.fail("plain version on CUDA"))
    for name, (call, counted) in calls.items():
        before = [f.f32_launches for f in counted]
        got = call(False)
        torch.cuda.synchronize()
        assert [f.f32_launches - b for f, b in zip(counted, before)] == [1] * len(counted), name
        for a, b in zip(got, want[name]):
            assert a.dtype == torch.float32 and _max_rel(a, b) <= TOL_F32_FORMS, name


# (B, N, D, H, F, seg_len) of the fp32 forms that kernels 4, 6, 7, 9 and the
# masks added: M = B·N not a multiple of 32 (51, 5, 34, 69, 138), N = 1, 17,
# 68 and 256, heads of 4 (mim_tiny, mae_tiny's packed encoder), 48
# (cls_ft_*_large), 64 (z_ft_2 at N = 66) and 512 (mae_tiny's decoder),
# segments of 5 and 17 (a ragged last one at N = 23)
F32_NEW_SHAPES = [(3, 17, 48, 12, 192, 0), (5, 1, 64, 16, 256, 0), (2, 17, 512, 1, 2048, 0),
                  (3, 20, 64, 16, 256, 5), (3, 23, 48, 12, 192, 5), (2, 68, 768, 16, 3072, 17),
                  (2, 66, 1024, 16, 4096, 0), (1, 256, 256, 4, 1024, 0)]


@pytest.mark.parametrize("B,N,D,H,F,seg", F32_NEW_SHAPES)
def test_f32_new_forms_match_plain(dev, B, N, D, H, F, seg, monkeypatch):
    """Kernel 4's fp32 form (masked with seg_len > 0), K2 and kernel 2
    masked, kernel 3 from the masked fp32 stash, kernels 6 and 7 and kernel
    9 over forced slabs, against their plain versions output by output at
    TOL_F32_FORMS; each launch an fp32 one; kernel 6's ``out`` bit-equal to
    K1's fp32 form; kernels 4, 7 and 9 twice bit-equal."""
    attn = _f32_block(dev, B, N, D, (D, 3 * D), (D, D), seed=50)
    mlp = _f32_block(dev, B, N, D, (D, F), (F, D), seed=51)
    g = 0.1 * torch.randn(B, N, D, device=dev, generator=torch.Generator(dev).manual_seed(52))
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*attn, H, seg)
    _, a = tmb.mlp_block_fwd_stash_plain(*mlp)
    monkeypatch.setattr(tmb, "_STREAM_FIXED_BUDGET", 12 * D * (F // 4))  # four slabs
    assert tmb._stream_slab(D, F) == F // 4
    calls = {
        "K2": (lambda: tab.fused_attn_block(*attn, H, seg_len=seg),
               lambda: tab.attn_block_plain(*attn, H, seg), tab.fused_attn_block),
        "kernel 2": (lambda: tab.attn_block_fwd_stash(*attn, H, seg),
                     lambda: tab.attn_block_fwd_stash_plain(*attn, H, seg), tab.attn_block_fwd_stash),
        "kernel 3": (lambda: tab.attn_block_bwd_stash(*attn[:4], attn[5], qkv, probs, g, H),
                     lambda: tab.attn_block_bwd_stash_plain(*attn[:4], attn[5], qkv, probs, g, H),
                     tab.attn_block_bwd_stash),
        "kernel 4": (lambda: tab.attn_block_bwd(*attn[:6], g, H, seg),
                     lambda: tab.attn_block_bwd_plain(*attn[:6], g, H, seg), tab.attn_block_bwd),
        "kernel 6": (lambda: tmb.mlp_block_fwd_stash(*mlp),
                     lambda: tmb.mlp_block_fwd_stash_plain(*mlp), tmb.mlp_block_fwd_stash),
        "kernel 7": (lambda: tmb.mlp_block_bwd_stash(*mlp[:4], mlp[5], a, g),
                     lambda: tmb.mlp_block_bwd_stash_plain(*mlp[:4], mlp[5], a, g),
                     tmb.mlp_block_bwd_stash),
        "kernel 9": (lambda: tmb.mlp_block_bwd_stream(*mlp[:6], g),
                     lambda: tmb.mlp_block_bwd_stream_plain(*mlp[:6], g), tmb.mlp_block_bwd_stream),
    }
    got = {}
    for name, (kern, plain, counted) in calls.items():
        before = counted.f32_launches
        got[name] = kern()
        torch.cuda.synchronize()
        assert counted.f32_launches == before + 1, name
        want = plain()
        out = got[name] if isinstance(got[name], tuple) else (got[name],)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(out, want):
            assert x.dtype == torch.float32 and x.shape == y.shape, name
            assert _max_rel(x, y) <= TOL_F32_FORMS, name
    assert torch.equal(got["kernel 6"][0], tmb.fused_mlp_block(*mlp))
    for name in ("kernel 4", "kernel 7", "kernel 9"):
        again = calls[name][0]()
        assert all(torch.equal(x, y) for x, y in zip(got[name], again)), name
    if seg:  # the masked fp32 stash holds exact zeros across segments
        ids = torch.arange(N, device=dev) // seg
        assert bool((got["kernel 2"][2][:, :, ids[:, None] != ids[None, :]] == 0).all())


def test_f32_training_step_reaches_every_parameter(dev):
    """A small fp32 encoder (stash on, as ViT-B trains) through the fp32
    forms: loss.backward() reaches every parameter, the launches are kernels
    2, 3 and 8 and K1's fp32 forms, and the gradients match the plain path's."""
    from sky_embeddings_tpu_torch.models.layers import Encoder

    enc = Encoder(2, 64, 4, 4.0, torch.float32, stash=True, stash_mlp=False)
    gen = torch.Generator().manual_seed(46)
    with torch.no_grad():
        for n, p in enc.named_parameters():
            p.copy_(float(n.endswith("scale")) + 0.05 * torch.randn(p.shape, generator=gen))
    enc = enc.to(dev)
    x = 0.5 * torch.randn(3, 17, 64, device=dev, generator=torch.Generator(dev).manual_seed(45))
    counted = (tab.attn_block_fwd_stash, tab.attn_block_bwd_stash, tmb.fused_mlp_block,
               tmb.mlp_block_bwd)
    grads = []
    for plain in (False, True):
        enc.plain = plain
        enc.zero_grad(set_to_none=True)
        before = [f.f32_launches for f in counted]
        enc(x).square().mean().backward()
        torch.cuda.synchronize()
        if not plain:
            assert [f.f32_launches - b for f, b in zip(counted, before)] == [2, 2, 2, 2]
        grads.append({n: p.grad for n, p in enc.named_parameters()})
    assert grads[0].keys() == {n for n, _ in enc.named_parameters()}
    for n, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), n
        assert float((g - grads[1][n]).norm() / grads[1][n].norm()) <= 1e-5, n


# (stash, stash_mlp, remat, heads, seg_len) of a small fp32 encoder: the
# MLP stash at heads of 4 (kernels 6 and 7, as mimlarge trains), the
# attention stash off (kernel 4), remat over the packed sequence (K2 and K1
# replayed, kernel 4 masked, kernel 8), the packed encoder with the stash
# (kernels 2 masked and 3)
F32_ENCODERS = [(True, True, False, 16, 0), (False, False, False, 4, 0), (False, True, True, 16, 5),
                (True, False, False, 16, 5)]


@pytest.mark.parametrize("stash,stash_mlp,remat,H,seg", F32_ENCODERS)
def test_f32_encoder_paths_reach_every_parameter(dev, stash, stash_mlp, remat, H, seg):
    """A small fp32 encoder (depth 2, D = 64) through each fp32 route:
    loss.backward() reaches every parameter, every block launch is an fp32
    one, the route's kernels run (masked where seg_len > 0), and the
    gradients match the plain path's."""
    from sky_embeddings_tpu_torch.models.layers import Encoder

    enc = Encoder(2, 64, H, 4.0, torch.float32, stash=stash, stash_mlp=stash_mlp, remat=remat)
    gen = torch.Generator().manual_seed(53)
    with torch.no_grad():
        for n, p in enc.named_parameters():
            p.copy_(float(n.endswith("scale")) + 0.05 * torch.randn(p.shape, generator=gen))
    enc = enc.to(dev)
    x = 0.5 * torch.randn(3, 20, 64, device=dev, generator=torch.Generator(dev).manual_seed(54))
    counted = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
               tab.attn_block_bwd, tmb.fused_mlp_block, tmb.mlp_block_fwd_stash,
               tmb.mlp_block_bwd_stash, tmb.mlp_block_bwd)
    attn_stash, mlp_stash = stash and not remat, stash_mlp and not remat
    want = {tab.fused_attn_block: 0 if attn_stash else 2 * (1 + remat),
            tab.attn_block_fwd_stash: 2 * attn_stash, tab.attn_block_bwd_stash: 2 * attn_stash,
            tab.attn_block_bwd: 0 if attn_stash else 2,
            tmb.fused_mlp_block: 0 if mlp_stash else 2 * (1 + remat),
            tmb.mlp_block_fwd_stash: 2 * mlp_stash, tmb.mlp_block_bwd_stash: 2 * mlp_stash,
            tmb.mlp_block_bwd: 0 if mlp_stash else 2}
    grads = []
    for plain in (False, True):
        enc.plain = plain
        enc.zero_grad(set_to_none=True)
        before = [(f.launches, f.f32_launches) for f in counted]
        seg_before = [f.seg_launches for f in (tab.fused_attn_block, tab.attn_block_fwd_stash,
                                               tab.attn_block_bwd)]
        enc(x, seg).square().mean().backward()
        torch.cuda.synchronize()
        if not plain:
            for f, (n, n32) in zip(counted, before):
                assert f.launches - n == f.f32_launches - n32 == want[f], (f.__name__, want[f])
            seg_got = [f.seg_launches - b for f, b in zip(
                (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd), seg_before)]
            assert seg_got == ([want[tab.fused_attn_block], want[tab.attn_block_fwd_stash],
                                want[tab.attn_block_bwd]] if seg else [0, 0, 0])
        grads.append({n: p.grad for n, p in enc.named_parameters()})
    assert grads[0].keys() == {n for n, _ in enc.named_parameters()}
    for n, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), n
        assert float((g - grads[1][n]).norm() / grads[1][n].norm()) <= 1e-5, n


# ---- I-JEPA's widths -----------------------------------------------------------
# (B, N, D, H, F, dtype): jepa_struct's ViT-S encoder (D = 384, 6 heads of 64)
# over its 64 tokens and its 192-wide predictor (3 heads of 64) over 64 + 13
# at B = 256, the predictor at jepa_1's B = 64 and a ragged 63; jepa_tiny's
# fp32 encoder (D = 192, 3 heads of 64) over 16 and its predictor (one head
# of 96) over 16 + 5 at B = 16 and a ragged 15
JEPA_SHAPES = [(256, 64, 384, 6, 1536, torch.bfloat16), (256, 77, 192, 3, 768, torch.bfloat16),
               (64, 77, 192, 3, 768, torch.bfloat16), (63, 77, 192, 3, 768, torch.bfloat16),
               (16, 16, 192, 3, 768, torch.float32), (16, 21, 96, 1, 384, torch.float32),
               (15, 21, 96, 1, 384, torch.float32)]


@pytest.mark.parametrize("B,N,D,H,F,dtype", JEPA_SHAPES)
def test_jepa_block_kernels_match_plain(dev, B, N, D, H, F, dtype):
    """The five kernels an I-JEPA step runs (K2, kernels 2 and 3, K1 and
    kernel 8) at each I-JEPA width against their plain versions, output by
    output, each call one launch (fp32: an fp32 one)."""
    fp32 = dtype == torch.float32
    make = _f32_block if fp32 else _block_args
    tol_f, tol_b = (TOL_F32_FORMS, TOL_F32_FORMS) if fp32 else (TOL_FWD, TOL_BWD)
    attn = make(dev, B, N, D, (D, 3 * D), (D, D), seed=60)
    mlp = make(dev, B, N, D, (D, F), (F, D), seed=61)
    g = (0.1 * torch.randn(B, N, D, device=dev, generator=torch.Generator(dev).manual_seed(62))).to(dtype)
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*attn, H)
    counted = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
               tmb.fused_mlp_block, tmb.mlp_block_bwd)
    before = [(f.launches, f.f32_launches) for f in counted]
    cases = [
        (tab.fused_attn_block(*attn, H), tab.attn_block_plain(*attn, H), tol_f),
        (tab.attn_block_fwd_stash(*attn, H), tab.attn_block_fwd_stash_plain(*attn, H), tol_f),
        (tab.attn_block_bwd_stash(*attn[:4], attn[5], qkv, probs, g, H),
         tab.attn_block_bwd_stash_plain(*attn[:4], attn[5], qkv, probs, g, H), tol_b),
        (tmb.fused_mlp_block(*mlp), tmb.mlp_block_plain(*mlp), tol_f),
        (tmb.mlp_block_bwd(*mlp[:6], g), tmb.mlp_block_bwd_plain(*mlp[:6], g), tol_b),
    ]
    torch.cuda.synchronize()
    assert [(f.launches - n, f.f32_launches - n32) for f, (n, n32) in zip(counted, before)] == \
        [(1, int(fp32))] * 5
    for got, want, tol in cases:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _max_rel(a, b) <= tol


@pytest.mark.parametrize("name", ["jepa_struct", "jepa_tiny"])
def test_jepa_training_step_on_the_card(dev, name, monkeypatch):
    """One ``JEPATrainer`` step's forward and backward on the shipped config
    at depth 2 (the predictor at depth 1), B = 32, a NaN band: the launches
    are the five kernels' (fp32 forms for jepa_tiny) in the counts that the
    target encoder, the context encoder and four predictor passes give;
    every parameter gets a finite gradient; the loss and gradients match
    the plain path's."""
    import os

    from sky_embeddings_tpu_torch.configuration import apply_overrides, load_config
    from sky_embeddings_tpu_torch.models import jepa as tj
    from sky_embeddings_tpu_torch.train.jepa import JEPATrainer

    cfg = load_config(name, os.path.join(os.path.dirname(__file__), "..", "configs"))
    size = cfg.architecture.str("model_type")
    monkeypatch.setitem(tj._SIZES, size, {**tj._SIZES[size], "depth": 2})
    cfg = apply_overrides(cfg, ["ARCHITECTURE.pred_depth=1", "TRAINING.batch_size=32"], name)
    pair = [JEPATrainer(cfg, seed=0, device=dev) for _ in range(2)]
    pair[1].plain = True
    m = pair[0].model
    fp32 = m.dtype == torch.float32
    gen = torch.Generator(dev).manual_seed(63)
    imgs = torch.randn(32, m.in_chans, m.img_size, m.img_size, device=dev, generator=gen)
    imgs[0, 1] = float("nan")
    masks = pair[0].draw_masks(32, gen)
    counted = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
               tmb.fused_mlp_block, tmb.mlp_block_bwd, tab.attn_block_bwd, tmb.mlp_block_fwd_stash,
               tmb.mlp_block_bwd_stash, tmb.mlp_block_bwd_stream)
    # the target's 2 layers (K2, K1), the context's 2 (kernel 2, K1 and
    # kernels 3, 8), 4 predictor passes of 1 layer (the same)
    want = [2, 6, 6, 8, 6, 0, 0, 0, 0]
    grads, losses = [], []
    for tr in pair:
        before = [(f.launches, f.f32_launches) for f in counted]
        loss = tr.loss(imgs, masks)
        loss.backward()
        torch.cuda.synchronize()
        if tr is pair[0]:
            got = [(f.launches - n, f.f32_launches - n32) for f, (n, n32) in zip(counted, before)]
            assert got == [(w, w * fp32) for w in want]
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in tr.model.named_parameters()})
    assert grads[0].keys() == {n for n, _ in m.named_parameters()}
    tol = 1e-5 if fp32 else 3e-2
    assert abs(losses[0] - losses[1]) <= tol * abs(losses[1])
    for n, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), n
        assert float((g - grads[1][n]).norm() / grads[1][n].norm()) <= tol, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosmos_training_step_on_the_card(dev, dtype):
    """A CosmicEmbeds step at a small width (32 x 32, patch 8, 5 bands: N =
    1 + 5 + 16 = 22 tokens; D = 128, depth 2, 2 heads of 64), B = 6, the MSE
    loss with a context under a pixel mask and a NaN band in the target: the
    forward and backward launch kernels 2, 3, 8 and K1 once per block (their
    fp32 forms in fp32) and nothing else; every parameter gets a finite
    gradient that matches the plain path's; ``generate`` under no grad
    launches K2 and K1 once per block and matches the plain path. The MSE
    loss, since the L1 gradient of a pixel is the sign of its error: at
    this size a handful of sign flips between the paths moves a leaf's
    gradient by more than the kernels' rounding does (``chip_smoke.py``
    holds the shipped L1 loss at full size, to bars measured there)."""
    from sky_embeddings_tpu_torch.models.cosmos import CosmicEmbeds

    dt = getattr(torch, dtype)
    pair = []
    for plain in (False, True):
        m = CosmicEmbeds(img_size=32, patch_size=8, in_chans=5, embed_dim=128, depth=2, num_heads=2,
                         loss_fn="mse", dtype=dt)
        m.reset_parameters(torch.Generator().manual_seed(0))
        m.plain = plain
        pair.append(m.to(dev))
    gen = torch.Generator(dev).manual_seed(5)
    target = torch.randn(6, 5, 32, 32, device=dev, generator=gen)
    target[0, 2] = float("nan")
    ra_dec = torch.rand(6, 2, device=dev, generator=gen) * 90
    waves = torch.tensor([477.0, 622.0, 770.0, 891.0, 978.0], device=dev).expand(6, -1)
    hidden = (torch.rand(6, 5, 32, 32, device=dev, generator=gen) < 0.6).float()
    hidden[..., 16:] = 1.0  # half the patches hidden in every band: mask-token queries
    counted = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
               tmb.fused_mlp_block, tmb.mlp_block_bwd, tab.attn_block_bwd, tmb.mlp_block_fwd_stash,
               tmb.mlp_block_bwd_stash, tmb.mlp_block_bwd_stream)
    fp32 = dt == torch.float32
    grads, losses, imgs = [], [], []
    for m in pair:
        before = [(f.launches, f.f32_launches) for f in counted]
        loss = m.loss(target, ra_dec, waves, target, hidden)
        loss.backward()
        torch.cuda.synchronize()
        if m is pair[0]:
            got = [(f.launches - n, f.f32_launches - n32) for f, (n, n32) in zip(counted, before)]
            assert got == [(w, w * fp32) for w in (0, 2, 2, 2, 2, 0, 0, 0, 0)]
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in m.named_parameters()})
        before = [(f.launches, f.f32_launches) for f in counted]
        with torch.no_grad():
            imgs.append(m.generate(ra_dec, waves))
        torch.cuda.synchronize()
        if m is pair[0]:
            got = [(f.launches - n, f.f32_launches - n32) for f, (n, n32) in zip(counted, before)]
            assert got == [(w, w * fp32) for w in (2, 0, 0, 2, 0, 0, 0, 0, 0)]
    tol = 1e-5 if fp32 else 3e-2
    assert abs(losses[0] - losses[1]) <= tol * abs(losses[1])
    for n, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), n
        assert float((g - grads[1][n]).norm() / grads[1][n].norm()) <= tol, n
    assert imgs[0].shape == (6, 5, 32, 32) and _max_rel(imgs[0], imgs[1]) <= tol


def test_prefetch_copies_to_the_card_on_a_side_stream(dev):
    """``device_prefetch`` onto the card: numpy arrays and CPU tensors
    arrive on the card equal to the source, in order, read by the current
    stream after their copies; a tensor already on the card passes through
    as the same object."""
    from sky_embeddings_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(3)
    on_card = torch.arange(10.0, device=dev)
    src = [{"cutouts": rng.normal(size=(64, 5, 64, 64)).astype(np.float32),
            "ra_dec": torch.from_numpy(rng.normal(size=(64, 2)).astype(np.float32)),
            "labels": on_card, "step": i} for i in range(5)]
    seen = 0
    for i, b in enumerate(device_prefetch(iter(src), size=2, device=dev)):
        assert b["step"] == i and b["labels"] is on_card
        assert b["cutouts"].device.type == "cuda" and b["ra_dec"].device.type == "cuda"
        total = (b["cutouts"] * 2).sum()  # a kernel on the current stream
        assert torch.equal(b["cutouts"].cpu(), torch.from_numpy(src[i]["cutouts"]))
        assert torch.equal(b["ra_dec"].cpu(), src[i]["ra_dec"])
        assert float(total) == float((torch.from_numpy(src[i]["cutouts"]).to(dev) * 2).sum())
        seen += 1
    assert seen == 5


# ---- the fused TP forward half ---------------------------------------------------
# (B, N, local heads, F_r) of a rank's shard at D = 384: jepa_struct's ViT-S
# encoder at tensor_parallel = 2 (B = 256 over 64 tokens: 256 whole row
# blocks), a context subset (40 tokens), ragged ones: N = 49 and 17 (row
# blocks part padding), one and two local heads, F_r of 128 and 1 536 for
# K1 TP's chain beside it; N = 1
TP_FUSED_SHAPES = [(256, 64, 3, 768), (256, 40, 3, 768), (5, 49, 3, 768), (7, 17, 2, 256),
                   (3, 64, 1, 128), (2, 33, 3, 1536), (9, 1, 3, 384)]


def _tp_shard_args(dev, B, N, Hl, Fr, seed):
    """One rank's attention and MLP shards at D = 384 (heads of 64): (x,
    scale, bias, wqkv_r, bqkv_r, wproj_r) and (x, scale, bias, w1_r, b1_r,
    w2_r), bf16 x and weights."""
    D, Dl = 384, 64 * Hl
    attn = _block_args(dev, B, N, D, (D, 3 * Dl), (Dl, D), seed)[:6]
    mlp = _block_args(dev, B, N, D, (D, Fr), (Fr, D), seed + 1)[:6]
    return attn, (attn[0], attn[1], attn[2], *mlp[3:])


@pytest.mark.parametrize("B,N,Hl,Fr", TP_FUSED_SHAPES)
def test_tp_fused_forward_halves_match_the_chain_and_plain(dev, B, N, Hl, Fr):
    """K2 TP's fused bf16 forward half (the shape rule picks it at D = 384)
    against its chain forced at the same shape, bit for bit (the same
    products per element, the same K order, the held-row LN's arithmetic),
    and against the plain version within TOL_FWD; twice bit-equal; one
    counted launch, on ``fused_launches`` too. K1 TP's half (its chain on
    the held-row LN) at the same shapes against its plain version."""
    attn, mlp = _tp_shard_args(dev, B, N, Hl, Fr, seed=70 + N)
    assert tab.tp_fwd_path(N, 384, 64 * Hl, Hl, 0, torch.bfloat16) == "fused"
    n, n_fused = tab.attn_block_tp_fwd.launches, tab.attn_block_tp_fwd.fused_launches
    got, again = tab.attn_block_tp_fwd(*attn, Hl), tab.attn_block_tp_fwd(*attn, Hl)
    ref = tab.attn_block_tp_fwd_chain(*attn, Hl)
    torch.cuda.synchronize()
    assert (tab.attn_block_tp_fwd.launches - n, tab.attn_block_tp_fwd.fused_launches - n_fused) \
        == (2, 2)
    assert got.shape == (B, N, 384) and got.dtype == torch.float32
    assert torch.equal(got, again) and torch.equal(got, ref)
    assert _max_rel(got, tab.attn_block_tp_fwd_plain(*attn, Hl)) <= TOL_FWD
    n = tmb.mlp_block_tp_fwd.launches
    got = tmb.mlp_block_tp_fwd(*mlp)
    torch.cuda.synchronize()
    assert tmb.mlp_block_tp_fwd.launches - n == 1
    assert torch.equal(got, tmb.mlp_block_tp_fwd(*mlp))
    assert _max_rel(got, tmb.mlp_block_tp_fwd_plain(*mlp)) <= TOL_FWD


def test_tp_fused_forward_halves_launch_one_kernel(dev):
    """At jepa_struct's ViT-S shard K2 TP's half is one launch of its fused
    kernel (the profiler's names): no LN, GEMM or core launch and no scratch
    beside the fp32 partial; K1 TP's is its chain's three."""
    from torch.profiler import ProfilerActivity, profile

    attn, mlp = _tp_shard_args(dev, 256, 64, 3, 768, seed=80)
    for fn, kernels in ((lambda: tab.attn_block_tp_fwd(*attn, 3), ["attn_tp_fused_kernel"]),
                        (lambda: tmb.mlp_block_tp_fwd(*mlp), ["layernorm", "gemm", "gemm"])):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        assert len(names) == len(kernels), names
        assert all(k in n.lower() for k, n in zip(kernels, names)), names


@pytest.mark.parametrize("B,N,D,Hl,seg", [(256, 64, 384, 3, 0), (256, 40, 384, 3, 0),
                                          (32, 66, 1024, 8, 0), (256, 65, 768, 6, 0),
                                          (32, 68, 768, 6, 17), (3, 65, 384, 3, 0),
                                          (3, 64, 384, 3, 16), (3, 49, 384, 4, 0),
                                          (3, 49, 256, 2, 0), (3, 49, 384, 2, 0),
                                          (3, 1, 384, 1, 64)])
def test_tp_forward_path_rule_equals_its_python_copy(dev, B, N, D, Hl, seg):
    """K2 TP's bf16 forward path rule as the C source computes it
    (``sky_attn_block_tp_fwd_path``) equals the Python copy at the shipped
    TP legs' shapes and at the rule's limits."""
    assert tab.tp_fwd_path_cuda(B, N, D, 64 * Hl, Hl, seg) == tab.tp_fwd_path(
        N, D, 64 * Hl, Hl, seg, torch.bfloat16)


@pytest.mark.parametrize("D", [384, 768, 1024, 1280])
def test_held_row_layernorm_gives_the_multi_pass_bits(dev, D):
    """The LN that holds the row in registers (the TP forms' chains and the
    fused half's arithmetic) gives the bits of the multi-pass LN the whole
    blocks keep, at ViT-S, ViT-B, ViT-L and ViT-H widths over ragged rows."""
    x, scale, bias = _block_args(dev, 7, 33, D, (8, 8), (8, 8), seed=D)[:3]
    x = (x.float() * 3.0 + 0.25).to(torch.bfloat16)  # a mean off zero
    held = tmb.layernorm_cuda(x, scale, bias, True)
    multi = tmb.layernorm_cuda(x, scale, bias, False)
    torch.cuda.synchronize()
    assert torch.equal(held, multi)
