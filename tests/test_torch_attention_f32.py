"""Kernels 12 and 13 in fp32 (``csrc/attention.cu``) on the CPU, where the
CUDA kernels cannot run: their arithmetic, emulated in torch, against the
plain versions and the JAX package, and their shared-memory plan through its
Python copy (``attention.f32_plan``).

The emulation follows the kernels operation by operation: every product
element is one fp32 FMA chain in a fixed order (S over the head dims, ctx
and dQ over the keys, dK and dV over the queries), each step one rounding
(the exact product and sum in fp64, rounded to fp32); the softmax a warp
per row (lane l adds keys l, l + 32, ..., then the xor butterfly 16, 8, 4,
2, 1; ``e / sum``); delta the same lane sums of FMAs. It is held to
``attention_plain`` / ``attention_bwd_plain`` within ``chip_smoke.py``'s
fp32 bar TOL_CORE_F32 = 5e-7 (max|a-b|/max|b|), and to JAX's
``xla_attention`` and ``jax.vjp`` of it in fp32 within TOL_XLA_F32 = 1e-6,
at ViT-B's and ViT-H's head geometry (B = 2, N = 65 / 66, hd = 64 / 80) and
at a head of 15. XLA's CPU einsum sums in another order than the card's
fp32 GEMMs: at ViT-H's geometry the plain version itself lies 6.8e-7 from
it, about as far as it lies from an fp64 product
(``tools/attn_f32_variants.py emulate``), so no fp32 attention meets 5e-7
against JAX. The card tests
(``tests/test_torch_cuda.py``) hold the kernels to the plain versions and
the C plan to this copy.

The plan: it fits a block's shared memory at every shipped config's head
geometry and at every (N <= 256, head width) the CUDA-core kernels it
replaced took, and stages the whole head (one CTA per sample and head) at
the training geometries.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.ops.kernels import attention as ja
from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models.mim import _SIZES, MODEL_TYPES
from sky_embeddings_tpu_torch.ops.kernels import attention as ta

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TOL_CORE_F32 = 5e-7
TOL_XLA_F32 = 1e-6
SMEM = ta.SMEM_PER_BLOCK
# (B, N, D, H): ViT-B, ViT-H (heads of 80, the RA/Dec token), a head of 15
SHAPES = [(2, 65, 768, 12), (2, 66, 1280, 16), (3, 17, 60, 4)]


def _chain(a, b):
    """a (..., M, K) @ b (..., K, N) as one fp32 FMA chain per element, k = 0,
    1, ... in order (the kernels' fmaf tiles)."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float64)
    ad, bd = a.double(), b.double()
    for k in range(a.shape[-1]):
        acc = (acc + ad[..., :, k:k + 1] * bd[..., k:k + 1, :]).float().double()
    return acc.float()


def _warp_sum(a, b=None):
    """A row's sum over its last axis as a warp takes it: lane l adds terms
    l, l + 32, ... (with ``b``: FMAs of a·b), then the xor butterfly."""
    lanes = torch.zeros(a.shape[:-1] + (32,), dtype=torch.float64)
    for j in range(a.shape[-1]):
        term = a[..., j].double() * (1.0 if b is None else b[..., j].double())
        lanes[..., j % 32] = (lanes[..., j % 32] + term).float().double()
    lanes = lanes.float()
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    return lanes[..., :1]


def _heads(t, parts, num_heads):
    B, N, width = t.shape
    return t.reshape(B, N, parts, num_heads, width // parts // num_heads).permute(2, 0, 3, 1, 4).unbind(0)


def _probs(q, k):
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    z = _chain(q, k.transpose(-1, -2)) * scale
    e = torch.exp(z - z.amax(-1, keepdim=True))
    return e / _warp_sum(e), scale


def kernel_fwd(qkv, num_heads):
    """Kernel 12's fp32 arithmetic: ctx (B, N, D) from qkv (B, N, 3D)."""
    B, N, width = qkv.shape
    q, k, v = _heads(qkv, 3, num_heads)
    p, _ = _probs(q, k)
    return _chain(p, v).transpose(1, 2).reshape(B, N, width // 3)


def kernel_bwd(qkv, dctx, num_heads):
    """Kernel 13's fp32 arithmetic: dqkv (B, N, 3D) from qkv and dctx."""
    B, N, width = qkv.shape
    q, k, v = _heads(qkv, 3, num_heads)
    (dc,) = _heads(dctx, 1, num_heads)
    p, scale = _probs(q, k)
    dp = _chain(dc, v.transpose(-1, -2))
    ds = (dp * p - p * _warp_sum(dp, p)) * scale
    dq, dk, dv = _chain(ds, k), _chain(ds.transpose(-1, -2), q), _chain(p.transpose(-1, -2), dc)
    return torch.stack([dq, dk, dv], 2).permute(0, 3, 2, 1, 4).reshape(B, N, width)


def _inputs(B, N, D, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, N, 3 * D)).astype(np.float32), rng.normal(size=(B, N, D)).astype(np.float32)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("B,N,D,H", SHAPES)
def test_kernel_arithmetic_matches_the_plain_versions(B, N, D, H):
    qkv, dctx = (torch.from_numpy(a) for a in _inputs(B, N, D, seed=N + D))
    got_f, got_b = kernel_fwd(qkv, H), kernel_bwd(qkv, dctx, H)
    assert torch.isfinite(got_f).all() and torch.isfinite(got_b).all()
    assert _max_rel(got_f, ta.attention_plain(qkv, H)) <= TOL_CORE_F32
    assert _max_rel(got_b, ta.attention_bwd_plain(qkv, dctx, H)) <= TOL_CORE_F32


@pytest.mark.parametrize("B,N,D,H", SHAPES)
def test_kernel_arithmetic_matches_jax(B, N, D, H):
    qkv, dctx = _inputs(B, N, D, seed=N + D + 1)
    want_f, vjp = jax.vjp(lambda x: ja.xla_attention(x, H), jnp.asarray(qkv))
    want_b = vjp(jnp.asarray(dctx))[0]
    got_f = kernel_fwd(torch.from_numpy(qkv), H)
    got_b = kernel_bwd(torch.from_numpy(qkv), torch.from_numpy(dctx), H)
    assert _max_rel(got_f, want_f) <= TOL_XLA_F32
    assert _max_rel(got_b, want_b) <= TOL_XLA_F32


# -- the shared-memory plan ------------------------------------------------------------

def _cuda_core_plan_bytes(N, hd, backward):
    """The plan of the CUDA-core fp32 kernels this design replaced: K and V
    of N x (hd + 1), per warp of 8 two rows of hd and two of N, and the
    backward's row statistics, 3 x N fp32."""
    return (2 * N * (hd + 1) + 8 * (2 * hd + 2 * N) + (3 * N if backward else 0)) * 4


def _config_heads(name):
    """(N, hd) of every attention a shipped MIM config runs: the encoder
    (with the RA/Dec token; MAE also packed, four samples of the kept
    patches and cls) and the MAE decoder over every patch."""
    arch = load_config(name, str(CONFIGS))["ARCHITECTURE"]
    size, simmim = MODEL_TYPES[arch.str("model_type")]
    grid = arch.int("img_size") // arch.int("patch_size")
    n_enc = grid * grid + 1 + int(arch.bool("ra_dec", False))
    heads = [(n_enc, arch.int("embed_dim") // _SIZES[size]["num_heads"])]
    if not simmim:
        kept = grid * grid // 4 + 1 + int(arch.bool("ra_dec", False))
        dec_heads = 1 if arch.str("model_type") == "maesimple" else 16
        heads += [(min(4 * kept, 256), heads[0][1]), (grid * grid + 1, 512 // dec_heads)]
    return heads


MIM_CONFIGS = sorted(p.stem for p in CONFIGS.glob("*.ini")
                     if load_config(p.stem, str(CONFIGS))["ARCHITECTURE"].str("model_type", "") in MODEL_TYPES)
# chip_smoke.py's in-memory bench models: ViT-H (N = 66, 16 heads of 80),
# MAE's packed encoder (N = 68) and its decoder (16 heads of 32)
BENCH_HEADS = [(66, 80), (68, 64), (65, 32)]


def _assert_sound(N, hd, backward):
    pl = ta.f32_plan(N, hd, backward)
    NP = -(-N // 4) * 4
    hd8 = -(-hd // 8) * 8
    assert pl.bytes <= SMEM, (N, hd, backward)
    assert pl.qb % 4 == 0 and 4 <= pl.qb <= NP and pl.hc % 8 == 0 and 8 <= pl.hc <= hd8
    assert pl.threads % 32 == 0 and 128 <= pl.threads <= ta.F32_MAX_THREADS
    # one thread per 4 x 4 tile of the largest product, up to 512
    tiles = max(pl.qb // 4 * NP // 4, pl.qb // 4 * pl.hc // 4, NP // 4 * pl.hc // 4 if backward else 0)
    assert pl.threads >= min(tiles, ta.F32_MAX_THREADS)
    if pl.staged or not backward:  # the whole head's columns in one CTA
        assert pl.hc == hd8
    if pl.staged:  # and every query row in one block
        assert pl.qb == NP
    return pl


@pytest.mark.parametrize("name", MIM_CONFIGS)
def test_plan_takes_every_head_of_the_shipped_configs(name):
    for N, hd in _config_heads(name):
        assert N <= ta.MAX_TOKENS
        for backward in (False, True):
            _assert_sound(N, hd, backward)


def test_plan_stages_the_training_geometries():
    """Whole heads at ViT-B, ViT-L's 16 heads, ViT-H, MAE's packed encoder
    and its decoder, with the bytes csrc/attention.cu's note states (three
    and two CTAs an SM at ViT-B, two at ViT-H); at N = 256 and hd = 64 (and
    128) the plan reads from device memory in blocks."""
    for N, hd in BENCH_HEADS + [(65, 64), (65, 48), (66, 64)]:
        for backward in (False, True):
            assert _assert_sound(N, hd, backward).staged, (N, hd, backward)
    assert [ta.f32_plan(65, 64, b).bytes for b in (False, True)] == [73984, 92480]
    assert [ta.f32_plan(66, 80, b).bytes for b in (False, True)] == [87040, 109888]
    assert ta.f32_plan(65, 64, False).threads == ta.f32_plan(65, 64, True).threads == 320
    assert ta.f32_plan(66, 80, True).threads == 352
    fwd, bwd = ta.f32_plan(256, 64, False), ta.f32_plan(256, 64, True)
    assert (fwd.staged, fwd.qb, fwd.bytes) == (False, 128, 131072)
    assert (bwd.staged, bwd.qb, bwd.hc, bwd.bytes) == (False, 32, 64, 196608)
    assert not ta.f32_plan(256, 128, True).staged and ta.f32_plan(256, 128, True).hc == 64


@pytest.mark.parametrize("backward", [False, True])
def test_plan_takes_every_shape_the_cuda_core_kernels_took(backward):
    """Every N <= 256 at every head width the replaced kernels' plan fitted
    (the widest near 3 227 at N = 1, 101 at N = 256) fits the new plan, and
    every head up to 512 fits at every N."""
    for N in range(1, ta.MAX_TOKENS + 1):
        widest = max(hd for hd in range(1, 4096) if _cuda_core_plan_bytes(N, hd, backward) <= SMEM)
        for hd in sorted(set(range(1, 513)) | set(range(max(widest - 8, 1), widest + 1))):
            assert ta.f32_plan(N, hd, backward).bytes <= SMEM, (N, hd)
