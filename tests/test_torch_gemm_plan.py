"""The tile rule of the forward GEMM (``csrc/gemm_sm90.cuh``
``gemm_sm90_plan``) through its Python copy, ``ops/kernels/gemm.gemm_plan``,
at every forward product of every shipped MIM config and of the bench
models ``chip_smoke.py`` drives: each plan fits a block's shared memory,
counts its tiles, and comes within a sixteenth of the fewest waves x BN
that any tile width gives; at ``mim_1`` B=64 it takes the widths the
design names (132 tiles, one wave, for fc2 and proj; 396, three waves, for
fc1 and qkv). A card test (``tests/test_torch_cuda.py``) holds this copy to
the rule the C source computes. The plain version of the GEMM's four
epilogues is held to numpy here.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models.mim import MODEL_TYPES
from sky_embeddings_tpu_torch.ops.kernels import gemm as G

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
MIM_CONFIGS = sorted(
    p.stem for p in CONFIGS.glob("*.ini")
    if load_config(p.stem, str(CONFIGS))["ARCHITECTURE"].str("model_type", "") in MODEL_TYPES
)
DECODER_D = 512  # SkyMIM's decoder_embed_dim


def _products(M: int, D: int):
    """(name, M, N, K) of one block's four forward products at width D."""
    F = 4 * D
    return [("qkv", M, 3 * D, D), ("proj", M, D, D), ("fc1", M, F, D), ("fc2", M, D, F)]


def _config_products(name: str):
    cfg = load_config(name, str(CONFIGS))
    arch, training = cfg["ARCHITECTURE"], cfg["TRAINING"]
    grid = arch.int("img_size") // arch.int("patch_size")
    n_tok = grid * grid + 1 + int(arch.bool("ra_dec", False))
    batch = training.int("batch_size")
    out = []
    for B in (1, batch, 1024):  # one image, the config's batch, bank building
        out += _products(B * n_tok, arch.int("embed_dim"))
        if not MODEL_TYPES[arch.str("model_type")][1]:  # MAE: the decoder over every token
            out += _products(B * (grid * grid + 1), DECODER_D)
    return out


# chip_smoke.py's in-memory bench models: ViT-H (N=66, D=1280) at B=32 and
# 256; MAE's packed encoder (N=68) at 256 sequences and its decoder at 1024
BENCH_PRODUCTS = (_products(32 * 66, 1280) + _products(256 * 66, 1280)
                  + _products(256 * 68, 768) + _products(1024 * 65, DECODER_D))


def _waves_bn(M: int, N: int, bn: int) -> int:
    tiles = math.ceil(M / G.BM) * math.ceil(N / bn)
    return math.ceil(tiles / G.H100_SMS) * bn


def _assert_sound(M: int, N: int):
    plan = G.gemm_plan(M, N)
    assert plan.bn in G.BNS
    assert plan.tiles == math.ceil(M / G.BM) * math.ceil(N / plan.bn)
    assert plan.stages >= 3
    stage_bytes = G.BM * G.BK * 2 + G.BK * plan.bn * 2
    out_bytes = G.BM * plan.bn * 2  # the staged output tile
    assert plan.smem == plan.stages * stage_bytes + out_bytes + G.SMEM_EXTRA <= G.SMEM_OPTIN_MAX
    assert plan.smem + stage_bytes > G.SMEM_OPTIN_MAX  # one more ring slot would not fit
    best = min(_waves_bn(M, N, bn) for bn in G.BNS)
    assert _waves_bn(M, N, plan.bn) * 15 <= best * 16


@pytest.mark.parametrize("name", MIM_CONFIGS)
def test_plan_fits_every_forward_product_of_the_shipped_configs(name):
    products = _config_products(name)
    assert len(products) >= 12
    for _, M, N, K in products:
        _assert_sound(M, N)


@pytest.mark.parametrize("case", range(len(BENCH_PRODUCTS)))
def test_plan_fits_the_bench_models(case):
    _, M, N, _ = BENCH_PRODUCTS[case]
    _assert_sound(M, N)


@pytest.mark.parametrize("name,bn,tiles", [("qkv", 192, 396), ("proj", 192, 132),
                                           ("fc1", 256, 396), ("fc2", 192, 132)])
def test_plan_at_mim_1_batch_64(name, bn, tiles):
    """M = 64 * 65 = 4 160 rows, 33 row tiles: fc2 and proj (N = 768) in one
    wave of 132 tiles; fc1 (N = 3 072) and qkv (N = 2 304) in three waves
    of 396."""
    cfg = load_config("mim_1", str(CONFIGS))
    B = cfg["TRAINING"].int("batch_size")
    (M, N, _), = [(m, n, k) for nm, m, n, k in _products(B * 65, 768) if nm == name]
    assert M == 4160
    plan = G.gemm_plan(M, N)
    assert (plan.bn, plan.tiles) == (bn, tiles)
    assert plan.tiles % G.H100_SMS == 0


def test_plan_at_tiny_and_ragged_shapes():
    for M, N in ((1, 8), (63, 200), (4161, 3072), (1, 3072), (200, 64)):
        _assert_sound(M, N)
    assert G.gemm_plan(1, 8).tiles == 1


@pytest.mark.parametrize("epi", sorted(G.EPILOGUES))
def test_gemm_plain_epilogues_match_numpy(epi):
    """The CPU path of ``gemm`` is the plain version, and its four
    epilogues round where the kernel does: bf16 operands, fp32 sum and bias,
    erf-GELU, residual added in fp32, one rounding to bf16 (the stash's
    pre-activation rounded on its own)."""
    from scipy.special import erf

    rng = np.random.default_rng(0)
    M, K, N = 37, 200, 72
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    a, b = bf(rng.normal(size=(M, K))), bf(rng.normal(size=(K, N)) / np.sqrt(K))
    bias = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    resid = bf(rng.normal(size=(M, N)))
    before = G.gemm.launches
    out, out2 = G.gemm(a, b, bias, epi, resid)
    assert G.gemm.launches == before  # CPU tensors launch nothing
    acc = a.float().numpy().astype(np.float64) @ b.float().numpy().astype(np.float64) + bias.numpy()
    want = {"bias": acc, "bias_gelu": 0.5 * acc * (1 + erf(acc / np.sqrt(2))),
            "bias_gelu_stash": 0.5 * acc * (1 + erf(acc / np.sqrt(2))),
            "bias_residual": resid.float().numpy() + acc}[epi]
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    # one bf16 rounding: within half an ulp (2^-9 relative) plus the fp32 sum
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8, atol=1e-5)
    if epi == "bias_gelu_stash":
        np.testing.assert_allclose(out2.float().numpy(), acc, rtol=2 ** -8, atol=1e-5)
    else:
        assert out2 is None


def test_gemm_plain_refuses_an_unknown_epilogue():
    a, b, bias = torch.zeros(2, 8), torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        G.gemm(a.bfloat16(), b.bfloat16(), bias, "gelu")
