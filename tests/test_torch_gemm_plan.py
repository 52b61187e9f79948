"""The tile rule of the forward GEMM (``csrc/gemm_sm90.cuh``
``gemm_sm90_plan``) through its Python copy, ``ops/kernels/gemm.gemm_plan``,
at every forward product of every shipped MIM config and of the bench
models ``chip_smoke.py`` drives: each plan fits a block's shared memory,
counts its tiles, and comes within a sixteenth of the fewest waves x BN
that any tile width gives; at ``mim_1`` B=64 it takes the widths the
design names (132 tiles, one wave, for fc2 and proj; 396, three waves, for
fc1 and qkv). A card test (``tests/test_torch_cuda.py``) holds this copy to
the rule the C source computes. The plain version of the GEMM's four
epilogues is held to numpy here, as are the backward products' (the dual
and the stash dh products, ``gemm_bwd``); kernels 8 and 7's plain versions
equal their products' composed, and the stash dh product's plan fits at
every shipped stash config. The fp32 GEMM's tile and split rule
(``csrc/gemm_f32.cuh`` ``f32_plan``, copied as ``gemm.f32_plan``) fits,
covers K in whole slabs, sizes the workspace the C side allocates and
fills the waves at every fp32 product of every fp32 config that runs on
the card, ViT-H's and kernel 9's slabs included. The I-JEPA configs
(``jepa_struct``, ``jepa_1`` in bf16, ``jepa_tiny`` in fp32) are held the
same way at every block they run: the target encoder over the full grid,
the context encoder over its fixed context budget and the narrow predictor
over the context plus one target block (``_jepa_blocks``).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models.jepa import _SIZES as JEPA_SIZES
from sky_embeddings_tpu_torch.models.mim import MODEL_TYPES
from sky_embeddings_tpu_torch.ops.jepa_masks import mask_budgets
from sky_embeddings_tpu_torch.ops.kernels import gemm as G
from sky_embeddings_tpu_torch.train.jepa import mask_params

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
MIM_CONFIGS = sorted(
    p.stem for p in CONFIGS.glob("*.ini")
    if load_config(p.stem, str(CONFIGS))["ARCHITECTURE"].str("model_type", "") in MODEL_TYPES
)
DECODER_D = 512  # SkyMIM's decoder_embed_dim
JEPA_CONFIGS = sorted(p.stem for p in CONFIGS.glob("*.ini")
                      if "pred_emb_dim" in load_config(p.stem, str(CONFIGS))["ARCHITECTURE"])


def _jepa_blocks(name: str, batches=None):
    """(M, D) of every block width and sequence an I-JEPA config runs, at one
    image, its batch and 1024 (or ``batches``): the target encoder over the
    L = G² grid, the context encoder over K_ctx tokens and the predictor
    (``pred_emb_dim`` wide) over K_ctx + K_tgt."""
    cfg = load_config(name, str(CONFIGS))
    arch = cfg["ARCHITECTURE"]
    grid = arch.int("img_size") // arch.int("patch_size")
    m = mask_params(cfg)
    k_ctx, k_tgt = mask_budgets(grid, m["pred_mask_scale"], m["enc_mask_scale"], m["min_keep"])
    D = JEPA_SIZES[arch.str("model_type", "small")]["embed_dim"]
    out = []
    for B in batches or (1, cfg["TRAINING"].int("batch_size"), 1024):
        out += [(B * grid * grid, D), (B * k_ctx, D), (B * (k_ctx + k_tgt), arch.int("pred_emb_dim"))]
    return out


def test_jepa_blocks_are_the_shipped_geometry():
    """jepa_struct and jepa_1: ViT-S (D = 384) over 64 tokens, the
    192-wide predictor over 64 + 13; jepa_tiny: D = 192 over 16, the 96-wide
    predictor over 16 + 5."""
    assert JEPA_CONFIGS == ["jepa_1", "jepa_struct", "jepa_tiny"]
    assert _jepa_blocks("jepa_struct", (256,)) == [(256 * 64, 384), (256 * 64, 384), (256 * 77, 192)]
    assert _jepa_blocks("jepa_1", (64,)) == [(64 * 64, 384), (64 * 64, 384), (64 * 77, 192)]
    assert _jepa_blocks("jepa_tiny", (16,)) == [(16 * 16, 192), (16 * 16, 192), (16 * 21, 96)]


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


@pytest.mark.parametrize("name", JEPA_CONFIGS)
def test_plan_fits_every_forward_product_of_the_jepa_configs(name):
    for M, D in _jepa_blocks(name):
        for _, M_, N, K in _products(M, D):
            _assert_sound(M_, N)


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


# ---- the backward forms (kernels 8 and 9) -------------------------------------

from sky_embeddings_tpu_torch.ops.kernels.mlp_block import _stream_slab  # noqa: E402


def _bwd_cost_all(shapes):
    """Every candidate's modelled cost, for the within-a-sixteenth check."""
    splits = G.SPLIT_CANDIDATES if any(s[0] == G.KIND_TN_SPLIT for s in shapes) else (1,)
    return [G._bwd_cost(shapes, bn, sp, G.H100_SMS)[0] for bn in G.BNS for sp in splits]


def _assert_bwd_sound(shapes):
    plan = G.bwd_plan(shapes)
    assert plan.bn in G.BNS
    may_split = any(s[0] == G.KIND_TN_SPLIT for s in shapes)
    assert plan.splits in (G.SPLIT_CANDIDATES if may_split else (1,))
    units, ws = 0, 0
    for kind, M, N, K in shapes:
        nk = math.ceil(K / G.BK)
        sp, chunk = G.split_count(nk, plan.splits) if kind == G.KIND_TN_SPLIT else (1, nk)
        assert 1 <= sp <= max(G.SPLIT_CANDIDATES) and (sp - 1) * chunk < nk <= sp * chunk
        units += math.ceil(M / G.BM) * math.ceil(N / plan.bn) * sp
        ws += sp * M * N if sp > 1 else 0
    assert plan.units == units
    assert G.bwd_workspace(shapes, plan) == ws
    stage_bytes = G.BM * G.BK * 2 + G.BK * plan.bn * 2
    out_bytes = G.BM * plan.bn * 2  # the staged output tile
    stages = (plan.smem - out_bytes - G.SMEM_EXTRA) // stage_bytes
    assert plan.smem == stages * stage_bytes + out_bytes + G.SMEM_EXTRA and stages >= 3
    assert plan.smem + stage_bytes > G.SMEM_OPTIN_MAX >= plan.smem  # one more slot would not fit
    assert plan.cost * 15 <= min(_bwd_cost_all(shapes)) * 16


def _config_bwd_groups(name: str):
    """Kernel 8's two launches at every MLP block a shipped config trains
    (the encoder; an MAE model's decoder too), at one image, the config's
    batch and 1024; kernel 9's slabs where JAX streams the block."""
    cfg = load_config(name, str(CONFIGS))
    arch, training = cfg["ARCHITECTURE"], cfg["TRAINING"]
    grid = arch.int("img_size") // arch.int("patch_size")
    n_tok = grid * grid + 1 + int(arch.bool("ra_dec", False))
    D = arch.int("embed_dim")
    out = []
    for B in (1, training.int("batch_size"), 1024):
        widths = [(B * n_tok, D)]
        if not MODEL_TYPES[arch.str("model_type")][1]:
            widths.append((B * (grid * grid + 1), DECODER_D))
        for M, d in widths:
            out += G.mlp_bwd_groups(M, d, _stream_slab(d, 4 * d))
    return out


# chip_smoke.py's bench shapes: mim_1 at B=64 and 512, ViT-H slabs (fs =
# 1280) at B=32 and 256, MAE's packed encoder (256 x 68) and its decoder
# (1024 x 65 at D=512)
BENCH_BWD = (G.mlp_bwd_groups(64 * 65, 768, 3072) + G.mlp_bwd_groups(512 * 65, 768, 3072)
             + G.mlp_bwd_groups(32 * 66, 1280, 1280) + G.mlp_bwd_groups(256 * 66, 1280, 1280)
             + G.mlp_bwd_groups(256 * 68, 768, 3072) + G.mlp_bwd_groups(1024 * 65, DECODER_D, 2048))


@pytest.mark.parametrize("name", MIM_CONFIGS)
def test_bwd_plan_fits_every_backward_product_of_the_shipped_configs(name):
    groups = _config_bwd_groups(name)
    assert len(groups) >= 6
    for shapes in groups:
        _assert_bwd_sound(shapes)


@pytest.mark.parametrize("name", JEPA_CONFIGS)
def test_bwd_plan_fits_every_backward_product_of_the_jepa_configs(name):
    """Kernel 8's two launches and kernels 3 and 4's three at every block
    width and sequence of an I-JEPA config."""
    for M, D in _jepa_blocks(name):
        for shapes in G.mlp_bwd_groups(M, D, _stream_slab(D, 4 * D)) + G.attn_bwd_groups(M, D):
            _assert_bwd_sound(shapes)


@pytest.mark.parametrize("case", range(len(BENCH_BWD)))
def test_bwd_plan_fits_the_bench_models(case):
    _assert_bwd_sound(BENCH_BWD[case])


def test_bwd_plan_at_mim_1_batch_64():
    """dy (4 160 x 768, K = 3 072) on 132 tiles of 128 x 192, one wave; dW1
    and dW2 (768 x 3 072 and 3 072 x 768, K = 4 160) together on 192 tiles
    of 128 x 192 with no split: the widths a sweep on the card found
    fastest for dy alone and for the group (PERF.md)."""
    dy, dw = G.mlp_bwd_groups(64 * 65, 768, 3072)
    assert (G.bwd_plan(dy).bn, G.bwd_plan(dy).units) == (192, 132)
    assert (G.bwd_plan(dw).bn, G.bwd_plan(dw).splits, G.bwd_plan(dw).units) == (192, 1, 192)
    assert G.bwd_workspace(dw, G.bwd_plan(dw)) == 0


# a weight-gradient group and the (tile width, split count) of least device
# time among those a card sweep forced on an H100 (PERF.md §6): kernel 8's
# or 9's dW1 + dW2 (tools/mlp_bwd_variants.py, 18 readings), kernels 3 and
# 4's dWqkv + dWproj (tools/attn_bwd_variants.py, 12 readings)
GROUP_SWEEP_FASTEST = {
    "attention mim_1 B=64": (G.attn_bwd_groups(64 * 65, 768)[2], (192, 1)),
    "attention mim_1 B=512": (G.attn_bwd_groups(512 * 65, 768)[2], (192, 1)),
    "attention mim_32 B=32": (G.attn_bwd_groups(32 * 66, 1024)[2], (256, 1)),
    "attention vith B=256": (G.attn_bwd_groups(256 * 66, 1280)[2], (256, 1)),
    "attention mae encoder B=256": (G.attn_bwd_groups(256 * 68, 768)[2], (192, 1)),
    "mim_1 B=64": (G.mlp_bwd_groups(64 * 65, 768, 3072)[1], (192, 1)),
    "mim_1 B=512": (G.mlp_bwd_groups(512 * 65, 768, 3072)[1], (192, 2)),
    "mae encoder B=256": (G.mlp_bwd_groups(256 * 68, 768, 3072)[1], (192, 1)),
    "mae decoder B=1024": (G.mlp_bwd_groups(1024 * 65, DECODER_D, 2048)[1], (256, 2)),
    "vith slab B=32": (G.mlp_bwd_groups(32 * 66, 1280, 1280)[1], (256, 1)),
    "vith slab B=256": (G.mlp_bwd_groups(256 * 66, 1280, 1280)[1], (256, 1)),
}


@pytest.mark.parametrize("case", sorted(GROUP_SWEEP_FASTEST))
def test_bwd_plan_picks_the_fastest_weight_gradient_group_of_the_card_sweep(case):
    shapes, want = GROUP_SWEEP_FASTEST[case]
    plan = G.bwd_plan(shapes)
    assert (plan.bn, plan.splits) == want


def test_bwd_plan_at_tiny_and_ragged_shapes():
    for shapes in ([(0, 1, 8, 8)], [(1, 8, 8, 8)], [(1, 200, 8, 585)], [(0, 4161, 200, 3072)],
                   [(1, 768, 3072, 17408), (1, 3072, 768, 17408)], [(1, 8, 5120, 1)]):
        _assert_bwd_sound(shapes)
    assert G.bwd_plan([(1, 8, 8, 8)]).units == 1


@pytest.mark.parametrize("nk", [1, 2, 7, 33, 65, 272, 1040])
def test_split_count_covers_k_in_whole_slabs(nk):
    for split in G.SPLIT_CANDIDATES:
        sp, chunk = G.split_count(nk, split)
        assert 1 <= sp <= min(split, nk)
        assert (sp - 1) * chunk < nk <= sp * chunk  # no empty slice, nothing left over


@pytest.mark.parametrize("M,N", [(64 * 65, 3072), (2112, 1280), (1, 8), (66560, 2048)]
                         + sorted({(M, 4 * D) for n in JEPA_CONFIGS for M, D in _jepa_blocks(n)}))
def test_dual_plan_fits(M, N):
    plan = G.dual_plan(M, N)
    assert plan["tiles"] == math.ceil(M / 128) * math.ceil(N / 128)
    assert plan["stages"] == 3
    assert plan["smem"] <= G.SMEM_OPTIN_MAX < plan["smem"] + G.DUAL_STAGE_BYTES


def _bf(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("form,epi", [("nt", "store"), ("nt", "store_f32"), ("nt", "add_f32"),
                                      ("tn", "store"), ("tn", "store_f32"), ("tn", "add_f32")])
def test_gemm_bwd_plain_matches_numpy(form, epi):
    """The CPU path of ``gemm_bwd`` is the plain version: the fp32 product of
    the bf16 operands, a @ bᵀ (b stored (N, K)) or aᵀ @ b (a stored (K, M)),
    rounded once to bf16, kept in fp32, or added to c."""
    rng = np.random.default_rng(1)
    M, N, K = 37, 72, 585
    a = _bf(rng, M, K) if form == "nt" else _bf(rng, K, M)
    b = _bf(rng, N, K, scale=K ** -0.5) if form == "nt" else _bf(rng, K, N, scale=K ** -0.5)
    c = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    before = G.gemm_bwd.launches
    out = G.gemm_bwd(a, b, form, epi, c)
    assert G.gemm_bwd.launches == before  # CPU tensors launch nothing
    a64, b64 = a.float().numpy().astype(np.float64), b.float().numpy().astype(np.float64)
    want = a64 @ b64.T if form == "nt" else a64.T @ b64
    if epi == "add_f32":
        want = want + c.numpy()
    assert out.shape == (M, N)
    assert out.dtype == (torch.bfloat16 if epi == "store" else torch.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8 if epi == "store" else 1e-5,
                               atol=1e-5)


def test_gemm_dual_plain_matches_numpy():
    """The dual product's plain version: a = y @ W1 + b1 and dh = g @ W2ᵀ in
    fp32, da = dh · gelu'(a) (exact erf), da_c and h_c = gelu(a) rounded
    once to bf16, db1 the fp32 column sums of da."""
    from scipy.special import erf

    rng = np.random.default_rng(2)
    M, N, K = 37, 72, 48
    y, g = _bf(rng, M, K), _bf(rng, M, K, scale=0.1)
    w1, w2 = _bf(rng, K, N, scale=K ** -0.5), _bf(rng, N, K, scale=N ** -0.5)
    b1 = torch.from_numpy(rng.normal(size=N).astype(np.float32) * 0.1)
    da_c, h_c, db1 = G.gemm_dual(y, w1, b1, g, w2)
    f = lambda t: t.float().numpy().astype(np.float64)
    a = f(y) @ f(w1) + b1.numpy()
    grad = 0.5 * (1 + erf(a / np.sqrt(2))) + a * np.exp(-0.5 * a * a) / np.sqrt(2 * np.pi)
    da = (f(g) @ f(w2).T) * grad
    np.testing.assert_allclose(f(da_c), da, rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(f(h_c), 0.5 * a * (1 + erf(a / np.sqrt(2))), rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(db1.numpy(), da.sum(0), rtol=1e-4, atol=1e-6)
    assert da_c.dtype == h_c.dtype == torch.bfloat16 and db1.dtype == torch.float32


def test_mlp_backward_plain_is_the_dual_and_group_products():
    """Kernel 8's plain version equals its decomposition into the plain
    dual product and the plain backward forms: dW1 = yᵀ @ da_c and dW2 =
    h_cᵀ @ g (``"tn"``, one by one and as the group ``mlp_weight_grads``),
    db1 from the dual's column sums, on y = LN(x)."""
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as M_

    rng = np.random.default_rng(3)
    B, N, D, F = 3, 17, 48, 192
    x, g = _bf(rng, B, N, D, scale=0.5), _bf(rng, B, N, D, scale=0.1)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=D).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=D).astype(np.float32))
    w1, w2 = _bf(rng, D, F, scale=D ** -0.5), _bf(rng, F, D, scale=F ** -0.5)
    b1 = torch.from_numpy(0.01 * rng.normal(size=F).astype(np.float32))
    _, _, _, dw1, db1, dw2, _ = M_.mlp_block_bwd_plain(x, scale, bias, w1, b1, w2, g)
    y = M_.layer_norm(x.reshape(-1, D).float(), scale, bias).to(torch.bfloat16)
    g2 = g.reshape(-1, D)
    da_c, h_c, db1_d = G.gemm_dual(y, w1, b1, g2, w2)
    torch.testing.assert_close(G.gemm_bwd(y, da_c, "tn", "store"), dw1, rtol=0, atol=0)
    torch.testing.assert_close(G.gemm_bwd(h_c, g2, "tn", "store"), dw2, rtol=0, atol=0)
    for got, want in zip(G.mlp_weight_grads(y, da_c, h_c, g2), (dw1, dw2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(db1_d, db1, rtol=1e-6, atol=1e-7)


def _stash_config_shapes():
    """(M, F) of the stash dh product at every shipped config that builds
    the MLP stash (ViT-L: ``stash_mlp`` on by default), at one image, the
    config's batch and 1024."""
    out = []
    for name in MIM_CONFIGS:
        arch, training = (load_config(name, str(CONFIGS))[k] for k in ("ARCHITECTURE", "TRAINING"))
        size = MODEL_TYPES[arch.str("model_type")][0]
        if not arch.bool("stash_mlp", size == "large"):
            continue
        grid = arch.int("img_size") // arch.int("patch_size")
        n_tok = grid * grid + 1 + int(arch.bool("ra_dec", False))
        out += [(B * n_tok, 4 * arch.int("embed_dim")) for B in (1, training.int("batch_size"), 1024)]
    return out


STASH_SHAPES = _stash_config_shapes()


@pytest.mark.parametrize("M,N", STASH_SHAPES + [(1, 8), (63, 136), (4161, 5120), (66560, 2048)])
def test_dh_stash_plan_fits(M, N):
    """The stash dh product's plan (``StashCfg``) at every shipped stash
    config and at ragged shapes: its tiles cover (M, N), its ring holds at
    least three slots and one more would not fit a block's shared memory."""
    assert len(STASH_SHAPES) >= 6  # mim_25_large, mim_32, mim_tiny_large
    plan = G.dh_stash_plan(M, N)
    stage = G.BM * G.BK * 2 + G.STASH_BN * G.BK * 2
    assert plan["tiles"] == math.ceil(M / 128) * math.ceil(N / G.STASH_BN)
    assert plan["stages"] >= 3
    assert plan["smem"] <= G.SMEM_OPTIN_MAX < plan["smem"] + stage


def test_gemm_dh_stash_plain_matches_numpy():
    """The stash dh product's plain version, against float64 numpy of
    ``_bwd_stash_kernel``'s lines (mlp_block.py:392-397, :419): dh = g @ W2ᵀ,
    GELU and GELU' of the bf16 stash a upcast, da_c and h_c rounded once to
    bf16, db1 the column sums of da; ragged M, N a multiple of 8."""
    from scipy.special import erf

    rng = np.random.default_rng(4)
    M, N, K = 37, 72, 48
    g, a = _bf(rng, M, K, scale=0.1), _bf(rng, M, N)
    w2 = _bf(rng, N, K, scale=N ** -0.5)
    before = G.gemm_dh_stash.launches
    da_c, h_c, db1 = G.gemm_dh_stash(g, w2, a)
    assert G.gemm_dh_stash.launches == before  # CPU tensors launch nothing
    f = lambda t: t.float().numpy().astype(np.float64)
    a64 = f(a)
    grad = 0.5 * (1 + erf(a64 / np.sqrt(2))) + a64 * np.exp(-0.5 * a64 * a64) / np.sqrt(2 * np.pi)
    da = (f(g) @ f(w2).T) * grad
    np.testing.assert_allclose(f(da_c), da, rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(f(h_c), 0.5 * a64 * (1 + erf(a64 / np.sqrt(2))), rtol=2 ** -8,
                               atol=1e-6)
    np.testing.assert_allclose(db1.numpy(), da.sum(0), rtol=1e-4, atol=1e-6)
    assert da_c.shape == h_c.shape == (M, N) and db1.shape == (N,)
    assert da_c.dtype == h_c.dtype == torch.bfloat16 and db1.dtype == torch.float32


def test_mlp_stash_backward_plain_is_the_dh_stash_and_group_products():
    """Kernel 7's plain version (held to JAX in ``test_torch_kernels.py``)
    equals its decomposition into the products' plain versions, as the
    kernel launches them: the stash dh product, dy = da_c @ W1ᵀ (``"nt"``,
    fp32), the weight-gradient group (``mlp_weight_grads``), then the LN
    backward from dy and the column sums, on y = LN(x)."""
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as M_

    rng = np.random.default_rng(5)
    B, N, D, F = 3, 17, 48, 192
    x, g = _bf(rng, B, N, D, scale=0.5), _bf(rng, B, N, D, scale=0.1)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=D).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=D).astype(np.float32))
    w1, w2 = _bf(rng, D, F, scale=D ** -0.5), _bf(rng, F, D, scale=F ** -0.5)
    b1 = torch.from_numpy(0.01 * rng.normal(size=F).astype(np.float32))
    _, a = M_.mlp_block_fwd_stash_plain(x, scale, bias, w1, b1, w2, torch.zeros(D))
    want = M_.mlp_block_bwd_stash_plain(x, scale, bias, w1, w2, a, g)
    x2, g2 = x.reshape(-1, D), g.reshape(-1, D)
    y, xhat, rstd = M_._ln_forward(x2.float(), scale, bias)
    y = y.to(torch.bfloat16)
    da_c, h_c, db1 = G.gemm_dh_stash(g2, w2, a)
    dy = G.gemm_bwd(da_c, w1, "nt", "store_f32")
    dw1, dw2 = G.mlp_weight_grads(y, da_c, h_c, g2)
    dx, dscale, dbias = M_._ln_backward(g2.float(), dy, xhat, rstd, scale)
    got = (dx.to(x.dtype).reshape(x.shape), dscale, dbias, dw1, db1, dw2, g2.float().sum(0))
    for name, a_, b_ in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), got, want):
        assert a_.shape == b_.shape and a_.dtype == b_.dtype, name
        torch.testing.assert_close(a_, b_, rtol=0, atol=0, msg=name)


def test_gemm_bwd_plain_refuses_unknown_forms_and_epilogues():
    a, b = torch.zeros(8, 8, dtype=torch.bfloat16), torch.zeros(8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="form"):
        G.gemm_bwd(a, b, "nn", "store")
    with pytest.raises(ValueError, match="epilogue"):
        G.gemm_bwd(a, b, "nt", "gelu")
    with pytest.raises(ValueError, match="tn"):
        G.gemm_bwd(a, torch.zeros(9, 8, dtype=torch.bfloat16), "tn", "store")


# ---- the attention backwards (kernels 3 and 4) --------------------------------

ATTN_BWD_SRC = (Path(__file__).resolve().parents[1]
                / "sky_embeddings_tpu_torch/ops/kernels/csrc/attn_block_bwd.cu")


def _attn_source_groups(M: int, D: int):
    """(kind, M, N, K) of every BwdSpec that ``csrc/attn_block_bwd.cu``
    builds, its size expressions evaluated at (M, D)."""
    import re

    text = ATTN_BWD_SRC.read_text()
    out = []
    for body in re.findall(r"BwdSpec\s*\w*\s*\{([^{}]*)\}", text):
        fields = [f.strip() for f in body.split(",")]
        form, epi, rows, cols, depth = fields[0], fields[1], *fields[-3:]
        kind = (G.KIND_NT if form.endswith("FORM_NT")
                else G.KIND_TN_SPLIT if epi.endswith("EPI_STORE") else G.KIND_TN)
        out.append((kind, *(eval(e, {"M": M, "D": D}) for e in (rows, cols, depth))))
    return out


@pytest.mark.parametrize("M,D", [(64 * 65, 768), (32 * 66, 1024), (1, 64)]
                         + sorted({b for n in JEPA_CONFIGS for b in _jepa_blocks(n)}))
def test_attn_bwd_groups_are_the_launches_of_kernels_3_and_4(M, D):
    """``attn_bwd_groups`` names the products the C source launches: dctx
    and dy (``"nt"``, K = D and 3·D), dWqkv and dWproj in one ``"tn"`` group
    over the M token rows; nothing else runs on the group kernel."""
    groups = G.attn_bwd_groups(M, D)
    assert [len(g) for g in groups] == [1, 1, 2]
    assert groups[0] == [(G.KIND_NT, M, D, D)] and groups[1] == [(G.KIND_NT, M, D, 3 * D)]
    assert groups[2] == [(G.KIND_TN_SPLIT, D, 3 * D, M), (G.KIND_TN_SPLIT, D, D, M)]
    assert sorted(_attn_source_groups(M, D)) == sorted(s for g in groups for s in g)


def _config_attn_groups(name: str):
    """Kernels 3 and 4's group launches at every attention block a shipped
    config trains (the encoder; an MAE model's decoder too), at one image,
    the config's batch and 1024."""
    cfg = load_config(name, str(CONFIGS))
    arch, training = cfg["ARCHITECTURE"], cfg["TRAINING"]
    grid = arch.int("img_size") // arch.int("patch_size")
    n_tok = grid * grid + 1 + int(arch.bool("ra_dec", False))
    D = arch.int("embed_dim")
    out = []
    for B in (1, training.int("batch_size"), 1024):
        out += G.attn_bwd_groups(B * n_tok, D)
        if not MODEL_TYPES[arch.str("model_type")][1]:
            out += G.attn_bwd_groups(B * (grid * grid + 1), DECODER_D)
    return out


# chip_smoke.py's bench shapes of kernels 3 and 4: mim_1 at B=64 and 512,
# mim_32 (N=66, D=1024) at B=32, ViT-H (N=66, D=1280) at B=32 and 256, MAE's
# packed encoder (256 x 68) and its decoder (1024 x 65 at D=512), the head
# of 512 (64 x 65)
BENCH_ATTN_BWD = (G.attn_bwd_groups(64 * 65, 768) + G.attn_bwd_groups(512 * 65, 768)
                  + G.attn_bwd_groups(32 * 66, 1024) + G.attn_bwd_groups(32 * 66, 1280)
                  + G.attn_bwd_groups(256 * 66, 1280) + G.attn_bwd_groups(256 * 68, 768)
                  + G.attn_bwd_groups(1024 * 65, DECODER_D) + G.attn_bwd_groups(64 * 65, 512))


@pytest.mark.parametrize("name", MIM_CONFIGS)
def test_bwd_plan_fits_every_attention_backward_product_of_the_shipped_configs(name):
    groups = _config_attn_groups(name)
    assert len(groups) >= 9
    for shapes in groups:
        _assert_bwd_sound(shapes)


@pytest.mark.parametrize("case", range(len(BENCH_ATTN_BWD)))
def test_bwd_plan_fits_the_attention_bench_models(case):
    _assert_bwd_sound(BENCH_ATTN_BWD[case])


def _attn_block_inputs(rng, B, N, D):
    x, g = _bf(rng, B, N, D, scale=0.5), _bf(rng, B, N, D, scale=0.1)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=D).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=D).astype(np.float32))
    wqkv, wproj = _bf(rng, D, 3 * D, scale=D ** -0.5), _bf(rng, D, D, scale=D ** -0.5)
    bqkv = torch.from_numpy(0.01 * rng.normal(size=3 * D).astype(np.float32))
    return x, scale, bias, wqkv, bqkv, wproj, g


@pytest.mark.parametrize("kernel", ["stash", "recompute", "recompute masked"])
def test_attn_backward_plain_is_the_sm90_products_and_the_core(kernel):
    """Kernels 3 and 4 as their launches compose them, each launch by its
    plain version: LN, qkv on the forward form (``gemm_plain``, kernel 4),
    dctx and dy on the ``"nt"`` form and dWqkv, dWproj on the ``"tn"`` group
    (``gemm_bwd_plain``, ``attn_weight_grads``), the backward core
    (``attn_bwd_core_plain``) whose fp32 dqkv is rounded to bf16 and summed
    per sample, the B partials then added in order. Held to
    ``attn_block_bwd_stash_plain`` / ``attn_block_bwd_plain``, which the JAX
    tests hold to the Pallas kernels in interpret mode."""
    from sky_embeddings_tpu_torch.ops.kernels import attn_block as A
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as M_

    rng = np.random.default_rng(4)
    B, N, D, H = 3, 17, 48, 4
    seg = 6 if kernel == "recompute masked" else 0
    x, scale, bias, wqkv, bqkv, wproj, g = _attn_block_inputs(rng, B, N, D)
    bf = torch.bfloat16
    x2, g2 = x.reshape(-1, D), g.reshape(-1, D)
    y, xhat, rstd = M_._ln_forward(x2.float(), scale, bias)
    y = y.to(bf)
    if kernel == "stash":
        _, qkv, probs = A.attn_block_fwd_stash_plain(x, scale, bias, wqkv, bqkv, wproj,
                                                     torch.zeros(D), H)
        p_soft = p_c = probs.float()
        want = A.attn_block_bwd_stash_plain(x, scale, bias, wqkv, wproj, qkv, probs, g, H)
    else:
        qkv = G.gemm_plain(y, wqkv, bqkv, "bias")[0].reshape(B, N, 3 * D)
        q, k, _ = qkv.float().reshape(B, N, 3, H, D // H).unbind(2)
        z = torch.einsum("bnhd,bmhd->bhnm", q, k) * (D // H) ** -0.5
        if seg:
            ids = torch.arange(N) // seg
            z = z + torch.where(ids[:, None] == ids[None, :], 0.0, -1e9)
        p_soft = torch.softmax(z, dim=-1)
        p_c = p_soft.to(bf).float()
        want = A.attn_block_bwd_plain(x, scale, bias, wqkv, bqkv, wproj, g, H, seg)
    dc = G.gemm_bwd_plain(g2, wproj, "nt", "store")
    dqkv, ctx = A.attn_bwd_core_plain(qkv, p_soft, p_c, dc.reshape(B, N, D), H)
    dqkv_c = dqkv.to(bf)
    dbqkv = dqkv.reshape(B, N, 3 * D).sum(1)  # the core's per-sample partials
    dbqkv = torch.stack(list(dbqkv)).sum(0)
    dy = G.gemm_bwd_plain(dqkv_c, wqkv, "nt", "store_f32")
    dx, dscale, dbias = M_._ln_backward(g2.float(), dy, xhat, rstd, scale)
    dwqkv, dwproj = G.attn_weight_grads(y, dqkv_c, ctx.reshape(-1, D), g2)
    got = (dx.to(bf).reshape(B, N, D), dscale, dbias, dwqkv, dbqkv, dwproj, g2.float().sum(0))
    names = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        # the products are the plain versions' own; only dbqkv sums in
        # another order (per sample, then over the samples)
        tol = dict(rtol=1e-5, atol=1e-6) if name == "dbqkv" else dict(rtol=0, atol=0)
        torch.testing.assert_close(a, b, **tol, msg=name)


# ---- the fp32 GEMM's tile and split rule (csrc/gemm_f32.cuh f32_plan) --------

F32_SOURCES = ("mae_tiny", "mim_tiny", "mim_tiny_large")  # fp32 MIM configs trained as shipped


def _f32_blocks():
    """(label, B, tokens, D) of every encoder (and MAE decoder) that a shipped
    fp32 config runs on the card, at its batch: the configs with no ``dtype``
    whose backbone loads (a predictor reads its pretraining config's
    architecture under its own), an I-JEPA config's blocks as (label, 1,
    rows, D), and chip_smoke.py's ViT-H in fp32 at B=32 and 256."""
    out = []
    for p in sorted(CONFIGS.glob("*.ini")):
        cfg = load_config(p.stem, str(CONFIGS))
        if "dtype" in cfg["TRAINING"]:
            continue
        base = cfg.pretrained_mae_name()
        if base is not None and not (CONFIGS / f"{base}.ini").exists():
            continue  # mim_25: loads in neither package
        arch = dict(load_config(base, str(CONFIGS))["ARCHITECTURE"].items()) if base else {}
        arch.update(cfg["ARCHITECTURE"].items())
        if "pred_emb_dim" in arch:  # I-JEPA: the encoder's and the predictor's blocks
            B = cfg["TRAINING"].int("batch_size")
            for M, D in dict.fromkeys(_jepa_blocks(p.stem, (B,))):
                out.append((f"{p.stem} D={D} M={M}", 1, M, D))
            continue
        if arch.get("model_type", "") not in MODEL_TYPES:
            continue
        grid = (int(arch["img_size"]) // int(arch.get("patch_size", 8))) ** 2
        n_tok = grid + 1 + int(str(arch.get("ra_dec", "False")) == "True")
        B = cfg["TRAINING"].int("batch_size")
        out.append((p.stem, B, n_tok, int(arch.get("embed_dim", 768))))
        if not MODEL_TYPES[arch["model_type"]][1]:
            out.append((f"{p.stem} decoder", B, grid + 1, DECODER_D))
    return out + [("vith", 32, 66, 1280), ("vith", 256, 66, 1280)]


def _f32_products(M: int, D: int):
    """(name, form, M, N, K) of every fp32 product of one block at M rows:
    the forwards' four, the backwards' NT and TN ones, and kernel 9's per
    slab where it streams the block."""
    F = 4 * D
    out = [("qkv", "fwd", M, 3 * D, D), ("proj", "fwd", M, D, D), ("fc1", "fwd", M, F, D),
           ("fc2", "fwd", M, D, F), ("dctx", "nt", M, D, D), ("dy_attn", "nt", M, D, 3 * D),
           ("dh", "nt", M, F, D), ("dy_mlp", "nt", M, D, F), ("dWqkv", "tn", D, 3 * D, M),
           ("dWproj", "tn", D, D, M), ("dW1", "tn", D, F, M), ("dW2", "tn", F, D, M)]
    fs = _stream_slab(D, F)
    if fs < F:
        out += [("k9_fc1", "fwd", M, fs, D), ("k9_dh", "nt", M, fs, D), ("k9_dy", "nt", M, D, fs),
                ("k9_dW1", "tn", D, fs, M), ("k9_dW2", "tn", fs, D, M)]
    return out


F32_BLOCKS = _f32_blocks()


def _f32_cost(M, N, K, bn, s):
    nk = math.ceil(K / G.F32_BK)
    per = math.ceil(nk / s)
    units = math.ceil(M / G.BM) * math.ceil(N / bn) * s
    cost = math.ceil(units / G.H100_SMS) * per * (bn + G.F32_TILE_COST)
    return cost + ((2 * s + 1) * M * N * 4 // G.F32_REDUCE_BYTES_PER_COST if s > 1 else 0)


def _f32_efficiency(M, N, K, bn, s):
    """Useful columns x slabs (rows in whole 128-row tiles) over what the
    CTAs' waves take."""
    nk = math.ceil(K / G.F32_BK)
    per = math.ceil(nk / s)
    units = math.ceil(M / G.BM) * math.ceil(N / bn) * s
    return math.ceil(M / G.BM) * N * nk / (G.H100_SMS * math.ceil(units / G.H100_SMS) * bn * per)


def _assert_f32_sound(form, M, N, K):
    may_split = form == "tn"
    plan = G.f32_plan(M, N, K, may_split)
    nk = math.ceil(K / G.F32_BK)
    assert plan.bn in G.F32_BNS and 1 <= plan.splits <= (G.F32_MAX_SPLITS if may_split else 1)
    # whole slabs, no slice empty
    assert (plan.splits - 1) * plan.kslabs < nk <= plan.splits * plan.kslabs
    assert plan.splits == 1 or K >= plan.splits * G.F32_MIN_SLICE
    assert plan.units == math.ceil(M / G.BM) * math.ceil(N / plan.bn) * plan.splits
    stage = G.F32_A_BYTES + 3 * plan.bn * G.F32_BK * 4  # A, B and B's two planes
    assert plan.stages >= 3 and plan.smem == plan.stages * stage + G.SMEM_EXTRA
    assert plan.smem <= G.SMEM_OPTIN_MAX < plan.smem + stage  # one more slot would not fit
    # the split partials are what the blocks' C entries allocate
    assert G.f32_workspace(M, N, K) == (G.f32_plan(M, N, K, True).splits * M * N
                                        if G.f32_plan(M, N, K, True).splits > 1 else 0)
    cands = [_f32_cost(M, N, K, bn, s) for bn in G.F32_BNS
             for s in range(1, (G.F32_MAX_SPLITS if may_split else 1) + 1)
             if s == 1 or (K >= s * G.F32_MIN_SLICE and math.ceil(nk / math.ceil(nk / s)) == s)]
    assert _f32_cost(M, N, K, plan.bn, plan.splits) * 15 <= min(cands) * 16
    # the waves filled at least as well as by the one 128 x 128 tile it
    # replaced, and at least two thirds full wherever 64-wide tiles
    # alone would fill the card
    eff = _f32_efficiency(M, N, K, plan.bn, plan.splits)
    assert eff >= _f32_efficiency(M, N, K, 128, 1)
    if math.ceil(M / G.BM) * math.ceil(N / 64) >= G.H100_SMS:
        assert eff >= 2 / 3, (form, M, N, K, plan, eff)
    else:
        assert plan.units <= 2 * G.H100_SMS  # small products: at most two waves
    return plan


@pytest.mark.parametrize("label,B,n_tok,D", F32_BLOCKS, ids=[f"{b[0]}-B{b[1]}" for b in F32_BLOCKS])
def test_f32_plan_fills_the_waves_of_every_fp32_config(label, B, n_tok, D):
    """Every fp32 product of every shipped fp32 config that runs on the card
    (cls_fs_*, cls_ft_*_large, lp_1, z_ft_2, z_tiny, the tiny MIM configs)
    and of ViT-H in fp32, kernel 9's slabs included: the plan fits, covers K
    in whole slabs, sizes the workspace the C side allocates, comes within a
    sixteenth of the least modelled time and fills the waves."""
    products = _f32_products(B * n_tok, D)
    assert len(products) >= 12
    for _, form, M, N, K in products:
        _assert_f32_sound(form, M, N, K)


def test_f32_plan_covers_the_configs_the_fp32_path_runs():
    labels = {b[0] for b in F32_BLOCKS}
    for name in ("cls_fs_1k", "cls_fs_16k", "cls_ft_1k_large", "lp_1", "z_ft_2", "z_tiny",
                 *F32_SOURCES, "mae_tiny decoder", "vith", "jepa_tiny D=192 M=256",
                 "jepa_tiny D=96 M=336"):
        assert name in labels, name
    assert not any(lab.startswith(("cls_ap_", "jepa_1", "jepa_struct")) or lab == "cls_ft_1k"
                   for lab in labels)


# the plan's picks, each the card sweep's fastest or within 5% of it
# (tools/gemm_f32_variants.py sweep, PERF.md)
@pytest.mark.parametrize("name,form,M,N,K,bn,splits", [
    # cls_fs_1k B=256 (M = 16 896, 132 row tiles): whole waves at 128
    ("fc1", "fwd", 16896, 3072, 768, 128, 1), ("dy_mlp", "nt", 16896, 768, 3072, 128, 1),
    ("dW1", "tn", 768, 3072, 16896, 128, 5), ("dWqkv", "tn", 768, 2304, 16896, 128, 6),
    ("dWproj", "tn", 768, 768, 16896, 128, 7),
    # M = 2 112: kernel 4 at mim_32 B=32 and kernel 9's slab at ViT-H B=32,
    # where 128 x 128 tiles left a second wave 3% and 29% full
    ("k4_dctx", "nt", 2112, 1024, 1024, 64, 1), ("k4_dy", "nt", 2112, 1024, 3072, 64, 1),
    ("k9_dy", "nt", 2112, 1280, 1280, 64, 1), ("k9_dW1", "tn", 1280, 1280, 2112, 128, 1),
    ("k4_qkv", "fwd", 2112, 3072, 1024, 128, 1), ("k4_dWqkv", "tn", 1024, 3072, 2112, 128, 2),
])
def test_f32_plan_at_the_named_products(name, form, M, N, K, bn, splits):
    plan = _assert_f32_sound(form, M, N, K)
    assert (plan.bn, plan.splits) == (bn, splits), name


def test_f32_plan_at_tiny_and_ragged_shapes():
    for form, M, N, K in (("fwd", 4, 8, 4), ("nt", 300, 264, 200), ("tn", 132, 36, 1028),
                          ("tn", 4, 4, 16896), ("fwd", 1, 3072, 768), ("tn", 768, 768, 1024)):
        _assert_f32_sound(form, M, N, K)
    assert G.f32_plan(4, 8, 4).units == 1
    assert G.f32_plan(768, 768, 16896).splits == 1  # a product without a workspace stays whole
