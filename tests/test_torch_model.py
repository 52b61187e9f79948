"""The port's model and package boundary against the JAX package: weights
round trip (with the RA/Dec encoder's leaves), ``SkyMIM.encode`` parity with
and without the RA/Dec token (fp32 atol 1e-5, bf16 max-rel 2e-2), the
spherical-harmonics basis and the location encoders, remat against the
stored path, config parsing, import hygiene, and the default-device rule."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import location as jloc
from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models import location as tloc
from sky_embeddings_tpu_torch.models.mim import SkyMIM, build_mim_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_params(seed=0, ra_dec=False):
    """Tiny JAX SimMIM params with every leaf perturbed (so biases, LN
    scales and the NaN fill values all matter), as a numpy tree."""
    model = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                      ra_dec=ra_dec)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    kw = {"ra_dec": jnp.zeros((2, 2), jnp.float32)} if ra_dec else {}
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs),
                                 **kw)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params
    )


def _port_model(params, dtype, **kw):
    model = SkyMIM(**TINY, dtype=_TDT[dtype], **kw)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _ra_dec(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 360, n), rng.uniform(-90, 90, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("ra_dec", [False, True])
def test_params_round_trip_exact(ra_dec):
    params = _jax_params(ra_dec=ra_dec)
    assert ("ra_dec_embed" in params) == ra_dec
    sd = params_from_jax(params)
    model = SkyMIM(**TINY, ra_dec=ra_dec)
    model.load_state_dict(sd)  # strict: every leaf has a home, no extras
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("ra_dec", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype, ra_dec):
    params = _jax_params(1, ra_dec=ra_dec)
    rng = np.random.default_rng(7)
    imgs = rng.normal(size=(4, 3, 16, 16)).astype(np.float32)
    imgs[0, 1] = np.nan  # whole-band NaNs
    imgs[2, 0] = np.nan
    mask = (rng.random((4, 3, 16, 16)) < 0.3).astype(np.float32)
    rd = _ra_dec(4, 8)
    jmodel = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                       dtype=_JDT[dtype], ra_dec=ra_dec)
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(imgs), mask=jnp.asarray(mask),
                              ra_dec=jnp.asarray(rd) if ra_dec else None, method=JaxSkyMIM.encode)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    with torch.inference_mode():
        got, _, _ = _port_model(params, dtype, ra_dec=ra_dec).encode(
            torch.from_numpy(imgs), ra_dec=torch.from_numpy(rd) if ra_dec else None,
            mask=torch.from_numpy(mask))
    assert got.dtype == _TDT[dtype] and got.shape == want.shape == (4, 16 + 1 + ra_dec, 48)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, f"max-rel {rel:.3g}"


def test_ra_dec_model_needs_ra_dec():
    model = SkyMIM(**TINY, ra_dec=True)
    assert model.num_extra_tokens == 2 and model.pos_embed.shape == (16 + 2, 48)
    with pytest.raises(ValueError, match="ra_dec=None"):
        model.encode(torch.zeros(1, 3, 16, 16))


@pytest.mark.parametrize("head", ["siren", "fcnet", "linear"])
def test_location_encoder_matches_jax(head):
    """The degree-5 real SH basis (25 features) and each head, fp32, from the
    same params (every leaf perturbed), over the whole sky; the SIREN's first
    layer multiplies by w0 = 30, so the bar is 1e-5 absolute."""
    rd = _ra_dec(64, 9)
    rd[:4] = [[0.0, -90.0], [359.9, 90.0], [180.0, 0.0], [90.0, 45.0]]  # poles, seam
    want = np.asarray(jloc.real_spherical_harmonics(jnp.asarray(rd), 5))
    got = tloc.real_spherical_harmonics(torch.from_numpy(rd), 5)
    assert got.shape == (64, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    jenc = jloc.LocationEncoder(out_dim=48, head=head)
    params = jenc.init(jax.random.PRNGKey(3), jnp.asarray(rd))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(rd)))
    enc = tloc.LocationEncoder(out_dim=48, head=head)
    enc.load_state_dict(params_from_jax(params))  # strict: the flax auto-names
    with torch.no_grad():
        got = enc(torch.from_numpy(rd))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tloc.normalize_ra_dec(torch.from_numpy(rd)).numpy(),
                               np.asarray(jloc.normalize_ra_dec(jnp.asarray(rd))), atol=1e-7)


def test_location_encoder_init_bounds():
    """The SIREN uniform inits: first layer U(±1/fan_in) (its bias U(±1/8),
    JAX reading the bias's own width as fan-in), the output layer
    U(±sqrt(6/fan_in)) (w0 = 1)."""
    enc = tloc.LocationEncoder(out_dim=48)
    for m in enc.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    first, out = enc.SirenNet_0.SirenLayer_0.Dense_0, enc.SirenNet_0.SirenLayer_1.Dense_0
    assert first.kernel.shape == (25, 8) and out.kernel.shape == (8, 48)
    top = {n: float(p.detach().abs().max()) for n, p in enc.named_parameters()}
    assert top["SirenNet_0.SirenLayer_0.Dense_0.kernel"] <= 1 / 25
    assert top["SirenNet_0.SirenLayer_0.Dense_0.bias"] <= 1 / 8
    assert top["SirenNet_0.SirenLayer_1.Dense_0.kernel"] <= (6 / 8) ** 0.5
    assert top["SirenNet_0.SirenLayer_1.Dense_0.bias"] <= (6 / 48) ** 0.5
    assert top["SirenNet_0.SirenLayer_0.Dense_0.kernel"] > 0.5 / 25


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_the_stored_path_exactly(dtype):
    """``remat`` (checkpointed blocks, both stashes off) against the same
    model without remat and with both stashes off: the same loss and the
    same gradient on every parameter, bit for bit, with the RA/Dec token."""
    params = _jax_params(2, ra_dec=True)
    rng = np.random.default_rng(10)
    imgs = torch.from_numpy(rng.normal(size=(4, 3, 16, 16)).astype(np.float32))
    mask = torch.from_numpy((rng.random((4, 3, 16, 16)) < 0.5).astype(np.float32))
    rd = torch.from_numpy(_ra_dec(4, 11))
    runs = []
    for remat in (True, False):
        model = _port_model(params, dtype, ra_dec=True, remat=remat, stash=False).train()
        blocks = [getattr(model.encoder, f"block{i}") for i in range(model.encoder.depth)]
        assert all(not b.stash and not b.ffn.stash for b in blocks)
        loss = model(imgs, mask, ra_dec=rd)[0]
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    for name, g in ga.items():
        if name == "mask_token":
            continue
        assert torch.equal(g, gb[name]), name
    assert float(ga["ra_dec_embed.SirenNet_0.SirenLayer_0.Dense_0.kernel"].abs().max()) > 0
@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.ini"))))
def test_load_config_matches_jax(path):
    name = os.path.splitext(os.path.basename(path))[0]
    ours = load_config(name, os.path.join(REPO, "configs"))
    ref = jax_load_config(name, os.path.join(REPO, "configs"))
    assert ours.sections() == ref.sections()
    for s in ref.sections():
        assert dict(ours[s].items()) == dict(ref[s].items())
    assert ours.pretrained_mae_name() == ref.pretrained_mae_name()


def test_port_imports_neither_jax_nor_the_jax_package():
    import pkgutil

    import sky_embeddings_tpu_torch as pkg

    # simscore_triton imports triton at module level; it is imported only on
    # the CUDA path, and this host has no triton
    mods = [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if not m.name.endswith("simscore_triton")
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'sky_embeddings_tpu' or m.startswith('sky_embeddings_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    assert len(mods) >= 15
    for new in ("data.fits_io", "data.fits_loader", "sky_sim_search", "eval.bank",
                "eval.simsearch", "ops.kernels.simscore", "ops.kernels.attention", "eval.probe",
                "eval.linear_probe", "models.predictor", "train.predictor", "data.device_cache",
                "utils.plotting", "train_predictor", "test_predictor", "semantic_validation",
                "ops.jepa_masks", "models.jepa", "train.jepa", "pretrain_jepa", "models.cosmos",
                "data.prefetch", "data.mask_generator", "jepa_validation", "parallel.distributed",
                "parallel.mesh", "parallel.zero", "parallel.smoke", "parallel.sharding",
                "cluster.queue_gpu",
                "cluster.launch_pretraining", "cluster.launch_predictor", "data_processing",
                "data_processing.combine", "data_processing.create_h5",
                "data_processing.cross_match", "data_processing.dedup",
                "data_processing.probe_sets", "data_processing.resolution",
                "data_processing.split"):
        assert f"{pkg.__name__}.{new}" in mods
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = load_config("mim_tiny", os.path.join(REPO, "configs"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mim_model(cfg)
    assert build_mim_model(cfg, device="cpu").cls_token.device.type == "cpu"


def test_unported_model_options_raise():
    from sky_embeddings_tpu_torch.configuration import Config

    base = {"TRAINING": {}, "ARCHITECTURE": dict(
        img_size=16, num_channels=3, embed_dim=48, patch_size=4, model_type="simmim")}
    # both ported: with no process group, zero_optimizer is plain AdamW, and
    # tensor_parallel = 2 meets JAX's create_mesh error on one device
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    for over in ({"tensor_parallel": "2"}, {"zero_optimizer": "True"}):
        training = dict(batch_size=2, total_batch_iters=1, init_lr=1e-3, final_lr_factor=10.0,
                        weight_decay=0.05, **over)
        cfg = Config.from_dict({**base, "DATA": {}, "TRAINING": training})
        if "zero_optimizer" in over:
            assert type(MIMPretrainer(cfg, device="cpu").optimizer) is torch.optim.AdamW
            continue
        with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
            MIMPretrainer(cfg, device="cpu")
    # the scan layout is a naming layer: scan_blocks builds the loop layout,
    # and weights stacked over the blocks (encoder.blocks.block.*) load into it
    for arch in ({"scan_blocks": "True"}, {"model_type": "base", "scan_blocks": "True"}):
        cfg = Config.from_dict({**base, "ARCHITECTURE": {**base["ARCHITECTURE"], **arch}})
        model = build_mim_model(cfg, device="cpu")
        loop = build_mim_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        sd = loop.state_dict()
        blocks = [k for k in sd if k.startswith("encoder.block")]
        stacked = {k: v for k, v in sd.items() if k not in blocks}
        for leaf in {k.split(".", 2)[2] for k in blocks}:
            stacked["encoder.blocks.block." + leaf] = torch.stack(
                [sd[f"encoder.block{i}.{leaf}"] for i in range(model.encoder.depth)])
        model.load_state_dict(stacked)
        for k, v in sd.items():
            assert torch.equal(model.state_dict()[k], v), k
    # the MAE model types build (tests/test_torch_mae.py holds them to JAX),
    # and attn_pool builds the pooled SimMIM (tests/test_torch_attention.py);
    # MAE ignores attn_pool, as JAX does
    cfg = Config.from_dict({**base, "ARCHITECTURE": {**base["ARCHITECTURE"], "model_type": "base"}})
    assert not build_mim_model(cfg, device="cpu").simmim
    for model_type, pooled in (("simmim", True), ("base", False)):
        arch = {**base["ARCHITECTURE"], "model_type": model_type, "attn_pool": "True"}
        assert build_mim_model(Config.from_dict({**base, "ARCHITECTURE": arch}),
                               device="cpu").pooled == pooled
