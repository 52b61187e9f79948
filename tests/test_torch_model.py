"""The port's model and package boundary against the JAX package: weights
round trip, ``SkyMIM.encode`` parity (fp32 atol 1e-5, bf16 max-rel 2e-2),
config parsing, import hygiene, and the default-device rule."""

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
from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models.mim import SkyMIM, build_mim_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_params(seed=0):
    """Tiny JAX SimMIM params with every leaf perturbed (so biases, LN
    scales and the NaN fill values all matter), as a numpy tree."""
    model = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params
    )


def _port_model(params, dtype):
    model = SkyMIM(**TINY, dtype=_TDT[dtype])
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def test_params_round_trip_exact():
    params = _jax_params()
    sd = params_from_jax(params)
    model = SkyMIM(**TINY)
    model.load_state_dict(sd)  # strict: every leaf has a home, no extras
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    params = _jax_params(1)
    rng = np.random.default_rng(7)
    imgs = rng.normal(size=(4, 3, 16, 16)).astype(np.float32)
    imgs[0, 1] = np.nan  # whole-band NaNs
    imgs[2, 0] = np.nan
    mask = (rng.random((4, 3, 16, 16)) < 0.3).astype(np.float32)
    jmodel = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                       dtype=_JDT[dtype])
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(imgs), mask=jnp.asarray(mask),
                              method=JaxSkyMIM.encode)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    with torch.inference_mode():
        got, _, _ = _port_model(params, dtype).encode(torch.from_numpy(imgs), mask=torch.from_numpy(mask))
    assert got.dtype == _TDT[dtype] and got.shape == want.shape == (4, 17, 48)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, f"max-rel {rel:.3g}"


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
    for arch in ({"model_type": "base"}, {"ra_dec": "True"}, {"attn_pool": "True"}):
        cfg = Config.from_dict({**base, "ARCHITECTURE": {**base["ARCHITECTURE"], **arch}})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_mim_model(cfg, device="cpu")
