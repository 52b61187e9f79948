"""The port's reconstruction preview and the trainers' figures on the CPU:
``eval/eval_fns.mim_reconstruct`` against JAX ``eval_fns.mim_reconstruct``
from the same params (``models/weights.params_from_jax``) and JAX's own
mask draw fed to the port, for SimMIM with ``norm_pix_loss`` on and off and
for MAE (packed encoder, ``norm_pix_loss``), at depth 2, D = 48, fp32
(prediction atol 1e-5, NaN positions of the masked input equal, the
original equal); ``train_network`` with ``fig_dir`` writing the progress,
reconstruction and all-band PNGs JAX's names, its losses and parameters
bit-equal to the run without ``fig_dir``; and the predictor loop's progress
PNG, bit-equal likewise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sky_embeddings_tpu.eval.eval_fns import mim_reconstruct as jax_reconstruct
from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu.ops.masking import simmim_batch_mask as jax_simmim_mask
from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
from sky_embeddings_tpu_torch.eval.eval_fns import mim_reconstruct
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.mim import SkyMIM
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, train_predictor_network
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
# img 32, patch 4: 64 patches; MAE keeps 16 (n = 17 tokens, four packed a sequence)
GEOM = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4,
            pixel_mean=0.2, pixel_std=1.5)
MAE = dict(simmim=False, decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
           pack_tokens=4, norm_pix_loss=True)
CASES = {"simmim": dict(norm_pix_loss=False), "simmim_norm_pix": dict(norm_pix_loss=True),
         "mae": MAE}


def _batch(B=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 3, 32, 32)).astype(np.float32) * 1.5 + 0.2
    x[0, 1] = np.nan  # a whole NaN band
    x[2, 0, :3, :3] = np.nan
    return {"cutouts": x, "ra_dec": np.zeros((B, 2), np.float32)}


def _models(kw, seed=0):
    """The JAX model, its params (every leaf perturbed) and the port's model
    holding them."""
    jmodel = JaxSkyMIM(**GEOM, **kw)
    x = jnp.asarray(_batch(4)["cutouts"])
    extra = ({"mae_noise": jnp.asarray(np.random.default_rng(0).random((4, 64), np.float32))}
             if not jmodel.simmim else {"mask": jnp.zeros_like(x)})
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), x, **extra)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    model = SkyMIM(**GEOM, **kw)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("case", list(CASES))
def test_mim_reconstruct_matches_jax(case):
    jmodel, params, model = _models(CASES[case])
    batch = _batch()
    key = jax.random.PRNGKey(5)
    want = jax_reconstruct(jmodel, {"params": params}, batch, key, max_mask_ratio=0.6)
    B, g, p = 8, 8, 4
    if model.simmim:  # JAX's draw, as its mim_reconstruct makes it
        mask = np.array(jax_simmim_mask(key, B, 3, 32, p, 0.6))
    else:  # JAX's token mask: the patches whose every pixel is NaN in its masked input
        nan = np.isnan(want[1]).reshape(B, g, p, g, p, 3)
        mask = nan.all(axis=(2, 4, 5)).reshape(B, g * g).astype(np.float32)
        assert (mask.sum(1) == 48).all()
    got = mim_reconstruct(model, batch, mask=mask)
    for a, b in zip(got, want):
        assert a.shape == (B, 32, 32, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # the prediction only fills the masked pixels
    keep = ~np.isnan(got[1])
    np.testing.assert_array_equal(got[0][keep], got[2][keep])
    assert np.isfinite(got[0][np.isnan(got[1]) & ~np.isnan(got[2])]).all()


def test_mim_reconstruct_draws_from_its_generator():
    """Without ``mask`` the draw comes from ``generator`` alone: the same seed
    gives the same preview, another seed another mask; SimMIM masks at
    ``max_mask_ratio`` at most; an MAE token mask of the wrong count is
    refused."""
    for kw in CASES.values():
        model = SkyMIM(**GEOM, **kw).eval()
        model.reset_parameters(torch.Generator().manual_seed(0))
        runs = [mim_reconstruct(model, _batch(), torch.Generator().manual_seed(s),
                                max_mask_ratio=0.5) for s in (3, 3, 4)]
        for a, b in zip(runs[0], runs[1]):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(np.isnan(runs[0][1]), np.isnan(runs[2][1]))
        if model.simmim:
            masked = np.isnan(runs[0][1]) & ~np.isnan(runs[0][2])
            assert masked.reshape(8, -1).mean(1).max() <= 0.5 + 1e-6
    with pytest.raises(ValueError, match="removes 48 of 64"):
        mim_reconstruct(model, _batch(), mask=np.zeros((8, 64), np.float32))


def _tiny_trainer(seed=1):
    return MIMPretrainer(load_config("mim_tiny", CONFIGS), dtype=torch.float32, seed=seed,
                         device="cpu")


class _Val(list):
    def take(self, n):
        return iter(self[:n])


def test_train_network_figures_bit_equal(tmp_path, monkeypatch):
    """mim_tiny at depth 2, 4 steps validating every 2: with ``fig_dir`` the
    loop writes ``m_progress.png``, ``m_4iters.png`` and ``m_4iters_tiled.png``
    (the first validation draws nothing, as JAX's), and its losses and
    parameters are bit-equal to the run without ``fig_dir``."""
    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    x = make_cutouts(6 * 16, channels=3, img_size=16, seed=4)["cutouts"]
    batches = [{"cutouts": x[i * 16:(i + 1) * 16]} for i in range(6)]
    runs = []
    for figs in (str(tmp_path / "figs"), None):
        if figs:
            os.makedirs(figs)
        tr = _tiny_trainer()
        train_network(tr, iter(batches[:4]), _Val(batches[4:]), 4, 2, 100.0,
                      str(tmp_path / f"m{len(runs)}" / "m.ckpt.pt"), fig_dir=figs,
                      log_fn=lambda m: None)
        runs.append(tr)
    assert sorted(os.listdir(tmp_path / "figs")) == [
        "m_4iters.png", "m_4iters_tiled.png", "m_progress.png"]
    for f in os.listdir(tmp_path / "figs"):
        assert os.path.getsize(tmp_path / "figs" / f) > 1000
    assert runs[0].losses == runs[1].losses and runs[0].losses["batch_iters"] == [2, 4]
    for (name, a), b in zip(runs[0].model.state_dict().items(),
                            runs[1].model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(runs[0].mask_gen.get_state(), runs[1].mask_gen.get_state())


def test_predictor_loop_progress_figure(tmp_path, monkeypatch):
    """``train_predictor_network`` with ``fig_dir``: ``p_progress.png`` after
    the second validation, losses and parameters bit-equal to the run
    without it."""
    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    mim = Config.from_dict({"DATA": {}, "TRAINING": dict(
        batch_size=8, total_batch_iters=5, weight_decay=0.05, init_lr=1e-3, final_lr_factor=1e4,
        loss_fn="L1"), "ARCHITECTURE": dict(img_size=16, num_channels=3, embed_dim=48,
                                           patch_size=4, model_type="simmim")})
    pred = Config.from_dict({"DATA": dict(label_keys="['zspec']", label_means="[0.64]",
                                          label_stds="[0.5]"),
                             "TRAINING": dict(train_method="ft", pretained_mae="mim_t",
                                              batch_size=8, total_batch_iters=4, layer_decay=0.75,
                                              weight_decay=1e-3, init_lr=2e-3, final_lr_factor=10.0,
                                              augment=True, loss_fn="mse"),
                             "ARCHITECTURE": dict(img_size=16, global_pool="map")})
    s = make_structured_cutouts(6 * 8, channels=3, img_size=16, seed=6)
    batches = [{"cutouts": s["cutouts"][i:i + 8], "labels": s["zspec"][i:i + 8, None]}
               for i in range(0, 48, 8)]
    runs = []
    for figs in (str(tmp_path), None):
        tr = PredictorTrainer(pred, mim, seed=2, device="cpu")
        train_predictor_network(tr, iter(batches[:4]), batches[4:], 2, 100.0,
                                str(tmp_path / f"p{len(runs)}.ckpt.pt"), fig_dir=figs,
                                log_fn=lambda m: None)
        runs.append(tr)
    assert os.path.getsize(tmp_path / "p0_progress.png") > 1000
    assert not (tmp_path / "p1_progress.png").exists()
    assert runs[0].losses == runs[1].losses
    for a, b in zip(runs[0].model.state_dict().values(), runs[1].model.state_dict().values()):
        assert torch.equal(a, b)
