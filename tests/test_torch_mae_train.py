"""The port's MAE trainer and CLI twins against the JAX package on the CPU:
three AdamW steps of ``configs/mae_tiny.ini`` cut to depth 2 (packed
encoder; the decoder's recompute and stash backwards; remat) against JAX +
optax from the same params, batches and noise; the trainer's validation
noise and checkpoint; the ``pretrain_mim`` twin on ``mae_tiny`` with the
serving twin restoring and serving its checkpoint; and the twin's FITS
training data (``train_data_paths``, no ``train_data_file``): ``mim_tiny``
on FITS tiles, and the docstring's documented ``--set`` commands (MAE at
ViT-B from ``mim_1``, ViT-H from ``mim_32``) cut to depth 2 and a few
steps, on FITS tiles as the production configs train.

Bars: training losses 1e-5 relative and params 1e-4 absolute after three
steps (tests/test_torch_train.py).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data import fits_io
from sky_embeddings_tpu_torch.data.synthetic import (
    make_cutouts,
    write_structured_h5,
    write_synthetic_h5,
)
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU models here are tiny: one thread runs them fastest, and it
    keeps the test workers that share the cores from spinning OpenMP pools
    against each other (the CLI twins ran 20-60x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- training -------------------------------------------------------------------

# the trainer paths: configs/mae_tiny.ini (maesimple; the decoder's stash
# off: K2 and kernel 4's plain versions), with its decoder stash on, and
# with remat; pack 4 at batch 16 (n = 5, N = 20)
TRAIN_PATHS = {
    "mae_tiny": {},
    "stash_decoder": {"ARCHITECTURE": {"stash_decoder": "True"}},
    "remat": {"TRAINING": {"remat": "True"}},
}


def _configs(path):
    base = jax_load_config("mae_tiny", CONFIGS)
    over = TRAIN_PATHS[path]
    d = {sec: {**dict(base[sec].items()), **over.get(sec, {})} for sec in base.sections()}
    return JaxConfig.from_dict(d), Config.from_dict(d)


@pytest.mark.parametrize("path", list(TRAIN_PATHS))
def test_three_adamw_steps_of_mae_match_jax(path, monkeypatch):
    """Three AdamW steps (fp32) of ``mae_tiny`` cut to depth 2 in both
    frameworks, from the same params, batches (with NaN bands) and noise:
    JAX ``SkyMIM.apply`` + ``pretrain_optimizer`` + optax against
    ``MIMPretrainer.train_batch(noise=...)``. The encoder runs packed (four
    samples of 5 tokens a sequence); every parameter, the mask token and the
    decoder included, moves. Bars as tests/test_torch_train.py."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
    jcfg, cfg = _configs(path)
    jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32, remat=jcfg.training.bool("remat", False))
    assert jmodel.pack_tokens == 4 and not jmodel.simmim
    data = make_cutouts(48, channels=3, img_size=16, seed=8)
    assert np.isnan(data["cutouts"]).any()
    rng = np.random.default_rng(8)
    noises = [rng.random((16, 16)).astype(np.float32) for _ in range(3)]
    x0 = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x0, mae_noise=jnp.zeros((2, 16)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, jcfg.training.int("total_batch_iters"), 1e7),
                                0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def jstep(p, s, x, nz):
        loss, grads = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, mae_noise=nz)[0])(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    trainer = MIMPretrainer(cfg, dtype=torch.float32, seed=0, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params))
    assert trainer.model.encoder.depth == 2 and trainer.max_mask_ratio is None
    assert trainer.model.encoder.remat == (path == "remat")
    for i, nz in enumerate(noises):
        batch = {"cutouts": data["cutouts"][16 * i:16 * (i + 1)]}
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.maximum(jnp.asarray(batch["cutouts"]), -3.0),
                                     jnp.asarray(nz))
        loss = trainer.train_batch(batch, noise=torch.from_numpy(nz))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _flat(jp)
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got) == set(want)
    start = _flat(params)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=0, atol=1e-4, err_msg=name)
        assert np.abs(got[name] - start[name]).max() > 1e-4, name  # every leaf moves


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_mae_validation_masks_vary_and_checkpoint_keeps_the_stream(tmp_path):
    """Validation noise is seeded by (seed, step, idx) and leaves the training
    stream alone; save/restore keeps the generator, so a restored trainer
    draws the same next noise."""
    cfg = load_config("mae_tiny", CONFIGS)
    trainer = MIMPretrainer(cfg, dtype=torch.float32, seed=0, device="cpu")
    drawn = []
    draw = trainer.draw_noise
    trainer.draw_noise = lambda b, g: drawn.append(draw(b, g)) or drawn[-1]
    batch = {"cutouts": make_cutouts(16, channels=3, img_size=16, seed=9)["cutouts"]}
    for idx in (0, 1, 0):
        assert np.isfinite(float(trainer.eval_batch(batch, idx=idx)))
    trainer.train_batch(batch)
    val0, val1, val0_again, train0 = drawn
    assert val0.shape == (16, 16)
    assert torch.equal(val0, val0_again) and not torch.equal(val0, val1)
    fresh = MIMPretrainer(cfg, dtype=torch.float32, seed=0, device="cpu")
    assert torch.equal(fresh.draw_noise(16, fresh.mask_gen), train0)
    path = str(tmp_path / "mae_tiny.ckpt.pt")
    trainer.save(path)
    other = MIMPretrainer(cfg, dtype=torch.float32, seed=5, device="cpu")
    assert other.restore(path) and other.cur_iter == 1
    assert torch.equal(other.draw_noise(16, other.mask_gen), draw(16, trainer.mask_gen))


# -- the CLI twins ----------------------------------------------------------------

def test_pretrain_cli_twin_trains_mae_tiny_and_the_serving_twins_serve_it(tmp_path, monkeypatch, capsys):
    """``pretrain_mim mae_tiny --device cpu`` on synthetic h5 files (12
    steps, validation every 6), then the serving twins restore the
    checkpoint and serve the MAE model, with no MAE-specific code:
    ``similarity_search`` (its latents the encoder's unmasked tokens) and
    ``sky_sim_search`` over FITS tiles."""
    from sky_embeddings_tpu_torch import pretrain_mim
    from sky_embeddings_tpu_torch import similarity_search as cli

    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    path = pretrain_mim.main(["mae_tiny", "-v", "6", "-ct", "100", "-dd", str(data), "--device", "cpu",
                              "--set", "TRAINING.total_batch_iters=12"])
    out = capsys.readouterr().out
    assert "Batch Iterations: 12/12" in out and "val loss" in out
    payload = load_checkpoint(path)
    assert payload["step"] == 12 and payload["params"]["mask_token"].shape == (1, 1, 512)
    assert np.isfinite(payload["losses"]["train_loss"]).all()

    model, _ = cli.build_model_from_config(CONFIGS, str(tmp_path / "models"), "mae_tiny", "cpu")
    for name, value in payload["params"].items():
        assert torch.equal(model.state_dict()[name], value), name
    tgt = f"mae_tgt_{os.getpid()}.h5"
    write_synthetic_h5(str(data / tgt), n=6, channels=3, img_size=16, seed=3)
    monkeypatch.setattr(cli, "REPO_DIR", str(tmp_path))
    res_path = cli.main(["mae_tiny", "-tgt_fn", tgt, "-tst_fn", "tiny_val.h5", "-tgt_i", "[1,2]",
                         "-aug", "False", "-snr", "[-100,100]", "-bs", "8", "-ns", "5",
                         "-dd", str(data), "--device", "cpu"])
    try:
        res = dict(np.load(res_path))
    finally:
        os.remove(res_path)
    assert res["target_features"].shape == (2, 17, 48)  # cls + 16 patches: unmasked
    assert res["test_scores"].shape == (5,) and np.isfinite(res["test_scores"]).all()

    # and the FITS twin, two target groups over FITS tiles in one pass
    from sky_embeddings_tpu_torch import sky_sim_search as sky

    capsys.readouterr()
    monkeypatch.setattr(sky, "REPO_DIR", str(tmp_path))
    tiles = _write_tiles(str(tmp_path / "tiles"), ("G", "R", "I"), size=(64, 72))
    outs = sky.main(["mae_tiny", "-tgt_fn", tgt, "-tgt_i", "[[1,2],[4,5]]", "-aug", "False",
                     "-fits", repr([tiles]), "-bs", "8", "-ns", "5", "-dd", str(data),
                     "--device", "cpu"])
    assert "WARNING" not in capsys.readouterr().out  # the checkpoint was restored
    for out in outs:
        res = dict(np.load(out))
        os.remove(out)
        assert res["target_features"].shape == (2, 17, 48)
        assert res["test_scores"].shape == (5,) and np.isfinite(res["test_scores"]).all()


# -- FITS training data -------------------------------------------------------------

def _write_tiles(root, bands, n_tiles=2, size=(96, 104), calexp=True, seed=3):
    """HSC tiles of ``size`` pixels, one FITS file per band
    (``[calexp-]HSC-<band>-<tract>-<patch>.fits``), TAN WCS cards around RA
    150, Dec 2.2, as tests/test_torch_retrieval.py writes them."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scale = 0.168 / 3600.0
    prefix = "calexp-" if calexp else ""
    for i in range(n_tiles):
        wcs = fits_io.TanWCS(crpix=(30.5, 40.5), crval=(150.1 + 0.01 * i, 2.2),
                             cd=[[-scale, 0.0], [0.0, scale]])
        for c, band in enumerate(bands):
            data = rng.normal(size=size).astype(np.float32) + c
            fits_io.write_image(os.path.join(root, f"{prefix}HSC-{band}-9813-{i},4.fits"), data,
                                wcs.to_cards())
    return root


def test_pretrain_cli_twin_trains_from_fits_tiles(tmp_path, monkeypatch, capsys):
    """``mim_tiny`` without ``train_data_file``: the twin streams its training
    batches from the FITS tiles under ``train_data_paths`` (random windows
    of the tiles, as the JAX twin does), validates on the h5 file, probes on
    the probe file the config names, and saves a checkpoint that holds the
    steps taken."""
    from sky_embeddings_tpu_torch import pretrain_mim

    configs = tmp_path / "configs"
    configs.mkdir()
    with open(os.path.join(CONFIGS, "mim_tiny.ini")) as f:
        text = f.read()
    assert "train_data_file" in text
    (configs / "mim_tiny.ini").write_text(
        "".join(line for line in text.splitlines(True) if not line.startswith("train_data_file")))
    tiles = _write_tiles(str(tmp_path / "tiles"), ("G", "R", "I"), size=(64, 72))
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    write_structured_h5(str(data / "tiny_probe.h5"), 64, channels=3, img_size=16, seed=5)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    path = pretrain_mim.main(["mim_tiny", "-v", "5", "-ct", "100", "-dd", str(data), "--device", "cpu",
                              "--set", f"DATA.train_data_paths=['{tiles}']",
                              "--set", "DATA.cutouts_per_tile=48", "--set", "TRAINING.total_batch_iters=10"])
    out = capsys.readouterr().out
    assert "The training set consists of 2 sky tiles." in out
    assert "Batch Iterations: 10/10" in out and "val loss" in out and "lp acc" in out
    payload = load_checkpoint(path)
    assert payload["step"] == 10 and np.isfinite(payload["losses"]["train_loss"]).all()
    assert len(payload["losses"]["val_lp_r2"]) == 2


# the docstring's documented commands, cut: (config, its --set command, the
# zoo size cut to depth 2, bands on disk, calexp names, what the checkpoint
# holds at full width)
DOCUMENTED = {
    "mae_base": ("mim_1", ["--set", "ARCHITECTURE.model_type=base", "--set", "TRAINING.batch_size=1024",
                           "--run_name", "mae_base"],
                 "base", ("G", "I", "R", "Y", "Z"), True,
                 {"encoder.block1.attn.qkv.kernel": (768, 2304), "decoder.block1.attn.qkv.kernel": (512, 1536),
                  "mask_token": (1, 1, 512)}),
    "vith": ("mim_32", ["--set", "ARCHITECTURE.model_type=mimhuge", "--set", "ARCHITECTURE.embed_dim=1280",
                        "--set", "TRAINING.remat=False", "--run_name", "mim_32_huge"],
             "huge", ("G", "I", "R", "Y", "Z", "NB0387", "NB0816", "NB0921", "NB1010"), False,
             {"encoder.block1.attn.qkv.kernel": (1280, 3840), "mask_token": (1, 1, 1)}),
}


@pytest.mark.parametrize("name", list(DOCUMENTED))
def test_documented_commands_train_from_fits_tiles(name, tmp_path, monkeypatch, capsys):
    """The module docstring's commands, as given, then cut: the zoo depth to
    2 (the MAE decoder too), batch 8, 2 steps, 16 windows a tile, the
    config's bands written as FITS tiles where ``train_data_paths`` points,
    its validation file as a synthetic h5 and its two probe files as small
    structured h5 files, probed on mean-pooled features. The production
    configs name only ``train_data_paths``: before the FITS branch the twin
    refused them."""
    from sky_embeddings_tpu_torch import pretrain_mim

    config, command, size, bands, calexp, shapes = DOCUMENTED[name]
    monkeypatch.setitem(port_mim._SIZES, size, {**port_mim._SIZES[size], "depth": 2, "decoder_depth": 2})
    cfg = load_config(config, CONFIGS)
    assert cfg.data.list("bands") == list(bands) and "train_data_file" not in cfg.data
    (tmp_path / "configs").symlink_to(CONFIGS)
    tiles = _write_tiles(str(tmp_path / "tiles"), bands, n_tiles=1, calexp=calexp)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / cfg.data.str("val_data_file")), n=16, channels=len(bands),
                       img_size=64, seed=4)
    for seed, key in enumerate(("lp_class_data_file", "lp_regress_data_file")):
        write_structured_h5(str(data / cfg.data.str(key)), 32, channels=len(bands), img_size=64,
                            seed=seed)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    path = pretrain_mim.main([config, "-v", "1", "-ct", "100", "-dd", str(data), "--device", "cpu",
                              *command, "--set", "TRAINING.batch_size=8",
                              "--set", "TRAINING.total_batch_iters=2",
                              "--set", f"DATA.train_data_paths=['{tiles}']",
                              "--set", "DATA.cutouts_per_tile=16", "--set", "DATA.lp_combine=mean"])
    out = capsys.readouterr().out
    assert path.endswith(f"{command[-1]}.ckpt.pt")
    assert "1 sky tiles" in out and "Batch Iterations: 2/2" in out and "val loss" in out
    payload = load_checkpoint(path)
    assert payload["step"] == 2 and np.isfinite(payload["losses"]["train_loss"]).all()
    assert len(payload["losses"]["val_lp_acc"]) == len(payload["losses"]["val_lp_r2"]) == 2
    for leaf, shape in shapes.items():
        assert tuple(payload["params"][leaf].shape) == shape, leaf
