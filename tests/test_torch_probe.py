"""The port's training-time linear probes against the JAX package, on the
CPU: the structured synthetic survey bit-equal to JAX's; the probe fits
(``eval/probe.py``) against ``eval/probe_jax.py`` on the same features;
``pool_features`` in all six modes; ``extract_latents`` of an attn-pooled
model (the prefix kept) and with ``augment_params`` against JAX's with the
same draws; ``linear_probe`` end to end on a small structured file against
JAX's, on both backends; and the trainer's probes (``train_network``,
in-memory probe sets) and the ``pretrain_mim`` twin writing ``val_lp_acc`` /
``val_lp_r2`` into the checkpoint's losses.

Bars: the fits as tests/test_probe_jax.py holds JAX's to sklearn (accuracy
0.02, R² 0.01 well-conditioned and 0.06 over-parametrised); features 1e-5
(fp32 encoder, tests/test_torch_model.py).
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.data import synthetic as jsyn
from sky_embeddings_tpu.eval import eval_fns as jeval
from sky_embeddings_tpu.eval import linear_probe as jlp
from sky_embeddings_tpu.eval import probe_jax
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.data import synthetic as tsyn
from sky_embeddings_tpu_torch.eval import eval_fns as teval
from sky_embeddings_tpu_torch.eval import linear_probe as tlp
from sky_embeddings_tpu_torch.eval import probe
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer, train_network
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


# -- the structured survey ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=40, channels=5, img_size=16, seed=3),
    dict(n=37, channels=3, img_size=24, seed=5, nan_band_frac=0.2),
    dict(n=30, channels=4, img_size=16, seed=1, class_fracs=(0.5, 0.5, 0.0), z_range=(0.1, 1.0)),
])
def test_structured_cutouts_bit_equal_to_jax(kw):
    a, b = tsyn.make_structured_cutouts(**kw), jsyn.make_structured_cutouts(**kw)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert np.isnan(a["cutouts"]).any() and len(set(a["class"].tolist())) >= 2


def test_write_structured_h5_bit_equal_to_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    paths = [str(tmp_path / f"{w}.h5") for w in ("port", "jax")]
    tsyn.write_structured_h5(paths[0], 50, channels=3, img_size=16, seed=2, chunk=20)
    jsyn.write_structured_h5(paths[1], 50, channels=3, img_size=16, seed=2, chunk=20)
    with h5py.File(paths[0]) as fa, h5py.File(paths[1]) as fb:
        assert set(fa) == set(fb) and len(fa["cutouts"]) == 50
        for k in fb:
            np.testing.assert_array_equal(fa[k][:], fb[k][:])


# -- the fits ----------------------------------------------------------------------

def _class_data(n=600, d=32, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, size=(k, d))
    y = rng.integers(0, k, size=n)
    x = centers[y] + rng.normal(0, 1.5, size=(n, d))
    return x.astype(np.float32), y.astype(np.int64)


def _reg_data(n=600, d=32, seed=0, d_inf=None, noise=0.5):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, size=d)
    if d_inf is not None:
        w[d_inf:] = 0.0
    x = rng.normal(0, 1.0, size=(n, d))
    y = x @ w + rng.normal(0, noise, size=n)
    return x.astype(np.float32), y.astype(np.float32)


def test_split_and_standardize_match_jax():
    for n in (5, 137, 4800):
        for a, b in zip(probe.split_indices(n), probe_jax.split_indices(n)):
            np.testing.assert_array_equal(a, b)
    x, _ = _reg_data(n=100, d=5)
    x[:, 2] = 3.0  # zero-variance feature
    np.testing.assert_allclose(probe.standardize(x).numpy(), np.asarray(probe_jax.standardize(x)),
                               atol=1e-6)


def test_ridge_fit_matches_jax():
    x, y = _reg_data(n=200, d=16, seed=4)
    w, b = probe.ridge_fit(x, y)
    wj, bj = probe_jax.ridge_fit(x, y)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(float(b), float(bj), atol=1e-4)


def test_logistic_probe_matches_jax():
    x, y = _class_data()
    got, want = probe.probe_classification(x, y), probe_jax.probe_classification(x, y)
    assert got.keys() == want.keys() == {"train_lp_acc", "val_lp_acc"}
    assert abs(got["val_lp_acc"] - want["val_lp_acc"]) <= 0.02
    assert abs(got["train_lp_acc"] - want["train_lp_acc"]) <= 0.02
    assert got["train_lp_acc"] > 0.6
    # the fitted models predict alike
    xs = probe.standardize(x)
    params = probe.logistic_fit(xs, y, 3)
    jparams = probe_jax.logistic_fit(np.asarray(xs), y, 3)
    agree = (probe.logistic_predict(params, xs).numpy()
             == np.asarray(probe_jax.logistic_predict(jparams, np.asarray(xs)))).mean()
    assert agree >= 0.98


@pytest.mark.parametrize("regime,bar", [("well_conditioned", 0.01), ("overparametrized", 0.06)])
def test_enet_probe_matches_jax(regime, bar):
    """FISTA on sklearn's elastic-net objective, in both of
    tests/test_probe_jax.py's regimes (the over-parametrised one is the
    probe's real one: more features than informative samples)."""
    if regime == "well_conditioned":
        x, y = _reg_data()
    else:
        x, y = _reg_data(n=480, d=640, seed=3, d_inf=12, noise=1.0)
    got, want = probe.probe_regression(x, y), probe_jax.probe_regression(x, y)
    assert got.keys() == want.keys() == {"train_lp_r2", "val_lp_r2"}
    assert abs(got["val_lp_r2"] - want["val_lp_r2"]) <= bar
    assert abs(got["train_lp_r2"] - want["train_lp_r2"]) <= bar
    if regime == "well_conditioned":
        # the same FISTA iterates; over-parametrised, 1000 steps leave the
        # iterate short of the optimum and fp32 sums steer it apart
        xs = probe.standardize(x)
        tr, _ = probe.split_indices(len(y))
        w, _ = probe.enet_fit(xs[tr], y[tr])
        wj, _ = probe_jax.enet_fit(np.asarray(xs)[tr], y[tr])
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=2e-3)
    assert float(probe.r2_score(y, y)) == 1.0


def test_probes_run_without_sklearn(monkeypatch):
    for mod in list(sys.modules):
        if mod == "sklearn" or mod.startswith("sklearn."):
            monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    x, y = _class_data(n=200, d=8)
    assert 0.0 <= probe.probe_classification(x, y)["val_lp_acc"] <= 1.0
    xr, yr = _reg_data(n=200, d=8)
    assert probe.probe_regression(xr, yr)["val_lp_r2"] <= 1.0


@pytest.mark.parametrize("combine", ["token", "flatten", "pool", "centralpool", "central", "mean"])
def test_pool_features_match_jax(combine):
    lat = np.random.default_rng(6).normal(size=(5, 64, 12)).astype(np.float32)
    want = np.asarray(jlp.pool_features(jnp.asarray(lat), combine))
    # selections are exact; the mean sums in another order
    np.testing.assert_allclose(tlp.pool_features(lat, combine), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tlp.pool_features(torch.from_numpy(lat), combine).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="combine"):
        tlp.pool_features(lat, "nope")


# -- extraction and the probe end to end --------------------------------------------

def _models(monkeypatch, attn_pool=False, seed=0):
    """mim_tiny (or with attn_pool) cut to depth 2 in both frameworks, from
    the same perturbed params: (JAX model, its variables, port model)."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
    base = jax_load_config("mim_tiny", CONFIGS)
    d = {sec: dict(base[sec].items()) for sec in base.sections()}
    d["ARCHITECTURE"]["attn_pool"] = str(attn_pool)
    jmodel = jax_build_mim_model(JaxConfig.from_dict(d), dtype=jnp.float32)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    model = port_mim.build_mim_model(Config.from_dict(d), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jmodel, {"params": params}, model


def _labelled(data, key, bs=32):
    rd = np.stack([data["ra"], data["dec"]], 1)
    return [{"cutouts": data["cutouts"][i:i + bs], "ra_dec": rd[i:i + bs],
             "labels": data[key][i:i + bs]} for i in range(0, len(rd), bs)]


def test_extract_latents_of_an_attn_pooled_model_keeps_the_token(monkeypatch):
    jmodel, variables, model = _models(monkeypatch, attn_pool=True)
    data = tsyn.make_structured_cutouts(40, channels=3, img_size=16, seed=4)
    batches = _labelled(data, "class", bs=16)
    got = teval.extract_latents(model, batches)  # remove_prefix=True is overridden
    want = jeval.extract_latents(jmodel, variables, batches)
    assert got.shape == want.shape == (40, 1, 48)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    on_dev = teval.extract_latents(model, batches, to_host=False)
    assert torch.is_tensor(on_dev) and np.array_equal(on_dev.numpy(), got)


def test_extract_latents_augment_params_match_jax(monkeypatch):
    """``augment_params={"nan_channels": 0}`` reaches every augmentation: the
    port's ``augment_batch`` is fed JAX's draws for the keys JAX's
    ``extract_latents`` splits, so both extract the same latents, and no
    augmented copy loses a band."""
    from sky_embeddings_tpu.data.augment import augment_batch as jax_augment

    jmodel, variables, model = _models(monkeypatch)
    data = tsyn.make_structured_cutouts(8, channels=3, img_size=16, seed=5, nan_band_frac=0.0)
    batches = _labelled(data, "class", bs=4)
    A, params = 3, {"nan_channels": 0}
    seen, key = [], jax.random.PRNGKey(0)

    def fake_augment(gen, imgs, **kw):
        nonlocal key
        seen.append(kw)
        key, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax_augment(sub, jnp.asarray(imgs.numpy()), **kw)))

    monkeypatch.setattr(teval, "augment_batch", fake_augment)
    got, imgs = teval.extract_latents(model, batches, apply_augmentations=True, num_augmentations=A,
                                      augment_params=params, return_images=True)
    want, jimgs = jeval.extract_latents(jmodel, variables, batches, apply_augmentations=True,
                                        num_augmentations=A, key=jax.random.PRNGKey(0),
                                        augment_params=params, return_images=True)
    assert seen == [params] * (A * len(batches))
    assert got.shape == want.shape == (8 * (1 + A), 16, 48)
    np.testing.assert_allclose(imgs, jimgs, atol=1e-6)
    assert not np.isnan(imgs).any()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("attn_pool", [False, True])
def test_linear_probe_end_to_end_matches_jax(monkeypatch, tmp_path, attn_pool):
    """``linear_probe`` on a 480-cutout structured file (classes and zspec in
    the same file, as mim_tiny's ``tiny_probe.h5``) with ``central`` pooling
    (an attn-pooled model probes its one token): the torch backend against
    JAX's on-device probe, the sklearn backend against JAX's sklearn path,
    from the same weights."""
    pytest.importorskip("h5py")
    pytest.importorskip("sklearn")
    jmodel, variables, model = _models(monkeypatch, attn_pool=attn_pool, seed=1)
    path = str(tmp_path / "probe.h5")
    tsyn.write_structured_h5(path, 480, channels=3, img_size=16, seed=6)
    kw = dict(combine="central", img_size=16)
    x, y = tlp.probe_features(model, path, "zspec", **kw)
    xj, yj = jlp.probe_features(jmodel, variables, path, "zspec", **kw)
    assert x.shape == xj.shape == (480, 48 if attn_pool else 4 * 48)
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-4)
    np.testing.assert_array_equal(y, yj)
    got = tlp.linear_probe(model, path, path, **kw)
    want = jlp.linear_probe(jmodel, variables, path, path, **kw)
    assert got.keys() == want.keys() == {"train_lp_acc", "val_lp_acc", "train_lp_r2", "val_lp_r2"}
    assert abs(got["val_lp_acc"] - want["val_lp_acc"]) <= 0.02
    assert abs(got["val_lp_r2"] - want["val_lp_r2"]) <= 0.06
    got_sk = tlp.linear_probe(model, path, path, backend="sklearn", **kw)
    want_sk = jlp.linear_probe(jmodel, variables, path, path, backend="sklearn", **kw)
    for k in want_sk:
        assert abs(got_sk[k] - want_sk[k]) <= 0.02, k
    # the in-memory form (what the card host, without h5py, probes) gives the
    # same features as the file
    data = tsyn.make_structured_cutouts(64, channels=3, img_size=16, seed=7)
    data["cutouts"] = np.maximum(data["cutouts"], -3.0)  # the h5 batcher's clip
    xm, ym = tlp.probe_features(model, _labelled(data, "class"), "class", **kw)
    assert ym.dtype == np.int64 and np.array_equal(ym, data["class"])
    xl, _ = tlp.probe_features(model, _labelled(data, "class", bs=64), "class", **kw)
    np.testing.assert_allclose(xm, xl, atol=1e-5)


def test_train_network_runs_the_probes_from_memory(monkeypatch, tmp_path):
    """``train_network`` with in-memory probe sets (lists of labelled
    batches): the probes run at every ``verbose_iters`` after validation,
    their metrics land in the losses and the log line, and the checkpoint
    keeps them."""
    for mod in (port_mim,):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
    base = jax_load_config("mim_tiny", CONFIGS)
    d = {sec: dict(base[sec].items()) for sec in base.sections()}
    d["ARCHITECTURE"]["attn_pool"] = "True"
    d["TRAINING"]["total_batch_iters"] = "4"
    trainer = MIMPretrainer(Config.from_dict(d), dtype=torch.float32, device="cpu")
    train = tsyn.make_cutouts(64, channels=3, img_size=16, seed=2)
    batches = [{"cutouts": train["cutouts"][i:i + 16]} for i in range(0, 64, 16)]
    sets = {k: _labelled(tsyn.make_structured_cutouts(120, channels=3, img_size=16, seed=s), k)
            for k, s in (("class", 8), ("zspec", 9))}
    logs = []
    path = str(tmp_path / "pooled.ckpt.pt")
    train_network(trainer, iter(batches), None, 4, 2, 100.0, path,
                  lp_class_data_file=sets["class"], lp_regress_data_file=sets["zspec"],
                  lp_combine="central", log_fn=logs.append)
    losses = load_checkpoint(path)["losses"]
    assert losses["batch_iters"] == [2, 4]
    for k in ("train_lp_acc", "val_lp_acc", "train_lp_r2", "val_lp_r2"):
        assert len(losses[k]) == 2 and np.isfinite(losses[k]).all(), k
    assert all(0.0 <= a <= 1.0 for a in losses["val_lp_acc"])
    assert "lp acc" in logs[-2] and "lp r2" in logs[-2]


def test_pretrain_cli_twin_writes_the_probe_metrics(tmp_path, monkeypatch, capsys):
    """``python -m sky_embeddings_tpu_torch.pretrain_mim mim_tiny --device cpu
    --set ARCHITECTURE.attn_pool=True`` at depth 2 with mim_tiny's probe file
    (``tiny_probe.h5``, ``lp_combine = central``): the checkpoint's losses
    hold ``val_lp_acc`` and ``val_lp_r2`` at each of the two validations."""
    from sky_embeddings_tpu_torch import pretrain_mim

    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    tsyn.write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    tsyn.write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    tsyn.write_structured_h5(str(data / "tiny_probe.h5"), 160, channels=3, img_size=16, seed=3)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    path = pretrain_mim.main(["mim_tiny", "-v", "20", "-ct", "100", "-dd", str(data), "--device", "cpu",
                              "--set", "ARCHITECTURE.attn_pool=True", "--run_name", "tiny_pooled"])
    out = capsys.readouterr().out
    assert "lp acc" in out and "lp r2" in out
    losses = load_checkpoint(path)["losses"]
    assert len(losses["val_lp_acc"]) == len(losses["val_lp_r2"]) == 2
    assert np.isfinite(losses["val_lp_r2"]).all()
