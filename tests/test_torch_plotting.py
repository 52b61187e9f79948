"""The port's figures (``sky_embeddings_tpu_torch/utils/plotting.py``) against
the JAX package's ``utils/plotting.py`` on the same numpy inputs: every
drawing function writes a non-empty PNG from inputs JAX's draws from
(``z_plots`` and ``snr_plots`` also return JAX's per-bin numbers);
``normalize_images``, ``tile_channels``, ``photoz_prediction_metrics`` and
``evaluate_z`` equal JAX's; the numpy confusion matrix equals
``sklearn.metrics.confusion_matrix``; with ``plt`` set to None every drawing
function warns ``matplotlib unavailable; skipping <name>`` and returns None,
as JAX's does, while ``evaluate_z`` still returns its numbers.
"""

import os
import warnings

import numpy as np
import pytest

from sky_embeddings_tpu.utils import plotting as jax_plotting
from sky_embeddings_tpu_torch.utils import plotting

FIGURES = ("plot_progress", "plot_batch", "plot_batch_tiled", "z_plots", "snr_plots",
           "display_images", "plot_conf_mat", "plot_resid_hexbin", "plot_dual_histogram")


def _inputs():
    """Arguments of each drawing function, made from a seed."""
    rng = np.random.default_rng(0)
    n = 200
    z_true = rng.uniform(0.1, 1.8, n)
    z_pred = z_true + rng.normal(0, 0.05, n) * (1 + z_true)
    snr = rng.uniform(4.0, 30.0, n)
    imgs = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    masked = imgs.copy()
    masked[:, :8] = np.nan
    losses = {"batch_iters": [10, 20, 30], "train_loss": [1.0, 0.8, 0.7],
              "val_loss": [1.1, 0.9, 0.8], "train_lp_acc": [0.3, 0.4, 0.5],
              "val_lp_acc": [0.3, 0.35, 0.45], "train_mae": [0.2, 0.1, 0.05],
              "val_mae": [0.2, 0.15, 0.1]}
    y_true = rng.integers(0, 3, 90)
    y_pred = np.where(rng.random(90) < 0.7, y_true, rng.integers(0, 3, 90))
    return {
        "plot_progress": ((losses,), {}),
        "plot_batch": ((imgs, masked, imgs * 0.9), {"n_samples": 3}),
        "plot_batch_tiled": ((imgs, masked, imgs * 0.9), {"n_samples": 3}),
        "z_plots": ((z_pred, z_true), {}),
        "snr_plots": ((z_pred, z_true, snr), {}),
        "display_images": ((plotting.normalize_images(imgs[..., 0]),), {}),
        "plot_conf_mat": ((y_true, y_pred), {}),
        "plot_resid_hexbin": ((z_true, z_pred), {}),
        "plot_dual_histogram": ((z_true, z_pred), {}),
    }


@pytest.mark.parametrize("name", FIGURES)
def test_each_figure_writes_a_png_as_jax_does(name, tmp_path):
    args, kw = _inputs()[name]
    ours = str(tmp_path / "ours.png")
    out = getattr(plotting, name)(*args, savename=ours, **kw)
    assert out is not None and os.path.getsize(ours) > 1000
    if name in ("z_plots", "snr_plots"):  # their per-bin numbers, JAX's figure beside
        ref = getattr(jax_plotting, name)(*args, savename=str(tmp_path / "jax.png"), **kw)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])


def test_evaluate_z_draws_and_equals_jax(tmp_path):
    args, _ = _inputs()["snr_plots"]
    z_pred, z_true, snr = args
    path = str(tmp_path / "ez.png")
    ours = plotting.evaluate_z(z_pred, z_true, snr=snr, savename=path)
    ref = jax_plotting.evaluate_z(z_pred, z_true, snr=snr, savename=str(tmp_path / "j.png"))
    assert os.path.getsize(path) > 1000
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plotting.evaluate_z(z_pred, z_true, n_bins=5, z_range=(0.0, 2.0)),
                    jax_plotting.evaluate_z(z_pred, z_true, n_bins=5, z_range=(0.0, 2.0))):
        np.testing.assert_array_equal(a, b)
    assert plotting.photoz_prediction_metrics(z_pred, z_true) == \
        jax_plotting.photoz_prediction_metrics(z_pred, z_true)


@pytest.mark.parametrize("shape", [(4, 16, 16), (3, 2, 8, 8), (2, 5, 7, 9)])
def test_normalize_images_equals_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 5 + 2
    x.reshape(-1)[::7] = np.nan
    np.testing.assert_array_equal(plotting.normalize_images(x), jax_plotting.normalize_images(x))


@pytest.mark.parametrize("channels,grid", [(1, None), (3, None), (5, None), (9, None),
                                           (5, (1, 5)), (6, (2, 2))])
def test_tile_channels_equals_jax(channels, grid):
    img = np.random.default_rng(channels).normal(size=(channels, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(plotting.tile_channels(img, grid),
                                  jax_plotting.tile_channels(img, grid))


@pytest.mark.parametrize("normalize", [None, "true"])
@pytest.mark.parametrize("case", ["three", "missing_pred", "missing_true", "labels_4"])
def test_confusion_matrix_equals_sklearn(case, normalize):
    from sklearn.metrics import confusion_matrix

    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 3, 120), rng.integers(0, 3, 120)
    if case == "missing_pred":
        y_pred = np.where(y_pred == 2, 0, y_pred)
    elif case == "missing_true":  # a label only predicted: its row is 0 when normalised
        y_true = np.where(y_true == 1, 0, y_true)
    elif case == "labels_4":
        y_true, y_pred = y_true + (y_true == 2), y_pred * 2
    want = confusion_matrix(y_true, y_pred, normalize=normalize)
    got = plotting.confusion_matrix(y_true, y_pred, normalize=normalize)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", FIGURES)
def test_without_matplotlib_each_figure_warns_and_returns_none(name, tmp_path, monkeypatch):
    args, kw = _inputs()[name]
    path = tmp_path / "x.png"
    for mod in (plotting, jax_plotting):
        monkeypatch.setattr(mod, "plt", None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = getattr(mod, name)(*args, savename=str(path), **kw)
        assert out is None and not path.exists()
        assert [str(w.message) for w in caught] == [f"matplotlib unavailable; skipping {name}"]
    # the port's evaluate_z keeps its numbers and skips only the figure
    z_pred, z_true, _ = _inputs()["snr_plots"][0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = plotting.evaluate_z(z_pred, z_true, savename=str(path))
    assert [str(w.message) for w in caught] == ["matplotlib unavailable; skipping evaluate_z"]
    assert len(out) == 4 and not path.exists()
