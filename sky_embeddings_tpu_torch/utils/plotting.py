"""Plotting and metric figures (port of ``sky_embeddings_tpu/utils/plotting.py``,
reference ``utils/plotting_fns.py``).

Matplotlib is an optional dependency at run time, as in JAX: it is imported
here inside ``try`` with the Agg backend, and without it every drawing
function warns ``matplotlib unavailable; skipping <name>`` and returns
None (the card host has no matplotlib, so the twins and the trainers' figure
hooks run there and draw nothing). The numeric helpers (photo-z metrics,
image normalization, channel tiling, the confusion matrix) are numpy only
and run everywhere; :func:`evaluate_z` returns its per-bin numbers with or
without matplotlib and draws them only where it is present.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover - the card host
    plt = None


def set_latex_style(enable: bool = True) -> None:
    """Reference-style LaTeX figure text (``plotting_fns.py:9-13``), opt-in:
    off by default so hosts without a TeX install still render figures.
    Enable per process with ``SKY_LATEX_PLOTS=1`` or by calling this before
    plotting."""
    if plt is None:
        return
    if enable:
        plt.rcParams.update({
            "text.usetex": True,
            "font.family": "serif",
            "font.serif": ["Times"],
            "font.size": 10,
        })
    else:
        plt.rcParams.update({"text.usetex": False})


if plt is not None and os.environ.get("SKY_LATEX_PLOTS"):
    set_latex_style(True)


def _needs_mpl(fn):
    def wrapper(*args, **kwargs):
        if plt is None:
            warnings.warn(f"matplotlib unavailable; skipping {fn.__name__}")
            return None
        return fn(*args, **kwargs)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _save(fig, savename: Optional[str]) -> None:
    fig.tight_layout()
    if savename:
        fig.savefig(savename, dpi=100)
        plt.close(fig)


# ----------------------------------------------------------------------
# Numeric helpers
# ----------------------------------------------------------------------

def normalize_images(images: np.ndarray) -> np.ndarray:
    """Per-image [0,1] scaling for display (NaN-safe)."""
    flat = images.reshape(images.shape[0], -1)
    lo = np.nanmin(flat, axis=1).reshape(-1, *([1] * (images.ndim - 1)))
    hi = np.nanmax(flat, axis=1).reshape(-1, *([1] * (images.ndim - 1)))
    return (images - lo) / (hi - lo + 1e-12)


def photoz_prediction_metrics(z_pred: np.ndarray, z_true: np.ndarray,
                              threshold: float = 0.15) -> tuple[float, float, float]:
    """(bias, MAD scatter, outlier fraction) of Δz/(1+z) (reference
    ``plotting_fns.py:394-402``)."""
    resid = (z_pred - z_true) / (1.0 + z_true)
    bias = float(np.mean(resid))
    mad = float(1.4826 * np.median(np.abs(resid - np.median(resid))))
    frac_out = float(np.mean(np.abs(resid) > threshold))
    return bias, mad, frac_out


def tile_channels(image: np.ndarray, grid_size: Optional[tuple[int, int]] = None) -> np.ndarray:
    """Tile a (C, H, W) image's channels into one 2D mosaic
    (reference ``plotting_fns.py:203-238``)."""
    c, h, w = image.shape
    if grid_size is None:
        rows = int(np.ceil(np.sqrt(c)))
        cols = int(np.ceil(c / rows))
    else:
        rows, cols = grid_size
    out = np.zeros((rows * h, cols * w), dtype=image.dtype)
    for idx in range(min(c, rows * cols)):
        r, col = divmod(idx, cols)
        out[r * h : (r + 1) * h, col * w : (col + 1) * w] = image[idx]
    return out


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     normalize: Optional[str] = None) -> np.ndarray:
    """The confusion matrix over the sorted labels that either array holds,
    rows the true label, as ``sklearn.metrics.confusion_matrix`` counts it
    (sklearn is not on the card host); ``normalize="true"`` divides each row
    by its count, a row of no samples staying 0."""
    y_true, y_pred = np.asarray(y_true).reshape(-1), np.asarray(y_pred).reshape(-1)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)), 1)
    if normalize != "true":
        return cm
    with np.errstate(all="ignore"):
        return np.nan_to_num(cm / cm.sum(axis=1, keepdims=True))


def _binned_photoz(z_pred, z_true, edges, threshold):
    """(bias, MAD, outlier fraction) per redshift bin, NaN in bins of fewer
    than three objects."""
    stats = np.full((3, len(edges) - 1), np.nan)
    for i in range(len(edges) - 1):
        sel = (z_true >= edges[i]) & (z_true < edges[i + 1])
        if sel.sum() > 2:
            stats[:, i] = photoz_prediction_metrics(z_pred[sel], z_true[sel], threshold)
    return stats


def evaluate_z(z_pred: np.ndarray, z_true: np.ndarray, n_bins: int = 8,
               z_range: tuple[float, float] = (0.2, 1.6), threshold: float = 0.1,
               snr: Optional[np.ndarray] = None, savename: Optional[str] = None):
    """Binned photo-z metrics against redshift (reference ``:458-650``):
    ``(centers, bias, mad, frac_out)``, NaN in bins of fewer than three
    objects. With ``savename`` they are drawn (and, with ``snr``, the
    residuals against S/N) where matplotlib is present; the numbers come
    back either way."""
    edges = np.linspace(z_range[0], z_range[1], n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    bias, mad, fout = _binned_photoz(z_pred, z_true, edges, threshold)
    if savename is not None and plt is None:
        warnings.warn("matplotlib unavailable; skipping evaluate_z")
    elif savename is not None:
        _draw_evaluate_z(z_pred, z_true, centers, (bias, mad, fout), threshold, snr, savename)
    return centers, bias, mad, fout


def _draw_evaluate_z(z_pred, z_true, centers, stats, threshold, snr, savename):
    ncols = 3 if snr is None else 4
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 3.2))
    for ax, vals, name in zip(axes, stats, ["bias", "MAD", f"f(>|{threshold}|)"]):
        ax.plot(centers, vals, "o-")
        ax.set_xlabel("$z_{spec}$"), ax.set_ylabel(name)
        ax.grid(alpha=0.3)
    if snr is not None:
        axes[3].hexbin(snr, (z_pred - z_true) / (1 + z_true), gridsize=40, mincnt=1)
        axes[3].set_xlabel("S/N"), axes[3].set_ylabel("$\\Delta z/(1+z)$")
    _save(fig, savename)
    return fig


# ----------------------------------------------------------------------
# Figures
# ----------------------------------------------------------------------

@_needs_mpl
def plot_progress(losses: dict, y_lims: Optional[Sequence[tuple]] = None,
                  savename: Optional[str] = None):
    """Multi-panel training curves from the checkpoint losses dict
    (reference ``plotting_fns.py:15-107``)."""
    iters = losses.get("batch_iters", [])
    panels = [("Loss", ["train_loss", "val_loss"])]
    if "train_lp_acc" in losses:
        panels.append(("Linear-probe accuracy", ["train_lp_acc", "val_lp_acc"]))
    if "train_lp_r2" in losses:
        panels.append(("Linear-probe R²", ["train_lp_r2", "val_lp_r2"]))
    if "train_acc" in losses:
        panels.append(("Accuracy", ["train_acc", "val_acc"]))
    if "train_mae" in losses:
        panels.append(("MAE", ["train_mae", "val_mae"]))

    fig, axes = plt.subplots(len(panels), 1, figsize=(8, 3 * len(panels)), squeeze=False)
    for i, (title, keys) in enumerate(panels):
        ax = axes[i, 0]
        for k in keys:
            if k in losses and len(losses[k]):
                ax.plot(iters[: len(losses[k])], losses[k], label=k)
        ax.set_title(title)
        ax.set_xlabel("batch iterations")
        ax.legend()
        ax.grid(alpha=0.3)
        if y_lims is not None and i < len(y_lims):
            ax.set_ylim(*y_lims[i])
    _save(fig, savename)
    return fig


@_needs_mpl
def plot_batch(orig_imgs: np.ndarray, mask_imgs: np.ndarray, pred_imgs: np.ndarray,
               n_samples: int = 5, channel_index: int = 0, savename: Optional[str] = None):
    """Original / masked / reconstruction triptychs, one channel
    (reference ``plotting_fns.py:127-222``). Inputs are (B, H, W, C)."""
    n = min(n_samples, orig_imgs.shape[0])
    fig, axes = plt.subplots(n, 3, figsize=(7, 2.2 * n), squeeze=False)
    for i in range(n):
        triple = [orig_imgs[i, ..., channel_index],
                  mask_imgs[i, ..., channel_index],
                  pred_imgs[i, ..., channel_index]]
        vmin = np.nanpercentile(triple[0], 2)
        vmax = np.nanpercentile(triple[0], 98)
        for j, (img, title) in enumerate(zip(triple, ["original", "masked", "reconstruction"])):
            ax = axes[i, j]
            ax.imshow(img, vmin=vmin, vmax=vmax, cmap="viridis")
            ax.set_xticks([]), ax.set_yticks([])
            if i == 0:
                ax.set_title(title)
    _save(fig, savename)
    return fig


@_needs_mpl
def plot_batch_tiled(orig_imgs: np.ndarray, mask_imgs: np.ndarray, pred_imgs: np.ndarray,
                     n_samples: int = 5, savename: Optional[str] = None):
    """Original / masked / reconstruction triptychs with **all channels**
    tiled into each panel (reference ``plotting_fns.py:239-280``).
    Inputs are (B, H, W, C); channels are moved to the front for tiling."""
    n = min(n_samples, orig_imgs.shape[0])
    fig, axes = plt.subplots(n, 3, figsize=(10, n * 10 / 3), squeeze=False)
    for i in range(n):
        for j, (batch, title) in enumerate(
            zip([orig_imgs, mask_imgs, pred_imgs], ["Original", "Masked Input", "Reconstruction"])
        ):
            tiled = tile_channels(np.moveaxis(batch[i], -1, 0))
            ax = axes[i, j]
            ax.imshow(tiled)
            ax.axis("off")
            if i == 0:
                ax.set_title(title, fontsize=12)
    _save(fig, savename)
    return fig


@_needs_mpl
def z_plots(z_pred: np.ndarray, z_true: np.ndarray, n_bins: int = 8,
            z_range: tuple[float, float] = (0.2, 1.6), threshold: float = 0.1,
            savename: Optional[str] = None):
    """Dedicated photo-z panel (reference ``plotting_fns.py:458-563``):
    z distribution, normalized-residual hexbin annotated with global
    bias/MAD/outlier-frac, then binned bias / MAD / outlier-fraction vs z."""
    resid = (z_pred - z_true) / (1.0 + z_true)
    bias, mad, fout = photoz_prediction_metrics(z_pred, z_true, threshold)
    edges = np.linspace(z_range[0], z_range[1], n_bins + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])
    bin_stats = _binned_photoz(z_pred, z_true, edges, threshold)

    fig, axes = plt.subplots(5, 1, figsize=(8, 12), sharex=True)
    axes[0].hist(z_true, bins=100, range=z_range)
    axes[0].set_ylabel("N")
    hx = axes[1].hexbin(z_true, resid, gridsize=(100, 50), mincnt=1, cmap="viridis",
                        extent=(z_range[0], z_range[1], -0.3, 0.3))
    axes[1].axhline(0, lw=1, c="k", ls="--")
    axes[1].annotate(f"bias={bias:.3f}, MAD={mad:.3f}, frac={fout:.3f}",
                     (0.55, 0.85), xycoords="axes fraction",
                     bbox=dict(boxstyle="square,pad=0.3", fc="w", ec="k"))
    axes[1].set_ylabel("Normalized\nresidual")
    fig.colorbar(hx, ax=axes[1], pad=0.01)
    for ax, vals, name in zip(axes[2:], bin_stats, ["Bias", "MAD", "Outlier\nfraction"]):
        ax.plot(mids, vals, "o--")
        ax.set_ylabel(name)
        if name == "Bias":
            ax.axhline(0, lw=1, c="k", ls="--")
    axes[-1].set_xlabel("Spectroscopic redshift")
    for ax in axes:
        ax.set_xlim(*z_range)
        ax.grid(alpha=0.2)
    _save(fig, savename)
    return mids, bin_stats


@_needs_mpl
def snr_plots(z_pred: np.ndarray, z_true: np.ndarray, snr: np.ndarray, n_bins: int = 8,
              snr_lim: tuple[float, float] = (5.0, 25.0), threshold: float = 0.15,
              seed: int = 0, savename: Optional[str] = None):
    """Photo-z quality vs signal-to-noise (reference ``plotting_fns.py:565-650``):
    truth/prediction scatter colored by S/N, then bias / MAD / outlier-fraction
    in equal-count S/N bins (each bin subsampled to the smallest bin's size so
    the metrics are comparable across bins)."""
    edges = np.linspace(snr_lim[0], snr_lim[1], n_bins + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])
    bins = [np.where((snr >= edges[i]) & (snr < edges[i + 1]))[0] for i in range(n_bins)]
    n_per = min((len(b) for b in bins), default=0)
    rng = np.random.default_rng(seed)
    bin_stats = np.full((3, n_bins), np.nan)
    if n_per > 2:
        for i, b in enumerate(bins):
            sel = rng.choice(b, size=n_per, replace=False)
            bin_stats[:, i] = photoz_prediction_metrics(z_pred[sel], z_true[sel], threshold)

    fig, axes = plt.subplots(4, 1, figsize=(8, 11))
    sc = axes[0].scatter(z_true, z_pred, c=snr, s=3, vmin=0, vmax=snr_lim[1], cmap="viridis")
    axes[0].plot([0, 2], [0, 2], lw=1, c="k", ls="--")
    axes[0].set_xlim(0, 2), axes[0].set_ylim(0, 2)
    axes[0].set_xlabel("Spectroscopic redshift"), axes[0].set_ylabel("Predicted redshift")
    fig.colorbar(sc, ax=axes[0], pad=0.01, label="S/N")
    for ax, vals, name in zip(axes[1:], bin_stats, ["Bias", "MAD", "Outlier\nfraction"]):
        ax.plot(mids, vals, "o--")
        ax.set_ylabel(name)
        ax.set_xlim(snr_lim)
        ax.grid(alpha=0.2)
        if name == "Bias":
            ax.axhline(0, lw=1, c="k", ls="--")
    axes[-1].set_xlabel("Signal-to-noise")
    _save(fig, savename)
    return mids, bin_stats


@_needs_mpl
def display_images(images: np.ndarray, vmin: float = 0.0, vmax: float = 1.0,
                   savename: Optional[str] = None):
    """Square grid viewer for (N, H, W) images (reference ``:282-325``)."""
    n = images.shape[0]
    side = int(np.ceil(np.sqrt(n)))
    fig, axes = plt.subplots(side, side, figsize=(1.6 * side, 1.6 * side), squeeze=False)
    for i in range(side * side):
        ax = axes[i // side, i % side]
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], vmin=vmin, vmax=vmax, cmap="viridis")
    _save(fig, savename)
    return fig


@_needs_mpl
def plot_conf_mat(y_true: np.ndarray, y_pred: np.ndarray,
                  labels: Sequence[str] = ("galaxy", "qso", "star"),
                  savename: Optional[str] = None):
    """Normalized confusion matrix (reference ``:326-337``), counted by
    :func:`confusion_matrix`."""
    cm = confusion_matrix(y_true, y_pred, normalize="true")
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(cm, vmin=0, vmax=1, cmap="Blues")
    ax.set_xticks(range(len(labels)), labels)
    ax.set_yticks(range(len(labels)), labels)
    ax.set_xlabel("predicted"), ax.set_ylabel("true")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                    color="white" if cm[i, j] > 0.5 else "black")
    fig.colorbar(im)
    _save(fig, savename)
    return fig


@_needs_mpl
def plot_resid_hexbin(z_true: np.ndarray, z_pred: np.ndarray, savename: Optional[str] = None):
    """Prediction vs truth + normalized-residual hexbins (reference ``:339-392``)."""
    resid = (z_pred - z_true) / (1 + z_true)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hexbin(z_true, z_pred, gridsize=40, mincnt=1, cmap="viridis")
    lims = [min(z_true.min(), z_pred.min()), max(z_true.max(), z_pred.max())]
    axes[0].plot(lims, lims, "r--", lw=1)
    axes[0].set_xlabel("$z_{spec}$"), axes[0].set_ylabel("$z_{pred}$")
    axes[1].hexbin(z_true, resid, gridsize=40, mincnt=1, cmap="viridis")
    axes[1].axhline(0, color="r", ls="--", lw=1)
    axes[1].set_xlabel("$z_{spec}$"), axes[1].set_ylabel("$\\Delta z/(1+z)$")
    _save(fig, savename)
    return fig


@_needs_mpl
def plot_dual_histogram(data1: np.ndarray, data2: np.ndarray, bins: int = 30,
                        labels: tuple[str, str] = ("a", "b"), savename: Optional[str] = None):
    """Overlaid histograms (reference ``:652-683``)."""
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.hist(data1, bins=bins, alpha=0.6, label=labels[0], density=True)
    ax.hist(data2, bins=bins, alpha=0.6, label=labels[1], density=True)
    ax.legend()
    _save(fig, savename)
    return fig
