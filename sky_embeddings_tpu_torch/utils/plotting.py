"""The numbers behind the predictor's figures (port of the numeric part of
``sky_embeddings_tpu/utils/plotting.py``, reference ``plotting_fns.py``):
photo-z bias, MAD scatter and outlier fraction, overall and per redshift
bin. The figures themselves wait for the plots' port (ROADMAP: figures);
nothing here imports matplotlib, which the card host lacks.
"""

from __future__ import annotations

import numpy as np


def photoz_prediction_metrics(z_pred: np.ndarray, z_true: np.ndarray,
                              threshold: float = 0.15) -> tuple[float, float, float]:
    """(bias, MAD scatter, outlier fraction) of Δz/(1+z) (reference
    ``plotting_fns.py:394-402``)."""
    resid = (z_pred - z_true) / (1.0 + z_true)
    bias = float(np.mean(resid))
    mad = float(1.4826 * np.median(np.abs(resid - np.median(resid))))
    frac_out = float(np.mean(np.abs(resid) > threshold))
    return bias, mad, frac_out


def evaluate_z(z_pred: np.ndarray, z_true: np.ndarray, n_bins: int = 8,
               z_range: tuple[float, float] = (0.2, 1.6), threshold: float = 0.1):
    """Binned photo-z metrics against redshift (the numbers of JAX
    ``evaluate_z``): ``(centers, bias, mad, frac_out)``, NaN in bins of
    fewer than three objects."""
    edges = np.linspace(z_range[0], z_range[1], n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    bias = np.full(n_bins, np.nan)
    mad = np.full(n_bins, np.nan)
    fout = np.full(n_bins, np.nan)
    for i in range(n_bins):
        sel = (z_true >= edges[i]) & (z_true < edges[i + 1])
        if sel.sum() > 2:
            bias[i], mad[i], fout[i] = photoz_prediction_metrics(z_pred[sel], z_true[sel], threshold)
    return centers, bias, mad, fout
