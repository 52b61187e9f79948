"""Synthetic HDF5 fixtures with the survey-cutout schema.

Copy of ``make_cutouts`` / ``write_synthetic_h5`` from
``sky_embeddings_tpu/data/synthetic.py``; the same seed gives the same
arrays. Schema:

    cutouts    (N, C, S, S) float32
    ra         (N,) float
    dec        (N,) float
    zspec      (N,) float
    zspec_err  (N,) float
    class      (N,) int   (classifier sets only)

Cutouts are exponential-profile blobs plus noise, with an optional fraction
of whole bands set to NaN (missing bands).
"""

from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - hosts without h5py use make_cutouts only
    h5py = None


def make_cutouts(
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.1,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Build an in-memory synthetic dataset dict (schema above)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    cy = cx = (img_size - 1) / 2.0

    amp = rng.lognormal(mean=0.0, sigma=0.8, size=(n, 1, 1, 1)).astype(np.float32)
    radius = rng.uniform(1.5, 6.0, size=(n, 1, 1, 1)).astype(np.float32)
    band_scale = rng.uniform(0.5, 1.5, size=(n, channels, 1, 1)).astype(np.float32)
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2)[None, None]
    profile = amp * band_scale * np.exp(-np.sqrt(r2) / radius)
    noise = rng.normal(0.0, 0.05, size=(n, channels, img_size, img_size)).astype(np.float32)
    cutouts = (profile + noise).astype(np.float32)

    if nan_band_frac > 0:
        drop = rng.random((n, channels)) < nan_band_frac
        cutouts[drop] = np.nan

    zspec = rng.uniform(0.05, 1.6, size=n).astype(np.float32)
    return {
        "cutouts": cutouts,
        "ra": rng.uniform(0.0, 360.0, size=n).astype(np.float32),
        "dec": rng.uniform(-20.0, 60.0, size=n).astype(np.float32),
        "zspec": zspec,
        "zspec_err": (0.01 + 0.05 * rng.random(n) * zspec).astype(np.float32),
        "class": rng.integers(0, 3, size=n).astype(np.int64),
    }


def write_synthetic_h5(
    path: str,
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.1,
    seed: int = 0,
    include_class: bool = True,
) -> str:
    """Write a synthetic dataset file; returns the path."""
    if h5py is None:
        raise ImportError("h5py is required to write synthetic datasets")
    data = make_cutouts(n, channels, img_size, nan_band_frac, seed)
    with h5py.File(path, "w") as f:
        for key, arr in data.items():
            if key == "class" and not include_class:
                continue
            # chunk by row groups so batched reads stream contiguously
            chunks = (min(n, 256),) + arr.shape[1:]
            f.create_dataset(key, data=arr, chunks=chunks)
    return path
