"""Balanced linear-probe datasets (port of
``sky_embeddings_tpu/data_processing/probe_sets.py``, reference
``4_linear_probe_datasets.ipynb``: fixed per-class sample counts for the
training-time probe canary)."""

from __future__ import annotations

import numpy as np

from sky_embeddings_tpu_torch.data_processing import require_h5py


def probe_indices(classes: np.ndarray, per_class: int = 2000, seed: int = 0) -> np.ndarray:
    """Sorted rows of up to ``per_class`` samples of each class, drawn
    without replacement class by class (ascending) from one generator."""
    rng = np.random.default_rng(seed)
    classes = np.asarray(classes)
    chosen: list[int] = []
    for cls in np.unique(classes):
        rows = np.where(classes == cls)[0]
        take = min(per_class, len(rows))
        chosen.extend(rng.choice(rows, size=take, replace=False).tolist())
    return np.sort(np.asarray(chosen, dtype=np.int64))


def regression_probe_indices(n: int, n_samples: int = 6000, seed: int = 0) -> np.ndarray:
    """Sorted rows of a uniform random subset of ``min(n_samples, n)`` rows."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(n_samples, n), replace=False))


def _write_rows(h5py, f, out_path: str, idx: np.ndarray) -> None:
    with h5py.File(out_path, "w") as out:
        for k in f:
            out.create_dataset(k, data=f[k][:][idx])


def make_probe_set(
    in_path: str,
    out_path: str,
    per_class: int = 2000,
    class_key: str = "class",
    seed: int = 0,
) -> int:
    """Sample up to ``per_class`` rows per class (:func:`probe_indices`);
    returns the output size."""
    h5py = require_h5py()
    with h5py.File(in_path, "r") as f:
        idx = probe_indices(f[class_key][:], per_class, seed)
        _write_rows(h5py, f, out_path, idx)
    return len(idx)


def make_regression_probe_set(in_path: str, out_path: str, n_samples: int = 6000,
                              seed: int = 0) -> int:
    """Uniform random probe subset for the regression (zspec) probe
    (:func:`regression_probe_indices`)."""
    h5py = require_h5py()
    with h5py.File(in_path, "r") as f:
        idx = regression_probe_indices(f["cutouts"].shape[0], n_samples, seed)
        _write_rows(h5py, f, out_path, idx)
    return len(idx)
