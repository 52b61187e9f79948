"""The training CLI's argument parser, central-patch selection and
channel-wise S/N (copies of ``build_train_argparser``, ``select_centre`` and
``h5_snr`` from ``sky_embeddings_tpu/utils/misc.py``, reference
``utils/misc.py``). Framework-free: ``select_centre`` indexes numpy arrays
and torch tensors alike."""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - hosts without h5py skip the S/N filter
    h5py = None


def build_train_argparser(description: str = "Training") -> argparse.ArgumentParser:
    """The shared train/test CLI surface (reference ``misc.py:9-33``):
    ``<model_name> [-v verbose_iters] [-ct cp_time_minutes] [-dd data_dir]``."""
    parser = argparse.ArgumentParser(description, add_help=False)
    parser.add_argument("model_name", help="Name of model (keys configs/<name>.ini).", type=str)
    parser.add_argument(
        "-v", "--verbose_iters", type=int, default=10000,
        help="Batch iterations between validation/eval reports.",
    )
    parser.add_argument(
        "-ct", "--cp_time", type=float, default=15,
        help="Minutes between checkpoint saves.",
    )
    parser.add_argument(
        "-dd", "--data_dir", type=str, default=None,
        help="Data directory (defaults to <repo>/data/).",
    )
    return parser


def central_patch_indices(grid_size: int, n_patches: int) -> np.ndarray:
    """Flat indices of the central √n×√n block of a grid_size×grid_size grid."""
    side = int(round(n_patches ** 0.5))
    if side * side != n_patches:
        raise ValueError("n_patches must be a perfect square")
    start = grid_size // 2 - side // 2
    rows = np.arange(start, start + side)
    return (rows[:, None] * grid_size + rows[None, :]).reshape(-1)


def select_centre(latent, n_patches: int):
    """(B, L, D) -> (B, n_patches, D), the central patches of the token grid."""
    L = latent.shape[1]
    grid = int(round(L ** 0.5))
    if grid * grid != L:
        raise ValueError(f"token count {L} is not a square grid")
    return latent[:, central_patch_indices(grid, n_patches)]


def calculate_snr(images: np.ndarray, n_central_pix: int = 8) -> np.ndarray:
    """Mean of the central window / std of the surround, per channel.

    images: (B, C, S, S) -> snr (B, C).
    """
    b, c, s, _ = images.shape
    start = (s - n_central_pix) // 2
    end = start + n_central_pix
    central = images[:, :, start:end, start:end]
    surround_mask = np.ones((s, s), dtype=bool)
    surround_mask[start:end, start:end] = False
    surround = images[:, :, surround_mask].reshape(b, c, -1)
    return central.mean(axis=(2, 3)) / (surround.std(axis=2) + 1e-8)


def h5_snr(
    h5_path: str,
    n_central_pix: int = 8,
    batch_size: int = 5000,
    num_samples: Optional[int] = None,
) -> np.ndarray:
    """Streamed S/N over an h5 cutout file: (N, C)."""
    if h5py is None:
        raise ImportError("h5py required")
    vals = []
    with h5py.File(h5_path, "r") as f:
        n = num_samples if num_samples is not None else len(f["cutouts"])
        for i in range(0, n, batch_size):
            vals.append(calculate_snr(f["cutouts"][i : min(n, i + batch_size)], n_central_pix))
    return np.concatenate(vals)
