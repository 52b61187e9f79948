"""Random train/val/test split of an h5 dataset (port of
``sky_embeddings_tpu/data_processing/split.py``, reference
``4_split_dataset.py``: 80/10/10)."""

from __future__ import annotations

import numpy as np

from sky_embeddings_tpu_torch.data_processing import require_h5py


def split_indices(n: int, fractions: tuple[float, float, float] = (0.8, 0.1, 0.1),
                  seed: int = 42) -> list[np.ndarray]:
    """The sorted row indices of each part of ``n`` rows: a permutation from
    ``seed``, cut at ``int(fraction * n)``, the remainder to the last part."""
    if abs(sum(fractions) - 1.0) > 1e-6:
        raise ValueError("fractions must sum to 1")
    order = np.random.default_rng(seed).permutation(n)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    parts = [order[:n_train], order[n_train : n_train + n_val], order[n_train + n_val :]]
    return [np.sort(idx) for idx in parts]


def split_dataset(
    in_path: str,
    fractions: tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 42,
    suffixes: tuple[str, str, str] = ("_train", "_val", "_test"),
) -> list[str]:
    """Write ``<stem>_train/_val/_test.h5`` files with the rows of
    :func:`split_indices`; returns their paths."""
    h5py = require_h5py()
    stem = in_path[:-3] if in_path.endswith(".h5") else in_path

    with h5py.File(in_path, "r") as f:
        parts = split_indices(f["cutouts"].shape[0], fractions, seed)
        out_paths = []
        for idx, suffix in zip(parts, suffixes):
            path = f"{stem}{suffix}.h5"
            with h5py.File(path, "w") as out:
                for k in f:
                    out.create_dataset(k, data=f[k][:][idx])
            out_paths.append(path)
    return out_paths


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser("Split an h5 dataset into train/val/test")
    p.add_argument("in_path")
    p.add_argument("-f", "--fractions", nargs=3, type=float, default=[0.8, 0.1, 0.1])
    p.add_argument("-s", "--seed", type=int, default=42)
    args = p.parse_args(argv)
    print(split_dataset(args.in_path, tuple(args.fractions), args.seed))


if __name__ == "__main__":  # pragma: no cover
    main()
