"""Sky-position deduplication (port of
``sky_embeddings_tpu/data_processing/dedup.py``, reference
``3b_remove_duplicates.ipynb``): drop sources closer than a matching radius
using a kd-tree over unit-sphere coordinates."""

from __future__ import annotations

import numpy as np

from sky_embeddings_tpu_torch.data_processing import require_h5py


def duplicate_mask(ra: np.ndarray, dec: np.ndarray, radius_arcsec: float = 1.0) -> np.ndarray:
    """Boolean keep-mask: for each duplicate group, keep the first source."""
    from scipy.spatial import cKDTree

    ra_r = np.deg2rad(np.asarray(ra, np.float64))
    dec_r = np.deg2rad(np.asarray(dec, np.float64))
    xyz = np.stack(
        [np.cos(dec_r) * np.cos(ra_r), np.cos(dec_r) * np.sin(ra_r), np.sin(dec_r)],
        axis=1,
    )
    # chord distance for a small angular separation
    chord = 2.0 * np.sin(np.deg2rad(radius_arcsec / 3600.0) / 2.0)
    tree = cKDTree(xyz)
    pairs = tree.query_pairs(chord, output_type="ndarray")
    keep = np.ones(len(ra), dtype=bool)
    for i, j in pairs:
        if keep[i] and keep[j]:
            keep[max(i, j)] = False
    return keep


def deduplicate_h5(in_path: str, out_path: str, radius_arcsec: float = 1.0) -> int:
    """Write a deduplicated copy; returns the number of kept rows."""
    h5py = require_h5py()
    with h5py.File(in_path, "r") as f:
        keep = duplicate_mask(f["ra"][:], f["dec"][:], radius_arcsec)
        idx = np.where(keep)[0]
        with h5py.File(out_path, "w") as out:
            for k in f:
                out.create_dataset(k, data=f[k][:][idx])
    return int(keep.sum())


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser("Deduplicate an h5 dataset by sky position")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("-r", "--radius_arcsec", type=float, default=1.0)
    args = p.parse_args(argv)
    n = deduplicate_h5(args.in_path, args.out_path, args.radius_arcsec)
    print(f"kept {n} rows")


if __name__ == "__main__":  # pragma: no cover
    main()
