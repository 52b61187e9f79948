"""Cut catalog sources from survey FITS tiles into HDF5 cutout datasets (port
of ``sky_embeddings_tpu/data_processing/create_h5.py``).

For each sky patch (one multi-band FITS tile set) and each catalog source
that falls inside it, extract a fixed-size multi-band cutout centered on the
source position; write the dataset with the standard schema:

    cutouts (N, C, S, S) f32, ra (N,), dec (N,), zspec (N,), zspec_err (N,)
    [, class (N,)]

Reference behavior mirrored from ``2_create_h5_files.py`` +
``data_processing/utils.py:144-361``: WCS containment test per patch,
missing bands -> NaN channels, edge sources skipped, shard files merged into
resizable datasets. :func:`catalog_from_csv` and :func:`cutouts_for_patch`
need no h5py; :func:`create_h5_dataset` does.
"""

from __future__ import annotations

import csv
import os
import uuid
from typing import Optional, Sequence

import numpy as np

from sky_embeddings_tpu_torch.data.fits_loader import find_band_files, load_band_stack
from sky_embeddings_tpu_torch.data_processing import require_h5py


def catalog_from_csv(path: str) -> dict[str, np.ndarray]:
    """Load a (name,)ra,dec[,zspec[,zspec_err[,class]]] CSV catalog."""
    cols: dict[str, list] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                cols.setdefault(k.strip().lower(), []).append(v)
    out: dict[str, np.ndarray] = {}
    for k, vals in cols.items():
        if k in ("ra", "dec", "zspec", "zspec_err"):
            out[k] = np.asarray([float(v) for v in vals], np.float32)
        elif k == "class":
            out[k] = np.asarray([int(float(v)) for v in vals], np.int64)
    if "ra" not in out or "dec" not in out:
        raise ValueError(f"catalog {path} must have ra and dec columns")
    return out


def cutouts_for_patch(
    band_files: Sequence[str],
    catalog: dict[str, np.ndarray],
    img_size: int = 64,
) -> Optional[dict[str, np.ndarray]]:
    """Extract cutouts of all catalog sources inside one patch, or None."""
    tile, wcs = load_band_stack(band_files, return_wcs=True)
    if wcs is None:
        return None
    C, H, W = tile.shape
    xs, ys = wcs.world_to_pixel(catalog["ra"], catalog["dec"])
    half = img_size // 2
    inside = (xs >= half) & (xs < W - half) & (ys >= half) & (ys < H - half)
    idx = np.where(inside)[0]
    if len(idx) == 0:
        return None

    cutouts = np.empty((len(idx), C, img_size, img_size), np.float32)
    for j, i in enumerate(idx):
        x0 = int(round(xs[i])) - half
        y0 = int(round(ys[i])) - half
        cutouts[j] = tile[:, y0 : y0 + img_size, x0 : x0 + img_size]

    out = {"cutouts": cutouts, "ra": catalog["ra"][idx], "dec": catalog["dec"][idx]}
    for key in ("zspec", "zspec_err", "class"):
        if key in catalog:
            out[key] = catalog[key][idx]
    return out


def _append(f, key: str, arr: np.ndarray) -> None:
    if key not in f:
        maxshape = (None,) + arr.shape[1:]
        f.create_dataset(key, data=arr, maxshape=maxshape,
                         chunks=(min(len(arr), 256),) + arr.shape[1:])
    else:
        ds = f[key]
        n0 = ds.shape[0]
        ds.resize(n0 + len(arr), axis=0)
        ds[n0:] = arr


def create_h5_dataset(
    fits_paths: Sequence[str],
    catalog: dict[str, np.ndarray],
    out_path: str,
    bands: Sequence[str] = ("G", "R", "I", "Z", "Y"),
    min_bands: int = 2,
    img_size: int = 64,
    use_calexp: bool = True,
    shard_dir: Optional[str] = None,
    verbose: bool = True,
) -> str:
    """Walk all patches, shard per patch, then merge into ``out_path``."""
    h5py = require_h5py()
    patches = find_band_files(fits_paths, bands, min_bands, use_calexp, verbose=verbose)
    shard_dir = shard_dir or os.path.dirname(os.path.abspath(out_path))
    os.makedirs(shard_dir, exist_ok=True)

    shards = []
    for band_files in patches:
        data = cutouts_for_patch(band_files, catalog, img_size)
        if data is None:
            continue
        shard = os.path.join(shard_dir, f"shard_{uuid.uuid4().hex}.h5")
        with h5py.File(shard, "w") as f:
            for k, v in data.items():
                f.create_dataset(k, data=v)
        shards.append(shard)
        if verbose:
            print(f"patch -> {len(data['cutouts'])} cutouts")

    with h5py.File(out_path, "w") as out:
        for shard in shards:
            with h5py.File(shard, "r") as f:
                for k in f:
                    _append(out, k, f[k][:])
            os.remove(shard)
        n = out["cutouts"].shape[0] if "cutouts" in out else 0
    if verbose:
        print(f"Wrote {n} cutouts to {out_path}")
    return out_path


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser("Create an h5 cutout dataset from FITS tiles")
    p.add_argument("catalog_csv")
    p.add_argument("out_path")
    p.add_argument("-fits", "--fits_paths", nargs="+", required=True)
    p.add_argument("-bands", nargs="+", default=["G", "R", "I", "Z", "Y"])
    p.add_argument("-mb", "--min_bands", type=int, default=2)
    p.add_argument("-is", "--img_size", type=int, default=64)
    p.add_argument("-uc", "--use_calexp", action="store_true")
    args = p.parse_args(argv)
    create_h5_dataset(
        args.fits_paths, catalog_from_csv(args.catalog_csv), args.out_path,
        bands=args.bands, min_bands=args.min_bands, img_size=args.img_size,
        use_calexp=args.use_calexp,
    )


if __name__ == "__main__":  # pragma: no cover
    main()
