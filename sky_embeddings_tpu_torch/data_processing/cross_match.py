"""Positional catalog cross-matching (port of
``sky_embeddings_tpu/data_processing/cross_match.py``, reference
``data_processing/1_create_csv_files.ipynb``): match an HSC-SSP
spectroscopic-redshift catalog against a classification catalog
(star / galaxy / qso / unknown) by sky position and emit per-class CSVs of
(ra, dec, zspec, zspec_err) — the files ``create_h5.catalog_from_csv`` then
turns into cutout datasets.

All matching runs on a kd-tree over unit-sphere Cartesian coordinates with a
chord-length radius (the notebook used ``query_ball_point`` per row in a
Python loop; here the match is one vectorized nearest-neighbor query).
A ``.parquet`` catalog is read with pandas, a ``.csv`` one with numpy.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np

from sky_embeddings_tpu_torch.data_processing import require_h5py

CLASS_INDICES = {"unknown": 0, "star": 1, "galaxy": 2, "qso": 3}


def _unit_xyz(ra_deg: np.ndarray, dec_deg: np.ndarray) -> np.ndarray:
    ra = np.deg2rad(np.asarray(ra_deg, np.float64))
    dec = np.deg2rad(np.asarray(dec_deg, np.float64))
    return np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)], axis=1)


def _chord(radius_arcsec: float) -> float:
    return 2.0 * np.sin(np.deg2rad(radius_arcsec / 3600.0) / 2.0)


def cross_match_mask(
    ra: np.ndarray,
    dec: np.ndarray,
    ref_ra: np.ndarray,
    ref_dec: np.ndarray,
    radius_arcsec: float = 1.0,
) -> np.ndarray:
    """Boolean mask over (ra, dec): True where a reference source lies within
    ``radius_arcsec`` (one vectorized nearest-neighbor query)."""
    from scipy.spatial import cKDTree

    if len(ref_ra) == 0:
        return np.zeros(len(ra), dtype=bool)
    tree = cKDTree(_unit_xyz(ref_ra, ref_dec))
    dist, _ = tree.query(_unit_xyz(ra, dec), k=1)
    return dist <= _chord(radius_arcsec)


def isolated_mask(ra: np.ndarray, dec: np.ndarray, radius_arcsec: float = 1.0) -> np.ndarray:
    """True for sources with NO neighbor within the radius (the notebook's
    duplicate removal drops *every* member of a close pair, unlike
    ``dedup.duplicate_mask`` which keeps the first)."""
    from scipy.spatial import cKDTree

    xyz = _unit_xyz(ra, dec)
    tree = cKDTree(xyz)
    counts = np.asarray([len(m) for m in tree.query_ball_point(xyz, r=_chord(radius_arcsec))])
    return counts < 2


def _read_catalog(path: str, columns: Sequence[str]) -> dict[str, np.ndarray]:
    """Read a .csv or .parquet catalog into numpy columns."""
    if path.endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(path)
        return {c: df[c].to_numpy() for c in columns if c in df.columns}
    data = np.genfromtxt(path, delimiter=",", names=True)
    names = data.dtype.names or ()
    return {c: np.asarray(data[c]) for c in columns if c in names}


def make_class_catalogs(
    hsc: Mapping[str, np.ndarray],
    classes: Mapping[str, np.ndarray],
    out_dir: str,
    class_names: Optional[Sequence[str]] = None,
    class_indices: Optional[Mapping[str, int]] = None,
    tolerance_arcsec: float = 1.0,
    dedup: bool = True,
    prefix: str = "HSC",
) -> dict[str, str]:
    """Cross-match the redshift catalog against the class catalog and write
    one ``<prefix>_<class>.csv`` per class (columns ra, dec, zspec,
    zspec_err). Returns {class_name: csv_path}.

    ``hsc``: dict with ra, dec, zspec[, zspec_err] arrays.
    ``classes``: dict with ra, dec, cspec (class index) arrays.
    """
    class_indices = dict(class_indices or CLASS_INDICES)
    class_names = list(class_names or class_indices)

    ra = np.asarray(hsc["ra"], np.float64)
    dec = np.asarray(hsc["dec"], np.float64)
    zspec = np.asarray(hsc.get("zspec", np.full(len(ra), np.nan)))
    zspec_err = np.asarray(hsc.get("zspec_err", np.full(len(ra), np.nan)))

    if dedup:
        keep = isolated_mask(ra, dec, tolerance_arcsec)
        ra, dec, zspec, zspec_err = ra[keep], dec[keep], zspec[keep], zspec_err[keep]

    cspec = np.asarray(classes["cspec"])
    out_paths: dict[str, str] = {}
    os.makedirs(out_dir, exist_ok=True)
    for name in class_names:
        sel = cspec == class_indices[name]
        mask = cross_match_mask(
            ra, dec, np.asarray(classes["ra"])[sel], np.asarray(classes["dec"])[sel],
            tolerance_arcsec,
        )
        path = os.path.join(out_dir, f"{prefix}_{name}.csv")
        np.savetxt(
            path,
            np.stack([ra[mask], dec[mask], zspec[mask], zspec_err[mask]], axis=1),
            delimiter=",",
            header="ra,dec,zspec,zspec_err",
            comments="",
            fmt="%.10g",
        )
        out_paths[name] = path
    return out_paths


def h5_to_csv(h5_path: str, csv_path: str) -> int:
    """Export an h5 cutout dataset's (ra, dec[, zspec]) to CSV (notebook
    cells 11/14) — used to seed target lists for similarity searches."""
    h5py = require_h5py()
    with h5py.File(h5_path, "r") as f:
        cols = {"ra": f["ra"][:], "dec": f["dec"][:]}
        if "zspec" in f:
            cols["zspec"] = f["zspec"][:]
    arr = np.stack(list(cols.values()), axis=1)
    np.savetxt(csv_path, arr, delimiter=",", header=",".join(cols), comments="", fmt="%.10g")
    return arr.shape[0]


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(
        "Cross-match a redshift catalog with a class catalog into per-class CSVs"
    )
    p.add_argument("hsc_catalog", help=".csv/.parquet with ra,dec,zspec[,zspec_err]")
    p.add_argument("class_catalog", help=".csv/.parquet with ra,dec,cspec")
    p.add_argument("-o", "--out_dir", default="data")
    p.add_argument("-t", "--tolerance_arcsec", type=float, default=1.0)
    p.add_argument("--no-dedup", action="store_true")
    p.add_argument("--prefix", default="HSC")
    args = p.parse_args(argv)

    hsc = _read_catalog(args.hsc_catalog, ["ra", "dec", "zspec", "zspec_err"])
    classes = _read_catalog(args.class_catalog, ["ra", "dec", "cspec"])
    paths = make_class_catalogs(
        hsc, classes, args.out_dir,
        tolerance_arcsec=args.tolerance_arcsec,
        dedup=not args.no_dedup,
        prefix=args.prefix,
    )
    for name, path in paths.items():
        with open(path) as f:
            n = sum(1 for _ in f) - 1
        print(f"{name}: {n} sources -> {path}")


if __name__ == "__main__":  # pragma: no cover
    main()
