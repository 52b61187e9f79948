"""Survey pixel-scale measurement from FITS WCS headers (port of
``sky_embeddings_tpu/data_processing/resolution.py``, reference
``data_processing/resolution.py``)."""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

from sky_embeddings_tpu_torch.data.fits_io import TanWCS, read_image


def pixel_scale_arcsec(wcs: TanWCS) -> float:
    """Geometric-mean pixel scale in arcsec from the CD matrix."""
    det = abs(np.linalg.det(wcs.cd))
    return float(np.sqrt(det) * 3600.0)


def measure_resolution(fits_paths: Sequence[str], limit: int = 20) -> dict:
    """Scan up to ``limit`` tiles a directory and report pixel-scale
    statistics; a file without a readable TAN WCS is skipped."""
    scales = []
    for root in fits_paths:
        for path in sorted(glob.glob(os.path.join(root, "*.fits")))[:limit]:
            try:
                _, header = read_image(path)
                scales.append(pixel_scale_arcsec(TanWCS.from_header(header)))
            except Exception:  # a corrupt file or a header without a TAN WCS
                continue
    if not scales:
        return {"n": 0}
    arr = np.asarray(scales)
    return {
        "n": len(arr),
        "mean_arcsec": float(arr.mean()),
        "min_arcsec": float(arr.min()),
        "max_arcsec": float(arr.max()),
    }


if __name__ == "__main__":  # pragma: no cover
    import sys

    print(measure_resolution(sys.argv[1:]))
