"""Survey-tile streaming from FITS files (framework-free copy of
``sky_embeddings_tpu/data/fits_loader.py``; the notes below are the original's).

Counterpart of the reference FITS pipeline (``utils/dataloaders.py:331-654``):
discover per-patch band files by filename convention, load all bands of a
tile (missing/corrupt bands become NaN channels), cut random or overlapping
windows with WCS sky coordinates, and stream fixed-shape batches.

Where the reference nests M sub-batches inside one DataLoader item and
un-nests in the consumer (``dataloaders.py:642-652``), this batcher yields
flat fixed-size batches directly — same contract as ``H5Batcher`` so training
and search loops are loader-agnostic.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from sky_embeddings_tpu_torch.data.fits_io import TanWCS, read_image


def find_band_files(
    fits_paths: Sequence[str],
    bands: Sequence[str],
    min_bands: int = 2,
    use_calexp: bool = True,
    verbose: bool = True,
) -> list[list[str]]:
    """Group FITS files by sky patch and band from the HSC filename
    convention ``[calexp-]<...>-<band>-<tract>-<patch>.fits``
    (reference ``find_HSC_bands``, ``dataloaders.py:331-380``).

    Returns one list per patch, ordered like ``bands``; missing bands are
    ``'None'`` placeholders; patches with fewer than ``min_bands`` real files
    are dropped.
    """
    patches: dict[str, dict[str, str]] = {}
    for root in fits_paths:
        for path in glob.glob(os.path.join(root, "*.fits")):
            name = os.path.basename(path)
            is_calexp = name.startswith("calexp-")
            if use_calexp != is_calexp:
                continue
            parts = name.split("-")
            if len(parts) < 3:
                continue
            band = parts[-3]
            patch = "-".join(parts[-2:])
            if band not in bands:
                continue
            entry = patches.setdefault(patch, {b: "None" for b in bands})
            entry[band] = path

    out = []
    for patch, by_band in patches.items():
        files = [by_band[b] for b in bands]
        if sum(f != "None" for f in files) >= min_bands:
            out.append(files)
    if verbose:
        print(f"Found {len(out)} patches with at least {min_bands} of the {list(bands)} bands.")
    return out


def load_band_stack(
    band_files: Sequence[str], return_wcs: bool = False
) -> tuple[np.ndarray, Optional[TanWCS]]:
    """Load all bands of a tile as (C, H, W); missing/corrupt bands -> NaN
    (reference ``load_fits_bands``, ``dataloaders.py:382-448``)."""
    images: list[Optional[np.ndarray]] = []
    shape = None
    wcs = None
    for path in band_files:
        if path == "None":
            images.append(None)
            continue
        try:
            data, header = read_image(path)
            images.append(np.asarray(data, dtype=np.float32))
            if shape is None:
                shape = data.shape
            if return_wcs and wcs is None:
                try:
                    wcs = TanWCS.from_header(header)
                except (ValueError, KeyError):
                    wcs = None
        except Exception as e:  # corrupt file -> NaN band, keep going
            print(f"Error opening {path}: {e}")
            images.append(None)
    if shape is None:
        raise ValueError("no readable band in tile")
    stack = np.stack(
        [img if img is not None else np.full(shape, np.nan, np.float32) for img in images]
    )
    return stack, wcs


def random_cutouts(
    tile: np.ndarray,
    img_size: int,
    n_cutouts: int,
    wcs: Optional[TanWCS] = None,
    rng: Optional[np.random.Generator] = None,
):
    """N random windows from a (C, H, W) tile (+ RA/Dec of centers)."""
    rng = rng or np.random.default_rng()
    C, H, W = tile.shape
    ys = rng.integers(0, H - img_size + 1, size=n_cutouts)
    xs = rng.integers(0, W - img_size + 1, size=n_cutouts)
    cutouts = np.empty((n_cutouts, C, img_size, img_size), tile.dtype)
    for i, (y, x) in enumerate(zip(ys, xs)):
        cutouts[i] = tile[:, y : y + img_size, x : x + img_size]
    if wcs is not None:
        ra, dec = wcs.pixel_to_world(xs + img_size // 2, ys + img_size // 2)
        return cutouts, np.stack([ra, dec], axis=1).astype(np.float32)
    return cutouts, None


def overlap_coords(shape: tuple[int, int], img_size: int, overlap: float) -> list[tuple[int, int]]:
    """Top-left coords of a stride-(1-overlap)·size grid covering the edges
    (reference ``generate_overlap_coords``, ``dataloaders.py:481-508``)."""
    H, W = shape
    step = max(int(img_size * (1.0 - overlap)), 1)
    ys = list(range(0, H - img_size + 1, step))
    xs = list(range(0, W - img_size + 1, step))
    if ys[-1] != H - img_size:
        ys.append(H - img_size)
    if xs[-1] != W - img_size:
        xs.append(W - img_size)
    return [(y, x) for y in ys for x in xs]


def overlapping_cutouts(
    tile: np.ndarray, img_size: int, overlap: float, wcs: Optional[TanWCS] = None
):
    """Full-coverage overlapping windows (the 'search the whole sky' grid)."""
    C, H, W = tile.shape
    coords = overlap_coords((H, W), img_size, overlap)
    cutouts = np.empty((len(coords), C, img_size, img_size), tile.dtype)
    for i, (y, x) in enumerate(coords):
        cutouts[i] = tile[:, y : y + img_size, x : x + img_size]
    if wcs is not None:
        ys = np.asarray([y + img_size // 2 for y, _ in coords])
        xs = np.asarray([x + img_size // 2 for _, x in coords])
        ra, dec = wcs.pixel_to_world(xs, ys)
        return cutouts, np.stack([ra, dec], axis=1).astype(np.float32)
    return cutouts, None


class FitsTileBatcher:
    """Stream fixed-size batches of cutouts from survey tiles.

    One background thread loads tiles and cuts windows; the consumer sees the
    same dict-batch contract as ``H5Batcher``. Cutouts from one tile fill
    ``n // batch_size`` consecutive batches (remainder dropped, like the
    reference's nested batching).
    """

    def __init__(
        self,
        fits_paths: Sequence[str],
        bands: Sequence[str] = ("G", "R", "I", "Z", "Y"),
        min_bands: int = 5,
        img_size: int = 64,
        cutouts_per_tile: int = 1024,
        batch_size: int = 64,
        use_calexp: bool = True,
        use_overlap: bool = False,
        overlap: float = 0.5,
        shuffle: bool = True,
        pixel_min: Optional[float] = -3.0,
        pixel_max: Optional[float] = None,
        seed: int = 0,
        prefetch_batches: int = 4,
    ):
        self.band_files = find_band_files(fits_paths, bands, min_bands, use_calexp)
        self.img_size = img_size
        self.cutouts_per_tile = cutouts_per_tile
        self.batch_size = batch_size
        self.use_overlap = use_overlap
        self.overlap = overlap
        self.shuffle = shuffle
        self.pixel_min = pixel_min
        self.pixel_max = pixel_max
        self.prefetch_batches = prefetch_batches
        self._seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.band_files)

    def _tile_batches(self, band_files, rng) -> Iterator[dict]:
        tile, wcs = load_band_stack(band_files, return_wcs=True)
        if self.use_overlap:
            cutouts, ra_dec = overlapping_cutouts(tile, self.img_size, self.overlap, wcs)
        else:
            cutouts, ra_dec = random_cutouts(
                tile, self.img_size, self.cutouts_per_tile, wcs, rng
            )
        if self.pixel_min is not None:
            np.maximum(cutouts, self.pixel_min, out=cutouts)
        if self.pixel_max is not None:
            np.minimum(cutouts, self.pixel_max, out=cutouts)
        if ra_dec is None:
            ra_dec = np.zeros((len(cutouts), 2), np.float32)

        n_full = len(cutouts) // self.batch_size
        for i in range(n_full):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield {"cutouts": cutouts[sl], "ra_dec": ra_dec[sl]}

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        rng = np.random.default_rng(self._seed + self._epoch)
        order = np.arange(len(self.band_files))
        if self.shuffle:
            order = rng.permutation(order)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        _SENTINEL = object()

        def reader():
            try:
                for idx in order:
                    for batch in self._tile_batches(self.band_files[idx], rng):
                        q.put(batch)
            except BaseException as e:
                q.put(e)
                return
            q.put(_SENTINEL)

        threading.Thread(target=reader, daemon=True).start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def forever(self) -> Iterator[dict]:
        while True:
            yield from self


def build_fits_batcher(
    fits_paths: Sequence[str],
    bands: Sequence[str],
    min_bands: int,
    batch_size: int,
    img_size: int = 64,
    cutouts_per_tile: int = 1024,
    use_calexp: bool = True,
    shuffle: bool = True,
    **kwargs,
) -> FitsTileBatcher:
    """Convenience constructor mirroring ``build_fits_dataloader``
    (reference ``dataloaders.py:108-132``)."""
    return FitsTileBatcher(
        fits_paths,
        bands=bands,
        min_bands=min_bands,
        img_size=img_size,
        cutouts_per_tile=cutouts_per_tile,
        batch_size=batch_size,
        use_calexp=use_calexp,
        shuffle=shuffle,
        **kwargs,
    )
