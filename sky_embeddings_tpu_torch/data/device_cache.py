"""Device-resident dataset cache for small corpora (port of
``sky_embeddings_tpu/data/device_cache.py``).

When a whole dataset fits in device memory (40k 64×64×5 cutouts are 3.3 GB
in fp32, 1.6 GB in bf16), the bytes cross from the host once and every
batch is an ``index_select`` on the device: the host loader leaves the
step's critical path. For survey-scale files use ``H5Batcher``.

:class:`DeviceDataset` serves the dict batches of ``H5Batcher``
(``{"cutouts", "ra_dec"[, "labels"]}``, tensors on its device), with JAX's
batch order: epoch ``e`` (counted from 1 at each ``iter``) shuffles with
``np.random.default_rng(seed + e)``; ``indices`` keep the caller's order and
duplicates; ``drop_remainder``, ``take`` and ``forever`` behave as in JAX.
It reads an h5 file, or takes the same columns as arrays
(:meth:`DeviceDataset.from_arrays`: the card host has no h5py).
:func:`build_cached_or_streaming_batcher` picks it or ``H5Batcher`` from
the ``[DATA]`` section's ``device_cache`` keys. ``device="cuda"`` without a
card raises.
"""

from __future__ import annotations

import os
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from sky_embeddings_tpu_torch.utils.device import DTYPES, resolve_device

try:
    import h5py
except ImportError:  # pragma: no cover - the card host reads arrays instead
    h5py = None


def _storage_dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


class DeviceDataset:
    """A whole dataset resident on one device; batches are device gathers."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        img_size: int = 64,
        label_keys: Optional[Sequence[str]] = None,
        shuffle: bool = True,
        indices: Optional[Sequence[int]] = None,
        pixel_min: Optional[float] = -3.0,
        pixel_max: Optional[float] = None,
        drop_remainder: bool = True,
        seed: int = 0,
        dtype=torch.float32,
        max_bytes: int = 8 << 30,
        device: str | torch.device = "cuda",
    ):
        """``dtype``: storage dtype on the device (``torch.bfloat16`` or
        ``"bfloat16"`` halves the bytes; the models cast inputs anyway).
        ``max_bytes`` guards against device-loading a survey-scale file: it
        raises with a pointer to ``H5Batcher`` instead."""
        if h5py is None:
            raise ImportError("h5py is required for the HDF5 data path")
        with h5py.File(path, "r") as f:
            self._setup(f, path, batch_size, img_size, label_keys, shuffle, indices, pixel_min,
                        pixel_max, drop_remainder, seed, dtype, max_bytes, device)

    @classmethod
    def from_arrays(cls, data: Mapping[str, np.ndarray], batch_size: int, img_size: int = 64,
                    label_keys: Optional[Sequence[str]] = None, shuffle: bool = True,
                    indices: Optional[Sequence[int]] = None, pixel_min: Optional[float] = -3.0,
                    pixel_max: Optional[float] = None, drop_remainder: bool = True, seed: int = 0,
                    dtype=torch.float32, max_bytes: int = 8 << 30,
                    device: str | torch.device = "cuda", name: str = "arrays") -> "DeviceDataset":
        """The same dataset from the columns an h5 file holds (``cutouts``
        (N, C, H, W), ``ra``, ``dec`` and the label keys), e.g. those of
        ``data/synthetic.make_structured_cutouts``."""
        self = cls.__new__(cls)
        self._setup(data, name, batch_size, img_size, label_keys, shuffle, indices, pixel_min,
                    pixel_max, drop_remainder, seed, dtype, max_bytes, device)
        return self

    def _setup(self, cols, name, batch_size, img_size, label_keys, shuffle, indices, pixel_min,
               pixel_max, drop_remainder, seed, dtype, max_bytes, device) -> None:
        from sky_embeddings_tpu_torch.data.h5_loader import central_crop

        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self.label_keys = list(label_keys) if label_keys else None
        if self.label_keys and "class" in self.label_keys and len(self.label_keys) > 1:
            # one labels array, one dtype: mixing the int 'class' key with
            # float keys would silently truncate the floats
            raise ValueError(
                f"label_keys mixes 'class' with float keys ({self.label_keys}); "
                "use separate datasets per task")
        dtype = _storage_dtype(dtype)
        shape = cols["cutouts"].shape
        n = shape[0] if indices is None else len(indices)
        bytes_needed = n * int(np.prod(shape[1:])) * dtype.itemsize
        if bytes_needed > max_bytes:
            raise ValueError(
                f"{name} needs {bytes_needed / 2**30:.1f} GiB on device "
                f"(> max_bytes={max_bytes / 2**30:.1f} GiB) — use the "
                "streaming H5Batcher for survey-scale files")
        if indices is not None:
            # h5py fancy indexing wants sorted unique rows; un-sort after the
            # gather so caller order is kept and duplicates are served
            uniq, unsort = np.unique(np.asarray(indices), return_inverse=True)
            take = lambda key: np.asarray(cols[key][uniq])[unsort]
        else:
            take = lambda key: np.asarray(cols[key][:])
        cutouts = np.array(take("cutouts"), np.float32)
        if pixel_min is not None:
            np.maximum(cutouts, pixel_min, out=cutouts)
        if pixel_max is not None:
            np.minimum(cutouts, pixel_max, out=cutouts)
        if cutouts.shape[-1] > img_size or cutouts.shape[-2] > img_size:
            cutouts = np.ascontiguousarray(central_crop(cutouts, img_size))
        # the one-time transfers, cast on the host first so that the copy
        # carries the storage dtype's bytes
        self.cutouts = torch.from_numpy(cutouts).to(dtype).to(self.device)
        ra_dec = np.stack([np.asarray(take("ra"), np.float32), np.asarray(take("dec"), np.float32)], 1)
        self.ra_dec = torch.from_numpy(ra_dec).to(self.device)
        self.labels = None
        if self.label_keys:
            labels = np.stack([take(k) for k in self.label_keys], axis=-1)
            if labels.ndim > 2:
                labels = labels.reshape(len(cutouts), -1)
            lab_dtype = np.int32 if "class" in self.label_keys else np.float32
            self.labels = torch.from_numpy(labels.astype(lab_dtype)).to(self.device)
        self.num_samples = int(self.cutouts.shape[0])

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def _gather(self, rows: np.ndarray) -> dict:
        idx = torch.from_numpy(rows).to(self.device)
        batch = {"cutouts": self.cutouts.index_select(0, idx),
                 "ra_dec": self.ra_dec.index_select(0, idx)}
        if self.labels is not None:
            batch["labels"] = self.labels.index_select(0, idx)
        return batch

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(order)
        n_full = self.num_samples // self.batch_size
        for i in range(n_full):
            yield self._gather(order[i * self.batch_size:(i + 1) * self.batch_size])
        rest = order[n_full * self.batch_size:]
        if len(rest) and not self.drop_remainder:
            yield self._gather(rest)

    def take(self, n: int) -> Iterator[dict]:
        for i, batch in enumerate(self):
            if i >= n:
                return
            yield batch

    def forever(self) -> Iterator[dict]:
        while True:
            yield from self


def build_cached_or_streaming_batcher(
    data_cfg,
    path: str,
    batch_size: int,
    img_size: int = 64,
    label_keys: Optional[Sequence[str]] = None,
    shuffle: bool = True,
    indices: Optional[Sequence[int]] = None,
    process_count: int = 1,
    process_index: int = 0,
    num_workers: int = 0,
    log_fn=print,
    device: str | torch.device = "cuda",
):
    """:class:`DeviceDataset` on ``device`` or a streaming ``H5Batcher``, by
    the ``[DATA]`` section:

    - ``device_cache = True | False | auto`` (default ``auto``): ``True``
      caches the whole file on the device; ``auto`` caches only when it fits
      under ``device_cache_bytes`` (default 2 GiB); ``False`` always streams.
    - ``device_cache_dtype = float32 | bfloat16``: the storage dtype.

    Multi-process runs always stream. Both serve the same dict batches with
    the pixel clip left to the training step.
    """
    from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher

    mode = str(data_cfg.get("device_cache", "auto")).strip().lower()
    if mode not in ("true", "false", "auto", "1", "0"):
        raise ValueError(f"device_cache must be True/False/auto, got {mode!r}")
    want = mode in ("true", "1")
    max_bytes = int(data_cfg.int("device_cache_bytes", 2 << 30))
    dtype = DTYPES[data_cfg.str("device_cache_dtype", "float32").strip().lower()]

    if process_count == 1 and (want or mode == "auto"):
        if h5py is None:
            raise ImportError("h5py is required for the HDF5 data path")
        with h5py.File(path, "r") as f:
            n = f["cutouts"].shape[0] if indices is None else len(indices)
            bytes_needed = n * int(np.prod(f["cutouts"].shape[1:])) * dtype.itemsize
        if bytes_needed <= max_bytes:
            log_fn(f"Device-caching {os.path.basename(path)} "
                   f"({bytes_needed / 2**20:.0f} MiB as {str(dtype).split('.')[-1]}).")
            return DeviceDataset(
                path, batch_size=batch_size, img_size=img_size, label_keys=label_keys,
                shuffle=shuffle, indices=indices, pixel_min=None, pixel_max=None,
                dtype=dtype, max_bytes=max_bytes, device=device)
        if want:
            raise ValueError(
                f"device_cache = True but {path} needs {bytes_needed / 2**30:.1f} GiB "
                f"(> device_cache_bytes {max_bytes / 2**30:.1f} GiB); raise the limit or stream")
    elif want and process_count > 1:
        log_fn("device_cache requested but multi-process run — streaming instead.")

    return build_h5_batcher(
        path, batch_size=batch_size, img_size=img_size, label_keys=label_keys, shuffle=shuffle,
        indices=indices, pixel_min=None, pixel_max=None, num_workers=num_workers,
        process_count=process_count, process_index=process_index)
