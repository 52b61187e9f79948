"""Precomputed embedding banks (port of ``sky_embeddings_tpu/eval/bank.py``).

:func:`build_bank` streams batches through the encoder, pools each image to
one feature row, standardises by the bank's own statistics and stores bf16
rows. :class:`EmbeddingBank` answers queries with the weighted-cosine
scorers of ``ops/kernels/simscore``, routed as JAX routes them: banks under
:data:`TWO_STAGE_MIN_ROWS` rows, or ``exact=True``, through the single-pass
scorer (K3; kernel 11 for ``query_multi``); larger device-resident banks
through the int8 two-stage scorer; banks over :data:`DEVICE_ROWS_LIMIT`
rows, or features that are not an in-memory tensor (``load(lazy=True)``),
through the chunked scorer, slab by slab from the host. Save/load use the
JAX package's HDF5 layout, so a bank built by either package loads in the
other (bf16 features stored as uint16 bits with ``feat_dtype =
"bfloat16"``); ``h5py`` is imported only there.

The double standardisation quirk is kept: ``build_bank`` divides by
``std + 1e-8`` and ``query`` by ``(std + 1e-8) + 1e-8`` (``bank.py:164,306-307``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from sky_embeddings_tpu_torch.eval.eval_fns import (
    batch_images,
    batch_ra_dec,
    host_array,
    make_encoder,
    model_device,
)
from sky_embeddings_tpu_torch.ops.kernels.simscore import (
    bank_topk,
    bank_topk_chunked,
    bank_topk_int8,
    bank_topk_multi,
    bank_topk_multi_int8,
    quantize_bank_int8,
)
from sky_embeddings_tpu_torch.ops.similarity import target_features
from sky_embeddings_tpu_torch.utils.device import resolve_device
from sky_embeddings_tpu_torch.utils.misc import select_centre

# the JAX package's routing thresholds (bank.py:52,56)
DEVICE_ROWS_LIMIT = 2_500_000
TWO_STAGE_MIN_ROWS = 1 << 16


def _features_to_numpy(feats: torch.Tensor) -> tuple[np.ndarray, str]:
    """HDF5 has no bf16: store the raw bits as uint16."""
    if feats.dtype == torch.bfloat16:
        return feats.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return feats.numpy(), str(feats.numpy().dtype)


def _features_from_numpy(arr: np.ndarray, feat_dtype: str) -> torch.Tensor:
    if feat_dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class _DiskFeatures:
    """Row-sliceable view of an on-disk feature dataset (bf16 stored as raw
    uint16 bits); feeds ``bank_topk_chunked`` without loading the bank."""

    def __init__(self, dataset, feat_dtype: str):
        self._ds = dataset
        self._dtype = feat_dtype

    @property
    def shape(self):
        return self._ds.shape

    def __getitem__(self, sl) -> torch.Tensor:
        return _features_from_numpy(self._ds[sl], self._dtype)


class EmbeddingBank:
    """(N, D) standardised pooled features (a CPU tensor, copied to
    ``device`` on first query, or a row-sliceable host view that queries
    stream in slabs) + (N, 2) ra/dec + bank stats."""

    def __init__(self, features, ra_decs: np.ndarray, mean: np.ndarray,
                 std: np.ndarray, pool: str = "mean", n_extra: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.features = features
        self.ra_decs = ra_decs
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.pool = pool
        self.n_extra = int(n_extra)
        self._device_bank = None
        self._device_int8_bank = None

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        import h5py

        feats, feat_dtype = _features_to_numpy(self.features.cpu())
        with h5py.File(path, "w") as f:
            f.create_dataset(
                "features", data=feats, chunks=(min(len(feats), 1 << 14), feats.shape[1]),
            )
            f.create_dataset("ra_decs", data=self.ra_decs)
            f.create_dataset("mean", data=self.mean)
            f.create_dataset("std", data=self.std)
            f.attrs["pool"] = self.pool
            f.attrs["n_extra"] = self.n_extra
            f.attrs["feat_dtype"] = feat_dtype

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda",
             lazy: bool = False) -> "EmbeddingBank":
        """``lazy=True`` keeps the features as a slab-sliceable view of the
        open file (banks larger than host memory: queries stream slabs from
        disk through the chunked scorer)."""
        import h5py

        f = h5py.File(path, "r")  # a lazy bank's features keep it open
        try:
            feat_dtype = str(f.attrs.get("feat_dtype", "float32"))
            if lazy:
                feats = _DiskFeatures(f["features"], feat_dtype)
            else:
                feats = _features_from_numpy(f["features"][:], feat_dtype)
            return cls(feats, f["ra_decs"][:], f["mean"][:], f["std"][:],
                       pool=str(f.attrs.get("pool", "mean")),
                       n_extra=int(f.attrs.get("n_extra", 1)), device=device)
        finally:
            if not lazy:
                f.close()

    # -- queries -------------------------------------------------------
    def query(self, target_latent, k: int = 300, use_weights: bool = True,
              exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(scores, indices) of the best-k rows for a (Bt, Lt, D) target
        group. Device-resident banks of :data:`TWO_STAGE_MIN_ROWS` rows or
        more take the int8 two-stage scorer unless ``exact``; the others the
        single-pass scorer; banks over :data:`DEVICE_ROWS_LIMIT` rows or
        lazy ones the chunked scorer."""
        tgt, w = self._query_target(target_latent, use_weights)
        n = self.features.shape[0]
        if not self._device_resident():
            return bank_topk_chunked(self.features, tgt, w, k)
        bank = self._device()
        if exact or n < TWO_STAGE_MIN_ROWS:
            vals, idx = bank_topk(bank, tgt, w, min(k, n))
        else:
            bank8, rnorm = self._device_int8()
            vals, idx = bank_topk_int8(bank8, rnorm, bank, tgt, w, min(k, n),
                                       oversample=min(max(8192, k), n))
        return vals.cpu().numpy(), idx.cpu().numpy()

    def query_multi(self, target_latents, k: int = 300, use_weights: bool = True,
                    exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Batched :meth:`query`: Q target groups, one bank pass (kernel 11,
        or the int8 two-stage scorer on the same routing as :meth:`query`).
        Returns (Q, k) scores and indices. Needs a device-resident bank."""
        if not self._device_resident():
            raise ValueError(
                "query_multi needs a device-resident bank; for out-of-memory "
                "banks loop bank_topk_chunked per target"
            )
        pairs = [self._query_target(latent, use_weights) for latent in target_latents]
        targets = torch.stack([t for t, _ in pairs])
        weights = torch.stack([w for _, w in pairs])
        n = self.features.shape[0]
        bank = self._device()
        if exact or n < TWO_STAGE_MIN_ROWS:
            vals, idx = bank_topk_multi(bank, targets, weights, min(k, n))
        else:
            bank8, rnorm = self._device_int8()
            vals, idx = bank_topk_multi_int8(bank8, rnorm, bank, targets, weights, min(k, n),
                                             oversample=min(max(2048, k), n))
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _device_resident(self) -> bool:
        return (self.features.shape[0] <= DEVICE_ROWS_LIMIT
                and isinstance(self.features, torch.Tensor))

    def _query_target(self, target_latent, use_weights: bool):
        """A target group's mean feature and weights in the bank's space:
        standardised by the bank stats before the mean/inverse-variance
        collapse, as the streaming path orders it."""
        flat = self._pool_target(target_latent)
        mean = torch.as_tensor(self.mean, device=self.device)
        std = torch.as_tensor(self.std, device=self.device)
        tgt, w = target_features((flat - mean) / (std + 1e-8))
        if not use_weights:
            w = torch.ones_like(w) / w.shape[0]
        return tgt, w

    def _pool_target(self, target_latent) -> torch.Tensor:
        """Target tokens in the bank's feature space: ``central`` banks hold
        the central-4-patch flattened features, so targets collapse the same
        way; other pool modes keep the token-level collapse."""
        flat = torch.as_tensor(np.asarray(target_latent, np.float32), device=self.device)
        if self.pool == "central":
            sel = select_centre(flat[:, self.n_extra:], 4)
            flat = sel.reshape(sel.shape[0], -1)
        return flat

    def _device(self) -> torch.Tensor:
        if self._device_bank is None:
            self._device_bank = self.features.to(self.device).contiguous()
        return self._device_bank

    def _device_int8(self):
        """The device bank quantised for the stage-1 int8 cut, made once."""
        if self._device_int8_bank is None:
            self._device_int8_bank = quantize_bank_int8(self._device())
        return self._device_int8_bank


@torch.inference_mode()
def build_bank(
    model,
    batches: Iterable[dict],
    pool: str = "mean",
    dtype: torch.dtype = torch.bfloat16,
) -> EmbeddingBank:
    """Encode a survey stream into an :class:`EmbeddingBank` on the model's device.

    ``pool``: 'mean' | 'max' over patch tokens, 'cls' for the cls token, or
    'central' -- the central-4-patch flattened features (4·D rows).
    """
    n_extra = model.num_extra_tokens
    device = model_device(model)
    encode = make_encoder(model)

    def pooled(imgs, ra_dec):
        # pooled in the tokens' dtype (a bf16 mean rounds to bf16), as JAX
        # pools, then widened to fp32 for the bank's statistics
        latent = encode(imgs, ra_dec)
        if pool == "cls":
            return latent[:, 0].float()
        patches = latent[:, n_extra:]
        if pool == "central":
            sel = select_centre(patches, 4)
            return sel.reshape(sel.shape[0], -1).float()
        return (patches.max(dim=1).values if pool == "max" else patches.mean(dim=1)).float()

    rows, ra_decs = [], []
    for batch in batches:
        imgs = batch_images(batch, device)
        rows.append(pooled(imgs, batch_ra_dec(batch, device)).cpu().numpy())
        ra_decs.append(host_array(batch["ra_dec"], np.float32))
    if not rows:
        raise ValueError("build_bank received no batches")
    feats = np.concatenate(rows, axis=0)
    mean = feats.mean(axis=0)
    std = feats.std(axis=0) + 1e-8
    feats = (feats - mean) / std
    return EmbeddingBank(
        torch.from_numpy(feats).to(dtype), np.concatenate(ra_decs, axis=0), mean, std,
        pool=pool, n_extra=n_extra, device=device,
    )
