"""Streaming similarity search over a survey (port of ``mim_simsearch`` and
``mim_simsearch_multi`` from ``sky_embeddings_tpu/eval/simsearch.py``,
reference ``mae_simsearch``).

Per batch: encode -> standardise -> weighted score -> merge into the running
best-k, all on the model's device; the host only feeds batches. Several
target groups share one pass: one encoder call per batch, each group scored
against the shared latent and merged into its own running best-k.

Parity notes kept from the JAX version:
* features are standardised by the mean/std of the FIRST test batch
  (reference quirk, PARITY #6), with ``std + 1e-8``;
* ``cls_token`` keeps only the cls token; otherwise the prefix is dropped and
  ``max_pool`` optionally max-pools over patches;
* after the stream the winners are re-encoded for their features.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from sky_embeddings_tpu_torch.eval.eval_fns import batch_ra_dec, make_encoder, model_device
from sky_embeddings_tpu_torch.ops.similarity import (
    compute_similarity,
    topk_finalize,
    topk_init,
    topk_update,
)


def _select_tokens(latent, num_extra_tokens: int, cls_token: bool, max_pool: bool):
    if cls_token:
        return latent[:, :1]
    latent = latent[:, num_extra_tokens:]
    if max_pool:
        latent = latent.max(dim=1, keepdim=True).values
    return latent


def mim_simsearch(
    model,
    target_latent: np.ndarray,
    batches: Iterable[dict],
    n_save: int = 256,
    metric: str = "cosine",
    combine: str = "min",
    use_weights: bool = True,
    max_pool: bool = False,
    cls_token: bool = False,
    log_every: int = 100,
):
    """Returns (best_images, best_latent, best_ra_decs, best_scores) numpy.

    ``target_latent``: (Bt, Lt, D) token features of the target set with the
    prefix tokens (``extract_latents(..., remove_prefix=False)``).
    """
    return mim_simsearch_multi(
        model, [target_latent], batches, n_save=n_save, metric=metric, combine=combine,
        use_weights=use_weights, max_pool=max_pool, cls_token=cls_token, log_every=log_every,
    )[0]


@torch.inference_mode()
def mim_simsearch_multi(
    model,
    target_latents: list,
    batches: Iterable[dict],
    n_save: int = 256,
    metric: str = "cosine",
    combine: str = "min",
    use_weights: bool = True,
    max_pool: bool = False,
    cls_token: bool = False,
    log_every: int = 100,
):
    """Search the survey for G target groups in ONE pass.

    Encoding every survey cutout is shared across the groups; G running
    best-k sets stay on the device (ties lowest index first, as
    ``lax.top_k``), each group scored as a search for it alone would score
    it. ``target_latents``: list of (Bt_g, Lt, D) token-feature arrays with
    the prefix tokens, one per group. Returns a list of per-group (images,
    latent, ra_decs, scores) numpy arrays, ordered like the input.
    """
    largest = metric == "cosine"
    n_extra = model.num_extra_tokens
    device = model_device(model)
    encode = make_encoder(model)
    targets = [
        _select_tokens(torch.as_tensor(np.asarray(t, np.float32), device=device),
                       n_extra, cls_token, max_pool)
        for t in target_latents
    ]

    topks = None
    mean = std = targets_std = None
    for i, batch in enumerate(batches):
        imgs = torch.as_tensor(np.asarray(batch["cutouts"]), device=device)
        ra_dec = batch_ra_dec(batch, device)
        latent = _select_tokens(encode(imgs, ra_dec).float(), n_extra, cls_token, max_pool)
        if i == 0:
            mean = latent.mean(dim=(0, 1))
            n = latent.shape[0] * latent.shape[1]
            std = torch.sqrt(((latent - mean) ** 2).sum(dim=(0, 1)) / max(n - 1, 1))
            targets_std = [(t - mean) / (std + 1e-8) for t in targets]
            shapes = {"images": (imgs.shape[1:], imgs.dtype), "ra_decs": ((2,), torch.float32)}
            topks = [topk_init(n_save, shapes, device, largest=largest) for _ in targets]
        latent = (latent - mean) / (std + 1e-8)
        payload = {"images": imgs, "ra_decs": ra_dec}
        topks = [
            topk_update(st, compute_similarity(t, latent, metric=metric, combine=combine,
                                               use_weights=use_weights), payload, largest=largest)
            for st, t in zip(topks, targets_std)
        ]
        if log_every and (i + 1) % log_every == 0:
            print(f"Processed {i + 1} image batches...")

    if topks is None:
        raise ValueError("similarity search received no batches")

    results = []
    for st in topks:
        scores, payload = topk_finalize(st, largest=largest)
        best_latent = encode(payload["images"], payload["ra_decs"])
        results.append((
            payload["images"].cpu().numpy(),
            best_latent.float().cpu().numpy(),
            payload["ra_decs"].cpu().numpy(),
            scores.cpu().numpy(),
        ))
    return results
