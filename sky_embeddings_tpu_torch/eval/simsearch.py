"""Streaming similarity search over a survey (port of ``mim_simsearch`` from
``sky_embeddings_tpu/eval/simsearch.py``, reference ``mae_simsearch``).

Per batch: encode -> standardise -> weighted score -> merge into the running
best-k, all on the model's device; the host only feeds batches.

Parity notes kept from the JAX version:
* features are standardised by the mean/std of the FIRST test batch
  (reference quirk, PARITY #6), with ``std + 1e-8``;
* ``cls_token`` keeps only the cls token; otherwise the prefix is dropped and
  ``max_pool`` optionally max-pools over patches;
* after the stream the winners are re-encoded for their features.

``mim_simsearch_multi`` is not ported yet (ROADMAP: multi-target search).
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


@torch.inference_mode()
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
    largest = metric == "cosine"
    n_extra = model.num_extra_tokens
    device = model_device(model)
    encode = make_encoder(model)
    target = _select_tokens(
        torch.as_tensor(np.asarray(target_latent, np.float32), device=device),
        n_extra, cls_token, max_pool,
    )

    def features(imgs, ra_dec):
        return _select_tokens(encode(imgs, ra_dec).float(), n_extra, cls_token, max_pool)

    topk = None
    mean = std = target_std = None
    for i, batch in enumerate(batches):
        imgs = torch.as_tensor(np.asarray(batch["cutouts"]), device=device)
        ra_dec = batch_ra_dec(batch, device)
        latent = features(imgs, ra_dec)
        if i == 0:
            mean = latent.mean(dim=(0, 1))
            n = latent.shape[0] * latent.shape[1]
            std = torch.sqrt(((latent - mean) ** 2).sum(dim=(0, 1)) / max(n - 1, 1))
            target_std = (target - mean) / (std + 1e-8)
            topk = topk_init(
                n_save,
                {"images": (imgs.shape[1:], imgs.dtype), "ra_decs": ((2,), torch.float32)},
                device, largest=largest,
            )
        latent = (latent - mean) / (std + 1e-8)
        scores = compute_similarity(
            target_std, latent, metric=metric, combine=combine, use_weights=use_weights
        )
        topk = topk_update(topk, scores, {"images": imgs, "ra_decs": ra_dec}, largest=largest)
        if log_every and (i + 1) % log_every == 0:
            print(f"Processed {i + 1} image batches...")

    if topk is None:
        raise ValueError("similarity search received no batches")

    scores, payload = topk_finalize(topk, largest=largest)
    best_latent = encode(payload["images"], payload["ra_decs"])
    return (
        payload["images"].cpu().numpy(),
        best_latent.float().cpu().numpy(),
        payload["ra_decs"].cpu().numpy(),
        scores.cpu().numpy(),
    )
