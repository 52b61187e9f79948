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
* statistics, standardisation and scores are taken in the tokens' dtype
  (bf16 for a bf16 model; reductions accumulate in fp32), targets included,
  so a bf16 search ranks its winners as JAX ranks them;
* ``cls_token`` keeps only the cls token; otherwise the prefix is dropped and
  ``max_pool`` optionally max-pools over patches;
* after the stream the winners are re-encoded for their features.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from sky_embeddings_tpu_torch.eval.eval_fns import (
    batch_images,
    batch_ra_dec,
    make_encoder,
    model_device,
)
from sky_embeddings_tpu_torch.ops.similarity import (
    mean_var,
    score_features,
    target_features,
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
    prefix tokens (``extract_latents(..., remove_prefix=False)``). The
    target's statistics are rounded as JAX's ``mim_simsearch`` takes them,
    inside its compiled step; in bf16 that differs from
    :func:`mim_simsearch_multi`, as the two JAX searches differ.
    """
    return _search(model, [target_latent], batches, n_save, metric, combine, use_weights,
                   max_pool, cls_token, log_every, fused_targets=True)[0]


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
    ``lax.top_k``), each group scored as a one-group search would score it,
    its statistics rounded as JAX's ``mim_simsearch_multi`` takes them,
    op by op. ``target_latents``: list of (Bt_g, Lt, D) token-feature arrays
    with the prefix tokens, one per group. Returns a list of per-group
    (images, latent, ra_decs, scores) numpy arrays, ordered like the input.
    """
    return _search(model, target_latents, batches, n_save, metric, combine, use_weights,
                   max_pool, cls_token, log_every, fused_targets=False)


@torch.inference_mode()
def _search(model, target_latents, batches, n_save, metric, combine, use_weights, max_pool,
            cls_token, log_every, fused_targets):
    largest = metric == "cosine"
    n_extra = model.num_extra_tokens
    device = model_device(model)
    encode = make_encoder(model)
    targets = [torch.as_tensor(np.asarray(t, np.float32), device=device) for t in target_latents]

    topks = feats = None
    mean = std = None
    for i, batch in enumerate(batches):
        imgs = batch_images(batch, device)
        ra_dec = batch_ra_dec(batch, device)
        latent = _select_tokens(encode(imgs, ra_dec), n_extra, cls_token, max_pool)
        if i == 0:
            # the first batch's statistics, as JAX's compiled first_batch_stats
            # takes them
            mean, var = mean_var(latent.reshape(-1, latent.shape[-1]), fused=True)
            std = torch.sqrt(var)
            feats = []
            for t in targets:
                # the targets are the tokens of the same model: exact in its dtype
                t = _select_tokens(t.to(latent.dtype), n_extra, cls_token, max_pool)
                tgt, w = target_features((t - mean) / (std + 1e-8), fused=fused_targets)
                feats.append((tgt, w if use_weights else torch.ones_like(w) / w.shape[0]))
            shapes = {"images": (imgs.shape[1:], imgs.dtype), "ra_decs": ((2,), torch.float32)}
            topks = [topk_init(n_save, shapes, device, largest=largest) for _ in targets]
        latent = (latent - mean) / (std + 1e-8)
        payload = {"images": imgs, "ra_decs": ra_dec}
        topks = [
            topk_update(st, score_features(tgt, w, latent, metric=metric, combine=combine),
                        payload, largest=largest)
            for st, (tgt, w) in zip(topks, feats)
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
