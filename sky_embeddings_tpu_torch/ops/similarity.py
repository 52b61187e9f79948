"""Similarity scoring + running top-k (port of ``sky_embeddings_tpu/ops/similarity.py``).

A target group's token features collapse to one mean feature vector with
inverse-variance feature weights; test samples score against it with a
weighted cosine / MSE / MAE over (sample, patch), combined per sample by
mean/min/max; a running best-k set is kept while the survey streams. Plain
PyTorch: JAX runs this scorer in XLA, not in a Pallas kernel.

Ties in the running top-k break as ``lax.top_k`` does, lowest index first
(``torch.sort(..., stable=True)``; ``torch.topk`` promises no tie order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def target_features(target_latent: torch.Tensor, eps_w: float = 0.0):
    """(B, L, D) target token features -> (mean (D,), weights (D,)).

    Weights are inverse unbiased variance over all (sample, patch) rows,
    normalised to sum 1 (reference ``similarity.py:134-147``)."""
    flat = target_latent.reshape(-1, target_latent.shape[-1])
    mean = flat.mean(dim=0)
    var = ((flat - mean) ** 2).sum(dim=0) / max(flat.shape[0] - 1, 1)
    w = 1.0 / (var + eps_w)
    return mean, w / w.sum()


def weighted_cosine(target, test, weights, eps: float = 1e-6):
    """Weighted cosine similarity of (..., D) test rows vs a (D,) target."""
    dot = torch.einsum("d,...d->...", weights * target, test)
    mag_t = torch.sqrt(torch.sum(weights * target ** 2))
    mag_x = torch.sqrt(torch.einsum("d,...d->...", weights, test ** 2))
    return dot / (mag_t * mag_x + eps)


def weighted_mse(target, test, weights):
    """mean_d(err² · w/Σw) (reference ``weighted_MSE``)."""
    w = weights / weights.sum()
    return torch.einsum("d,...d->...", w, (test - target) ** 2) / test.shape[-1]


def weighted_mae(target, test, weights):
    """mean_d(|err| · w/Σw) (reference ``weighted_MAE``)."""
    w = weights / weights.sum()
    return torch.einsum("d,...d->...", w, torch.abs(test - target)) / test.shape[-1]


def compute_similarity(
    target_latent: torch.Tensor,
    test_latent: torch.Tensor,
    metric: str = "cosine",
    combine: str = "min",
    use_weights: bool = True,
    n_top_sims: Optional[int] = None,
) -> torch.Tensor:
    """(B, L, D) test features vs (Bt, Lt, D) target features -> (B,) scores
    (reference ``compute_similarity``, ``similarity.py:214-268``)."""
    tgt, weights = target_features(target_latent)
    if not use_weights:
        weights = torch.ones_like(weights) / weights.shape[0]

    if metric == "cosine":
        sims = weighted_cosine(tgt, test_latent, weights)
        largest = True
    elif metric.upper() == "MSE":
        sims = weighted_mse(tgt, test_latent, weights)
        largest = False
    elif metric.upper() == "MAE":
        sims = weighted_mae(tgt, test_latent, weights)
        largest = False
    else:
        raise ValueError(f"unknown metric {metric!r}")

    if n_top_sims is not None and sims.dim() > 1:
        vals = torch.topk(sims if largest else -sims, n_top_sims, dim=-1).values
        sims = vals if largest else -vals

    if sims.dim() == 1:
        return sims
    if combine == "mean":
        return sims.mean(dim=1)
    if combine == "min":
        return sims.min(dim=1).values
    if combine == "max":
        return sims.max(dim=1).values
    raise ValueError(f"unknown combine {combine!r}")


class TopK(NamedTuple):
    """Running best-k candidates: scores and a dict payload, each leaf (k, ...)."""

    scores: torch.Tensor  # (k,), always 'larger is better'
    payload: dict


def topk_init(k: int, payload_shapes: dict, device, largest: bool = True) -> TopK:
    """Empty running set. ``payload_shapes`` maps names to (shape, dtype).
    Scores are stored negated for smallest-is-better metrics."""
    scores = torch.full((k,), -torch.inf, device=device)
    payload = {
        name: torch.zeros((k,) + tuple(shape), dtype=dtype, device=device)
        for name, (shape, dtype) in payload_shapes.items()
    }
    return TopK(scores, payload)


def topk_update(state: TopK, scores: torch.Tensor, payload: dict, largest: bool = True) -> TopK:
    """Merge a batch of candidates into the running best-k (reference
    ``update_best_scores``, ``similarity.py:18-35``)."""
    oriented = scores if largest else -scores
    all_scores = torch.cat([state.scores, oriented.to(state.scores.dtype)])
    k = state.scores.shape[0]
    top_vals, order = torch.sort(all_scores, descending=True, stable=True)
    top_idx = order[:k]
    merged = {
        name: torch.cat([state.payload[name], payload[name].to(state.payload[name].dtype)])[top_idx]
        for name in state.payload
    }
    return TopK(top_vals[:k], merged)


def topk_finalize(state: TopK, largest: bool = True):
    """(scores, payload) in final orientation, best first."""
    return (state.scores if largest else -state.scores), state.payload
