"""Similarity scoring + running top-k (port of ``sky_embeddings_tpu/ops/similarity.py``).

A target group's token features collapse to one mean feature vector with
inverse-variance feature weights; test samples score against it with a
weighted cosine / MSE / MAE over (sample, patch), combined per sample by
mean/min/max; a running best-k set is kept while the survey streams. Plain
PyTorch: JAX runs this scorer in XLA, not in a Pallas kernel.

Statistics and scores are taken in the features' dtype, rounded where JAX
rounds them: each elementwise op and each product's output in that dtype,
sums accumulated in fp32 and rounded once. Inside a compiled JAX step a sum
also takes the unrounded result of the op that feeds it (XLA folds that op
into the reduction); outside one, every op rounds. So the per-patch scores
stay fp32 until the combine reduces them and the combine rounds, and
:func:`target_features` takes ``fused`` for target statistics that JAX
computes inside a step. For fp32 features all of this is the plain fp32
arithmetic.

The running top-k ranks as ``lax.top_k`` does: by the float total order,
where a NaN with the sign bit set sorts below -inf and one without it above
+inf (``torch.sort`` puts every NaN first), and ties break lowest index
first (a stable sort; ``torch.topk`` promises no tie order). A target group
with zero variance scores NaN everywhere; on x86 that NaN is negative, so
such a search keeps its empty slots in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def mean_var(flat: torch.Tensor, fused: bool = False):
    """Per-column mean and unbiased variance of (n, D) rows in their dtype:
    fp32 sums, each rounded once; the squared deviations rounded first
    unless ``fused`` (a compiled step's sum takes them unrounded)."""
    dt = flat.dtype
    n = flat.shape[0]
    mean = (flat.float().sum(dim=0) / n).to(dt)
    d = flat - mean
    sq = d.float() * d.float() if fused else (d * d).float()
    return mean, (sq.sum(dim=0).to(dt).float() / max(n - 1, 1)).to(dt)


def target_features(target_latent: torch.Tensor, eps_w: float = 0.0, fused: bool = False):
    """(B, L, D) target token features -> (mean (D,), weights (D,)).

    Weights are inverse unbiased variance over all (sample, patch) rows,
    normalised to sum 1 (reference ``similarity.py:134-147``); ``fused``
    rounds the variance as a compiled JAX step does (:func:`mean_var`)."""
    mean, var = mean_var(target_latent.reshape(-1, target_latent.shape[-1]), fused)
    w = 1.0 / (var.float() + eps_w)
    total = w.sum().to(var.dtype) if fused else w.to(var.dtype).sum()
    return mean, w.to(var.dtype) / total


def weighted_cosine(target, test, weights, eps: float = 1e-6):
    """Weighted cosine similarity of (..., D) test rows vs a (D,) target, in
    fp32 from the features' dtype (round it to that dtype to finish)."""
    dt = test.dtype
    dot = torch.einsum("d,...d->...", weights * target, test)
    mag_t = torch.sqrt((weights.float() * (target ** 2).float()).sum().to(dt))
    mag_x = torch.sqrt(torch.einsum("d,...d->...", weights, test ** 2))
    return dot.float() / (mag_t * mag_x + eps).float()


def weighted_mse(target, test, weights):
    """mean_d(err² · w/Σw) (reference ``weighted_MSE``), in fp32 from the
    features' dtype."""
    w = weights / weights.sum()
    return torch.einsum("d,...d->...", w, (test - target) ** 2).float() * (1.0 / test.shape[-1])


def weighted_mae(target, test, weights):
    """mean_d(|err| · w/Σw) (reference ``weighted_MAE``), in fp32 from the
    features' dtype."""
    w = weights / weights.sum()
    return torch.einsum("d,...d->...", w, torch.abs(test - target)).float() * (1.0 / test.shape[-1])


def compute_similarity(
    target_latent: torch.Tensor,
    test_latent: torch.Tensor,
    metric: str = "cosine",
    combine: str = "min",
    use_weights: bool = True,
    n_top_sims: Optional[int] = None,
) -> torch.Tensor:
    """(B, L, D) test features vs (Bt, Lt, D) target features -> (B,) scores
    in the features' dtype (reference ``compute_similarity``,
    ``similarity.py:214-268``)."""
    tgt, weights = target_features(target_latent)
    if not use_weights:
        weights = torch.ones_like(weights) / weights.shape[0]
    return score_features(tgt, weights, test_latent, metric, combine, n_top_sims)


def score_features(tgt: torch.Tensor, weights: torch.Tensor, test_latent: torch.Tensor,
                   metric: str = "cosine", combine: str = "min",
                   n_top_sims: Optional[int] = None) -> torch.Tensor:
    """(B, L, D) test features vs a target's (mean, weights) -> (B,) scores in
    the features' dtype, each sample's patches combined by ``combine``."""
    dt = test_latent.dtype
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
        sims = sims.to(dt)
        vals = torch.topk(sims if largest else -sims, n_top_sims, dim=-1).values
        sims = vals if largest else -vals

    if sims.dim() == 1:
        return sims.to(dt)
    # min and max commute with the (monotone) rounding; the mean rounds its
    # fp32 sum once
    if combine == "mean":
        return (sims.float().sum(dim=1) * (1.0 / sims.shape[1])).to(dt)
    if combine == "min":
        return sims.min(dim=1).values.to(dt)
    if combine == "max":
        return sims.max(dim=1).values.to(dt)
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


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order fp32 values as the float total order does:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    bits = x.float().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_update(state: TopK, scores: torch.Tensor, payload: dict, largest: bool = True) -> TopK:
    """Merge a batch of candidates into the running best-k (reference
    ``update_best_scores``, ``similarity.py:18-35``)."""
    oriented = scores if largest else -scores
    all_scores = torch.cat([state.scores, oriented.to(state.scores.dtype)])
    k = state.scores.shape[0]
    top_idx = torch.sort(_total_order_key(all_scores), descending=True, stable=True)[1][:k]
    merged = {
        name: torch.cat([state.payload[name], payload[name].to(state.payload[name].dtype)])[top_idx]
        for name in state.payload
    }
    return TopK(all_scores[top_idx], merged)


def topk_finalize(state: TopK, largest: bool = True):
    """(scores, payload) in final orientation, best first."""
    return (state.scores if largest else -state.scores), state.payload
