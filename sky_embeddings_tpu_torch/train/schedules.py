"""Learning-rate schedules of MIM pretraining and predictor training (port
of ``sky_embeddings_tpu/train/schedules.py``).

``cosine_annealing`` is the closed form of optax's ``cosine_decay_schedule``
as the JAX package builds it (torch ``CosineAnnealingLR`` with
``eta_min = init_lr / final_lr_factor``, reference ``mim_vit.py:142-144``);
``linear_lr`` that of optax's ``linear_schedule`` (torch ``LinearLR`` from 1
to ``1 / final_lr_factor``, reference ``vit.py:182-185``). Both are indexed
as optax indexes them: update ``t`` (from 0) uses ``lr(t)``, so the first
update uses ``init_lr``.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing(init_lr: float, total_iters: int, final_lr_factor: float) -> Callable[[int], float]:
    """lr(t) = init · ((1 - α) · (1 + cos(π · min(t, T) / T)) / 2 + α),
    α = eta_min / init, T = max(total_iters, 1)."""
    eta_min = init_lr / final_lr_factor
    alpha = eta_min / init_lr if init_lr else 0.0
    T = max(total_iters, 1)

    def lr(step: int) -> float:
        t = min(step, T)
        return init_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / T)) + alpha)

    return lr


def linear_lr(init_lr: float, total_iters: int, final_lr_factor: float) -> Callable[[int], float]:
    """lr(t) = init + (init / final_lr_factor - init) · min(t, T) / T,
    T = max(total_iters, 1): linear from init to init / final_lr_factor,
    then held."""
    end = init_lr / final_lr_factor
    T = max(total_iters, 1)

    def lr(step: int) -> float:
        frac = 1.0 - min(max(step, 0), T) / T
        return (init_lr - end) * frac + end

    return lr
