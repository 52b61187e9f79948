"""Learning-rate schedule of MIM pretraining (port of
``sky_embeddings_tpu/train/schedules.py``).

``cosine_annealing`` is the closed form of optax's ``cosine_decay_schedule``
as the JAX package builds it (torch ``CosineAnnealingLR`` with
``eta_min = init_lr / final_lr_factor``, reference ``mim_vit.py:142-144``),
indexed as optax indexes it: update ``t`` (from 0) uses ``lr(t)``, so the
first update uses ``init_lr``.
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
