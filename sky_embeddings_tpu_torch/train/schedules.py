"""Learning-rate schedules of MIM pretraining and predictor training (port
of ``sky_embeddings_tpu/train/schedules.py``).

``cosine_annealing`` is the closed form of optax's ``cosine_decay_schedule``
as the JAX package builds it (torch ``CosineAnnealingLR`` with
``eta_min = init_lr / final_lr_factor``, reference ``mim_vit.py:142-144``);
``linear_lr`` that of optax's ``linear_schedule`` (torch ``LinearLR`` from 1
to ``1 / final_lr_factor``, reference ``vit.py:182-185``). Both are indexed
as optax indexes them: update ``t`` (from 0) uses ``lr(t)``, so the first
update uses ``init_lr``.

I-JEPA's three schedules (JAX ``train/jepa.py:96-107, 196``), indexed the
same way: ``warmup_cosine_decay`` (optax's ``warmup_cosine_decay_schedule``
as the JEPA trainer calls it: linear warmup from ``start_lr`` to
``ref_lr`` over ``max(int(0.1 · T), 1)`` updates, then cosine decay to
``final_lr`` at ``T``), ``cosine_ramp`` (the weight decay's cosine ramp
from ``weight_decay`` to ``final_weight_decay``) and ``linear_ramp`` (the
EMA momentum's linear ramp), the last two in JAX's fp32.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


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


def warmup_cosine_decay(init_lr: float, peak_lr: float, total_iters: int,
                        end_lr: float) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(init_lr, peak_lr, W, T, end_lr)``
    with W = max(int(0.1 · T), 1): lr(t) = init + (peak - init) · t / W for
    t < W, then peak · ((1 - α) · (1 + cos(π · min(t - W, T - W) / (T - W)))
    / 2 + α), α = end / peak. Raises where optax does (T <= W)."""
    warmup = max(int(0.1 * total_iters), 1)
    decay = total_iters - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs positive steps, got {decay} "
                         f"(total {total_iters}, warmup {warmup})")
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def lr(step: int) -> float:
        if step < warmup:
            frac = 1.0 - min(max(step, 0), warmup) / warmup
            return (init_lr - peak_lr) * frac + peak_lr
        t = min(step - warmup, decay)
        return peak_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)

    return lr


def cosine_ramp(start: float, end: float, total_iters: int) -> Callable[[int], float]:
    """v(t) = end + (start - end) · (1 + cos(π · clip(t / T, 0, 1))) / 2, in
    fp32 as JAX's JEPA trainer computes its weight decay."""
    f32 = np.float32

    def value(step: int) -> float:
        frac = np.clip(f32(step) / f32(total_iters), f32(0), f32(1))
        return float(f32(end) + f32(start - end) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac)))

    return value


def linear_ramp(start: float, end: float, total_iters: int) -> Callable[[int], float]:
    """v(t) = start + (end - start) · clip(t / T, 0, 1), in fp32 as JAX's JEPA
    trainer computes its EMA momentum."""
    f32 = np.float32

    def value(step: int) -> float:
        frac = np.clip(f32(step) / f32(total_iters), f32(0), f32(1))
        return float(f32(start) + f32(end - start) * frac)

    return value
