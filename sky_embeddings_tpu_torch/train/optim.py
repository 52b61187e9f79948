"""Optimizers of MIM pretraining and of the three predictor regimes (port of
``sky_embeddings_tpu/train/optim.py``, reference ``vit.py:130-185`` and
``mim_vit.py:119-148``).

The JAX chains are ``scale_by_adam(b1, b2) -> add_decayed_weights(wd, mask)
[-> scale_by_tree(layer scales)] -> scale_by_learning_rate(schedule)``:
each update is ``p -= lr · s · (m̂ / (sqrt(v̂) + eps) + wd · p)`` with eps
1e-8, the decay on the parameters before the update, ``s`` the parameter's
layer scale (1 without layer decay). That is torch's AdamW with one
parameter group per (layer scale, decay or not): a group's ``lr`` is
``schedule(t) · s`` and its ``weight_decay`` is ``wd`` (or 0), so torch's
decoupled decay ``p -= lr_group · wd · p`` equals JAX's ``lr · s · wd · p``.
Each group carries its scale as ``lr_scale``; the trainers set
``lr = schedule(t) · lr_scale`` before every step.

* ``pretrain``: betas 0.9/0.95; decay on parameters with ndim > 1 (timm
  ``param_groups_weight_decay``).
* ``ft``: betas 0.9/0.999, BEiT layer-wise LR decay (scale
  ``layer_decay ** (depth + 1 - layer id)``), no decay on ``cls_token`` /
  ``pos_embed``. PARITY #1: the reference passes its ``weight_decay`` into
  ``param_groups_lrd``'s ``init_lr`` slot, so with ``compat_ft_lr=True``
  (the default) the base LR is the config's ``weight_decay`` and the decay
  is ``FT_DEFAULT_WEIGHT_DECAY`` (0.05).
* ``lp``: only ``head``, ``norm`` / ``fc_norm`` and, for ``map`` pooling,
  ``pool`` are in the optimizer; the frozen parameters get neither updates
  nor decay, as ``optax.set_to_zero`` gives them.
* ``fs``: every parameter, betas 0.9/0.999, the ndim > 1 decay mask.
* ``jepa``: I-JEPA's chain (JAX ``train/jepa.py:44-56, 122-126``),
  ``scale_by_adam(0.9, 0.999) -> u + wd(t) · p`` on the ndim > 1 leaves
  ``-> · -lr(t)``: ``fs``'s AdamW over the context encoder and the
  predictor, whose decayed groups' ``weight_decay`` the trainer sets to
  ``wd(t)`` before every step.
"""

from __future__ import annotations

from typing import Iterable

import torch

FT_DEFAULT_WEIGHT_DECAY = 0.05  # lr_decay.py:14 default, active under the quirk


def decay_mask(named_params: Iterable[tuple[str, torch.Tensor]],
               no_decay_names: tuple[str, ...] = ()) -> dict[str, bool]:
    """True where weight decay applies: ndim > 1 (timm
    ``param_groups_weight_decay``) and no part of the name in
    ``no_decay_names``. Without names the tokens and ``patch_mask_values``
    are decayed, as in JAX's pretraining mask."""
    return {name: p.dim() > 1 and not any(k in name.split(".") for k in no_decay_names)
            for name, p in named_params}


def vit_layer_id(name: str, depth: int) -> int:
    """BEiT layer id of a parameter (reference ``lr_decay.get_layer_id_for_vit``,
    ``lr_decay.py:60-74``): embeddings and tokens 0, block i i + 1, everything
    else (norm, head, pool) depth + 1."""
    path = name.split(".")
    for part in path:
        if part.startswith("block"):
            try:
                return int(part[5:]) + 1
            except ValueError:
                continue
    if any(p in ("patch_embed", "cls_token", "pos_embed") for p in path):
        return 0
    return depth + 1


def layer_scale_tree(named_params: Iterable[tuple[str, torch.Tensor]], depth: int,
                     layer_decay: float) -> dict[str, float]:
    """Per-parameter LR multiplier: layer_decay ** (depth + 1 - layer id)."""
    return {name: layer_decay ** (depth + 1 - vit_layer_id(name, depth)) for name, _ in named_params}


def _lp_trainable(name: str, global_pool: str) -> bool:
    """Head-only training set (reference ``vit.py:146-161``): the final norm,
    fc_norm, the head, and the attention pool for ``map`` pooling."""
    path = name.split(".")
    if "head" in path:
        return True
    if any(p in ("norm", "fc_norm") for p in path):
        return True
    return global_pool == "map" and "pool" in path


def trainable_mask(named_params: Iterable[tuple[str, torch.Tensor]], train_method: str,
                   global_pool: str) -> dict[str, bool]:
    """Which parameters the regime updates."""
    if train_method in ("lp", "linearprobe"):
        return {name: _lp_trainable(name, global_pool) for name, _ in named_params}
    return {name: True for name, _ in named_params}


def _adamw(named, init_lr: float, weight_decay: float, betas, mask: dict[str, bool],
           scales: dict[str, float] | None = None) -> torch.optim.AdamW:
    """AdamW (eps 1e-8) with one group per (layer scale, decayed or not), in
    the order the parameters come; each group's ``lr_scale`` multiplies the
    schedule's lr."""
    groups: dict[tuple[float, bool], dict] = {}
    for name, p in named:
        s = 1.0 if scales is None else scales[name]
        key = (s, mask[name])
        if key not in groups:
            groups[key] = {"params": [], "names": [], "lr_scale": s, "lr": init_lr * s,
                           "weight_decay": weight_decay if mask[name] else 0.0}
        groups[key]["params"].append(p)
        groups[key]["names"].append(name)
    return torch.optim.AdamW(list(groups.values()), lr=init_lr, betas=betas, eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's lr = ``lr`` times its ``lr_scale`` (1 when absent)."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


def pretrain_optimizer(model: torch.nn.Module, init_lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW(betas 0.9/0.95, eps 1e-8) over ``model``'s parameters in two
    groups by :func:`decay_mask` (reference ``mim_vit.py:126-129``). The
    trainer sets each group's ``lr`` from the schedule before every step."""
    named = list(model.named_parameters())
    mask = decay_mask(named)
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=init_lr, betas=(0.9, 0.95), eps=1e-8)


def finetune_optimizer(model: torch.nn.Module, depth: int, layer_decay: float, init_lr: float,
                       weight_decay: float, compat_ft_lr: bool = True) -> tuple[torch.optim.AdamW, float]:
    """Layer-wise LR decay fine-tuning (reference ``vit.py:138-144``):
    ``(optimizer, base_lr)``, the base LR that the schedule starts from
    (the config's ``weight_decay`` under PARITY #1)."""
    if compat_ft_lr:
        base_lr, wd = weight_decay, FT_DEFAULT_WEIGHT_DECAY
    else:
        base_lr, wd = init_lr, weight_decay
    named = list(model.named_parameters())
    scales = layer_scale_tree(named, depth, layer_decay)
    mask = decay_mask(named, no_decay_names=("cls_token", "pos_embed"))
    return _adamw(named, base_lr, wd, (0.9, 0.999), mask, scales), base_lr


def linear_probe_optimizer(model: torch.nn.Module, init_lr: float, weight_decay: float,
                           global_pool: str) -> torch.optim.AdamW:
    """AdamW over the head's parameters alone (the backbone frozen)."""
    named = [(n, p) for n, p in model.named_parameters() if _lp_trainable(n, global_pool)]
    return _adamw(named, init_lr, weight_decay, (0.9, 0.999), decay_mask(named))


def supervised_optimizer(model: torch.nn.Module, init_lr: float, weight_decay: float) -> torch.optim.AdamW:
    """Fully-supervised AdamW (reference ``vit.py:163-171``)."""
    named = list(model.named_parameters())
    return _adamw(named, init_lr, weight_decay, (0.9, 0.999), decay_mask(named))

