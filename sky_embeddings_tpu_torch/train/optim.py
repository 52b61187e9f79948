"""The MIM pretraining optimizer (port of ``pretrain_optimizer`` and
``decay_mask`` from ``sky_embeddings_tpu/train/optim.py``).

The JAX chain ``scale_by_adam(0.9, 0.95) -> add_decayed_weights(wd, mask)
-> scale_by_learning_rate(schedule)`` is torch's AdamW: both update
``p -= lr · (m̂ / (sqrt(v̂) + eps) + wd · p)`` with eps 1e-8 and decay on the
parameters before the update. The decay mask becomes two parameter groups.
"""

from __future__ import annotations

from typing import Iterable

import torch


def decay_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """True where weight decay applies: ndim > 1 (timm
    ``param_groups_weight_decay``), so the tokens and ``patch_mask_values``
    are decayed, as in JAX's pretraining mask."""
    return {name: p.dim() > 1 for name, p in named_params}


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
