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

The JAX package's checkpoints hold these chains' optax state in flax's
state-dict form. :func:`load_optax_state` finds its ``ScaleByAdamState`` by
its keys and maps ``mu`` / ``nu`` onto each parameter's ``exp_avg`` /
``exp_avg_sq`` by name and ``count`` onto every ``step``;
:func:`optax_state_dict` writes the chain of a regime back;
:func:`restore_state` loads either framework's file into a trainer.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.models.weights import load_jax_params, params_to_jax
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt

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


# ----------------------------------------------------------------------
# optax's state-dict form (the JAX package's checkpoints) <-> torch AdamW

def _names(model: torch.nn.Module) -> dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def find_adam_state(opt_state) -> Optional[dict]:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) in an optax
    state dict, wherever the chain puts it (``lp`` nests it in
    ``multi_transform``'s ``inner_states/train``), or None."""
    if not isinstance(opt_state, Mapping):
        return None
    if {"count", "mu", "nu"} <= set(opt_state):
        return opt_state
    for key in sorted(opt_state):
        found = find_adam_state(opt_state[key])
        if found is not None:
            return found
    return None


def load_optax_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, opt_state) -> bool:
    """Set ``optimizer``'s AdamW state from optax's state-dict form: ``mu`` and
    ``nu`` onto each parameter's ``exp_avg`` and ``exp_avg_sq`` by name
    (through ``adapt_block_layout``, so a scan-layout tree loads), ``count``
    onto every ``step``. False when ``opt_state`` holds no Adam state."""
    adam = find_adam_state(opt_state)
    if adam is None:
        return False
    template = ckpt.nest(model.state_dict())
    mu = ckpt.flatten(ckpt.adapt_block_layout(adam["mu"], template))
    nu = ckpt.flatten(ckpt.adapt_block_layout(adam["nu"], template))
    count = float(np.asarray(adam["count"]))
    names = _names(model)
    optimizer.state.clear()
    with warnings.catch_warnings():  # moments may view a read-only file buffer; they are copied
        warnings.simplefilter("ignore", UserWarning)
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                if name not in mu or name not in nu:
                    raise KeyError(f"optax state has no moments for {name}")
                optimizer.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": torch.as_tensor(mu[name]).to(p.device, p.dtype, copy=True),
                    "exp_avg_sq": torch.as_tensor(nu[name]).to(p.device, p.dtype, copy=True)}
    return True


def optax_state_dict(optimizer: torch.optim.Optimizer, model: torch.nn.Module, regime: str,
                     step: int) -> dict:
    """``optimizer``'s state in the state-dict form of the JAX package's optax
    chain for ``regime`` (``pretrain``, ``ft``, ``fs``, ``lp`` or ``jepa``;
    JAX ``train/optim.py``, ``train/jepa.py``), every count ``step``:
    ``scale_by_adam -> [add_decayed_weights] -> [scale_by_tree] ->
    scale_by_learning_rate``, ``lp``'s inside ``multi_transform`` with
    empty moments for the frozen parameters, JEPA's with its scheduled decay.
    The decay stage is there when some group decays, as JAX adds it for a
    non-zero ``weight_decay``."""
    names = _names(model)
    state = {names[id(p)]: optimizer.state.get(p, {}) for g in optimizer.param_groups
             for p in g["params"]}

    def moments(key: str) -> dict:
        out = {}
        for name, p in model.named_parameters():
            if name not in state:
                out[name] = {}  # optax.MaskedNode: a frozen lp parameter
            elif key in state[name]:
                out[name] = state[name][key].detach().to("cpu", torch.float32).numpy()
            else:
                out[name] = np.zeros(tuple(p.shape), np.float32)  # before the first step
        return ckpt.nest(out)

    count = {"count": np.asarray(step, np.int32)}
    adam = {"count": np.asarray(step, np.int32), "mu": moments("exp_avg"),
            "nu": moments("exp_avg_sq")}
    if regime == "jepa":
        return {"0": adam, "1": dict(count), "2": dict(count)}
    parts = [adam]
    if any(g["weight_decay"] for g in optimizer.param_groups):
        parts.append({"inner_state": {}})
    if regime == "ft":
        parts.append({})  # scale_by_tree's EmptyState
    parts.append(dict(count))
    chain = {str(i): part for i, part in enumerate(parts)}
    if regime == "lp":
        return {"inner_states": {"freeze": {"inner_state": {}}, "train": {"inner_state": chain}}}
    return chain


def jax_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer, regime: str,
                step: int, seed: int, losses: Mapping, **extra) -> dict:
    """A trainer's state as the JAX package's trainers save it: ``step``,
    ``params`` (JAX's tree), ``opt_state`` (:func:`optax_state_dict`), an
    ``rng`` key (``checkpoint.jax_key``) and ``losses``; ``extra`` entries
    (JEPA's ``target_params``) beside them."""
    return {"step": np.asarray(step, np.int32), "params": params_to_jax(model.state_dict()),
            **extra, "opt_state": optax_state_dict(optimizer, model, regime, step),
            "rng": ckpt.jax_key(seed, step), "losses": dict(losses)}


def restore_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  generator: torch.Generator, seed: int, log_fn: Callable[[str], None] = print):
    """Load the checkpoint at ``path`` into ``model``, ``optimizer`` and
    ``generator``: ``(payload, step, losses)``, or None without a file.

    The port's ``.ckpt.pt`` loads as it was saved. The JAX package's
    ``.ckpt.msgpack`` loads its params in either encoder layout and its
    AdamW moments and step from optax's state (:func:`load_optax_state`);
    its ``jax.random`` key cannot seed a torch generator, which is seeded
    from (``seed``, step) instead, with a line saying so. A file without
    optimizer state (the checkpoint-porting tools') starts AdamW fresh at
    its step, and one without a generator state reseeds it, each with a
    line saying so."""
    payload = ckpt.load_checkpoint(path)
    if payload is None:
        return None
    jax_file = ckpt.is_jax_checkpoint(path)
    if jax_file:
        load_jax_params(model, payload["params"])
    else:
        model.load_state_dict(payload["params"])
    step = int(np.asarray(payload.get("step", 0)))
    if jax_file:
        moments = load_optax_state(optimizer, model, payload.get("opt_state"))
    elif "opt_state" in payload:
        optimizer.load_state_dict(payload["opt_state"])
        moments = True
    else:
        moments = False
    if not moments:
        optimizer.state.clear()
        log_fn(f"The checkpoint holds no optimizer state: AdamW starts fresh at step {step}.")
    if not jax_file and "rng" in payload:
        generator.set_state(payload["rng"])
    else:
        generator.manual_seed(ckpt.generator_seed(seed, step))
        why = ("its jax.random key cannot seed a torch generator" if jax_file
               else "it holds no generator state")
        log_fn(f"The checkpoint's generator: {why}; seeded from seed {seed} and step {step}.")
    losses = (ckpt.losses_to_lists(payload.get("losses")) if jax_file
              else {k: list(v) for k, v in payload.get("losses", {}).items()})
    return payload, step, losses
