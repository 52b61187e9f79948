"""Single-file checkpoints with the JAX package's payload
(port of ``sky_embeddings_tpu/utils/checkpoint.py``).

One file per model, ``_best`` preferred by readers that want it, written
atomically (temp file + rename). The payload has the JAX keys
(``train/pretrain.py`` ``MIMPretrainer.save``)::

    {"step": int, "params": state dict, "opt_state": optimizer state dict,
     "rng": mask-generator state, "losses": {name: [floats]}}

The port writes ``torch.save`` files, ``<name>.ckpt.pt``. It reads those and
the JAX package's ``<name>.ckpt.msgpack`` (flax msgpack, through
``utils/flax_msgpack``: the GPU host has neither flax nor msgpack), and
writes that format too when a path ends in ``.ckpt.msgpack``, with the
payload in its state-dict form as JAX's ``save_checkpoint`` gives it (lists
as ``{"0": ...}`` dicts, every leaf an array). :func:`find_checkpoint` picks
the port's file of a name, else JAX's.

:func:`adapt_block_layout` converts a nested params dict between the loop
and the scan layouts of the encoder (JAX ``utils/checkpoint.py:73``);
:func:`nest` and :func:`flatten` move between a state dict's dotted names
and that nested form.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.utils import flax_msgpack

CKPT_SUFFIX = ".ckpt.pt"
JAX_CKPT_SUFFIX = ".ckpt.msgpack"  # the JAX package's (flax msgpack)


def checkpoint_path(model_dir: str, model_name: str, best: bool = False) -> str:
    suffix = "_best" + CKPT_SUFFIX if best else CKPT_SUFFIX
    return os.path.join(model_dir, model_name + suffix)


def find_checkpoint(model_dir: str, model_name: str, best: bool = False) -> Optional[str]:
    """The port's checkpoint of ``model_name`` if it exists, else the JAX
    package's of the same name, else None."""
    for suffix in (CKPT_SUFFIX, JAX_CKPT_SUFFIX):
        path = os.path.join(model_dir, model_name + ("_best" if best else "") + suffix)
        if os.path.exists(path):
            return path
    return None


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` names a checkpoint in the JAX package's format."""
    return path.endswith(JAX_CKPT_SUFFIX)


def jax_state_dict_form(tree: Any) -> Any:
    """``tree`` as JAX's ``save_checkpoint`` writes it: flax's state-dict form
    (dicts with str keys, lists and tuples as ``{"0": ...}``) with every
    leaf an array (numpy, or a torch tensor on the host), None kept."""
    if isinstance(tree, Mapping):
        return {str(k): jax_state_dict_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): jax_state_dict_form(v) for i, v in enumerate(tree)}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)


def save_checkpoint(path: str, payload: dict) -> None:
    """Atomically write ``payload`` (tensors, arrays, dicts, lists and
    numbers): ``torch.save``, or for a ``.ckpt.msgpack`` path the JAX
    package's format, byte for byte what its ``save_checkpoint`` writes of
    the same payload."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    if is_jax_checkpoint(path):
        with open(tmp, "wb") as f:
            flax_msgpack.write(f, jax_state_dict_form(payload))
    else:
        torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The payload at ``path`` (tensors on the CPU), or None if there is no
    file. A ``.ckpt.pt`` file loads tensors and plain containers only
    (``weights_only``); a ``.ckpt.msgpack`` file loads as flax restores it,
    its arrays viewing one buffer of the file (bfloat16 ones as tensors)."""
    if not os.path.exists(path):
        return None
    if is_jax_checkpoint(path):
        return flax_msgpack.read(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def losses_to_lists(losses: Optional[Mapping]) -> dict:
    """A restored losses dict as ``{str: [float]}`` (JAX
    ``utils/checkpoint.py:103``): flax's state-dict form stores lists as
    ``{"0": v0, "1": v1, ...}``; undo that."""
    out: dict[str, list] = {}
    for k, v in (losses or {}).items():
        if isinstance(v, Mapping):
            v = [v[i] for i in sorted(v, key=lambda s: int(s))]
        arr = np.asarray(v)
        out[str(k)] = [float(x) for x in np.atleast_1d(arr)]
    return out


def generator_seed(seed: int, step: int) -> int:
    """The seed of a trainer's generator resumed at ``step`` from a JAX
    checkpoint, whose ``jax.random`` key cannot seed a torch generator."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def jax_key(seed: int, step: int) -> np.ndarray:
    """``jax.random.PRNGKey(generator_seed(seed, step))``'s data: the ``rng``
    a checkpoint written for JAX carries."""
    return np.asarray([0, generator_seed(seed, step)], np.uint32)


def nest(state_dict: Mapping) -> dict:
    """Dotted names -> nested dicts (``encoder.block0.attn.qkv.kernel`` ->
    ``{"encoder": {"block0": {"attn": {"qkv": {"kernel": ...}}}}}``)."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Inverse of :func:`nest`."""
    out: dict = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def adapt_block_layout(params: Mapping, template: Mapping) -> dict:
    """Convert a nested params dict between the loop-encoder (``block0``..
    ``blockN``) and scan-encoder (``blocks``, depth-stacked) layouts to match
    ``template``. Applies recursively, so an MAE decoder's nested encoder
    converts too; a no-op when the layouts already agree."""
    from sky_embeddings_tpu_torch.models.layers import stack_block_params, unstack_block_params

    if not isinstance(params, Mapping) or not isinstance(template, Mapping):
        return params
    params = dict(params)
    has_loop = any(k.startswith("block") and k[5:].isdigit() for k in params)
    tmpl_scan = "blocks" in template
    if has_loop and tmpl_scan:
        depth = 1 + max(int(k[5:]) for k in params if k.startswith("block") and k[5:].isdigit())
        params = stack_block_params(params, depth)
    elif "blocks" in params and not tmpl_scan:
        params = unstack_block_params(params)
    return {k: adapt_block_layout(v, template[k]) if k in template else v
            for k, v in params.items()}
