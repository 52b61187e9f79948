"""Single-file checkpoints with the JAX package's payload
(port of ``sky_embeddings_tpu/utils/checkpoint.py``).

One file per model, ``_best`` preferred by readers that want it, written
atomically (temp file + rename). The payload has the JAX keys
(``train/pretrain.py`` ``MIMPretrainer.save``)::

    {"step": int, "params": state dict, "opt_state": optimizer state dict,
     "rng": mask-generator state, "losses": {name: [floats]}}

It is a ``torch.save`` file: the GPU host has neither flax nor msgpack.

:func:`adapt_block_layout` converts a nested params dict between the loop
and the scan layouts of the encoder (JAX ``utils/checkpoint.py:73``);
:func:`nest` and :func:`flatten` move between a state dict's dotted names
and that nested form.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Optional

import torch

CKPT_SUFFIX = ".ckpt.pt"


def checkpoint_path(model_dir: str, model_name: str, best: bool = False) -> str:
    suffix = "_best" + CKPT_SUFFIX if best else CKPT_SUFFIX
    return os.path.join(model_dir, model_name + suffix)


def save_checkpoint(path: str, payload: dict) -> None:
    """Atomically write ``payload`` (tensors, dicts, lists and numbers)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The payload at ``path`` (tensors on the CPU), or None if there is no
    file. Loads tensors and plain containers only (``weights_only``)."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


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
