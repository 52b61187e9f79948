"""Weights between the JAX ``SkyMIM`` params tree and the port's state dict.

The port's modules keep the JAX tree's names and (in, out) kernel layouts
(``models/layers.py``), so the map is a rename of paths: the JAX leaf
``encoder/block0/attn/qkv/kernel`` is the state-dict entry
``encoder.block0.attn.qkv.kernel``, with the same shape and values. The
attention modules map the same way: an ``attn_pool`` model's
``pool/latent``, ``pool/xattn/{q,kv,proj}``, ``pool/norm`` and
``pool/mlp/{fc1,fc2}``, its ``decoder_pred`` at (D, img_size²·C), and an
``Attention``'s ``qkv``/``proj``. Both directions are pure numpy and torch;
the GPU host cannot read flax msgpack checkpoints, so weights cross over as
numpy trees.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (the JAX ``params`` collection) -> state dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: state dict -> nested numpy dict."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val.detach().to("cpu", torch.float32).numpy()
    return tree
