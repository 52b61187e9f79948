"""Single-file checkpoints with the JAX package's payload
(port of ``sky_embeddings_tpu/utils/checkpoint.py``).

One file per model, ``_best`` preferred by readers that want it, written
atomically (temp file + rename). The payload has the JAX keys
(``train/pretrain.py`` ``MIMPretrainer.save``)::

    {"step": int, "params": state dict, "opt_state": optimizer state dict,
     "rng": mask-generator state, "losses": {name: [floats]}}

It is a ``torch.save`` file: the GPU host has neither flax nor msgpack.
"""

from __future__ import annotations

import os
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
