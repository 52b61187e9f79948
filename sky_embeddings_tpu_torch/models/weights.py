"""Weights between the JAX ``SkyMIM`` params tree and the port's state dict.

The port's modules keep the JAX tree's names and (in, out) kernel layouts
(``models/layers.py``), so the map is a rename of paths: the JAX leaf
``encoder/block0/attn/qkv/kernel`` is the state-dict entry
``encoder.block0.attn.qkv.kernel``, with the same shape and values. The
attention modules map the same way: an ``attn_pool`` model's
``pool/latent``, ``pool/xattn/{q,kv,proj}``, ``pool/norm`` and
``pool/mlp/{fc1,fc2}``, its ``decoder_pred`` at (D, img_size²·C), and an
``Attention``'s ``qkv``/``proj``. A predictor (``models/predictor.SkyViT``)
maps the same way: ``patch_embed``, ``cls_token``, ``patch_mask_values``,
``ra_dec_embed``, ``encoder/block*``, then ``norm`` (``map`` and ``token``
pooling) or ``fc_norm`` (``avg``), the ``map`` pool's ``pool/latent``,
``pool/xattn/{q,kv,proj}``, ``pool/norm``, ``pool/mlp/{fc1,fc2}``, and
``head/{kernel,bias}`` at (D, num_labels). An I-JEPA model
(``models/jepa.SkyJEPA``) maps the same way: ``encoder/patch_embed/proj``,
``encoder/patch_mask_values``, ``encoder/encoder/block*``, ``encoder/norm``
and ``predictor/{proj_in,mask_token,blocks/block*,norm,proj_out}`` (the
sin-cos tables are constants in both); its EMA target tree, the
``encoder`` subtree alone (JAX ``train/jepa.py:131``), maps onto a
``JEPAEncoder``'s state dict (``JEPATrainer.target``). A CosmicEmbeds
model (``models/cosmos.CosmicEmbeds``) maps the same way:
``patch_embed/proj``, ``loc_encoder/SirenNet_0/SirenLayer_{0,1}/Dense_0``
(or the ``FCNet_0`` / ``Dense_0`` heads as ``models/location.py`` names
them), ``wave_mlp``, ``mask_token`` at (1, 1, D), ``encoder/block*``,
``norm`` and ``pred`` at (D, p²·C) (the sin-cos grid table a constant in
both). A tree in the scan layout
(``encoder/blocks/block/...``, every leaf stacked over the blocks, as JAX
builds ViT-H) maps to ``encoder.blocks.block.*``, which ``Encoder`` unstacks
into the loop layout as it loads (``models/layers.py``). Both
directions are pure numpy and torch; the trees come from and go to the JAX
package's checkpoints through ``utils/flax_msgpack``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sky_embeddings_tpu_torch.utils.checkpoint import adapt_block_layout, flatten, nest


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (the JAX ``params`` collection; a
    bfloat16 leaf read from a checkpoint is a tensor) -> fp32 state dict,
    copied out of the tree's buffers."""
    return {name: (val.detach().to("cpu", torch.float32, copy=True) if torch.is_tensor(val)
                   else torch.from_numpy(np.array(val, dtype=np.float32)))
            for name, val in flatten(tree).items()}


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a JAX params tree, in the loop or the scan layout, into ``model``."""
    template = nest(model.state_dict())
    model.load_state_dict(params_from_jax(adapt_block_layout(tree, template)))


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: state dict -> nested numpy dict."""
    return nest({name: val.detach().to("cpu", torch.float32).numpy()
                 for name, val in state_dict.items()})
