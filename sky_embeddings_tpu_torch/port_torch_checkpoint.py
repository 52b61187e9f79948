"""Port a reference PyTorch checkpoint (``.pth.tar``) into the port's or the
JAX package's checkpoint format (port of the repo's
``tools/port_torch_checkpoint.py``).

    python -m sky_embeddings_tpu_torch.port_torch_checkpoint <ckpt.pth.tar> <config_name>
        <out.ckpt.msgpack | out.ckpt.pt> [--predictor] [--config_dir DIR]

The reference saves ``{batch_iters, losses, optimizer, lr_scheduler, model}``
with timm-style module names (``utils/mim_vit.py`` / ``utils/vit.py``). The
``model`` state dict maps onto the ``SkyMIM`` / ``SkyViT`` parameter tree:

* ``nn.Linear`` weights transpose (out, in) -> (in, out);
* the patch-embed conv kernel (D, C, p, p) permutes to the patchify flatten
  order ((p, p, C), D);
* ``blocks.N.{norm1,attn.qkv,attn.proj}`` -> ``encoder/blockN/...``;
  ``blocks.N.{norm2,mlp.fc1,mlp.fc2}`` -> the fused ``ffn`` flat names;
* the SimMIM conv1x1 decoder maps onto ``decoder_pred``;
* the frozen sin-cos positional tables are skipped (both packages recompute
  them);
* the optimizer and scheduler state is not ported (torch's AdamW moments of
  the reference's parameter order do not map by name): a run resumed from
  the output starts AdamW fresh at ``batch_iters``.

A ``.ckpt.msgpack`` output is the JAX package's format, byte for byte the
file that the JAX tool writes from the same input (``utils/flax_msgpack``);
a ``.ckpt.pt`` output is the port's own, ``{"step", "params" (state dict),
"losses"}``. Both load into the port's trainers and models.
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping

import numpy as np

from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.utils.checkpoint import is_jax_checkpoint, save_checkpoint

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _linear(sd, name):
    out = {"kernel": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T)}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def _norm(sd, name):
    return {"scale": np.asarray(sd[f"{name}.weight"]), "bias": np.asarray(sd[f"{name}.bias"])}


def _block(sd, prefix):
    """One transformer block -> {norm1, attn{qkv,proj}, ffn{...}}."""
    n2 = _norm(sd, f"{prefix}.norm2")
    fc1 = _linear(sd, f"{prefix}.mlp.fc1")
    fc2 = _linear(sd, f"{prefix}.mlp.fc2")
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "attn": {"qkv": _linear(sd, f"{prefix}.attn.qkv"),
                 "proj": _linear(sd, f"{prefix}.attn.proj")},
        "ffn": {"norm_scale": n2["scale"], "norm_bias": n2["bias"],
                "fc1_kernel": fc1["kernel"], "fc1_bias": fc1["bias"],
                "fc2_kernel": fc2["kernel"], "fc2_bias": fc2["bias"]},
    }


def _patch_embed(sd, name="patch_embed.proj"):
    w = np.asarray(sd[f"{name}.weight"])  # (D, C, p, p)
    kernel = np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
    return {"proj": {"kernel": kernel, "bias": np.asarray(sd[f"{name}.bias"])}}


def _siren(sd, prefix="ra_dec_embed.neural_network"):
    out = {}
    i = 0
    while f"{prefix}.layers.{i}.weight" in sd:
        out[f"SirenLayer_{i}"] = {"Dense_0": {
            "kernel": np.asarray(sd[f"{prefix}.layers.{i}.weight"]).T,
            "bias": np.asarray(sd[f"{prefix}.layers.{i}.bias"])}}
        i += 1
    out[f"SirenLayer_{i}"] = {"Dense_0": {
        "kernel": np.asarray(sd[f"{prefix}.last_layer.weight"]).T,
        "bias": np.asarray(sd[f"{prefix}.last_layer.bias"])}}
    return {"SirenNet_0": out}


def _attn_pool(sd, prefix="attn_pool"):
    return {
        "latent": np.asarray(sd[f"{prefix}.latent"]),
        "xattn": {"q": _linear(sd, f"{prefix}.q"), "kv": _linear(sd, f"{prefix}.kv"),
                  "proj": _linear(sd, f"{prefix}.proj")},
        "norm": _norm(sd, f"{prefix}.norm"),
        "mlp": {"fc1": _linear(sd, f"{prefix}.mlp.fc1"), "fc2": _linear(sd, f"{prefix}.mlp.fc2")},
    }


def _blocks(sd, prefix: str) -> dict:
    out, i = {}, 0
    while f"{prefix}.{i}.norm1.weight" in sd:
        out[f"block{i}"] = _block(sd, f"{prefix}.{i}")
        i += 1
    return out


def port_mim_state_dict(sd: Mapping[str, np.ndarray], simmim: bool) -> dict:
    """Reference MaskedAutoencoderViT state dict -> SkyMIM params tree."""
    params: dict = {
        "patch_embed": _patch_embed(sd),
        "cls_token": np.asarray(sd["cls_token"]),
        "patch_mask_values": np.asarray(sd["patch_mask_values"]),
        "norm": _norm(sd, "norm"),
        "encoder": _blocks(sd, "blocks"),
    }
    if "ra_dec_embed.neural_network.last_layer.weight" in sd:
        params["ra_dec_embed"] = _siren(sd)
    if "attn_pool.latent" in sd:
        params["pool"] = _attn_pool(sd)
    if simmim:
        w = np.asarray(sd["decoder.0.weight"])  # (S²C, D, 1, 1) conv1x1
        params["decoder_pred"] = {"kernel": np.ascontiguousarray(w[:, :, 0, 0].T),
                                  "bias": np.asarray(sd["decoder.0.bias"])}
        params["mask_token"] = np.asarray(sd["mask_token"])
    else:
        params["decoder_embed"] = _linear(sd, "decoder_embed")
        params["mask_token"] = np.asarray(sd["mask_token"])
        params["decoder"] = _blocks(sd, "decoder_blocks")
        params["decoder_norm"] = _norm(sd, "decoder_norm")
        params["decoder_pred"] = _linear(sd, "decoder_pred")
    return params


def port_vit_state_dict(sd: Mapping[str, np.ndarray], global_pool: str) -> dict:
    """Reference predictor VisionTransformer state dict -> SkyViT params tree."""
    params: dict = {
        "patch_embed": _patch_embed(sd),
        "cls_token": np.asarray(sd["cls_token"]),
        "patch_mask_values": np.asarray(sd["patch_mask_values"]),
        "encoder": _blocks(sd, "blocks"),
        "head": _linear(sd, "head"),
    }
    if global_pool != "avg":
        params["norm"] = _norm(sd, "norm")
    elif "fc_norm.weight" in sd:
        params["fc_norm"] = _norm(sd, "fc_norm")
    if "ra_dec_embed.neural_network.last_layer.weight" in sd:
        params["ra_dec_embed"] = _siren(sd)
    if global_pool == "map" and "attn_pool.latent" in sd:
        params["pool"] = _attn_pool(sd)
    return params


def main(argv=None) -> str:
    import torch

    p = argparse.ArgumentParser("Port a reference .pth.tar checkpoint")
    p.add_argument("torch_ckpt")
    p.add_argument("config_name")
    p.add_argument("out_path", help="<name>.ckpt.msgpack (the JAX package's) or <name>.ckpt.pt")
    p.add_argument("--predictor", action="store_true")
    p.add_argument("--config_dir", default=os.path.join(REPO_DIR, "configs"))
    args = p.parse_args(argv)

    ckpt = torch.load(args.torch_ckpt, map_location="cpu")
    sd = {k: v.numpy() for k, v in ckpt["model"].items()}
    config = load_config(args.config_name, args.config_dir)
    if args.predictor:
        params = port_vit_state_dict(sd, config["ARCHITECTURE"].str("global_pool", "map"))
    else:
        params = port_mim_state_dict(sd, simmim="mim" in config["ARCHITECTURE"].str("model_type"))
    losses = {str(k): [float(x) for x in np.atleast_1d(np.asarray(v, dtype=np.float64))]
              for k, v in dict(ckpt.get("losses", {})).items()}
    step = int(ckpt.get("batch_iters", 0))
    if is_jax_checkpoint(args.out_path):
        payload = {"step": np.asarray(step, np.int32), "params": params, "losses": losses}
    else:
        payload = {"step": step, "params": params_from_jax(params), "losses": losses}
    save_checkpoint(args.out_path, payload)
    print(f"Ported {len(sd)} tensors -> {args.out_path}")
    print("NOTE: optimizer state is not ported; training resumes with a fresh optimizer.")
    return args.out_path


if __name__ == "__main__":
    main()
