"""Parameter sharding rules for tensor parallelism (port of
``sky_embeddings_tpu/parallel/sharding.py``).

JAX annotates every parameter with a ``PartitionSpec`` over the mesh's
'model' axis (Megatron-style) and lets GSPMD insert the all-reduces:
qkv / fc1 / kv / q kernels column-parallel, proj / fc2 kernels
row-parallel, the column-parallel biases split with their kernels, the
patch embedding column-parallel, everything else replicated; a scan-layout
leaf gets an unsharded leading depth axis. :func:`param_specs` reports
that rule table as it is, leaf for leaf (:class:`PartitionSpec` is a tuple
like JAX's), over a nested params tree or a flat state dict.

What the port shards (:func:`param_shardings`) is narrower, because its
tensor parallelism lives in the block kernels' tensor-parallel forms
(``ops/kernels/attn_block.py``, ``mlp_block.py``) and nowhere else:

- in every transformer block (``...block<i>.`` of an encoder, the MAE
  decoder or the I-JEPA predictor) that ``tp`` ranks can split, the
  attention's qkv kernel and bias and proj kernel, and the MLP's fc1
  kernel and bias and fc2 kernel, each over ``tp`` ranks;
- qkv by heads, not contiguously: JAX's ``P(None, "model")`` splits the
  (D, 3D) kernel's columns into contiguous blocks and XLA reshards after
  the ``(B, N, 3, H, hd)`` reshape, while the port's attention cores read
  q, k and v at columns 0, D and 2D of a row. So rank ``r`` holds ``[q_r |
  k_r | v_r]``, the columns of its own ``H / tp`` heads from each third
  (and ``bqkv`` alike): its heads' q, k and v at columns 0, Dl and 2 Dl of
  its (D, 3 Dl) shard, Dl = D / tp;
- fc1 / fc2 and ``fc1_bias`` contiguously, exactly as JAX's specs say;
  proj's rows likewise (the head-major rows of ctx);
- everything else whole on every rank: the LayerNorms, ``bproj`` and
  ``fc2_bias`` (added after the all-reduce), and the small layers JAX also
  shards but no kernel of the port takes sharded, computed whole on every
  rank: the patch embedding, the attention pool's ``q`` / ``kv`` / ``proj``
  / ``fc1`` / ``fc2``, the MAE ``decoder_embed``, I-JEPA's ``proj_in`` /
  ``proj_out`` / ``mask_token`` / ``patch_mask_values`` and the heads.
  Their gradients come out alike on every rank from replicated inputs.

The whole-block rule: a block whose heads or MLP width ``tp`` does not
divide (``num_heads % tp`` or ``F % tp`` nonzero: the I-JEPA predictor's
3 heads at 192 wide and 1 at 96, ``jepa_tiny``'s 3-head encoder,
``maesimple``'s one-head decoder) is not split at all. All its parameters
are whole on every rank, it runs the ordinary recompute kernels (K2 and
kernel 4, K1 and kernel 8) on the replicated activations, and its
gradients come out alike on every rank, so they are not reduced over the
model group, as the LayerNorms' are not. JAX has no such rule (GSPMD
splits qkv's columns contiguously, whatever the head count, and
reshards), so :func:`param_specs` still reports JAX's specs for every
block; only the port's layout differs. An uneven head split would leave a
one-head block's second rank empty and need other kernel forms; the blocks
the rule covers are narrow, so keeping them whole costs little memory.

Which blocks split is a property of the built model: :func:`split_blocks`
decides it from each block's heads and MLP width, :func:`shard_module`
hands the mesh to those blocks alone, and :func:`split_of` reads the set
back from the blocks that hold it. Every function that maps names to
layouts (:func:`param_shardings`, :func:`shard_of`, :func:`shard_state`,
:func:`gather_state`, :func:`gather_to_main`) takes that set (``split``,
the dotted names of the split blocks), since a leaf's name alone cannot
say whether its block's heads divide.

:func:`shard_state` turns a whole state dict into rank ``r``'s, and
:func:`gather_state` the ranks' back into the whole one, exactly (slices
and concatenations, no arithmetic). :func:`shard_module` does it in place
on a built model (so a rank starts from the same seeded init as one
process); :func:`gather_to_main` collects a sharded state dict on the
model group's first rank with broadcasts alone (which gloo takes on CUDA
tensors too).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AbstractSet, Mapping, Optional

import torch

_COLUMN = ("qkv", "fc1", "kv", "q")
_ROW = ("proj", "fc2")


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per array axis, the mesh axis
    name it is split over or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _stacked(names) -> bool:
    return any(a == "blocks" and b == "block" for a, b in zip(names, names[1:]))


def _spec_for(path: tuple[str, ...]) -> PartitionSpec:
    """JAX's rule for one leaf's path (JAX ``sharding.py`` ``_spec_for``)."""
    names = list(path)
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    stacked = _stacked(names)

    def out(spec: PartitionSpec) -> PartitionSpec:
        return P(None, *spec) if stacked else spec

    if "patch_embed" in names:
        if leaf == "kernel":
            return P(None, "model")
        return P("model") if leaf == "bias" else P()
    if leaf == "kernel":
        if parent in _COLUMN:
            return out(P(None, "model"))
        if parent in _ROW:
            return out(P("model", None))
    if leaf == "bias" and parent in _COLUMN:
        return out(P("model"))
    if leaf == "fc1_kernel":
        return out(P(None, "model"))
    if leaf == "fc2_kernel":
        return out(P("model", None))
    if leaf == "fc1_bias":
        return out(P("model"))
    return P()


def _map_paths(fn, tree: Mapping, prefix: tuple = ()) -> dict:
    """``fn(path)`` over the leaves of a nested dict, or of a flat state
    dict whose dotted names are the paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _map_paths(fn, v, prefix + (str(k),))
        else:
            out[k] = fn(prefix + tuple(str(k).split(".")))
    return out


def param_specs(params: Mapping) -> dict:
    """JAX's ``PartitionSpec`` of every leaf of ``params`` (a nested JAX
    params tree or a flat state dict), in its structure."""
    return _map_paths(_spec_for, params)


@dataclass(frozen=True)
class TPShard:
    """How the port splits a leaf over the model axis: along ``axis``,
    contiguously or (``heads``) as qkv's head groups."""

    axis: int
    heads: bool = False


_BLOCK_RULES = {  # (module, leaf) in a transformer block -> (axis, heads)
    ("qkv", "kernel"): (1, True), ("qkv", "bias"): (0, True), ("proj", "kernel"): (0, False),
    ("ffn", "fc1_kernel"): (1, False), ("ffn", "fc1_bias"): (0, False),
    ("ffn", "fc2_kernel"): (0, False),
}


def _block_of(path: tuple[str, ...]) -> Optional[str]:
    """The dotted name of the transformer block a leaf's path lies in
    (``encoder.block3``, or a scan layout's ``...blocks.block``), None
    outside one."""
    for i, n in enumerate(path):
        if n.startswith("block") and n[5:].isdigit():
            return ".".join(path[:i + 1])
        if n == "blocks" and path[i + 1:i + 2] == ("block",):
            return ".".join(path[:i + 2])
    return None


def _shard_for(path: tuple[str, ...], split: AbstractSet[str]) -> Optional[TPShard]:
    rule = _BLOCK_RULES.get(path[-2:]) if _block_of(path) in split else None
    return None if rule is None else TPShard(rule[0] + int(_stacked(path)), rule[1])


def param_shardings(params: Mapping, split: AbstractSet[str]) -> dict:
    """The port's layout of every leaf of ``params`` (nested or flat):
    a :class:`TPShard`, or None for a leaf every rank holds whole; only
    the blocks named in ``split`` split."""
    return _map_paths(lambda path: _shard_for(path, split), params)


def shard_of(name: str, split: AbstractSet[str]) -> Optional[TPShard]:
    """:func:`param_shardings` of one state-dict name."""
    return _shard_for(tuple(name.split(".")), split)


def shard_tensor(t: torch.Tensor, shard: Optional[TPShard], rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s part of the whole ``t`` (``t`` itself when whole)."""
    if shard is None or tp == 1:
        return t
    n = t.shape[shard.axis]
    if shard.heads:  # the axis is [q | k | v], each D wide: this rank's columns of each
        d = n // 3
        parts = t.unflatten(shard.axis, (3, d)).chunk(tp, dim=shard.axis + 1)[rank]
        return parts.flatten(shard.axis, shard.axis + 1).contiguous()
    if n % tp:
        raise ValueError(f"axis {shard.axis} of {tuple(t.shape)} does not split over {tp} ranks")
    return t.chunk(tp, dim=shard.axis)[rank].contiguous()


def gather_tensor(parts, shard: Optional[TPShard]) -> torch.Tensor:
    """The whole tensor from the ranks' ``parts`` (in rank order)."""
    if shard is None or len(parts) == 1:
        return parts[0]
    if shard.heads:
        thirds = [p.unflatten(shard.axis, (3, p.shape[shard.axis] // 3)) for p in parts]
        return torch.cat(thirds, dim=shard.axis + 1).flatten(shard.axis, shard.axis + 1)
    return torch.cat(list(parts), dim=shard.axis)


def shard_state(state_dict: Mapping[str, torch.Tensor], rank: int, tp: int,
                split: AbstractSet[str]) -> dict:
    """Rank ``rank``'s state dict of ``tp`` from the whole one (the blocks
    of ``split`` cut, every other leaf whole)."""
    return {k: shard_tensor(v, shard_of(k, split), rank, tp) for k, v in state_dict.items()}


def gather_state(states, split: AbstractSet[str]) -> dict:
    """The whole state dict from every rank's (in rank order); exact:
    ``gather_state([shard_state(sd, r, tp, s) for r in range(tp)], s) == sd``."""
    return {k: gather_tensor([s[k] for s in states], shard_of(k, split)) for k in states[0]}


def split_blocks(model: torch.nn.Module, tp: int) -> frozenset:
    """The dotted names of ``model``'s blocks that ``tp`` ranks split: those
    whose heads and MLP width ``tp`` divides. The others run whole on every
    rank. A bf16 head must stay a multiple of 16 (the cores' tiles; the
    rank's head width is the whole block's), or this raises."""
    from sky_embeddings_tpu_torch.models.layers import Block

    out = set()
    for name, m in model.named_modules():
        if not isinstance(m, Block):
            continue
        D = m.norm1.scale.shape[0]
        hd = D // m.num_heads
        if m.dtype == torch.bfloat16 and hd % 16:
            raise ValueError(f"{name}: bf16 heads of {hd} are no multiple of 16 (the attention "
                             "cores' tiles); tensor parallelism splits whole heads")
        if m.num_heads % tp == 0 and m.ffn.fc1_kernel.shape[1] % tp == 0:
            out.add(name)
    return frozenset(out)


def split_of(model: torch.nn.Module) -> frozenset:
    """The dotted names of ``model``'s blocks that :func:`shard_module` split
    (those that hold the mesh); empty for an unsharded model."""
    from sky_embeddings_tpu_torch.models.layers import Block

    return frozenset(name for name, m in model.named_modules()
                     if isinstance(m, Block) and m.tp is not None)


def shard_module(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replace the parameters of ``model``'s splittable blocks
    (:func:`split_blocks`) by this rank's shards (in place, from the whole
    seeded ones) and give those blocks ``mesh``, whose model group sums the
    tensor-parallel partials. The other blocks stay whole and take the
    recompute kernels (their stash flags off), as every block does under
    tensor parallelism. Returns ``model``."""
    from sky_embeddings_tpu_torch.models.layers import Block

    tp, rank = mesh.tp, mesh.model_index
    split = split_blocks(model, tp)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            shard = shard_of(name, split)
            if shard is None:
                continue
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            leaf = name.rsplit(".", 1)[-1]
            setattr(owner, leaf, torch.nn.Parameter(shard_tensor(p.data, shard, rank, tp).clone(),
                                                    requires_grad=p.requires_grad))
    for name, m in model.named_modules():
        if not isinstance(m, Block):
            continue
        if name in split:
            m.tp = m.ffn.tp = mesh
        else:
            m.stash = m.ffn.stash = False
    return model


def gather_to_main(state_dict: Mapping[str, torch.Tensor], mesh,
                   split: AbstractSet[str]) -> Optional[dict]:
    """The whole state dict (copies on the CPU) on the model group's first
    rank, None on the others, from every rank's sharded ``state_dict`` (every
    rank of the model group calls it; the blocks of ``split`` sharded).
    Each rank broadcasts its shards as one flat tensor per dtype; the
    leaves every rank holds whole come from the first rank's own dict."""
    import torch.distributed as dist

    names = [k for k in state_dict if shard_of(k, split) is not None]
    if mesh.tp == 1 or not names:
        return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}
    ranks = [int(r) for r in mesh.devices[mesh.data_index]]
    # NCCL takes CUDA tensors alone (ZeRO's collected moments are on the CPU)
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(mesh.model_group) == "nccl" else None)
    parts = {k: [] for k in names}
    by_dtype: dict = {}
    for k in names:
        by_dtype.setdefault(state_dict[k].dtype, []).append(k)
    for src in ranks:
        for dtype, keys in by_dtype.items():
            if src == mesh.rank:
                flat = torch.cat([state_dict[k].detach().reshape(-1) for k in keys])
            else:
                flat = torch.empty(sum(state_dict[k].numel() for k in keys), dtype=dtype,
                                   device=state_dict[keys[0]].device)
            if comm is not None:
                flat = flat.to(comm)
            dist.broadcast(flat, src=src, group=mesh.model_group)
            if mesh.model_index == 0:
                for k, piece in zip(keys, flat.cpu().split([state_dict[k].numel() for k in keys])):
                    parts[k].append(piece.reshape(state_dict[k].shape))
            del flat
    if mesh.model_index != 0:
        return None
    return {k: (gather_tensor(parts[k], shard_of(k, split)) if k in parts
                else v.detach().to("cpu", copy=True)) for k, v in state_dict.items()}
