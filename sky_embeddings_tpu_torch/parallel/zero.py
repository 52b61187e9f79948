"""ZeRO-1: the AdamW moments sharded over the data-parallel ranks (port of
``sky_embeddings_tpu/parallel/zero.py``).

JAX annotates each moment leaf with a ``NamedSharding`` that adds 'data' on
its first free divisible dimension (``zero_spec``), and XLA inserts the
reduce-scatter / all-gather pair. Here :func:`shard_optimizer` wraps a
built AdamW's parameter groups (``train/optim.py``: the layer scales, the
decay masks, I-JEPA's scheduled decay) in
``torch.distributed.optim.ZeroRedundancyOptimizer``, which partitions whole
parameters over the ranks: each rank keeps the moments of its share and
updates those parameters alone, then broadcasts them. The update is the
same either way, because AdamW is elementwise, so ``zero_spec`` has no
counterpart. The trainers set ``lr``, ``weight_decay`` and ``lr_scale`` on
the wrapper's groups before each step; ``step`` copies every group key but
``params`` onto the rank's own optimizer.

A save first collects every rank's share on rank 0 (:func:`consolidate`,
a collective: each rank broadcasts its moments as one flat tensor, the
collective that gloo also takes for CUDA tensors); :func:`state_dict` and
:func:`param_states` then read the full state there, in the unsharded
optimizer's form. ``ZeroRedundancyOptimizer.consolidate_state_dict`` would
pickle each rank's state and build a byte tensor from the pickle's
``bytearray`` element by element, about 0.1 s a MB on the host (34 s for
one rank's half of ViT-B's moments on the H100 host,
``tools/ddp_variants.py``). ``load_state_dict`` of a full state (either
framework's file) keeps the rank's share.

The ``lp`` regime stays unsharded, as JAX replicates its
``multi_transform`` state (``zero.py``'s fallback): the trainable head is
too small for sharding to matter.

Under tensor parallelism (``parallel/mesh``) the moments are sharded over
the data group, whose ranks hold the same model shard, and
:func:`consolidate` collects them on the data group's first rank: each
model index's first rank then holds its own shard's moments, which a save
gathers over the model group (``parallel/sharding.gather_to_main``). With
one data index there is nothing to shard: the optimizer stays as it is.
"""

from __future__ import annotations

import torch


def shard_optimizer(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """``optimizer``'s groups under ZeRO-1 over the process group, with its
    class and defaults; ``optimizer`` itself with no process group (one
    rank holds everything, as ``zero_spec`` leaves a spec at dp = 1)."""
    import torch.distributed as dist

    from sky_embeddings_tpu_torch.parallel import mesh

    if not dist.is_initialized() or (mesh.active() is not None and mesh.data_count() == 1):
        return optimizer
    from torch.distributed.optim import ZeroRedundancyOptimizer

    defaults = {k: optimizer.defaults[k] for k in ("lr", "betas", "eps", "weight_decay")}
    # each parameter keeps its own storage: ``parameters_as_bucket_view``
    # would pack them unpadded into one flat bucket a rank, and a parameter
    # after SimMIM's one-element mask_token then starts 4 bytes off the
    # alignment the kernels' vector loads take (a CUDA misaligned address)
    return ZeroRedundancyOptimizer([dict(g) for g in optimizer.param_groups],
                                   optimizer_class=type(optimizer),
                                   process_group=mesh.data_group(), **defaults)


def is_sharded(optimizer: torch.optim.Optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def local(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """The optimizer that holds this rank's state."""
    return optimizer.optim if is_sharded(optimizer) else optimizer


MOMENTS = ("exp_avg", "exp_avg_sq")


def consolidate(optimizer: torch.optim.Optimizer) -> None:
    """Collect a sharded optimizer's AdamW state on the data group's first
    rank (rank 0 without tensor parallelism), in the unsharded optimizer's
    ``state_dict`` form with the moments on the CPU, as
    ``optimizer.consolidated_state``. Every rank must call it; nothing for
    an unsharded optimizer. Each parameter's owner is found by one
    all-reduce; then each rank broadcasts its moments and steps as one flat
    tensor, which the first rank unpacks and the others drop."""
    if not is_sharded(optimizer):
        return
    import torch.distributed as dist

    from sky_embeddings_tpu_torch.parallel import mesh

    group = mesh.data_group()
    ranks = dist.get_process_group_ranks(group) if group is not None else list(
        range(dist.get_world_size()))
    params = [p for g in optimizer.param_groups for p in g["params"]]
    held = optimizer.optim.state
    rank, dev = dist.get_rank(), params[0].device
    first = rank == ranks[0]
    owner = torch.tensor([ranks.index(rank) + 1 if held.get(p) else 0 for p in params], device=dev)
    dist.all_reduce(owner, group=group)  # each state lives on one rank: its index + 1, or 0
    owner = (owner - 1).tolist()
    state = {}
    for r, src in enumerate(ranks):
        mine = [i for i in range(len(params)) if owner[i] == r]
        if not mine:
            continue
        sizes = [2 * params[i].numel() + 1 for i in mine]
        if src == rank:
            flat = torch.cat([torch.cat([held[params[i]][k].reshape(-1) for k in MOMENTS]
                                        + [held[params[i]]["step"].reshape(1).to(params[i])])
                              for i in mine])
        else:
            flat = torch.empty(sum(sizes), dtype=params[mine[0]].dtype, device=dev)
        dist.broadcast(flat, src=src, group=group)
        if first:
            for i, part in zip(mine, flat.cpu().split(sizes)):
                n = params[i].numel()
                state[i] = {"step": torch.tensor(float(part[-1]), dtype=torch.float32),
                            **{k: part[j * n:(j + 1) * n].reshape(params[i].shape).clone()
                               for j, k in enumerate(MOMENTS)}}
        del flat
    if first:
        optimizer.consolidated_state = {"state": state, "param_groups": index_groups(optimizer)}


def index_groups(optimizer: torch.optim.Optimizer) -> list:
    """``optimizer``'s groups as a ``state_dict`` holds them: every key, and
    the parameters as their indices in group order."""
    groups, start = [], 0
    for g in optimizer.param_groups:
        groups.append({**{k: v for k, v in g.items() if k != "params"},
                       "params": list(range(start, start + len(g["params"])))})
        start += len(g["params"])
    return groups


def state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()``; for a sharded optimizer the full state of
    the last :func:`consolidate`, on rank 0."""
    return optimizer.consolidated_state if is_sharded(optimizer) else optimizer.state_dict()


def param_states(optimizer: torch.optim.Optimizer) -> dict:
    """``{parameter: its state}`` of every parameter in ``optimizer``'s
    groups; for a sharded optimizer, on rank 0 after :func:`consolidate`."""
    if not is_sharded(optimizer):
        return {p: optimizer.state.get(p, {}) for g in optimizer.param_groups for p in g["params"]}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {params[i]: s for i, s in optimizer.consolidated_state["state"].items()}


def moment_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors this rank's optimizer state holds."""
    return sum(t.numel() * t.element_size() for s in local(optimizer).state.values()
               for t in s.values() if torch.is_tensor(t))
