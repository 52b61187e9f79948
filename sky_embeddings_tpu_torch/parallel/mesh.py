"""Device mesh and batch layouts (port of
``sky_embeddings_tpu/parallel/mesh.py``).

:func:`create_mesh` builds the ('data', 'model') ``DeviceMesh`` over the
ranks of the process group, with JAX's divisibility errors. Only
``model = 1`` runs: tensor parallelism is not ported (:data:`TP_REASON`).

:func:`batch_sharding` and :func:`replicated` are plain descriptors
(:class:`Sharding`) that ``data/prefetch.device_prefetch`` and
``parallel/distributed.put_global`` read: the rank's device, and whether
the leading axis is split over 'data' (each rank holds its own rows) or
every rank holds it whole. :func:`local_sharding` gives the same
descriptor for a data-only mesh over every process without building one,
which is what the trainers use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

TP_REASON = (
    "tensor parallelism is not ported (ROADMAP): the block kernels take whole qkv / proj / fc1 / "
    "fc2 weights and fuse the residual add after proj and fc2, where a tensor-parallel block "
    "needs column- and row-sharded weights and an all-reduce before that add; JAX turns its "
    "Pallas kernels off under tensor parallelism, and the port runs no plain path on CUDA")


@dataclass(frozen=True)
class Sharding:
    """Where a batch's leaves go: ``device`` (this rank's), split over
    'data' (``batch``: rank ``index`` of ``count`` holds its own rows) or
    replicated."""

    device: torch.device
    batch: bool = True
    index: int = 0
    count: int = 1


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence[int]] = None, device_type: str = "cuda"):
    """A ('data', 'model') ``DeviceMesh`` over ``devices`` (the ranks,
    every rank of the process group by default). ``data`` defaults to the
    rank count over ``model``; ``data * model`` must equal the rank
    count."""
    import torch.distributed as dist

    if devices is None:
        devices = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data({data}) * model({model}) != device count ({n})")
    if model > 1:
        raise NotImplementedError(TP_REASON)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.tensor(list(devices)).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def _rank_device(mesh) -> torch.device:
    from sky_embeddings_tpu_torch.parallel.distributed import rank_device

    return rank_device(mesh.device_type)


def batch_sharding(mesh) -> Sharding:
    """The leading (batch) axis split over 'data'; the rest replicated."""
    return Sharding(_rank_device(mesh), True, mesh.get_local_rank("data"), mesh.size(0))


def replicated(mesh) -> Sharding:
    return Sharding(_rank_device(mesh), False, 0, 1)


def local_sharding(device: torch.device) -> Sharding:
    """:func:`batch_sharding` of a data-only mesh over every process, on
    ``device``, without building the mesh."""
    from sky_embeddings_tpu_torch.parallel.distributed import process_count, process_index

    return Sharding(torch.device(device), True, process_index(), process_count())
